"""Time the port's bf16 flash attention kernel of several source trees in
turns on one card.

    python scripts/torch_flash_ab.py --tree checkout/parent --tree . --rounds 4

Each turn is a fresh process that puts its tree's ``src`` first on
``sys.path``, builds that tree's ``csrc/flash_attention.cu`` and times
``flash_forward_cuda`` on causal bf16 q, k, v drawn from seed 0 at each of
``SHAPES`` the tree's kernel takes (a tree without ``takes`` takes
dv == hd <= 128): the profiler's device ms of one call (the median of
``WINDOWS`` windows of ``CALLS`` calls after ``WARM_S`` seconds of calls,
so the card leaves its idle clocks first), its CUDA-event ms and the SM
clock ``nvidia-smi`` reads after the windows, and the rate of the causal
products at that device time (``causal_flops``).  The turns run the trees in
order, then in reverse, ``--rounds`` times, so each tree goes first as
often as last.  The last line is ``FLASH_AB`` and one JSON object: the
card's name and power limit, each tree's compiler lines for the
tensor-core kernels (registers, spills), every turn's numbers, and per
tree and shape the median and quartiles of the device ms over its turns.  The script and the trees it runs import
torch, never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# name -> (B, S, H, KH, hd, dv): tinyllama-1.1b's prefill (B 16 x 1024),
# chip_smoke.py's hd-128 check, qwen3-moe's and deepseek-v2's (MLA) prefill,
# and the shortest and longest batches of the deepseek-v2.prefill-16k cell
SHAPES = {"hd64": (16, 1024, 32, 4, 64, 64),
          "hd128": (4, 2048, 64, 8, 128, 128),
          "qwen3_moe": (16, 1024, 64, 4, 128, 128),
          "mla": (16, 1024, 128, 128, 192, 128),
          "mla_2k": (8, 2048, 128, 128, 192, 128),
          "mla_16k": (1, 16384, 128, 128, 192, 128)}
CALLS, WINDOWS = 20, 5
WARM_S = 2.0


def causal_flops(B: int, S: int, H: int, hd: int, dv: int) -> int:
    """The products at or below the diagonal: 2 (hd + dv) FLOP a visible
    (query, key) pair, S (S + 1) / 2 pairs a head."""
    return 2 * (hd + dv) * B * H * S * (S + 1) // 2


def measure(tree: str) -> dict:
    """One turn: each shape's device ms and event ms, in this process."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    takes = getattr(fa, "takes", lambda hd, dv: hd == dv <= fa.MAX_HEAD_DIM)
    out = {}
    for name, (B, S, H, KH, hd, dv) in SHAPES.items():
        if not takes(hd, dv):
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, S, H, hd, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, KH, hd, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, KH, dv, generator=g, device=dev).to(torch.bfloat16)
        call = lambda: fa.flash_forward_cuda(q, k, v)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_S:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
            us = sum(ev.self_device_time_total for ev in prof.key_averages()
                     if str(ev.device_type).endswith("CUDA"))
            windows.append(us / CALLS / 1e3)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(CALLS):
            call()
        b.record()
        b.synchronize()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                             capture_output=True, text=True)
        dms = statistics.median(windows)
        out[name] = dict(device_ms=dms, ms=a.elapsed_time(b) / CALLS,
                         causal_tflops=causal_flops(B, S, H, hd, dv) / dms / 1e9,
                         sm_clock=smi.stdout.strip())
        del q, k, v
    log = _build.build_log("flash_attention").splitlines()
    # each tensor-core kernel's entry line, then its spill and register lines
    ptxas = [ln.strip() for i, ln in enumerate(log)
             if "wgmma" in ln or (i > 0 and "wgmma" in " ".join(log[max(0, i - 2):i]))]
    return dict(shapes=out, ptxas=ptxas)


def quartiles(v: list) -> list:
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return [q[0], q[2]]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="a source tree (two or more, each with its src/)")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--measure", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.measure:
        print("TURN " + json.dumps(measure(args.measure)))
        return
    if len(args.tree) < 2:
        p.error("give --tree two or more times")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    fwd = list(range(len(args.tree)))
    order = []
    for i in range(args.rounds):
        order += fwd if i % 2 == 0 else fwd[::-1]
    turns, ptxas = [], {}
    for t in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--measure", args.tree[t]],
                           capture_output=True, text=True, timeout=900)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
        if r.returncode or not line:
            sys.exit(f"turn on {args.tree[t]} failed:\n{r.stdout}\n{r.stderr}")
        res = json.loads(line[0][5:])
        if res["ptxas"]:
            ptxas[args.tree[t]] = res["ptxas"]
        turns.append(dict(tree=args.tree[t], **res["shapes"]))
        print(f"turn {len(turns)} tree {args.tree[t]}: "
              + json.dumps({k: [round(u["device_ms"], 4), round(u["causal_tflops"], 1)]
                            for k, u in res["shapes"].items()}),
              flush=True)
    summary = {}
    for name in SHAPES:
        row = {}
        for tree in args.tree:
            v = [u[name]["device_ms"] for u in turns if u["tree"] == tree and name in u]
            if v:
                med = statistics.median(v)
                row[tree] = dict(device_ms_median=med, device_ms_quartiles=quartiles(v),
                                 causal_tflops=causal_flops(*SHAPES[name][:3],
                                                            *SHAPES[name][4:]) / med / 1e9,
                                 turns=len(v))
        summary[name] = row
    print("FLASH_AB " + json.dumps(dict(card=card, trees=args.tree, rounds=args.rounds,
                                        shapes=SHAPES, ptxas=ptxas, turns=turns,
                                        summary=summary)))


if __name__ == "__main__":
    main()
