"""Time the port's single-device training steps of two source trees in
turns on one card.

    python scripts/torch_step_ab.py --tree checkout/parent --tree . --pairs 10

Each turn is a fresh process that puts its tree's ``src`` first on
``sys.path`` and times, at tm-mnist's full width, B 64, on the bank
``tm.init`` makes from key 0, ``ops.tm_train_step_kernel`` fused, unfused
and chunked by 24, and ``ops.tm_train_step_matmul``: the CUDA-event ms of
one step (the median of ``LOOPS`` loops of ``STEPS`` steps after a
warm-up, host work between launches included) and the profiler's device
ms of one step.  The turns run A B B A A B ..., so each tree goes first
in half the pairs.  The last line is ``STEP_AB`` and one JSON object:
the card's name and power limit, every turn's numbers, and per tree and
step its median and quartiles over the turns, with the pairs the second
tree won.  The script and the trees it runs import torch, never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

BATCH, CHUNK, SEED = 64, 24, 3
LOOPS, STEPS = 5, 20
VARIANTS = ("fused", "unfused", f"chunk{CHUNK}", "matmul")


def measure(tree: str) -> dict:
    """One turn: every variant's event ms and device ms, in this process."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.matador_tm import TM_MNIST
    from repro_torch.core import prng, tm
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TM_MNIST
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 2, (BATCH, cfg.n_features), dtype=np.uint8)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, BATCH).astype(np.int32)).to(dev)
    ta = tm.init(cfg, prng.PRNGKey(0), dev).ta_state
    steps = {
        "fused": lambda: ops.tm_train_step_kernel(cfg, ta, x, y, SEED),
        "unfused": lambda: ops.tm_train_step_kernel(cfg, ta, x, y, SEED, fuse=False),
        f"chunk{CHUNK}": lambda: ops.tm_train_step_kernel(cfg, ta, x, y, SEED,
                                                         batch_chunk=CHUNK),
        "matmul": lambda: ops.tm_train_step_matmul(cfg, ta, x, y, SEED),
    }
    out = {}
    for name, step in steps.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        loops = []
        for _ in range(LOOPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(STEPS):
                step()
            b.record()
            b.synchronize()
            loops.append(a.elapsed_time(b) / STEPS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
        dev_us = sum(getattr(ev, "self_device_time_total", 0.0)
                     for ev in prof.key_averages()
                     if str(getattr(ev, "device_type", "")).endswith("CUDA"))
        out[name] = dict(ms=statistics.median(loops), device_ms=dev_us / STEPS / 1e3)
    return out


def quartiles(v: list) -> list:
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return [q[0], q[2]]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="a source tree (twice: A, then B)")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--measure", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.measure:
        print("TURN " + json.dumps(measure(args.measure)))
        return
    if len(args.tree) != 2:
        p.error("give --tree twice")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    order = []
    for i in range(args.pairs):
        order += [0, 1] if i % 2 == 0 else [1, 0]
    turns = []
    for t in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--measure", args.tree[t]],
                           capture_output=True, text=True, timeout=600)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("TURN ")]
        if r.returncode or not line:
            sys.exit(f"turn on {args.tree[t]} failed:\n{r.stdout}\n{r.stderr}")
        turns.append(dict(tree=t, **json.loads(line[0][5:])))
        print(f"turn {len(turns)} tree {args.tree[t]}: "
              + json.dumps({k: round(turns[-1][k]["ms"], 4) for k in VARIANTS}), flush=True)
    summary = {}
    for name in VARIANTS:
        row = {}
        for t in (0, 1):
            for key in ("ms", "device_ms"):
                v = [u[name][key] for u in turns if u["tree"] == t]
                row[f"{'ab'[t]}_{key}_median"] = statistics.median(v)
                row[f"{'ab'[t]}_{key}_quartiles"] = quartiles(v)
        a = [u[name]["ms"] for u in turns if u["tree"] == 0]
        b = [u[name]["ms"] for u in turns if u["tree"] == 1]
        row["b_faster_pairs"] = sum(bb < aa for aa, bb in zip(a, b))
        summary[name] = row
    print("STEP_AB " + json.dumps(dict(card=card, trees=args.tree, pairs=args.pairs,
                                       batch=BATCH, turns=turns, summary=summary)))


if __name__ == "__main__":
    main()
