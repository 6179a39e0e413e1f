"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card (bit for bit, tolerance
0) at tm-mnist width, checks every engine of ``run_compiled`` against the
oracle, then drives the serving path (``repro_torch.launch.serve.serve_tm``
on the committed tm-mnist artifact, 4096 requests in buckets of 512) once
per kernel rung of the engine ladder, with the kernels' launch counts set to
0 just before each run and read just after.  Prints the card's name and
power limit, a ``kernels`` JSON line with each kernel's launches, error,
time, plain-version time and bound, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device, when the port's sources are missing, or when
any phase fails.  Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ASSET = os.path.join(ROOT, "src", "repro_torch", "assets", "tm_mnist_e1.npz")
BATCHES = (1, 33, 97, 512)
BUCKET = 512
# H100 SXM peaks at its 700 W limit: device memory rate (NVIDIA data
# sheet), and the 32-bit integer and bitwise issue rate these kernels'
# operations run at (no tensor-core path): 132 SMs x 64 INT32 lanes per SM
# per clock (CUDA programming guide, compute capability 9.0) x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNELS = {
    "fused_infer": dict(source="src/repro_torch/kernels/csrc/fused_infer.cu",
                        replaces="src/repro/kernels/fused_infer.py:43",
                        engine="dense"),
    "sparse_infer": dict(source="src/repro_torch/kernels/csrc/sparse_infer.cu",
                         replaces="src/repro/kernels/sparse_infer.py:393",
                         engine="sparse"),
    "term_infer": dict(source="src/repro_torch/kernels/csrc/term_infer.cu",
                       replaces="src/repro/kernels/term_infer.py:334",
                       engine="factorized"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn`` (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(prof) -> dict:
    """{kernel or copy name: (device microseconds, count)} of a profile."""
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", 0.0)
            if us:
                out[ev.key] = (us, ev.count)
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def chain_need(rows, chain, tile_jb, indptr, *, n_rows, block_c, block_j,
               tile_off, sentinel):
    """(chain id bytes, AND operations) a chain walk over ``rows`` needs on
    this run's data.  A clause reads a tile of its chain only while one of
    its 32-sample words is still alive before that tile (the walk stops at a
    tile boundary once all 32 samples are dead); each such id is read once,
    and each real (non-sentinel) id ANDs one word per live sample word."""
    import torch

    from repro_torch.kernels.sparse_infer import and_reduce

    jb, ip = tile_jb.tolist(), indptr.tolist()
    n_bytes = n_ops = 0
    for cb in range(len(ip) - 1):
        t0, t1 = tile_off + ip[cb], tile_off + ip[cb + 1]
        lo, hi = cb * block_c, min((cb + 1) * block_c, n_rows)
        if t1 <= t0 or hi <= lo:
            continue
        n, nt = hi - lo, t1 - t0
        cols = torch.cat([torch.arange(j * block_j, (j + 1) * block_j,
                                       device=chain.device) for j in jb[t0:t1]])
        ids = chain[lo:hi].index_select(1, cols).long()          # (n, nt * bj)
        tile_ok = and_reduce(rows[ids].view(n * nt, block_j, -1)).view(n, nt, -1)
        alive = torch.empty_like(tile_ok)
        alive[:, 0] = -1
        for t in range(1, nt):
            alive[:, t] = alive[:, t - 1] & tile_ok[:, t - 1]
        live = alive != 0                                        # (n, nt, Sw)
        real = (ids.view(n, nt, block_j) != sentinel).sum(-1)    # (n, nt)
        n_bytes += int(live.any(-1).sum()) * block_j * 4
        n_ops += int((live.sum(-1) * real).sum())
    return n_bytes, n_ops


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        import numpy as np

        from repro_torch.core import compiler, packetizer
        from repro_torch.data.synthetic import make_boolean_classification
        from repro_torch.kernels import _build, fused_infer, ref, sparse_infer, term_infer
        from repro_torch.launch import serve
    except ImportError as e:
        fail(f"the port's package is not importable from {ROOT}/src: {e}")
    mods = {"fused_infer": fused_infer, "sparse_infer": sparse_infer,
            "term_infer": term_infer}
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    _build.build()
    print(f"built {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_build.last_build_seconds:.1f} s)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. the artifact, checksum verified
    compiled = compiler.CompiledTM.load(ASSET)
    st = compiled.stats
    print(f"artifact: U={compiled.n_unique} Wa={compiled.n_words_active} "
          f"includes={st.n_includes} sharing={st.partial_term_sharing:.3f}")
    tabs = compiled.tensors(dev)
    sched = compiled.default_schedule
    fsched = compiled.default_factorized_schedule

    # 4. requests, packed on the card
    X, _ = make_boolean_classification(max(BATCHES), 784, 10, seed=2)
    xp_all = packetizer.pack_literals(torch.from_numpy(X).to(dev))
    xw_all = xp_all[:, tabs["word_ids"]].contiguous()

    # 5. each kernel against its plain version, every engine against the
    # oracle, early exit against the full walk, quality tiers in bound
    stab = sched.tensors(dev)
    ftab = fsched.tensors(dev)
    smargin = torch.from_numpy(np.asarray(compiled.tile_margins(), np.int32)).to(dev)
    fmargin = torch.from_numpy(
        np.asarray(compiled.factorized_tile_margins(), np.int32)).to(dev)
    votes, inc = tabs["votes"], tabs["include_words"]
    nonempty = torch.ones(inc.shape[0], dtype=torch.int32, device=dev)

    def calls(name, xw, margin_on=False):
        """(kernel call, plain call) on the same inputs."""
        if name == "fused_infer":
            args = (xw, inc, votes, nonempty)
            return (lambda: fused_infer.fused_forward_cuda(*args),
                    lambda: fused_infer.fused_forward_plain(*args))
        if name == "sparse_infer":
            kw = dict(block_c=sched.block_c, block_j=sched.block_j,
                      tile_margin=smargin if margin_on else None)
            args = (xw, stab["chain_ids"], votes, stab["tiles"], stab["indptr"])
            return (lambda: sparse_infer.sparse_tables_cuda(*args, **kw),
                    lambda: sparse_infer.sparse_tables_plain(*args, **kw))
        kw = dict(block_c=fsched.block_c, block_j=fsched.block_j,
                  n_term_tiles=fsched.n_term_tiles,
                  tile_margin=fmargin if margin_on else None)
        args = (xw, ftab["term_chain"], ftab["clause_chain"], votes,
                ftab["tiles"], ftab["indptr"])
        return (lambda: term_infer.factorized_tables_cuda(*args, **kw),
                lambda: term_infer.factorized_tables_plain(*args, **kw))

    max_err = {name: 0 for name in KERNELS}
    for B in BATCHES:
        xp, xw = xp_all[:B].contiguous(), xw_all[:B].contiguous()
        oracle = compiler.run_compiled(compiled, xp, engine="oracle")
        torch.cuda.synchronize()
        check(oracle.shape == (B, 10) and oracle.dtype == torch.int32,
              f"oracle output {tuple(oracle.shape)} {oracle.dtype}")
        for name, meta in KERNELS.items():
            modes = [False] if name == "fused_infer" else [False, True]
            for margin_on in modes:
                kern, plain = calls(name, xw, margin_on)
                a, b = kern(), plain()
                torch.cuda.synchronize()
                err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                max_err[name] = max(max_err[name], err)
                check(err == 0, f"{name} B={B} early_exit={margin_on}: kernel "
                      f"differs from its plain version by {err}")
            eng = meta["engine"]
            out = compiler.run_compiled(compiled, xp, engine=eng)
            torch.cuda.synchronize()
            check(torch.equal(out, oracle), f"run_compiled({eng}) != oracle at B={B}")
            if eng == "dense":
                continue
            ee = compiler.run_compiled(compiled, xp, engine=eng, early_exit=True)
            check(torch.equal(ee.argmax(-1), oracle.argmax(-1)),
                  f"{eng} early-exit argmax != full walk at B={B}")
            for lvl in compiled.quality_levels(eng)[1:]:
                q = compiler.run_compiled(compiled, xp, engine=eng,
                                          quality=lvl["level"])
                served = q.argmax(-1)
                gap = oracle.max(-1).values - oracle.gather(1, served[:, None])[:, 0]
                check(bool((gap <= lvl["bound"]).all()),
                      f"{eng} quality {lvl['level']} misses its bound "
                      f"{lvl['bound']} at B={B}")
        print(f"B={B}: kernels == plain versions, engines == oracle, "
              "early exit and quality tiers hold")

    # times at every batch; the bucket's are the headline numbers
    times = {name: {} for name in KERNELS}
    for B in BATCHES:
        xw = xw_all[:B].contiguous()
        for name in KERNELS:
            kern, plain = calls(name, xw)
            times[name][B] = dict(ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain, reps=5))
            if name != "fused_infer":
                times[name][B]["early_exit_ms"] = cuda_time_ms(calls(name, xw, True)[0])
    print("BATCH_TIMES " + json.dumps(times))
    # device time of what each wrapper launches at the bucket size, from the
    # profiler: the event times above also hold the host's launch work
    from torch.profiler import ProfilerActivity, profile

    for name in KERNELS:
        kern = calls(name, xw_all[:BUCKET].contiguous())[0]
        kern()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kern()
            torch.cuda.synchronize()
        us = device_us(prof)
        times[name][BUCKET]["device_ms"] = (
            sum(u for u, _ in us.values()) / 20 / 1e3 if us else None)
        print(f"{name} device work per call at B={BUCKET}: "
              + json.dumps({k[:50]: round(u / 20, 2) for k, (u, _) in us.items()}))

    # 6. the serving path, once per kernel rung, counts zeroed around each
    runs = {"term_infer": [], "sparse_infer": ["--no-factorize"],
            "fused_infer": ["--no-sparse"]}
    expect = {"term_infer": "factorized", "sparse_infer": "sparse",
              "fused_infer": "dense"}
    launches = {}
    for name, extra in runs.items():
        argv = ["--arch", "tm-mnist", "--artifact", ASSET, "--device", "cuda",
                "--requests", "4096", "--bucket", str(BUCKET), *extra]
        for m in mods.values():
            m.launches = 0
        health, gw = serve.serve_tm(serve.build_parser().parse_args(argv))
        counts = {k: m.launches for k, m in mods.items()}
        print(f"serve {' '.join(extra) or '(default)'}: launches {counts}")
        check(health["final_engine"] == expect[name],
              f"serve ended on {health['final_engine']}, expected {expect[name]}")
        check(health["demotions"] == [] and health["probe_failures"] == [],
              f"serve demoted: {health['demotions']} {health['probe_failures']}")
        check(gw["unaccounted"] == 0 and gw["answered"] == 4096,
              f"gateway: {gw['answered']} answered, {gw['unaccounted']} unaccounted")
        check(counts[name] > 0, f"{name} was never launched on its serving path")
        launches[name] = counts[name]

    # where the serving time goes: the default run once more under the
    # profiler; device time against the serve call's host wall time
    argv = ["--arch", "tm-mnist", "--artifact", ASSET, "--device", "cuda",
            "--requests", "4096", "--bucket", str(BUCKET)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.serve_tm(serve.build_parser().parse_args(argv))
        wall_s = time.perf_counter() - t0
    us = device_us(prof)
    busy_s = sum(u for u, _ in us.values()) / 1e6
    top = sorted(us.items(), key=lambda kv: -kv[1][0])[:8]
    print("PROFILE " + json.dumps(dict(
        serve_wall_s=wall_s, device_busy_s=busy_s if us else None,
        idle_share=1 - busy_s / wall_s if us else None,
        top=[dict(name=k[:60], us=u, count=n) for k, (u, n) in top])))

    # 7. the kernels line.  Bound: the bytes the function must move (each
    # input it reads once, the output once; for the schedule kernels the
    # chain ids this run's walk needs, not the padded tables) over the
    # memory rate, against its integer operations over the issue rate
    B = BUCKET
    xw = xw_all[:B]
    Sw = -(-B // 32)
    fired = ref.clause_fire_ref(xw, inc).to(torch.int64)
    fold_ops = int(fired.sum()) * votes.shape[1]
    U, K = votes.shape
    io_bytes = nbytes(xw, votes) + B * K * 4
    lit_t = sparse_infer.bit_transpose_literals(xw, xw.shape[1] * 32)
    s_bytes, s_ops = chain_need(
        lit_t, stab["chain_ids"], stab["tiles"][1], stab["indptr"], n_rows=U,
        block_c=sched.block_c, block_j=sched.block_j, tile_off=0,
        sentinel=sched.n_lit_bits)
    term_bits = sparse_infer.and_reduce(lit_t[ftab["term_chain"].long()])
    f_bytes, f_ops = chain_need(
        term_bits, ftab["clause_chain"], ftab["tiles"][3], ftab["indptr"],
        n_rows=U, block_c=fsched.block_c, block_j=fsched.block_j,
        tile_off=fsched.n_term_tiles, sentinel=fsched.n_terms)
    stage1_ops = int((ftab["term_chain"] != fsched.n_lit_bits).sum()) * Sw
    n_clause_tiles = fsched.n_tiles - fsched.n_term_tiles
    work = {
        # one three-input logic op (viol |= inc & ~lit) per sample, clause, word
        "fused_infer": (io_bytes + nbytes(inc, nonempty),
                        B * inc.shape[0] * inc.shape[1] + fold_ops),
        "sparse_infer": (io_bytes + s_bytes + 2 * sched.n_tiles * 4
                         + nbytes(stab["indptr"]),
                         s_ops + fold_ops),
        "term_infer": (io_bytes + nbytes(ftab["term_chain"]) + f_bytes
                       + 2 * n_clause_tiles * 4 + nbytes(ftab["indptr"]),
                       stage1_ops + f_ops + fold_ops),
    }
    print("BOUND_WORK " + json.dumps(
        {k: dict(bytes=b, ops=o) for k, (b, o) in work.items()}))
    rows = []
    for name, meta in KERNELS.items():
        nb, ops = work[name]
        t_bytes, t_ops = nb / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[name],
                   max_abs_err=max_err[name], ms=times[name][B]["ms"],
                   plain_ms=times[name][B]["plain_ms"],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=None)
        for extra in ("device_ms", "early_exit_ms"):
            if extra in times[name][B]:
                row[extra] = times[name][B][extra]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
