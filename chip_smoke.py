"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card (bit for bit for the
eight integer kernels; flash attention to the tolerance stated at
``flash_tolerance``) at the widths its path uses, checks every engine of
``run_compiled`` against the oracle, then drives the serving path
(``repro_torch.launch.serve.serve_tm`` on the committed tm-mnist artifact,
4096 requests in buckets of 512) once per kernel rung of the engine
ladder, the training path (``repro_torch.launch.train.train_tm``,
tm-mnist, 40 steps of 64) fused, unfused and batch-chunked, the BNN
baseline (784-256-256-256-10 trained one epoch, packed, 10,000
predictions through ``xnor_popcount``) and the LM serving path
(``serve_lm`` on tinyllama-1.1b at full width in bf16, batch 16, 1024
prompt tokens, 64 decode steps, the flash kernel's tensor-core (wgmma)
variant in every layer's prefill), with the kernels' launch counts set to
0 just before each run and read just after.  The training kernels are
held to their plain versions on the initial and trained banks at every
batch size, with offsets, a half-bank shard and saturated feedback
(p_t = p_n = 1), ``fused_infer`` with them on the whole bank as a fused
step runs it, and their occupancy is printed (``TRAIN_OCCUPANCY``; the
serve bucket's ``fused_infer``, ``sparse_infer`` and ``term_infer`` in
``INFER_OCCUPANCY``).  At the benchmark's batch (65,536 samples) on its two
artifacts ``term_infer`` takes its slab-resident design: held to its plain
version at tolerance 0 in one launch and one ``term_infer.slab`` span a
call, and timed beside its bound (``SLAB``; the kernels line's
``term_infer`` row holds it as ``slab``).
The three trained banks must
equal each other and a run of the plain versions; a resumed run must
equal an uninterrupted one; the trained bank must compile and serve equal
to the oracle on every engine.  ``class_sum`` is also held and timed on the
unfused dense rung's shape, the serve bucket's fire matrix over the
artifact's clauses (``CLASS_SUM_SERVE``).  Checks that the flash and
xnor_popcount libraries' SASS holds tensor-core MMA instructions (HGMMA;
BMMA), times xnor_popcount at every BNN layer (``BNN_TIMES``, beside a
float32 ``torch.matmul`` and an int8 ``torch._int_mm`` of the +-1 matrices,
timed only) and prints its launch shape (``BNN_OCCUPANCY``), and holds and
times the bf16 flash kernel at hd 128 (qwen3-32b's attention) beside
``scaled_dot_product_attention``.  The JNP_TRAIN phase (``jnp_train_phase``)
runs ``serve_tm`` without an artifact, with the README's recipe of the
committed one: it trains tm-mnist on the card with the reference's
``jax.random`` trainer (``fit(engine="jnp")``, threefry in torch ops),
compiles and serves through ``term_infer``, and its artifact must equal
the committed asset; ``batch_feedback_delta`` on the card must equal the
CPU's at B 64, and ``train_step`` is timed beside the hash-RNG step.  The
online phase trains a live tm-mnist bank on the card the same way
(``fit(engine="jnp")``), drives the ``OnlineUpdater``
(each step held to the plain versions, each recompiled candidate to a
from-scratch compile, the promoted artifact to the oracle through both
schedule kernels; ``ONLINE_DRILL``), then ``serve_tm --online --zoo 2``
beside the same requests served without it (``ONLINE_SERVE``) and
``serve_tm --zoo 4`` on the committed artifact (``ZOO_SERVE``).  The
AUTOTUNE phase (``autotune_phase``) holds every candidate launch of the
four tuned kernels to its plain version, sweeps them in a fresh cache,
refits the ``torch-cuda`` cost model, and drives ``serve_tm --autotune``
under every policy, a zoo cold load and ``train_tm --autotune``.  The
LM_TRAIN phase (``lm_train_phase``, after the LM serve phase) holds the
flash kernel's ``lse`` variant to its plain version on layer 0's training
inputs and one bf16 smoke training step through the kernel route to the
plain route, then drives ``train_lm`` on tinyllama-1.1b at full width (5
steps of 4 x 1024; 2 x 22 tensor-core flash launches a step, the forward
and the remat recompute), holds its step 1 to the plain route's, profiles
a step's device time by part, and trains pixtral-12b and musicgen-large
at full width with 2 layers.  The LM_FAMILIES phase (``lm_families_phase``,
after LM_TRAIN) drives ``serve_lm`` on recurrentgemma-2b and xlstm-1.3b at
full size and on qwen3-moe-235b-a22b and deepseek-v2-236b at full width
with 2 layers (B 16, 1024-token prompts, 16 decode steps), each with the
flash counts zeroed around it (launches = the global attention layers:
0, 0, 2, 2), holds each prefill's logits to a cacheless forward's and,
for the two kernel families, to the plain route's, splits a profiled warm
prefill and decode's device time by the layers' profiler ranges, holds
the flash kernel to its plain version on the two kernel families' layer-0
prefill inputs (qwen3-moe's hd 128 over 4 kv heads, deepseek-v2's MLA
widths, qk 192 over v 128) in bf16, with lse and in float32, and times it
beside SDPA (the flash row's ``qwen3_*`` and ``mla_*`` fields), then
trains recurrentgemma-2b (3 layers) and xlstm-1.3b (8 layers) at full
width and the MoE families' bf16 smoke configs with ``train_lm``,
deepseek's smoke step through both routes.  The MESH phase
(``mesh_phase``) lays ``MESH_DEVICES`` logical devices over the card and
holds the clause-sharded forwards (padded tile tables included), training
steps, ``fit(mesh=)``, ``train_tm --mesh`` and ``serve_tm --mesh`` to
their unsharded runs, each kernel launched once a shard.  The LM_MESH
phase (``lm_mesh_phase``) lays 8 logical devices over the card and serves
qwen3-moe-235b-a22b and deepseek-v2-236b (full width, 2 layers) through
the mesh prefill and decode steps, MoE's experts a (data, model) shard at
a time, held to the plain route; trains the MoE smoke configs with the
mesh train step in both layouts; holds tinyllama-1.1b's mesh step to the
single-device step bit for bit; and holds the int8 all-reduce on the card
to its CPU result.  The DRYRUN phase (``dryrun_phase``) runs one
full-width dry-run cell on the meta device and prints LM_TRAIN's roofline
bound (the traced FLOPs, and the bytes the step must move) beside its
measured step.  Prints the
card's name and power limit, a
``kernels`` JSON line with each kernel's launches, error and tolerance,
time, plain-version time, library time (event and device) and bound
(device times: the median of ``WINDOWS`` profiler windows, with their
min-max spread; ``fused_infer``'s row also holds its ``train_*`` fields,
its launch in a fused training step, and ``flash_attention``'s the lse
variant's in ``train_lm`` and its ``qwen3_*`` and ``mla_*`` fields at the
two kernel families' prefill shapes), and
as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device, when the port's sources are missing, or when
any phase fails.  Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ASSET = os.path.join(ROOT, "src", "repro_torch", "assets", "tm_mnist_e1.npz")
BATCHES = (1, 33, 97, 512)
BUCKET = 512
# the benchmark's inference batch and artifacts, where term_infer takes its
# slab-resident design (SLAB)
SLAB_BATCH = 65536
SLAB_ASSETS = {"tm-mnist": ("mnist", "tmbench/assets/tm_mnist_10k_e1.npz"),
               "tm-cifar2": ("cifar2", "tmbench/assets/tm_cifar2_e1.npz")}
# H100 SXM peaks at its 700 W limit: device memory rate (NVIDIA data
# sheet), and the 32-bit integer and bitwise issue rate these kernels'
# operations run at (no tensor-core path): 132 SMs x 64 INT32 lanes per SM
# per clock (CUDA programming guide, compute capability 9.0) x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# __popc issues at 16 per SM per clock on compute capability 9.0, a quarter
# of the 32-bit integer rate (CUDA programming guide, arithmetic instruction
# throughput table): xnor_popcount's floor if its counts ran on the CUDA
# cores, printed as information
POPC_OPS_PER_S = 132 * 16 * 1.98e9
# dense int8 tensor-core peak (NVIDIA data sheet): the same 0/1 products as
# xnor_popcount's one-bit products, 2 operations a product
INT8_OPS_PER_S = 1979e12
# dense bf16 tensor-core peak (NVIDIA data sheet), the rate flash
# attention's products could run at
BF16_FLOPS_PER_S = 989e12

# profile_device: separate profiler windows, calls in each
WINDOWS, WINDOW_CALLS = 5, 20
# In a long process the profiler can miss a window's first launches (on
# the H100 up to 17 of 20 flash calls, reading a time under the byte
# bound while CUDA events read the full one; waiting after the profiler
# starts does not help).  So each window first launches PROFILER_PREROLL
# markers (``torch.cuda._sleep``'s spin kernel): the missed launches have
# been a prefix, so a window that recorded a marker is taken to have
# recorded every call, and the median over windows absorbs an exception.
# A window that recorded none is not read; at most PROFILER_TRIES x
# windows are run
PROFILER_PREROLL = 100
PROFILER_TRIES = 3
MARKER_KERNEL = "spin_kernel"

TRAIN_STEPS, TRAIN_BATCH = 40, 64
TRAIN_BATCHES = (1, 33, 64, 97)
# integer operations per automaton draw: the hash's 3 multiplies, 1 add,
# 3 shifts and 3 xors (kernels/csrc/hash_rng.cuh)
OPS_PER_DRAW = 10

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
TRAIN_KERNELS = {
    "fused_train": dict(source="src/repro_torch/kernels/csrc/fused_train.cu",
                        replaces="src/repro/kernels/fused_train.py:65"),
    "clause_eval": dict(source="src/repro_torch/kernels/csrc/clause_eval.cu",
                        replaces="src/repro/kernels/clause_eval.py:34"),
    "class_sum": dict(source="src/repro_torch/kernels/csrc/class_sum.cu",
                      replaces="src/repro/kernels/class_sum.py:22"),
    "ta_update": dict(source="src/repro_torch/kernels/csrc/ta_update.cu",
                      replaces="src/repro/kernels/ta_update.py:28"),
}

# the online phase: the live bank's boot training (tm-mnist at full width,
# the cut is depth: 1 epoch on 2000 synthetic samples), the drift threshold
# the drill and the --online serve run use (the reference's default; such a
# bank drifts 15-24% a step, so every step rebuilds), the drill's feedback
# batches (64 requests each, from the serving stream), and the zoo run's
# tenants
ONLINE_N_TRAIN, ONLINE_EPOCHS = 2000, 1
# the JNP_TRAIN phase: serve_tm's train path with the README's recipe of the
# committed artifact (tm-mnist at full width, 1 epoch on 600 synthetic
# samples at batch 64: 9 steps), 256 requests in buckets of 256
JNP_ARGV = ["--arch", "tm-mnist", "--device", "cuda", "--epochs", "1", "--n-train",
            "600", "--requests", "256", "--bucket", "256"]
ONLINE_DRIFT = 0.05
ONLINE_STEPS = 24
ONLINE_REQUESTS = 4096
ZOO_TENANTS = 4

BNN_SIZES = (784, 256, 256, 256, 10)
BNN_TEST = 10000
BNN_LR = 0.05
BNN_KERNEL = dict(source="src/repro_torch/kernels/csrc/xnor_popcount.cu",
                  replaces="src/repro/kernels/xnor_popcount.py:22")
LM_ARGV = ["--arch", "tinyllama-1.1b", "--device", "cuda", "--batch-size", "16",
           "--seq-len", "2048", "--new-tokens", "64"]
FLASH_KERNEL = dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:29")
# float32: the reference holds its own flash kernel to flash_ref at this
# absolute tolerance (tests/test_kernels.py)
FLASH_F32_ATOL = 2e-5
# the bf16 kernel at hd 128, the head width of qwen3-32b and starcoder2-7b:
# qwen3-32b's attention (64 query heads over 8 kv heads), 4 prompts of 2048
FLASH_HD128 = dict(B=4, S=2048, H=64, KH=8, hd=128)
# LM_TRAIN: train_lm on tinyllama-1.1b at full width (22 layers, d 2048, hd
# 64, bf16, seed 0), 5 AdamW steps of 4 x 1024 tokens (the cut is depth of
# training); then the stub frontend and the codebook heads at full width
# with the depth cut to LM_TRAIN_CUT_LAYERS, 2 steps of 2 x 1024 each
LM_TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--device", "cuda", "--steps", "5",
                 "--batch-size", "4", "--seq-len", "1024"]
LM_TRAIN_CUT_ARCHS = ("pixtral-12b", "musicgen-large")
LM_TRAIN_CUT_LAYERS = 2
LM_TRAIN_CUT_ARGV = ["--device", "cuda", "--steps", "2", "--batch-size", "2",
                     "--seq-len", "1024"]
# the flash kernel's lse against its plain version's, bf16 inputs: both sum
# the float32 scores and l in other orders, the kernel with ex2.approx
# (relative error under 2^-22), a few float32 units of lse; 1e-3 is ample
LSE_BF16_ATOL = 1e-3
# the kernel and plain routes of a bf16 training step round p and the
# attention output to bf16 at different points (flash_tolerance: 2^-7 of
# the scale): the loss is held to 2^-7 of itself, each gradient leaf's
# norm and the global norm, which sum such differences through the
# backward, to 2^-4 of the plain route's
LM_TRAIN_LOSS_RTOL = 2 ** -7
LM_ROUTE_GRAD_RTOL = 2 ** -4
# LM_FAMILIES: serve_lm on the four families the port ran last, at full
# width, B 16, 1024-token prompts (a 2048-slot cache), 16 decode steps;
# recurrentgemma-2b and xlstm-1.3b at full depth, the two 236 B MoE models
# with the depth cut to 2 layers (12.4 and 10.7 GB of bf16 weights; all of
# either needs expert parallelism over cards)
FAMILIES_SERVE = {"recurrentgemma-2b": None, "xlstm-1.3b": None,
                  "qwen3-moe-235b-a22b": 2, "deepseek-v2-236b": 2}
FAMILIES_ARGV = ["--device", "cuda", "--batch-size", "16", "--seq-len", "2048",
                 "--new-tokens", "16"]
# train_lm at full width with the depth cut to one unit of the pattern (3
# layers: rec, rec, local; 8: 7 mLSTM, 1 sLSTM), 2 steps of 2 x 1024; the
# MoE families' bf16 smoke configs one step of 4 x 256 (full-width MoE
# training does not fit one card: ~12 bytes a parameter for AdamW)
FAMILIES_TRAIN = {"recurrentgemma-2b": 3, "xlstm-1.3b": 8}
FAMILIES_TRAIN_ARGV = ["--device", "cuda", "--steps", "2", "--batch-size", "2",
                       "--seq-len", "1024"]
FAMILIES_SMOKE_TRAIN = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
FAMILIES_SMOKE_ARGV = ["--device", "cuda", "--steps", "1", "--batch-size", "4",
                       "--seq-len", "256"]
# bf16 logits of two routes (kernel and plain), or of the prefill and a
# cacheless forward, differ by rounding p and the attention output to bf16
# at different points and by bf16 index_add's order of each token's
# experts: held to 2^-7 of the largest |logit|.  A MoE layer's routing is
# discontinuous (a token near the k-th expert's gate, or at an expert's
# capacity, changes experts on a rounding), so the MoE families' logits
# are held as LM_TRAIN holds its loss, to 2^-7 of itself: the mean
# cross-entropy of the last-token logits against labels from seed 1, an
# end-to-end sanity line only (a statistic of 16 rows says little of the
# logits' values): the kernel itself is held to its plain version on
# these families' layer-0 inputs (FAMILIES_FLASH)
FAMILIES_LOGIT_RTOL = 2 ** -7
# random weights give unit-variance logits after the final norm: a loss
# near ln V + 0.5; a step or two moves it by far less than this
FAMILIES_LOSS_ATOL = 1.0
# the flash kernel held to its plain version on each kernel family's
# layer-0 prefill inputs at its serve shape: arch -> the flash row's field
# prefix (qwen3-moe: H 64 over 4 kv heads, hd 128; deepseek-v2's MLA: qk
# width 192 over v width 128)
FAMILIES_FLASH = {"qwen3-moe-235b-a22b": "qwen3_", "deepseek-v2-236b": "mla_"}
GEMM_RE = r"gemm|nvjet|xmma|cutlass|cublas|matmul"


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


def profile_device(fn, calls: int = WINDOW_CALLS, windows: int = WINDOWS,
                   key: str = "device_ms"):
    """Device time (ms) of everything one call of ``fn`` launches, from the
    profiler, in ``windows`` separate windows of ``calls`` calls, each
    read only when one of its marker launches was recorded:
    ``{key: the median of the windows' means, key + "_spread": [min, max],
    key + "_incomplete": windows not read, key + "_missed": the most
    markers a read window missed}``, and the median window's per-name
    breakdown in microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    reads, incomplete, missed = [], 0, 0
    while len(reads) < windows and len(reads) + incomplete < PROFILER_TRIES * windows:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_PREROLL):
                torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = device_us(prof)
        markers = [k for k in us if MARKER_KERNEL in k]
        if not markers:
            incomplete += 1
            continue
        missed = max(missed, PROFILER_PREROLL - sum(us[k][1] for k in markers))
        for k in markers:
            del us[k]
        if us:
            reads.append((sum(u for u, _ in us.values()) / calls / 1e3, us))
    if not reads:
        return {key: None, key + "_spread": None, key + "_incomplete": incomplete,
                key + "_missed": missed}, {}
    ms = sorted(r for r, _ in reads)
    med = statistics.median(ms)
    us = min(reads, key=lambda r: abs(r[0] - med))[1]
    return ({key: med, key + "_spread": [ms[0], ms[-1]], key + "_incomplete": incomplete,
             key + "_missed": missed},
            {k[:50]: round(u / calls, 2) for k, (u, _) in us.items()})


class Training:
    """The training slice on the card: tm-mnist, batches of 64."""

    def __init__(self, dev):
        import torch

        from repro_torch.configs.matador_tm import TM_MNIST
        from repro_torch.core import tm
        from repro_torch.data.synthetic import paper_dataset
        from repro_torch.kernels import (class_sum, clause_eval, fused_infer,
                                         fused_train, ta_update)
        from repro_torch.launch import train

        self.torch, self.tm, self.train = torch, tm, train
        self.dev, self.config = dev, TM_MNIST
        self.mods = {"fused_infer": fused_infer, "fused_train": fused_train,
                     "clause_eval": clause_eval, "class_sum": class_sum,
                     "ta_update": ta_update}
        self.X, self.y, self.Xte, self.yte = paper_dataset("mnist", n_train=4000)
        c = TM_MNIST
        self.votes = tm.vote_matrix(c, dev)
        self.cls = tm.clause_class(c, dev)
        self.pol = tm.polarity(c, dev)
        self.p_act = 1.0 if c.boost_true_positive else (c.s - 1.0) / c.s
        self.p_inact = 1.0 / c.s

    def args(self, *extra, steps=TRAIN_STEPS):
        return self.train.build_parser().parse_args(
            ["--arch", "tm-mnist", "--device", "cuda", "--steps", str(steps),
             "--batch-size", str(TRAIN_BATCH), "--log-every", str(steps), *extra])

    def run(self, label, *extra, steps=TRAIN_STEPS):
        """train_tm with every count zeroed before and read after."""
        for m in self.mods.values():
            m.launches = 0
        t0 = time.perf_counter()
        bank, _ = self.train.train_tm(self.args(*extra, steps=steps))
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: m.launches for k, m in self.mods.items()}
        print(f"train {label}: {wall:.2f} s for {steps} steps, launches {counts}")
        return bank, counts, wall

    def inputs(self, bank, x, y, seed, b_off):
        """Literals, words and per-sample feedback scalars of one batch,
        from the plain versions (the full bank's class sums)."""
        torch = self.torch
        from repro_torch.core import packetizer
        from repro_torch.kernels import fused_infer, ops

        c, T = self.config, self.config.threshold
        lits = self.tm.literals(x)
        lw = packetizer.pack_bits(lits)
        inc = packetizer.pack_include_masks(bank)
        ones = torch.ones(inc.shape[0], dtype=torch.int32, device=self.dev)
        sums = fused_infer.fused_forward_plain(lw, inc, self.votes, ones)
        kn, p_t, p_n = ops.feedback_probs(torch.clamp(sums, -T, T), y,
                                          c.n_classes, T, seed, b_offset=b_off)
        return dict(ta=bank, lits=lits, lit_words=lw, inc_words=inc, y=y, kn=kn,
                    p_t=p_t, p_n=p_n, clause_class=self.cls, clause_pol=self.pol)

    def plain_step(self, bank, x, y, seed):
        from repro_torch.core import feedback
        from repro_torch.kernels import fused_train

        t = fused_train.prepare(self.inputs(bank, x, y, seed, 0))
        delta = fused_train.fused_train_plain(t, seed, p_act=self.p_act,
                                              p_inact=self.p_inact)
        return feedback.apply_delta(self.config, bank, delta)

    def plain_run(self, bank):
        """The same 40 steps as train_tm, through the plain versions."""
        from repro_torch.data.loader import ShardedBatcher

        it = iter(ShardedBatcher((self.X, self.y), TRAIN_BATCH, seed=0, prefetch=0))
        for step in range(TRAIN_STEPS):
            xb, yb = next(it)
            bank = self.plain_step(bank, self.torch.from_numpy(xb).to(self.dev),
                                   self.torch.from_numpy(yb).to(self.dev), step)
        return bank

    def calls(self, name, t, fire, ftype, kw, seed):
        """(kernel call, plain call) of a training kernel on one batch's
        inputs ``t`` for the clause range of ``kw`` (its local rows)."""
        m = self.mods[name]
        sl = slice(kw["c_offset"], kw["c_offset"] + t["ta"].shape[0])
        if name == "fused_train":
            return (lambda: m.fused_train_cuda(t, seed, **kw),
                    lambda: m.fused_train_plain(t, seed, **kw))
        if name == "ta_update":
            a = (t["ta"], t["lits"], fire, ftype, seed)
            return (lambda: m.ta_delta_cuda(*a, **kw),
                    lambda: m.ta_delta_plain(*a, **kw))
        if name == "clause_eval":
            a = (t["lit_words"], t["inc_words"])
            return lambda: m.clause_fire_cuda(*a), lambda: m.clause_fire_plain(*a)
        a = (fire, self.votes[sl])    # uint8, as the unfused step passes it
        return lambda: m.class_sum_cuda(*a), lambda: m.class_sum_plain(*a)

    def fused_infer_calls(self, t):
        """(kernel call, plain call) of fused_infer on one batch's inputs
        ``t`` as a fused training step runs it: the class sums of the whole
        bank, no empty-clause mask (``nonempty=None``: all ones)."""
        m = self.mods["fused_infer"]
        ones = self.torch.ones(t["inc_words"].shape[0], dtype=self.torch.int32,
                               device=self.dev)
        a = (t["lit_words"], t["inc_words"], self.votes, ones)
        return lambda: m.fused_forward_cuda(*a), lambda: m.fused_forward_plain(*a)

    def batch(self, bank, B, seed, b_off, c_off=0, c_total=None, p=None):
        """(t, fire, ftype, kw) for a batch of B test samples on the rows
        [c_off, c_off + n_loc) of ``bank``: all of them, or half a bank
        when ``c_total`` is set.  ``p`` sets every sample's selection
        probabilities (1.0: every target and negative pair has feedback)."""
        from repro_torch.core import packetizer
        from repro_torch.kernels import fused_train, ops, ref

        torch = self.torch
        x = torch.from_numpy(self.Xte[:B]).to(self.dev)
        y = torch.from_numpy(self.yte[:B]).to(self.dev)
        t = self.inputs(bank, x, y, seed, b_off)
        if p is not None:
            t["p_t"] = t["p_n"] = torch.full_like(t["p_t"], p)
        n_loc = bank.shape[0] if c_total is None else bank.shape[0] // 2
        sl = slice(c_off, c_off + n_loc)
        for k in ("ta", "inc_words", "clause_class", "clause_pol"):
            t[k] = t[k][sl]
        t = fused_train.prepare(t)
        fire = ref.clause_fire_ref(t["lit_words"], t["inc_words"]).to(torch.uint8)
        ftype = ops.feedback_select(t["y"], t["kn"], t["p_t"], t["p_n"],
                                    t["clause_class"], t["clause_pol"], seed,
                                    b_offset=b_off, c_offset=c_off)
        kw = dict(p_act=self.p_act, p_inact=self.p_inact, b_offset=b_off,
                  c_offset=c_off, c_total=c_total)
        return t, fire, ftype, kw

    def check_kernels(self, banks, max_err):
        """Every training kernel against its plain version, tolerance 0, on
        each batch size with offsets and a half-bank shard, and on the
        saturated-feedback batch (p_t = p_n = 1 for every sample)."""
        torch = self.torch
        C = self.config.n_clauses_total
        cases = [(b_off, c_off, c_total, p)
                 for p in (None, 1.0)
                 for b_off, c_off, c_total in ((0, 0, None), (12345, 0, None),
                                               (2 ** 32 - 5, C // 2, C))]
        for label, bank in banks.items():
            for B in TRAIN_BATCHES:
                # fused_infer as a fused step runs it: the whole bank
                kern, plain = self.fused_infer_calls(self.batch(bank, B, 7, 0)[0])
                err = int((kern() - plain()).abs().max())
                max_err["fused_infer"] = max(max_err["fused_infer"], err)
                check(err == 0, f"fused_infer {label} B={B} nonempty=None: kernel "
                      f"differs from its plain version by {err}")
                for b_off, c_off, c_total, p in cases:
                    t, fire, ftype, kw = self.batch(bank, B, 7, b_off, c_off, c_total, p)
                    for name in TRAIN_KERNELS:
                        kern, plain = self.calls(name, t, fire, ftype, kw, 7)
                        a, b = kern(), plain()
                        torch.cuda.synchronize()
                        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                        max_err[name] = max(max_err[name], err)
                        check(err == 0, f"{name} {label} B={B} b_offset={b_off} "
                              f"c_offset={c_off} c_total={c_total} p={p}: kernel "
                              f"differs from its plain version by {err}")
            print(f"training kernels and fused_infer == plain versions on the {label} "
                  f"bank at B={TRAIN_BATCHES}, with offsets and a half-bank shard, "
                  "with the selection's probabilities and saturated (p = 1)")

    def work(self, t, fire, ftype):
        """(bytes, operations) each training kernel needs on these inputs."""
        C, L = t["ta"].shape
        B, W = t["lit_words"].shape
        K = self.votes.shape[1]
        draws = int((ftype == 1).sum()) * L
        bank_io = C * L + C * L * 4 + B * L          # ta in, delta out, lits in
        scal = nbytes(t["y"], t["kn"], t["p_t"], t["p_n"], t["clause_class"],
                      t["clause_pol"])
        fired = int(fire.sum())               # the whole bank's fired pairs
        return {
            # one LOP3 a (sample, clause, word), one add a fired pair and class
            "fused_infer": (nbytes(t["lit_words"], t["inc_words"], self.votes)
                            + C * 4 + B * K * 4, B * C * W + fired * K),
            "fused_train": (bank_io + nbytes(t["lit_words"], t["inc_words"]) + scal,
                            B * C * W + OPS_PER_DRAW * draws),
            "ta_update": (bank_io + 2 * B * C, OPS_PER_DRAW * draws),
            "clause_eval": (nbytes(t["lit_words"], t["inc_words"]) + B * C, B * C * W),
            "class_sum": (B * C + C * K * 4 + B * K * 4, B * C * K),
        }, draws


def train_phases(dev, max_err, launches):
    """Drive the training path and hold its kernels; returns the timing
    rows' numbers for the kernels line."""
    import tempfile

    import torch

    from repro_torch.core import compiler, packetizer, prng
    from repro_torch.kernels import (class_sum, clause_eval, fused_infer, fused_train, ops,
                                     ta_update)

    tr = Training(dev)
    runs = {"fused": (), "--no-fuse": ("--no-fuse",),
            "--batch-chunk 24": ("--batch-chunk", "24")}
    expect = {"fused": ("fused_infer", "fused_train"),
              "--no-fuse": ("clause_eval", "class_sum", "ta_update"),
              "--batch-chunk 24": ("fused_infer", "fused_train")}
    banks, walls, run_counts = {}, {}, {}
    for label, extra in runs.items():
        banks[label], counts, walls[label] = tr.run(label, *extra)
        run_counts[label] = counts
        for name in expect[label]:
            check(counts[name] > 0, f"{name} was never launched in the {label} run")
            if name in TRAIN_KERNELS:   # the first run that drives it
                launches.setdefault(name, counts[name])
    init = tr.tm.init(tr.config, prng.PRNGKey(0), dev).ta_state
    plain = tr.plain_run(init)
    for label, bank in banks.items():
        check(torch.equal(bank, plain),
              f"train_tm {label} ended on another bank than the plain versions")
    trained = banks["fused"]
    moved = int((trained != init).sum())
    print(f"train: fused, --no-fuse and --batch-chunk 24 end on the plain "
          f"versions' bank ({moved} automata moved in {TRAIN_STEPS} steps)")

    with tempfile.TemporaryDirectory() as d:
        tr.run("resume 1/2", "--ckpt-dir", d, "--ckpt-every", "10",
               steps=TRAIN_STEPS // 2)
        resumed, _, _ = tr.run("resume 2/2", "--ckpt-dir", d, "--ckpt-every", "10")
    check(torch.equal(resumed, trained), "resumed run != uninterrupted run")
    print("train: resume from step 20 is bit-exact")

    tr.check_kernels({"initial": init, "trained": trained}, max_err)

    # train -> compile -> serve on the trained bank
    t0 = time.perf_counter()
    comp = compiler.compile_tm(tr.config, trained)
    print(f"compiled the trained bank in {time.perf_counter() - t0:.1f} s: "
          f"U={comp.n_unique} includes={comp.stats.n_includes}")
    x_te = torch.from_numpy(tr.Xte).to(dev)
    xp = packetizer.pack_literals(x_te)
    oracle = compiler.run_compiled(comp, xp, engine="oracle")
    for eng in ("factorized", "sparse", "dense", ops.EngineSpec("dense", fuse=False)):
        out = compiler.run_compiled(comp, xp, engine=eng)
        torch.cuda.synchronize()
        check(torch.equal(out, oracle), f"trained bank: run_compiled({eng}) != oracle")
    pred = tr.tm.predict(tr.config, tr.tm.TMState(ta_state=trained), x_te)
    check(torch.equal(pred, oracle.argmax(-1)), "tm.predict != compiled argmax")
    acc = float((pred.cpu() == torch.from_numpy(tr.yte)).float().mean())
    print(f"TRAINED test_acc={acc:.4f} include_frac="
          f"{float((trained >= 0).float().mean()):.4f} (information, not a gate); "
          "every engine == oracle")

    # times at the training step's shapes (batch 64, the trained bank)
    t, fire, ftype, kw = tr.batch(trained, TRAIN_BATCH, TRAIN_STEPS, 0)
    times = {}
    for name in TRAIN_KERNELS:
        kern, plain = tr.calls(name, t, fire, ftype, kw, TRAIN_STEPS)
        times[name] = dict(ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain, reps=5))
        dev_ms, per = profile_device(kern)
        times[name].update(dev_ms)
        print(f"{name} device work per call at B={TRAIN_BATCH}: {json.dumps(per)}")
    f32 = (fire.to(torch.float32), tr.votes.to(torch.float32))
    times["class_sum"]["library_ms"] = cuda_time_ms(lambda: torch.matmul(*f32))
    times["class_sum"].update(profile_device(lambda: torch.matmul(*f32),
                                             key="library_device_ms")[0])
    # fused_infer at the training step's shape: its launch in every fused
    # step, on the trained bank with the training semantics (nonempty=None)
    kern, plain = tr.fused_infer_calls(t)
    fi = dict(shape=dict(B=TRAIN_BATCH, C=t["inc_words"].shape[0],
                         W=t["lit_words"].shape[1], K=tr.votes.shape[1]),
              launches=run_counts["fused"]["fused_infer"],
              ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain, reps=5))
    dev_ms, per = profile_device(kern)
    fi.update(dev_ms)
    times["fused_infer"] = fi
    print(f"fused_infer device work per call at B={TRAIN_BATCH}: {json.dumps(per)}")
    C, L = t["ta"].shape
    W = t["lit_words"].shape[1]
    K = tr.votes.shape[1]
    print("TRAIN_OCCUPANCY " + json.dumps(dict(
        B=TRAIN_BATCH, C=C, L=L, W=W, K=K,
        fused_train=fused_train.occupancy(TRAIN_BATCH, L, W),
        ta_update=ta_update.occupancy(TRAIN_BATCH, L),
        fused_infer=fused_infer.occupancy(TRAIN_BATCH, C),
        clause_eval=clause_eval.occupancy(TRAIN_BATCH, C),
        class_sum=class_sum.occupancy(TRAIN_BATCH, C, K))))
    work, draws = tr.work(t, fire, ftype)
    fi["bound_ms"], fi["bound_by"] = bound(work["fused_infer"][0],
                                           work["fused_infer"][1] / INT32_OPS_PER_S * 1e3)
    print("TRAIN_BOUND_WORK " + json.dumps(dict(
        draws=draws, **{k: dict(bytes=b, ops=o) for k, (b, o) in work.items()})))
    print("TRAIN_TIMES " + json.dumps(dict(times, train_wall_s=walls)))

    # steady-state wall time of one synchronized step on the host's clock
    xb = torch.from_numpy(tr.X[:TRAIN_BATCH]).to(dev)
    yb = torch.from_numpy(tr.y[:TRAIN_BATCH]).to(dev)
    step_ms = {}
    for label, kw in (("fused", {}), ("--no-fuse", dict(fuse=False)),
                      ("--batch-chunk 24", dict(batch_chunk=24))):
        def step(kw=kw):
            return ops.tm_train_step_kernel(tr.config, trained, xb, yb, 0, **kw)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        step_ms[label] = (time.perf_counter() - t0) / 20 * 1e3
    print("TRAIN_STEP_MS " + json.dumps(step_ms))

    # where one training step's time goes: train_tm under the profiler
    from torch.profiler import ProfilerActivity, profile

    for label, extra in (("fused", ()), ("--no-fuse", ("--no-fuse",))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train.train_tm(tr.args(*extra, steps=10))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        us = device_us(prof)
        busy_s = sum(u for u, _ in us.values()) / 1e6
        top = sorted(us.items(), key=lambda kv: -kv[1][0])[:10]
        n_launch = sum(n for _, n in us.values())
        print("TRAIN_PROFILE " + json.dumps(dict(
            run=label, steps=10, wall_s=wall_s, device_busy_s=busy_s if us else None,
            device_launches=n_launch, device_launches_per_step=n_launch / 10,
            idle_share=1 - busy_s / wall_s if us else None,
            top=[dict(name=k[:60], us=u, count=n) for k, (u, n) in top])))
    return times, work


class _Tee(io.TextIOBase):
    """Writes to several streams at once."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def serve_run(argv):
    """``serve_tm`` on ``argv`` -> (SERVE_HEALTH, GATEWAY_HEALTH,
    ONLINE_HEALTH, the predictions, ms from the first offer to the drained
    gateway, as the serve line prints it)."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        out = serve.serve_tm(serve.build_parser().parse_args(argv))
    m = re.search(r"inferences in \d+ buckets of \d+ \[[^]]*\] in ([0-9.]+) ms",
                  buf.getvalue())
    check(m is not None, "serve_tm printed no serve line")
    return (*out, float(m.group(1)))


def artifact_diffs(path: str, want_path: str) -> list:
    """The arrays and meta fields in which two artifact files differ,
    leaving out the cost-model features and the checksum (a port-saved
    artifact's features have no HLO terms, so both differ by design)."""
    import numpy as np

    a, b = np.load(path), np.load(want_path)
    out = sorted(set(a.files) ^ set(b.files))
    out += [k for k in sorted(set(a.files) & set(b.files))
            if k != "meta" and not np.array_equal(a[k], b[k])]
    ma, mb = (json.loads(bytes(z["meta"]).decode()) for z in (a, b))
    for m in (ma, mb):
        m.pop("features", None)
        m.pop("checksum", None)
    return out + ["meta." + k for k in sorted(set(ma) | set(mb)) if ma.get(k) != mb.get(k)]


def jnp_train_phase(dev, card: str) -> dict:
    """The reference's jax.random trainer on the card (JNP_TRAIN).

    ``serve_tm`` with the README's recipe of the committed artifact
    (``JNP_ARGV``) trains tm-mnist with ``fit(engine="jnp")``, compiles,
    serves through ``term_infer`` and saves; the artifact must equal
    ``ASSET``.  ``batch_feedback_delta`` on the card must equal the CPU's
    at tm-mnist B 64 on the initial bank and on the bank ``fit`` trains.
    Then ``train_step`` is timed beside ``train_step_kernel`` on the same
    batch, and the share of a step's device time spent in threefry."""
    import torch

    from repro_torch.configs.matador_tm import TM_MNIST
    from repro_torch.core import feedback, prng, tm, train
    from repro_torch.data.synthetic import make_boolean_classification
    from repro_torch.kernels import fused_infer, sparse_infer, term_infer

    mods = {"fused_infer": fused_infer, "sparse_infer": sparse_infer,
            "term_infer": term_infer}
    c = TM_MNIST

    # 1. the path: serve_tm trains, compiles, serves and writes the artifact
    out_dir = os.path.join(ROOT, "build", "jnp_train")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tm_mnist_e1.npz")
    if os.path.exists(path):
        os.remove(path)
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    health, gw, _, _, serve_ms = serve_run(JNP_ARGV + ["--artifact", path])
    serve_wall_s = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    check(health["final_engine"] == "factorized" and health["demotions"] == [],
          f"jnp_train: serve ended on {health['final_engine']}, {health['demotions']}")
    check(gw["answered"] == 256 and gw["unaccounted"] == 0,
          f"jnp_train: {gw['answered']} answered, {gw['unaccounted']} unaccounted")
    check(counts["term_infer"] > 0, "jnp_train: the trained artifact was not "
          "served through term_infer")
    diffs = artifact_diffs(path, ASSET)
    check(not diffs, f"jnp_train: the artifact trained on the card differs from "
          f"the committed one in {diffs}")
    print(f"jnp_train: serve_tm {' '.join(JNP_ARGV)} trained, compiled and served "
          f"in {serve_wall_s:.2f} s, launches {counts}; its artifact == "
          f"{os.path.relpath(ASSET, ROOT)} (every array and meta field but the "
          "features and the checksum)")

    # 2. fit's 9 steps on the host's clock, then batch_feedback_delta on the
    # card against the CPU, bit for bit, on the initial and the trained bank
    # (on the initial one no clause fires: only Type I penalties), with the
    # epoch's first batch and step key of fit's stream
    X, y = make_boolean_classification(600, c.n_features, c.n_classes, seed=0)
    bank0 = tm.init(c, prng.PRNGKey(0), dev).ta_state
    t0 = time.perf_counter()
    trained = train.fit(c, tm.TMState(ta_state=bank0), torch.from_numpy(X),
                        torch.from_numpy(y), epochs=1, batch_size=64,
                        rng=prng.PRNGKey(1)).ta_state
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rng, rp = prng.split(prng.PRNGKey(1, dev)).unbind(0)
    perm = prng.permutation(rp, 600)[:64]
    xb, yb = torch.from_numpy(X).to(dev)[perm], torch.from_numpy(y).to(dev)[perm]
    rs = prng.split(rng)[1]
    cpu_s, moved = [], {}
    for label, bank in (("initial", bank0), ("trained", trained)):
        got = feedback.batch_feedback_delta(c, bank, xb, yb, rs)
        t0 = time.perf_counter()
        want = feedback.batch_feedback_delta(c, bank.cpu(), xb.cpu(), yb.cpu(), rs.cpu())
        cpu_s.append(time.perf_counter() - t0)
        check(torch.equal(got.cpu(), want),
              f"jnp_train: batch_feedback_delta on the {label} bank differs from the "
              f"CPU's by {int((got.cpu() - want).abs().max())}")
        moved[label] = dict(up=int((want > 0).sum()), down=int((want < 0).sum()))
    check(moved["trained"]["up"] > 0, "jnp_train: no automaton rose on the trained "
          "bank: the comparison missed Type I rewards and Type II")
    print(f"jnp_train: batch_feedback_delta at tm-mnist B=64 == the CPU's on the "
          f"initial and the trained bank (automata moved: {moved})")

    # 3. the step's times: train_step against train_step_kernel on the same
    # batch and the trained bank
    def jnp_step():
        return train.train_step(c, tm.TMState(ta_state=trained), xb, yb, rs)

    def kernel_step():
        return train.train_step_kernel(c, tm.TMState(ta_state=trained), xb, yb, 0)
    times = dict(train_step_ms=cuda_time_ms(jnp_step, reps=10),
                 train_step_kernel_ms=cuda_time_ms(kernel_step))
    dev_ms, per = profile_device(jnp_step, calls=3, key="train_step_device_ms")
    kdev_ms, _ = profile_device(kernel_step, key="train_step_kernel_device_ms")
    # threefry's share: the step's threefry2x32 calls, captured with their
    # inputs and replayed alone under the profiler
    plain_threefry, captured = prng.threefry2x32, []

    def capturing(*a):
        captured.append(tuple(t.clone() for t in a))
        return plain_threefry(*a)

    prng.threefry2x32 = capturing
    try:
        jnp_step()
    finally:
        prng.threefry2x32 = plain_threefry
    words = sum(torch.broadcast_tensors(*a)[0].numel() for a in captured)

    def threefry_alone():
        for a in captured:
            plain_threefry(*a)

    tf_ms, _ = profile_device(threefry_alone, calls=3, key="threefry_device_ms")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    step_ms = dev_ms["train_step_device_ms"]
    row = dict(card=card, argv=JNP_ARGV, serve_wall_s=serve_wall_s, serve_ms=serve_ms,
               launches=counts, fit_steps=600 // 64, fit_wall_s=fit_s,
               feedback_delta_cpu_s=cpu_s, **times, **dev_ms, **kdev_ms,
               threefry_calls=len(captured), threefry_words=words, **tf_ms,
               threefry_share=(tf_ms["threefry_device_ms"] / step_ms
                               if step_ms and tf_ms["threefry_device_ms"] else None),
               step_idle_share=1 - step_ms / times["train_step_ms"] if step_ms else None,
               top_us=[dict(name=k, us=u) for k, u in top])
    print("JNP_TRAIN " + json.dumps(row))
    return row


def online_phase(dev) -> dict:
    """MATADOR's online loop on the card: a live tm-mnist bank trained by
    the jax.random trainer (``fit(engine="jnp")``), the OnlineUpdater drill (every step held
    to the plain versions, every candidate to a from-scratch compile, the
    promoted artifact to the oracle), then ``serve_tm --online`` and
    ``serve_tm --zoo``.  Returns the drill's numbers."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.matador_tm import TM_MNIST
    from repro_torch.core import compiler, packetizer, prng, tm, train
    from repro_torch.data.synthetic import make_boolean_classification
    from repro_torch.kernels import fused_infer, fused_train, sparse_infer, term_infer
    from repro_torch.runtime import online
    from repro_torch.runtime.zoo import ArtifactZoo

    mods = {"fused_infer": fused_infer, "fused_train": fused_train,
            "sparse_infer": sparse_infer, "term_infer": term_infer}

    def zero():
        for m in mods.values():
            m.launches = 0

    def counts():
        return {k: m.launches for k, m in mods.items()}

    c = TM_MNIST
    tr = Training(dev)
    print(f"online: drift threshold {ONLINE_DRIFT}, {ONLINE_STEPS} feedback batches "
          f"of 64, live bank {ONLINE_EPOCHS} epoch on {ONLINE_N_TRAIN} samples "
          "(tm-mnist at full width; the cut is depth)")

    # 1. the live bank on the card, booted as serve_tm --online boots it:
    # fit(engine="jnp") from the reference's keys, then compile
    X, y = make_boolean_classification(ONLINE_N_TRAIN, c.n_features, c.n_classes, seed=0)
    zero()
    t0 = time.perf_counter()
    state = tm.init(c, prng.PRNGKey(0), dev)
    init_bank = state.ta_state
    state = train.fit(c, state, torch.from_numpy(X), torch.from_numpy(y),
                      epochs=ONLINE_EPOCHS, batch_size=64, rng=prng.PRNGKey(1))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boot_counts = counts()
    check(state.ta_state.device == dev and not torch.equal(state.ta_state, init_bank),
          "the live bank's boot training did not train on the card")
    boot = compiler.compile_tm(c, state.ta_state)
    boot.schedule()
    print(f"online: live bank trained in {boot_s:.2f} s, launches {boot_counts}; "
          f"U={boot.n_unique} includes={boot.stats.n_includes} "
          f"sharing={boot.stats.partial_term_sharing:.3f}")

    # 2. the drill: immediate swaps through a zoo, batches from the request
    # stream; each candidate is held to a from-scratch compile of its bank
    Xr, yr = make_boolean_classification((ONLINE_STEPS + 8) * 64, c.n_features,
                                         c.n_classes, seed=2)
    nb = online.OnlineUpdater._artifact_nbytes(boot)
    checked, banks = [], []

    def make_obj(cand):
        fresh = compiler.compile_tm(c, upd.bank)
        for f in ("include_words", "word_ids", "votes"):
            check(np.array_equal(getattr(cand, f), getattr(fresh, f)),
                  f"candidate {len(checked)}: {f} != a from-scratch compile_tm")
        check(cand.stats.as_dict() == fresh.stats.as_dict(),
              f"candidate {len(checked)}: stats != a from-scratch compile_tm")
        want = sparse_infer.build_schedule(fresh.include_words)
        got = cand.default_schedule
        for f in ("block_c", "block_j", "n_rows", "n_lit_bits"):
            check(getattr(got, f) == getattr(want, f), f"candidate schedule {f}")
        for f in ("chain_ids", "tile_cb", "tile_jb", "tile_first", "tile_last",
                  "counts", "indptr"):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"candidate {len(checked)}: schedule {f} != build_schedule")
        checked.append(cand)
        banks.append(upd.bank)
        return {"compiled": cand}, online.OnlineUpdater._artifact_nbytes(cand)

    zoo = ArtifactZoo(lambda tenant: ({"compiled": boot}, nb))
    with zoo.lease("t0"):
        pass
    upd = online.OnlineUpdater(
        c, state.ta_state, boot,
        cfg=online.OnlineConfig(drift_threshold=ONLINE_DRIFT, batch_size=64,
                                swap_policy="immediate"),
        zoo=zoo, tenant="t0", make_obj=make_obj,
        deployed_obj={"compiled": boot}, deployed_nbytes=nb)
    drifts, rebuild_ms = [], []
    zero()
    for i in range(ONLINE_STEPS):
        prev, g = upd.bank, upd.gstep
        xb, yb = Xr[i * 64:(i + 1) * 64], yr[i * 64:(i + 1) * 64]
        for j in range(64):
            check(upd.ingest(xb[j], int(yb[j])), "the updater refused clean feedback")
        t0 = time.perf_counter()
        check(upd.step(), "a full feedback batch did not step")
        torch.cuda.synchronize()
        rebuild_ms.append((time.perf_counter() - t0) * 1e3)
        want = tr.plain_step(prev, torch.from_numpy(xb).to(dev),
                             torch.from_numpy(yb).to(dev), g)
        check(torch.equal(upd.bank, want),
              f"online step {g}: the bank differs from the plain versions' step")
        drifts.append(upd.last_drift)
    drill_counts = counts()
    h = upd.health()
    check(h["rebuilds"] >= 1 and h["incremental_rebuilds"] >= 1,
          f"the drill rebuilt {h['rebuilds']} times, {h['incremental_rebuilds']} "
          "incrementally: it needs at least one incremental rebuild")
    check(h["promotions"] >= 1 and h["rebuild_failures"] == 0 and not h["rollbacks"],
          f"the drill promoted nothing or failed: {h}")
    check(len(checked) == h["rebuilds"], "a candidate was not checked")
    check(drill_counts["fused_train"] == ONLINE_STEPS
          and drill_counts["fused_infer"] >= ONLINE_STEPS,
          f"online steps launched {drill_counts}")

    # the promoted artifact through both schedule kernels at the bucket
    dep = upd.deployed
    check(dep is checked[-1] and zoo.version("t0") == h["promotions"] + 1,
          "the zoo does not serve the last promoted candidate")
    xp = packetizer.pack_literals(torch.from_numpy(Xr[:BUCKET]).to(dev))
    oracle = compiler.run_compiled(dep, xp, engine="oracle")
    zero()
    for eng in ("factorized", "sparse"):
        out = compiler.run_compiled(dep, xp, engine=eng)
        torch.cuda.synchronize()
        check(torch.equal(out, oracle),
              f"promoted artifact: run_compiled({eng}) != oracle at B={BUCKET}")
    check(term_infer.launches > 0 and sparse_infer.launches > 0,
          "the promoted artifact was not served through both schedule kernels")
    print(f"online: promoted artifact through term_infer and sparse_infer at "
          f"B={BUCKET} == oracle")

    # one online step on the card, and a rebuild on the host
    xb_t = torch.from_numpy(Xr[:64]).to(dev)
    yb_t = torch.from_numpy(yr[:64]).to(dev)

    def one_step():
        return train.online_step(c, upd.bank, xb_t, yb_t, 0)

    # an updater step that rebuilds nothing: the training step, the drift
    # on the host and the accuracy watch
    upd.cfg.drift_threshold = float("inf")
    plain_ms = []
    for i in range(ONLINE_STEPS, ONLINE_STEPS + 8):
        for j in range(i * 64, (i + 1) * 64):
            upd.ingest(Xr[j], int(yr[j]))
        t0 = time.perf_counter()
        check(upd.step(), "a full feedback batch did not step")
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    step_dev, step_per = profile_device(one_step)
    print(f"online_step device work per call at B=64: {json.dumps(step_per)}")

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    drift_ms = host_ms(lambda: compiler.include_drift(
        upd._anchor, compiler.dense_include_words(c, upd.bank)))
    # each rebuild of the drill again, from the artifact it replaced: the
    # host ms to an artifact with its default chain schedule, through
    # incremental_recompile and through compile_tm + the full schedule
    recompile = {"incremental": [], "full": []}
    for i in range(1, len(checked)):
        t0 = time.perf_counter()
        new, info = compiler.incremental_recompile(c, banks[i], checked[i - 1])
        new.schedule()
        t_inc = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        compiler.compile_tm(c, banks[i]).schedule()
        recompile[info["mode"]].append(
            dict(ms=t_inc, full_ms=(time.perf_counter() - t0) * 1e3,
                 rows_reused=info["rows_reused"]))
    recompile = {mode: dict(n=len(r), ms_median=statistics.median(x["ms"] for x in r),
                            full_ms_median=statistics.median(x["full_ms"] for x in r),
                            rows_reused=[x["rows_reused"] for x in r])
                 for mode, r in recompile.items() if r}
    drill = dict(
        steps=h["steps"], drift_threshold=ONLINE_DRIFT, drifts=drifts,
        rebuilds=h["rebuilds"], incremental_rebuilds=h["incremental_rebuilds"],
        full_rebuilds=h["full_rebuilds"], promotions=h["promotions"],
        rebuild_info=upd.rebuild_info, launches=drill_counts,
        step_event_ms=cuda_time_ms(one_step), **{f"step_{k}": v for k, v in step_dev.items()},
        step_wall_ms_median=statistics.median(plain_ms),
        rebuild_step_wall_ms_median=statistics.median(rebuild_ms),
        drift_host_ms=drift_ms,
        recompile_host_ms=recompile,
        drift_to_promotion_ms=h["drift_to_promotion_ms"],
        boot=dict(wall_s=boot_s, launches=boot_counts, U=boot.n_unique,
                  sharing=boot.stats.partial_term_sharing))
    print("ONLINE_DRILL " + json.dumps(drill))

    # 3. serve_tm --online beside the same requests served without it, and
    # with the updater stepping but never rebuilding (a threshold no drift
    # reaches), in turns after a warm-up: plain, steps only, online, plain
    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", "tm-mnist", "--device", "cuda", "--zoo", "2",
                  "--requests", str(ONLINE_REQUESTS), "--bucket", str(BUCKET)]
        boot_path = boot.save(os.path.join(d, "boot.npz"))
        online_argv = ["--online", "--swap-policy", "immediate", "--epochs",
                       str(ONLINE_EPOCHS), "--n-train", str(ONLINE_N_TRAIN),
                       "--artifact", os.path.join(d, "online.npz")]
        turns = [("warmup", ["--artifact", boot_path]),
                 ("plain", ["--artifact", boot_path]),
                 ("steps_only", online_argv + ["--drift-threshold", "1e9"]),
                 ("online", online_argv + ["--drift-threshold", str(ONLINE_DRIFT)]),
                 ("plain", ["--artifact", boot_path])]
        runs = []
        for label, extra in turns:
            zero()
            sh, sg, oh, _, ms = serve_run(common + extra)
            runs.append(dict(run=label, ms=ms, latency_ms=sg["latency_ms"],
                             launches=counts(), health=sh, gateway=sg, online=oh))
        saved = compiler.CompiledTM.load(os.path.join(d, "online.npz"))
    for r in runs:
        check(r["gateway"]["unaccounted"] == 0 and r["gateway"]["answered"] == ONLINE_REQUESTS,
              f"serve {r['run']}: {r['gateway']['answered']} answered, "
              f"{r['gateway']['unaccounted']} unaccounted")
        check(r["health"]["demotions"] == [] and r["health"]["probe_failures"] == [],
              f"serve {r['run']} demoted: {r['health']['demotions']}")
        check(r["health"]["final_engine"] == runs[0]["health"]["final_engine"],
              f"serve {r['run']} ended on {r['health']['final_engine']}")
    on = runs[3]
    oh = on["online"]
    check(oh["steps"] > 0 and oh["promotions"] >= 1,
          f"serve --online: {oh['steps']} steps, {oh['promotions']} promotions")
    check(runs[2]["online"]["steps"] > 0 and runs[2]["online"]["promotions"] == 0,
          f"serve --online without rebuilds: {runs[2]['online']}")
    check(saved.n_unique > 0, "serve --online saved no artifact")
    kern = {"factorized": "term_infer", "sparse": "sparse_infer"}[on["health"]["final_engine"]]
    check(on["launches"]["fused_train"] > 1 and on["launches"][kern] > 1,
          f"serve --online launched {on['launches']}: fused_train and {kern} must "
          "each launch more than once")
    print("ONLINE_SERVE " + json.dumps(dict(
        requests=ONLINE_REQUESTS, bucket=BUCKET, engine=on["health"]["final_engine"],
        drift_threshold=ONLINE_DRIFT,
        turns=[dict(run=r["run"], ms=r["ms"], inf_per_s=ONLINE_REQUESTS / r["ms"] * 1e3,
                    latency_ms=r["latency_ms"], launches=r["launches"],
                    steps=r["online"]["steps"] if r["online"] else 0,
                    promotions=r["online"]["promotions"] if r["online"] else 0,
                    zoo_swaps=r["gateway"]["zoo"]["swaps"]) for r in runs])))

    # 4. serve_tm --zoo on the committed artifact: the LRU churns
    zh, zg, _, _, z_ms = serve_run(["--arch", "tm-mnist", "--artifact", ASSET,
                                 "--device", "cuda", "--requests", "4096",
                                 "--bucket", str(BUCKET), "--zoo", str(ZOO_TENANTS)])
    check(zg["unaccounted"] == 0 and zg["answered"] == 4096,
          f"serve --zoo: {zg['answered']} answered, {zg['unaccounted']} unaccounted")
    check(zg["zoo"]["evictions"] > 0 and zh["demotions"] == [],
          f"serve --zoo {ZOO_TENANTS}: zoo {zg['zoo']}, demotions {zh['demotions']}")
    print("ZOO_SERVE " + json.dumps(dict(tenants=ZOO_TENANTS, ms=z_ms,
                                         inf_per_s=4096 / z_ms * 1e3, zoo=zg["zoo"])))
    return drill


def bound(n_bytes, t_ops_ms):
    """(bound ms, what bounds it) from bytes moved once and the operations'
    time at their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops_ms), ("bytes" if t_bytes >= t_ops_ms else "operations")


def factorized_work(xw, inc, votes, fsched, ftab) -> tuple:
    """(bytes, integer operations) of the factorized walk over the (B, Wa)
    literal words ``xw``: the words, the votes and the (B, K) sums once,
    the term chains, the clause chain ids the walk reaches (``chain_need``)
    and the tile tables; every term's ANDs a sample word, the walk's ANDs
    and a vote add for each fired clause, class and sample."""
    import torch

    from repro_torch.kernels import ref, sparse_infer

    B = xw.shape[0]
    U, K = votes.shape
    fold_ops = K * sum(int(ref.clause_fire_ref(xw[lo:lo + 4096], inc).sum(dtype=torch.int64))
                       for lo in range(0, B, 4096))
    lit_t = sparse_infer.bit_transpose_literals(xw, xw.shape[1] * 32)
    term_bits = sparse_infer.and_reduce(lit_t[ftab["term_chain"].long()])
    f_bytes, f_ops = chain_need(
        term_bits, ftab["clause_chain"], ftab["tiles"][3], ftab["indptr"],
        n_rows=U, block_c=fsched.block_c, block_j=fsched.block_j,
        tile_off=fsched.n_term_tiles, sentinel=fsched.n_terms)
    stage1_ops = int((ftab["term_chain"] != fsched.n_lit_bits).sum()) * term_bits.shape[1]
    n_clause_tiles = fsched.n_tiles - fsched.n_term_tiles
    return (nbytes(xw, votes) + B * K * 4 + nbytes(ftab["term_chain"]) + f_bytes
            + 2 * n_clause_tiles * 4 + nbytes(ftab["indptr"]),
            stage1_ops + f_ops + fold_ops)


def slab_phase(dev) -> dict:
    """term_infer's slab-resident design (SLAB) at the benchmark's batch on
    both of its artifacts and the port's synthetic datasets of their
    widths: ``factorized_tables_cuda`` held to ``factorized_tables_plain``
    at tolerance 0, in one launch and one ``term_infer.slab`` span a call
    and no kernel but the slab kernel; its device time from the profiler
    (``profile_device``) and its bound (``factorized_work``) -> {config:
    fields}, which the kernels line's term_infer row holds as ``slab``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.core import compiler, packetizer
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import term_infer

    out = {}
    for cfg, (data, path) in SLAB_ASSETS.items():
        comp = compiler.CompiledTM.load(os.path.join(ROOT, path))
        tabs, fsched = comp.tensors(dev), comp.default_factorized_schedule
        ftab = fsched.tensors(dev)
        X, _, _, _ = paper_dataset(data, n_train=SLAB_BATCH, n_test=0, seed=3)
        xw = packetizer.pack_literals(torch.from_numpy(X).to(dev))[:, tabs["word_ids"]]
        xw = xw.contiguous()
        votes, inc = tabs["votes"], tabs["include_words"]
        args = (xw, ftab["term_chain"], ftab["clause_chain"], votes, ftab["tiles"],
                ftab["indptr"])
        kw = dict(block_c=fsched.block_c, block_j=fsched.block_j,
                  n_term_tiles=fsched.n_term_tiles)
        want = term_infer.factorized_tables_plain(*args, **kw)
        term_infer.factorized_tables_cuda(*args, **kw)           # the derived tables
        torch.cuda.synchronize()
        n0 = term_infer.launches
        spans.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            got = term_infer.factorized_tables_cuda(*args, **kw)
            torch.cuda.synchronize()
        n_launches = term_infer.launches - n0
        n_slab = spans.totals().get(term_infer.SLAB_RANGE, (0, 0))[0]
        check(n_launches == 1 and n_slab == 1,
              f"{cfg} B={SLAB_BATCH}: {n_launches} term_infer launches, {n_slab} "
              f"{term_infer.SLAB_RANGE} spans, expected 1 and 1")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{cfg} B={SLAB_BATCH}: the slab design differs from "
              f"factorized_tables_plain by {err}")
        dev_ms, per = profile_device(lambda: term_infer.factorized_tables_cuda(*args, **kw))
        check(len(per) == 1 and "slab_term_eval_kernel" in next(iter(per)),
              f"{cfg} B={SLAB_BATCH}: the call launched {sorted(per)}, expected only "
              "the slab kernel")
        sms, shared = term_infer._limits(dev)
        U, K = votes.shape
        n_planes = term_infer.vote_planes(votes)[1]
        row = dict(B=SLAB_BATCH, slab_words=term_infer.slab_words_for(
                       SLAB_BATCH, xw.shape[1], ftab["term_chain"].shape[0], K, U,
                       fsched.n_cblocks, n_planes, tile_margin=None, block_s=None,
                       sm_count=sms, shared_bytes=shared),
                   launches=n_launches, slab_spans=n_slab, max_abs_err=err, tolerance=0,
                   ms=cuda_time_ms(lambda: term_infer.factorized_tables_cuda(*args, **kw)),
                   **dev_ms)
        nb, ops = factorized_work(xw, inc, votes, fsched, ftab)
        row["bound_ms"], row["bound_by"] = bound(nb, ops / INT32_OPS_PER_S * 1e3)
        out[cfg] = row
    print("SLAB " + json.dumps(out))
    return out


def bnn_phase(dev) -> dict:
    """The BNN baseline: train 784-256-256-256-10 one epoch, pack, predict
    10,000 samples through xnor_popcount; the kernel's tensor-core
    instructions in its SASS; the kernel against its plain version on every
    layer's inputs; times at every layer's shape, the first layer's for the
    kernels line."""
    import torch

    from repro_torch.baselines import bnn
    from repro_torch.core import packetizer
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import xnor_popcount as xp

    # the one-bit products run on the tensor cores: BMMA in the SASS
    mma = sass_mma(_build._lib_path("xnor_popcount"), ("BMMA", "IMMA"))
    check(mma and all(n > 0 for n in mma.values()),
          f"an xnor_popcount kernel has no tensor-core MMA in its SASS: {mma}")
    print("xnor_popcount SASS tensor-core MMA (BMMA, IMMA) instructions: " + json.dumps(mma))

    X, y, Xte, yte = paper_dataset("mnist", n_train=4000, n_test=BNN_TEST)
    # one epoch at the default rate (1e-3) leaves the net near chance
    cfg = bnn.BNNConfig(layer_sizes=BNN_SIZES, lr=BNN_LR)
    t0 = time.perf_counter()
    params = bnn.bnn_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = bnn.bnn_train(cfg, params, X, y, epochs=1, batch_size=50)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    packed = bnn.bnn_pack(params)
    x = torch.from_numpy(Xte).to(dev)
    bnn.bnn_predict(packed, x)                        # warm-up
    torch.cuda.synchronize()
    xp.launches = 0
    t0 = time.perf_counter()
    pred = bnn.bnn_predict(packed, x)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    launches = xp.launches
    check(launches == len(packed), f"bnn_predict launched xnor_popcount {launches} "
          f"times for {len(packed)} layers")
    check(pred.shape == (BNN_TEST,) and int(pred.min()) >= 0 and int(pred.max()) < 10,
          f"bnn_predict output {tuple(pred.shape)}")
    with torch.no_grad():
        pred_float = bnn._forward_float(params, x).argmax(-1)
    agree = float((pred == pred_float).float().mean())
    check(agree >= 0.99, f"packed predictions agree with the float network on "
          f"{agree:.4f} < 0.99 (the reference's bar, tests/test_bnn.py)")
    acc = float((pred.cpu() == torch.from_numpy(yte)).float().mean())
    print(f"bnn: 784-256-256-256-10 trained 1 epoch at batch 50, lr {BNN_LR}, in "
          f"{train_s:.2f} s; "
          f"bnn_predict on {BNN_TEST} samples in {predict_ms:.2f} ms, launches "
          f"{launches}; test_acc={acc:.4f} (information, not a gate); agreement "
          f"with the float network {agree:.4f}")

    # every layer's real inputs, and a ragged width
    max_err, shapes = 0, []
    a = x.to(torch.uint8)
    layers = []
    for i, (w, n_bits) in enumerate(packed):
        aw = packetizer.pack_bits(a)
        layers.append((aw, w, n_bits))
        dots = xp.xnor_popcount_plain(aw, w, n_bits)
        a = (dots >= 0).to(torch.uint8)
    rng = torch.Generator(device=dev).manual_seed(5)
    rag = [packetizer.pack_bits(torch.randint(0, 2, (n, 150), generator=rng, device=dev))
           for n in (777, 33)]
    for aw, w, n_bits in layers + [(rag[0], rag[1], 150)]:
        got, want = xp.xnor_popcount_cuda(aw, w, n_bits), xp.xnor_popcount_plain(aw, w, n_bits)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        shapes.append(f"B={aw.shape[0]} W={aw.shape[1]} O={w.shape[0]} n_bits={n_bits}")
        check(err == 0, f"xnor_popcount {shapes[-1]}: kernel differs from its plain "
              f"version by {err}")
    print("xnor_popcount == plain version at " + "; ".join(shapes))

    per_layer = []
    for aw, w, n_bits in layers:
        run = lambda aw=aw, w=w, n_bits=n_bits: xp.xnor_popcount_cuda(aw, w, n_bits)
        per_layer.append(dict(W=aw.shape[1], O=w.shape[0], ms=cuda_time_ms(run),
                              **profile_device(run)[0]))
    print("BNN_OCCUPANCY " + json.dumps([dict(B=aw.shape[0], W=aw.shape[1], O=w.shape[0],
                                              **xp.occupancy(aw.shape[0], w.shape[0],
                                                             aw.shape[1]))
                                         for aw, w, _ in layers]))
    aw, w, n_bits = layers[0]
    B, W = aw.shape
    O = w.shape[0]
    kern = lambda: xp.xnor_popcount_cuda(aw, w, n_bits)
    plain = lambda: xp.xnor_popcount_plain(aw, w, n_bits)
    # yardsticks, timed only: one float32 product of the +-1 matrices, and
    # torch._int_mm of them as int8; the row's library_ms is the faster
    pm_a = 2.0 * x.to(torch.float32) - 1.0
    pm_w = torch.sign(torch.where(params[0] == 0, 1.0, params[0]))
    i8_a, i8_w = pm_a.to(torch.int8), pm_w.to(torch.int8)
    lib = {}
    for name, call in (("float32 torch.matmul", lambda: torch.matmul(pm_a, pm_w)),
                       ("int8 torch._int_mm", lambda: torch._int_mm(i8_a, i8_w))):
        try:
            same = torch.equal(call().to(torch.int32), kern())
        except RuntimeError as e:   # a yardstick only: note it and go on
            lib[name] = dict(error=str(e)[:200])
            continue
        check(same, f"{name} of the +-1 matrices != xnor_popcount")
        lib[name] = dict(ms=cuda_time_ms(call), **profile_device(call)[0])
    timed = [k for k in lib if lib[k].get("device_ms") is not None]
    check(timed, f"no library yardstick timed: {lib}")
    fast = min(timed, key=lambda k: lib[k]["device_ms"])
    row = dict(ms=cuda_time_ms(kern), plain_ms=cuda_time_ms(plain, reps=5),
               library_ms=lib[fast]["ms"], library_device_ms=lib[fast]["device_ms"],
               library_device_ms_spread=lib[fast]["device_ms_spread"], library_call=fast,
               library_calls=lib)
    dev_ms, per = profile_device(kern)
    row.update(dev_ms)
    print(f"xnor_popcount device work per call at B={B} W={W} O={O}: {json.dumps(per)}")
    # bound: the bytes (packed inputs read once, int32 output written once)
    # against the B x O x n_bits one-bit products at the int8 tensor-core rate;
    # the population-count floor (B x O x W words on the CUDA cores) as information
    row["bound_ms"], row["bound_by"] = bound(nbytes(aw, w) + B * O * 4,
                                             2 * B * O * n_bits / INT8_OPS_PER_S * 1e3)
    row["popc_floor_ms"] = B * O * W / POPC_OPS_PER_S * 1e3
    print("BNN_TIMES " + json.dumps(dict(row, shape=dict(B=B, W=W, O=O, n_bits=n_bits),
                                         per_layer=per_layer, predict_ms=predict_ms,
                                         train_s=train_s)))
    return dict(row, launches=launches, max_abs_err=max_err, tolerance=0)


def flash_tolerance(v, want) -> float:
    """bf16: the kernel and the plain version round the unnormalized
    probabilities to bf16 against different running maxima (each rounding
    <= 2^-8 relative, so a row's weights differ by <= 2^-7 of its sum,
    times at most max|v|), and round the output to bf16 (one unit in the
    last place <= 2^-7 x |out|)."""
    return 2 ** -7 * (float(v.abs().max()) + float(want.abs().max()))


def flash_elem_tolerance(fa, q, k, v, want):
    """bf16, per output element: the output's bf16 rounding on both sides
    (<= 2^-7 x |out| together) and p's (each <= 2^-8 relative, so <= 2^-7 of
    the p-weighted mean of |v|: the plain version's attention over |v| in
    float32), with 2^-6 of that for the float32 sums and ex2.approx."""
    w = fa.flash_forward_plain(q.float(), k.float(), v.float().abs())
    return 2 ** -7 * (1 + 2 ** -6) * (want.float().abs() + w)


def flash_errors(fa, q, k, v) -> dict:
    """The bf16 kernel against its plain version: the largest error, the
    tolerance ``flash_tolerance`` states, and the largest share of its
    per-element tolerance (``flash_elem_tolerance``) an element uses."""
    import torch

    got, want = fa.flash_forward_cuda(q, k, v).float(), fa.flash_forward_plain(q, k, v).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    share = diff / flash_elem_tolerance(fa, q, k, v, want).clamp(min=1e-30)
    return dict(max_abs_err=float(diff.max()), tolerance=flash_tolerance(v.float(), want),
                max_elem_tolerance_share=float(share.max()))


def flash_times(fa, q, k, v):
    """The bf16 kernel on causal self-attention q, k, v: event and device
    ms, FLOPs and bound, ``scaled_dot_product_attention``'s event and device
    ms; and each one's device work per call by name."""
    import torch

    kern = lambda: fa.flash_forward_cuda(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    row, per = dict(ms=cuda_time_ms(kern), library_ms=cuda_time_ms(library)), {}
    dev_ms, per["kernel"] = profile_device(kern)
    lib_ms, per["library"] = profile_device(library, key="library_device_ms")
    row.update(dev_ms, **lib_ms)
    B, S, H, hd = q.shape
    # QK^T and PV over the S(S+1)/2 causal (query, key) pairs, 2 FLOPs each
    row["flops"] = 4 * B * H * hd * S * (S + 1) // 2
    # q, k, v read once, the output (q's size) written once
    row["bound_ms"], row["bound_by"] = bound(nbytes(q, k, v) + nbytes(q),
                                             row["flops"] / BF16_FLOPS_PER_S * 1e3)
    return row, per


def flash_bf16_row(fa, dev, *, B, S, H, KH, hd) -> dict:
    """The bf16 kernel at one causal self-attention shape on normal inputs
    from seed 0: ``flash_errors`` and ``flash_times``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev).to(torch.bfloat16)
               for h in (H, KH, KH))
    return dict(shape=dict(B=B, S=S, H=H, KH=KH, hd=hd), **flash_errors(fa, q, k, v),
                **flash_times(fa, q, k, v)[0])


def split_device_time(us) -> dict:
    """Device microseconds by kind: the flash kernels (``flash_fwd_wgmma_kernel``
    for bf16, ``flash_fwd_simt_kernel`` for float32), GEMMs, the rest."""
    import re

    out = dict(flash=0.0, gemm=0.0, rest=0.0)
    for name, (u, _) in us.items():
        if "flash_fwd_" in name:
            out["flash"] += u
        elif re.search(GEMM_RE, name, re.I):
            out["gemm"] += u
        else:
            out["rest"] += u
    return out


def sass_mma(lib, kinds=("HGMMA", "HMMA")) -> dict:
    """{kernel function: tensor-core MMA instructions of ``kinds`` (HGMMA,
    Hopper's warpgroup MMA, and HMMA by default; BMMA and IMMA are the
    one-bit and integer forms)} in the SASS of a built library, from
    ``cuobjdump -sass``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    check(tool is not None, f"cuobjdump not found: cannot read the SASS of {lib}")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump -sass {lib} failed: {res.stderr[-2000:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and any(k in line for k in kinds):
            counts[fn] += 1
    return counts


def lm_phase(dev) -> dict:
    """serve_lm on tinyllama-1.1b at full width: the kernel route (counts
    zeroed around it), the plain route, a warm kernel run for the times;
    the kernel against its plain version on layer 0's real prefill inputs
    (bf16) and in float32; a profile of prefill and decode."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import attention, layers, steps, transformer

    # the bf16 kernel runs on the tensor cores: its SASS holds HGMMA
    mma = {fn: n for fn, n in sass_mma(_build._lib_path("flash_attention")).items()
           if "flash_fwd" in fn}
    tc_fns = [fn for fn in mma if "wgmma_kernel" in fn]
    check(tc_fns and all(mma[fn] > 0 for fn in tc_fns),
          f"flash_fwd_wgmma_kernel has no tensor-core MMA in its SASS: {mma}")
    print("flash_attention SASS tensor-core MMA (HGMMA, HMMA) instructions: "
          + json.dumps(mma))

    args = serve.build_parser().parse_args(LM_ARGV)
    cfg = get_config(args.arch)
    fa.launches = fa.launches_wgmma = fa.launches_simt = 0
    res = serve.serve_lm(args)
    launches, launches_wgmma, launches_simt = fa.launches, fa.launches_wgmma, fa.launches_simt
    res.pop("model")
    check(launches == cfg.n_layers == res["flash_launches"],
          f"the prefill launched the flash kernel {launches} times for "
          f"{cfg.n_layers} layers")
    check(launches_wgmma == launches and launches_simt == 0,
          f"the bf16 prefill launched the tensor-core kernel {launches_wgmma} times "
          f"and the CUDA-core kernel {launches_simt} times, of {launches}")
    print(f"flash launches in the prefill: {launches_wgmma} tensor-core (bf16), "
          f"{launches_simt} CUDA-core (float32)")
    B, P = args.batch_size, args.seq_len // 2
    logits, toks = res["prefill_logits"], res["tokens"]
    check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    check(toks.shape == (B, args.new_tokens + 1), f"tokens {tuple(toks.shape)}")

    # the plain route: the same serve with the kernel's plain version in place
    kernel_fn = fa.flash_forward
    fa.flash_forward = fa.flash_forward_plain
    try:
        plain = serve.serve_lm(args)
    finally:
        fa.flash_forward = kernel_fn
    plain.pop("model")
    check(fa.launches == launches, "the plain route launched the flash kernel")
    diff = float((logits - plain["prefill_logits"]).abs().max())
    same_first = float((toks[:, 0] == plain["tokens"][:, 0]).float().mean())
    same = float((toks[:, 1:] == plain["tokens"][:, 1:]).float().mean())
    warm = serve.serve_lm(args)
    warm.pop("model")
    print("LM_ROUTES " + json.dumps(dict(
        prefill_logits_max_abs_diff=diff, logits_max_abs=float(logits.abs().max()),
        equal_first_token_share=same_first, equal_decode_token_share=same)))

    # layer 0's real prefill inputs (the same seed and device as serve_lm)
    model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
    tokens = torch.from_numpy(prompts).to(dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None].expand(B, P)
    blk = model.blocks[0]
    with torch.no_grad():
        h = layers.rms_norm(model.embed[tokens], blk.norm1, cfg.norm_eps)
        q, k, v = attention._project_qkv(cfg, blk.mix, h, positions)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    errs = flash_errors(fa, q, k, v)
    err, tol, share = errs["max_abs_err"], errs["tolerance"], errs["max_elem_tolerance_share"]
    check(err <= tol and share <= 1, f"flash_attention bf16 q {tuple(q.shape)}: kernel "
          f"differs from its plain version by {err} (tolerance {tol}); largest share of "
          f"the per-element tolerance {share}")
    f32 = [t.float() for t in (q, k, v)]
    err32 = float((fa.flash_forward_cuda(*f32) - fa.flash_forward_plain(*f32)).abs().max())
    check(err32 <= FLASH_F32_ATOL, f"flash_attention float32: kernel differs from its "
          f"plain version by {err32} > {FLASH_F32_ATOL}")
    print(f"flash_attention == plain version on layer 0's prefill inputs: q "
          f"{tuple(q.shape)} k {tuple(k.shape)} bf16 max_abs_err {err} (tolerance "
          f"{tol}; largest share of the per-element tolerance {share}); float32 "
          f"{err32} (tolerance {FLASH_F32_ATOL})")

    # the bf16 kernel at hd 128 (qwen3-32b's attention), beside the library
    hd128 = flash_bf16_row(fa, dev, **FLASH_HD128)
    check(hd128["max_abs_err"] <= hd128["tolerance"] and hd128["max_elem_tolerance_share"] <= 1,
          f"flash_attention bf16 at hd 128: kernel differs from its plain version: {hd128}")
    print("FLASH_HD128 " + json.dumps(hd128))

    row, per = flash_times(fa, q, k, v)
    row["plain_ms"] = cuda_time_ms(lambda: fa.flash_forward_plain(q, k, v), reps=3, warmup=1)
    print(f"scaled_dot_product_attention device work per call: {json.dumps(per['library'])}")
    print(f"flash_attention device work per call: {json.dumps(per['kernel'])}")

    # where prefill and decode time goes (warm): the steps under the profiler
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    caches = model.init_caches(B, args.seq_len)
    prof_rows = {}
    for label in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "prefill":
                out, caches = prefill(model, {"tokens": tokens}, caches)
                n = 1
            else:
                tok = out.argmax(-1)[:, None]
                n = 16
                for i in range(n):
                    out, caches = decode(model, caches, {"tokens": tok}, P + i)
                    tok = out.argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        us = device_us(prof)
        busy_s = sum(u for u, _ in us.values()) / 1e6
        top = sorted(us.items(), key=lambda kv: -kv[1][0])[:8]
        prof_rows[label] = dict(
            steps=n, wall_ms=wall_s * 1e3, device_busy_ms=busy_s * 1e3,
            device_launches=sum(c for _, c in us.values()),
            idle_share=1 - busy_s / wall_s if us else None,
            split_ms={kk: u / 1e3 for kk, u in split_device_time(us).items()},
            top=[dict(name=kk[:60], us=u, count=c) for kk, (u, c) in top])
        print(f"LM_PROFILE_{label.upper()} " + json.dumps(prof_rows[label]))
    print("LM_TIMES " + json.dumps(dict(
        row, shape=dict(q=list(q.shape), k=list(k.shape)),
        serve_prefill_ms=[r["prefill_s"] * 1e3 for r in (res, plain, warm)],
        serve_decode_ms_per_step=[r["decode_s"] / args.new_tokens * 1e3
                                  for r in (res, plain, warm)],
        runs="kernel route (main path), plain route, kernel route (warm)",
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)))
    return dict(row, launches=launches, launches_wgmma=launches_wgmma,
                sass_tensor_mma=sum(mma[fn] for fn in tc_fns), max_abs_err=err,
                tolerance=tol, max_elem_tolerance_share=share, f32_max_abs_err=err32,
                f32_tolerance=FLASH_F32_ATOL)


@contextlib.contextmanager
def plain_flash(fa):
    """The flash kernel's plain version in its place (serving and the
    training VJP's forward both call ``fa.flash_forward``)."""
    kernel_fn = fa.flash_forward
    fa.flash_forward = fa.flash_forward_plain
    try:
        yield
    finally:
        fa.flash_forward = kernel_fn


def route_step(cfg, dev, batch):
    """One training step of a fresh model (seed 0) on ``batch``: the loss,
    each gradient leaf's norm and the global norm after AdamW's clip; run
    once through the kernel route and once under ``plain_flash``."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.optim import adamw

    m = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = list(m.parameters())
    loss = transformer.loss_fn(cfg, m, batch)
    grads = torch.autograd.grad(loss, params)
    _, info = adamw.adamw_update(adamw.AdamWConfig(), grads, params, adamw.adamw_init(params))
    return float(loss), [float(g.float().norm()) for g in grads], float(info["grad_norm"])


def device_split(prof, ranges: dict) -> dict:
    """A profile's device time (ms) by part, from its device events: the
    flash forward kernel, each part of ``ranges`` (profiler range name ->
    part: the kernels and copies inside the range's span on the device
    timeline, its user annotation), the other GEMMs, the rest; the
    launches; and ``busy``, the union of the kernels' and copies'
    intervals.  It reads the profiler's raw events: the CPU events'
    ``kernels`` lists attach some kernels to two CPU events at thousands of
    launches, and building those events for an xlstm-1.3b prefill's
    154,000 launches is slow."""
    import bisect

    marks, work = [], []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            t = (ev.start_ns() / 1e3, ev.end_ns() / 1e3)
            if not ev.is_user_annotation():
                work.append((*t, ev.name()))
            elif ev.name() in ranges:
                marks.append((*t, ranges[ev.name()]))
    marks.sort()
    starts = [m[0] for m in marks]
    us = dict.fromkeys(("flash_forward", *ranges.values(), "gemm", "rest"), 0.0)
    busy, end = 0.0, float("-inf")
    for t0, t1, name in sorted(work):
        i = bisect.bisect_right(starts, t0) - 1
        part = marks[i][2] if i >= 0 and t1 <= marks[i][1] else None
        if "flash_fwd_" in name:
            us["flash_forward"] += t1 - t0
        elif part:
            us[part] += t1 - t0
        elif re.search(GEMM_RE, name, re.I):
            us["gemm"] += t1 - t0
        else:
            us["rest"] += t1 - t0
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return dict({k: u / 1e3 for k, u in us.items()}, launches=len(work), busy=busy / 1e3)


def lm_train_phase(dev, card: str) -> dict:
    """LM_TRAIN: the flash kernel's lse variant against its plain version
    on layer 0's training inputs; one bf16 smoke step through the kernel
    and the plain route; ``train_lm`` on tinyllama-1.1b at full width
    (counts zeroed around it; 2 x 22 wgmma launches a step), its step 1
    against the plain route's, a profiled step's device split; pixtral-12b
    and musicgen-large at full width, 2 layers.  Returns the flash row's
    ``train_*`` fields."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import attention, layers, steps, transformer
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    args = train.build_parser().parse_args(LM_TRAIN_ARGV)
    cfg = get_config(args.arch)
    B, S, L = args.batch_size, args.seq_len, cfg.n_layers

    # 1. layer 0's inputs in train_lm's first step (its weights, its batch)
    model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    batch = train.lm_batch(cfg, np.random.default_rng(args.seed), B, S)
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    with torch.no_grad():
        blk = model.blocks[0]
        h = layers.rms_norm(model.embed[tokens], blk.norm1, cfg.norm_eps)
        q, k, v = (t.contiguous() for t in attention._project_qkv(cfg, blk.mix, h, positions))
    del model, h
    out, lse = fa.flash_forward_cuda(q, k, v, return_lse=True)
    serve_out = fa.flash_forward_cuda(q, k, v)
    want, want_lse = fa.flash_forward_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err, tol = float(diff.max()), flash_tolerance(v.float(), want.float())
    share = float((diff / flash_elem_tolerance(fa, q, k, v, want.float()).clamp(min=1e-30)).max())
    lse_err = float((lse - want_lse).abs().max())
    check(err <= tol and share <= 1, f"flash lse variant bf16 q {tuple(q.shape)}: out differs "
          f"from the plain version by {err} (tolerance {tol}), element share {share}")
    check(lse_err <= LSE_BF16_ATOL, f"flash lse differs from the plain version's by {lse_err} "
          f"> {LSE_BF16_ATOL}")
    check(torch.equal(out, serve_out), "the lse pointer changed the kernel's output")
    row = dict(train_shape=dict(q=list(q.shape), k=list(k.shape)), train_max_abs_err=err,
               train_tolerance=tol, train_max_elem_tolerance_share=share,
               train_lse_max_abs_err=lse_err, train_lse_tolerance=LSE_BF16_ATOL)
    row.update(profile_device(lambda: fa.flash_forward_cuda(q, k, v, return_lse=True),
                              key="train_lse_device_ms")[0])
    row.update(profile_device(lambda: fa.flash_forward_cuda(q, k, v),
                              key="train_serve_variant_device_ms")[0])
    flops = 4 * B * cfg.n_heads * q.shape[-1] * S * (S + 1) // 2
    # q, k, v read once; out and lse written once
    row["train_bound_ms"], row["train_bound_by"] = bound(
        nbytes(q, k, v) + nbytes(q) + nbytes(lse), flops / BF16_FLOPS_PER_S * 1e3)
    print(f"flash_attention lse variant == plain version on layer 0's training inputs: q "
          f"{tuple(q.shape)} out max_abs_err {err} (tolerance {tol}; element share "
          f"{share}); lse {lse_err} (tolerance {LSE_BF16_ATOL}); output equal to the "
          "launch without lse")
    del q, k, v, out, lse, serve_out, want, want_lse, diff

    # 2. one bf16 smoke step through the kernel route and the plain route
    scfg = dataclasses.replace(get_smoke_config(args.arch), dtype="bfloat16")
    sbatch = {kk: torch.from_numpy(a).to(dev)
              for kk, a in train.lm_batch(scfg, np.random.default_rng(0), 4, 256).items()}

    n0 = fa.launches_wgmma
    k_loss, k_norms, k_gn = route_step(scfg, dev, sbatch)
    smoke_launches = fa.launches_wgmma - n0
    n0 = fa.launches
    with plain_flash(fa):
        p_loss, p_norms, p_gn = route_step(scfg, dev, sbatch)
    check(fa.launches == n0, "the plain route launched the flash kernel")
    leaf_rel = max(abs(a - b) / max(b, 1e-30) for a, b in zip(k_norms, p_norms))
    route = dict(smoke=scfg.name, dtype="bfloat16", batch=[4, 256],
                 wgmma_launches=smoke_launches, loss=[k_loss, p_loss],
                 loss_rtol=LM_TRAIN_LOSS_RTOL, grad_norm=[k_gn, p_gn],
                 leaf_norm_max_rel_diff=leaf_rel, grad_rtol=LM_ROUTE_GRAD_RTOL)
    check(smoke_launches == 2 * scfg.n_layers, f"the smoke step launched the bf16 flash "
          f"kernel {smoke_launches} times for {scfg.n_layers} layers")
    check(abs(k_loss - p_loss) <= LM_TRAIN_LOSS_RTOL * abs(p_loss)
          and abs(k_gn - p_gn) <= LM_ROUTE_GRAD_RTOL * p_gn and leaf_rel <= LM_ROUTE_GRAD_RTOL,
          f"kernel and plain routes of a bf16 smoke step disagree: {route}")

    # 3. the slice at full width through train_lm, counts zeroed around it
    fa.launches = fa.launches_wgmma = fa.launches_simt = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.train_lm(args)
    train_s = time.perf_counter() - t0
    launches, launches_wgmma, launches_simt = fa.launches, fa.launches_wgmma, fa.launches_simt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res["flash_launches"] == [2 * L] * args.steps,
          f"train_lm launched the flash kernel {res['flash_launches']} times a step for "
          f"{L} layers (forward and remat recompute: {2 * L})")
    check(launches == launches_wgmma == 2 * L * args.steps and launches_simt == 0,
          f"train_lm's flash launches: {launches} ({launches_wgmma} tensor-core, "
          f"{launches_simt} CUDA-core)")
    check(all(np.isfinite(res["losses"])) and all(np.isfinite(res["grad_norms"])),
          f"train_lm losses {res['losses']}, grad norms {res['grad_norms']}")
    step_ms = statistics.median(res["step_event_ms"][1:])

    # a profiled step on the trained model, a fresh batch
    model, opt = res.pop("model"), res.pop("opt_state")
    step_fn = steps.make_train_step(cfg)
    pb = {kk: torch.from_numpy(a).to(dev)
          for kk, a in train.lm_batch(cfg, np.random.default_rng(1), B, S).items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, info = step_fn(model, opt, pb)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(info["loss"])), "the profiled step's loss is not finite")
    del model, opt, info, pb
    split = device_split(prof, {attention.BACKWARD_RANGE: "flash_backward",
                                adamw.UPDATE_RANGE: "optimizer"})
    check(split["flash_backward"] > 0 and split["optimizer"] > 0,
          f"the profiled step's device split found no work under a range: {split}")
    busy_ms = sum(split[kk] for kk in ("flash_forward", "flash_backward", "optimizer",
                                       "gemm", "rest"))
    split_rows = dict(wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
                      idle_share=1 - busy_ms / prof_wall_ms if busy_ms else None,
                      split_ms=split)

    # step 1 through the plain route, the same weights and batch
    pargs = train.build_parser().parse_args(LM_TRAIN_ARGV + ["--steps", "1"])
    n0 = fa.launches
    with plain_flash(fa):
        plain = train.train_lm(pargs)
    check(fa.launches == n0, "the plain route launched the flash kernel")
    plain.pop("model"), plain.pop("opt_state")
    check(abs(res["losses"][0] - plain["losses"][0]) <= LM_TRAIN_LOSS_RTOL * abs(plain["losses"][0]),
          f"train_lm step 1 loss {res['losses'][0]} against the plain route's "
          f"{plain['losses'][0]} (rtol {LM_TRAIN_LOSS_RTOL})")

    # 4. the stub frontend and the codebook heads at full width, depth cut
    cut = {}
    for arch in LM_TRAIN_CUT_ARCHS:
        ccfg = dataclasses.replace(get_config(arch), n_layers=LM_TRAIN_CUT_LAYERS)
        cargs = train.build_parser().parse_args(["--arch", arch, *LM_TRAIN_CUT_ARGV])
        n0, w0 = fa.launches, fa.launches_wgmma
        torch.cuda.reset_peak_memory_stats()
        r = train.train_lm(cargs, cfg=ccfg)
        r.pop("model"), r.pop("opt_state")
        n = 2 * ccfg.n_layers
        check(r["flash_launches"] == [n] * cargs.steps
              and fa.launches - n0 == fa.launches_wgmma - w0 == n * cargs.steps,
              f"{arch}: flash launches {r['flash_launches']} a step, expected {n}")
        check(all(np.isfinite(r["losses"])), f"{arch}: losses {r['losses']}")
        cut[arch] = dict(n_layers=ccfg.n_layers, frontend=ccfg.frontend,
                         n_codebooks=ccfg.n_codebooks, batch=[cargs.batch_size, cargs.seq_len],
                         losses=r["losses"], grad_norms=r["grad_norms"],
                         step_event_ms=r["step_event_ms"], flash_launches_per_step=n,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    print("LM_TRAIN " + json.dumps(dict(
        card=card, arch=cfg.name, n_layers=L, batch=[B, S], steps=args.steps,
        losses=res["losses"], grad_norms=res["grad_norms"], lrs=res["lrs"],
        step_event_ms=res["step_event_ms"], step_wall_s=res["step_s"],
        step_ms_median_2_to_5=step_ms, tokens_per_s=B * S / (step_ms / 1e3),
        peak_memory_gb=peak_gb, flash_launches_per_step=2 * L, wgmma_launches=launches_wgmma,
        plain_route_step1_loss=plain["losses"][0], loss_rtol=LM_TRAIN_LOSS_RTOL,
        route_check=route, profiled_step=split_rows, train_lm_s=train_s, cut=cut,
        phase_s=time.perf_counter() - t_phase)))
    row["train_launches_per_step"] = 2 * L
    row["train_step_ms"] = step_ms
    return row


def family_split(model, cfg, tokens, s_max: int, n_new: int, mesh=None) -> dict:
    """Where a warm prefill and ``n_new`` decode steps (on ``mesh`` when
    given) spend their time,
    each under the profiler: its event ms, the device's busy ms (the union
    of its device intervals) and idle share, and the device ms by part (``device_split`` over the layers'
    ranges: attention, the RG-LRU scan, the mLSTM core, the sLSTM steps,
    MoE routing and experts; the rest: projections, norms, MLPs, glue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import attention, moe, rglru, steps, xlstm

    ranges = {attention.ATTEND_RANGE: "attention", rglru.SCAN_RANGE: "rglru_scan",
              xlstm.MLSTM_RANGE: "mlstm_core", xlstm.SLSTM_RANGE: "slstm_steps",
              moe.ROUTE_RANGE: "moe_route", moe.EXPERTS_RANGE: "moe_experts"}
    prefill, decode = steps.make_prefill_step(cfg, mesh), steps.make_decode_step(cfg, mesh)
    B, P = tokens.shape
    caches = model.init_caches(B, s_max)
    rows = {}
    for label in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            if label == "prefill":
                logits, caches = prefill(model, {"tokens": tokens}, caches)
                n = 1
            else:
                n = n_new
                for i in range(n):
                    logits, caches = decode(model, caches, {"tokens": tok}, P + i)
                    tok = logits.argmax(-1)[:, None]
            t1.record()
            torch.cuda.synchronize()
        tok = logits.argmax(-1)[:, None]
        total = t0.elapsed_time(t1) / n
        split = device_split(prof, ranges)
        parts = {k: v / n for k, v in split.items() if k not in ("launches", "busy")}
        busy = split["busy"] / n
        rows[label] = dict(ms=total, device_busy_ms=busy, idle_share=1 - busy / total,
                           device_ms=parts, parts_sum_ms=sum(parts.values()),
                           launches=split["launches"] / n)
    return rows


def family_flash_checks(fa, model, cfg, tokens, prefix: str) -> dict:
    """The flash kernel on layer 0's prefill inputs of a global-attention
    family at its serve shape (bf16; MLA's q and k at qk width 192 over v
    width 128, or grouped-query q, k, v): against its plain version with
    and without lse, the float32 variant on the same inputs, the times, the
    bound and SDPA's time on the same q, k, v.  -> the flash row's fields,
    each named with ``prefix``."""
    import torch

    from repro_torch.models import attention, layers, mla

    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    blk = model.blocks[0]
    with torch.no_grad():
        h = layers.rms_norm(model.embed[tokens], blk.norm1, cfg.norm_eps)
        if cfg.attn_kind == "mla":
            q_nope, q_rope, c_kv, k_rope = mla._mla_qkv(cfg, blk.mix, h, positions)
            q = torch.cat([q_nope, q_rope], dim=-1)
            k, v = mla._expand_kv(blk.mix, c_kv, k_rope)
            del q_nope, q_rope, c_kv, k_rope
        else:
            q, k, v = attention._project_qkv(cfg, blk.mix, h, positions)
        q, k, v = (t.contiguous() for t in (q, k, v))
    del h
    what = f"flash at {cfg.name}'s layer-0 prefill, bf16 q {tuple(q.shape)} k {tuple(k.shape)} " \
           f"v {tuple(v.shape)}"
    errs = flash_errors(fa, q, k, v)
    err, tol, share = errs["max_abs_err"], errs["tolerance"], errs["max_elem_tolerance_share"]
    check(err <= tol and share <= 1, f"{what}: kernel differs from its plain version by {err} "
          f"(tolerance {tol}), element share {share}")
    out, lse = fa.flash_forward_cuda(q, k, v, return_lse=True)
    want, want_lse = fa.flash_forward_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    lse_err = float((lse - want_lse).abs().max())
    lse_out_err = float((out.float() - want.float()).abs().max())
    check(torch.equal(out, fa.flash_forward_cuda(q, k, v)) and lse_err <= LSE_BF16_ATOL
          and lse_out_err <= tol, f"{what}, lse variant: out {lse_out_err} (tolerance {tol}), "
          f"lse {lse_err} (tolerance {LSE_BF16_ATOL})")
    del out, lse, want, want_lse
    f32 = [t.float() for t in (q, k, v)]
    o32, l32 = fa.flash_forward_cuda(*f32, return_lse=True)
    w32, wl32 = fa.flash_forward_plain(*f32, return_lse=True)
    err32 = float((o32 - w32).abs().max())
    lse32 = float((l32 - wl32).abs().max())
    check(err32 <= FLASH_F32_ATOL and lse32 <= FLASH_F32_ATOL, f"{what}, float32: out "
          f"{err32}, lse {lse32} (tolerance {FLASH_F32_ATOL})")
    del f32, o32, l32, w32, wl32
    kern = lambda: fa.flash_forward_cuda(q, k, v)
    row = dict(shape=dict(q=list(q.shape), k=list(k.shape), v=list(v.shape)),
               max_abs_err=err, tolerance=tol, max_elem_tolerance_share=share,
               lse_max_abs_err=lse_err, lse_tolerance=LSE_BF16_ATOL, f32_max_abs_err=err32,
               f32_lse_max_abs_err=lse32, f32_tolerance=FLASH_F32_ATOL, ms=cuda_time_ms(kern))
    row.update(profile_device(kern)[0])
    row.update(profile_device(lambda: fa.flash_forward_cuda(q, k, v, return_lse=True),
                              key="lse_device_ms")[0])
    row["plain_ms"] = cuda_time_ms(lambda: fa.flash_forward_plain(q, k, v), reps=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=k.shape[2] != q.shape[2])
    try:
        row["library_ms"] = cuda_time_ms(library)
        row.update(profile_device(library, key="library_device_ms")[0])
    except RuntimeError as e:       # no SDPA backend for this shape
        row.update(library_ms=None, library_note=str(e)[:200])
    Bq, Sq, H, hd = q.shape
    # QK^T at the qk width and PV at the v width over the causal pairs
    row["flops"] = 2 * Bq * H * (Sq * (Sq + 1) // 2) * (hd + v.shape[-1])
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(q, k, v) + Bq * Sq * H * v.shape[-1] * 2, row["flops"] / BF16_FLOPS_PER_S * 1e3)
    print(f"{what} == plain version: max_abs_err {err} (tolerance {tol}; element share "
          f"{share}); lse {lse_err}; float32 {err32}")
    return {prefix + key: val for key, val in row.items()}


def logits_agree(name: str, got, want, labels, moe: bool) -> dict:
    """Hold the last-token logits ``got`` to ``want`` (``FAMILIES_LOGIT_RTOL``:
    the largest difference against the largest |logit|, or for a MoE family
    the mean cross-entropy against ``labels``) -> what was compared."""
    import torch

    def ce(logits):
        return float((torch.logsumexp(logits, -1)
                      - logits.gather(1, labels[:, None])[:, 0]).mean())

    diff = float((got - want).abs().max())
    tol = FAMILIES_LOGIT_RTOL * float(want.abs().max())
    ce_got, ce_want = ce(got), ce(want)
    row = dict(max_abs_diff=diff, max_abs_tolerance=tol, ce=[ce_got, ce_want],
               ce_rtol=FAMILIES_LOGIT_RTOL, held_by="ce" if moe else "max_abs",
               argmax_agreement=float((got.argmax(-1) == want.argmax(-1)).float().mean()))
    ok = (abs(ce_got - ce_want) <= FAMILIES_LOGIT_RTOL * abs(ce_want)) if moe else diff <= tol
    check(ok, f"{name}: {row}")
    return row


def lm_families_phase(dev, card: str) -> dict:
    """LM_FAMILIES: ``serve_lm`` on the MoE, MLA, RG-LRU (local windows, the
    ring cache) and xLSTM families at full width (``FAMILIES_SERVE``), each
    with the flash counts zeroed around it: flash launches = the global
    attention layers, finite logits, the prefill's last-token logits held
    to a cacheless forward's, the kernel route to the plain route (the two
    kernel families; a MoE family by its cross-entropy, an end-to-end sanity
    line), where a warm prefill and decode spend their time; the flash
    kernel against its plain version on the kernel families' layer-0
    prefill inputs (``FAMILIES_FLASH``); then ``train_lm`` at full width
    with the depth cut to one unit and on the MoE families' bf16 smoke
    configs (deepseek's through both routes).  Returns the flash row's
    ``qwen3_*`` and ``mla_*`` fields."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train

    t_phase = time.perf_counter()
    row, served = {}, {}
    for arch, cut in FAMILIES_SERVE.items():
        t_fam = time.perf_counter()
        cfg = get_config(arch)
        if cut:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        args = serve.build_parser().parse_args(["--arch", arch, *FAMILIES_ARGV])
        B, P = args.batch_size, args.seq_len // 2
        n_attn = sum(kind == "attn" for kind in cfg.layer_kinds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.launches_wgmma = fa.launches_simt = 0
        res = serve.serve_lm(args, cfg=cfg)
        launches, launches_wgmma = fa.launches, fa.launches_wgmma
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == launches_wgmma == res["flash_launches"] == n_attn,
              f"{arch}: the prefill launched the flash kernel {launches} times "
              f"({launches_wgmma} tensor-core) for {n_attn} global attention layers")
        logits, model = res["prefill_logits"], res.pop("model")
        check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))).to(dev)
        labels = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, B)).to(dev)
        with torch.no_grad():
            hidden, _ = model(tokens)
            fwd = (hidden[:, -1] @ model.unembed_matrix()).to(torch.float32)
        del hidden
        fam = dict(n_layers=cfg.n_layers, depth_cut=cut is not None, batch=B, prompt=P,
                   decode_steps=args.new_tokens, prefill_ms=res["prefill_s"] * 1e3,
                   decode_ms_per_step=res["decode_s"] / args.new_tokens * 1e3,
                   peak_memory_gb=peak_gb, flash_launches=launches,
                   against_cacheless_forward=logits_agree(
                       f"{arch}: prefill against a cacheless forward", logits, fwd, labels,
                       cfg.is_moe))
        if arch in FAMILIES_FLASH:
            row.update(family_flash_checks(fa, model, cfg, tokens, FAMILIES_FLASH[arch]))
            row[FAMILIES_FLASH[arch] + "launches"] = launches
        fam["split"] = family_split(model, cfg, tokens, args.seq_len, args.new_tokens)
        # each of the family's layer kinds has device time under its range
        kinds = set(cfg.layer_kinds)
        want = {"attention": bool(kinds & {"attn", "local"}), "rglru_scan": "rec" in kinds,
                "mlstm_core": "mlstm" in kinds, "slstm_steps": "slstm" in kinds,
                "moe_route": cfg.is_moe, "moe_experts": cfg.is_moe}
        for label, split in fam["split"].items():
            got = {part: split["device_ms"][part] > 0 for part in want}
            check(got == want, f"{arch}: the {label}'s device time by range {split['device_ms']}"
                  f" (parts expected {sorted(k for k, w in want.items() if w)})")
        del model, res, fwd
        torch.cuda.empty_cache()
        if n_attn:      # the plain route: the kernel's plain version in its place
            n0 = fa.launches
            with plain_flash(fa):
                plain = serve.serve_lm(args, cfg=cfg)
            plain.pop("model")
            check(fa.launches == n0, f"{arch}: the plain route launched the flash kernel")
            fam.update(against_plain_route=logits_agree(
                f"{arch}: kernel route against the plain route", logits,
                plain["prefill_logits"], labels, cfg.is_moe),
                plain_route_prefill_ms=plain["prefill_s"] * 1e3)
            del plain
        del logits
        torch.cuda.empty_cache()
        fam["wall_s"] = time.perf_counter() - t_fam
        served[arch] = fam
        print(f"family {arch}: " + json.dumps(fam))

    trained = {}
    runs = [(arch, dataclasses.replace(get_config(arch), n_layers=n), FAMILIES_TRAIN_ARGV)
            for arch, n in FAMILIES_TRAIN.items()]
    runs += [(arch, dataclasses.replace(get_smoke_config(arch), dtype="bfloat16"),
              FAMILIES_SMOKE_ARGV) for arch in FAMILIES_SMOKE_TRAIN]
    for arch, tcfg, argv in runs:
        targs = train.build_parser().parse_args(["--arch", arch, *argv])
        torch.cuda.reset_peak_memory_stats()
        n0 = fa.launches_wgmma
        r = train.train_lm(targs, cfg=tcfg)
        r.pop("model"), r.pop("opt_state")
        n = 2 * sum(kind == "attn" for kind in tcfg.layer_kinds)
        want = math.log(tcfg.vocab_size) + 0.5
        check(r["flash_launches"] == [n] * targs.steps
              and fa.launches_wgmma - n0 == n * targs.steps,
              f"{tcfg.name}: flash launches {r['flash_launches']} a step, expected {n}")
        check(all(np.isfinite(r["losses"])) and all(np.isfinite(r["grad_norms"]))
              and all(abs(x - want) <= FAMILIES_LOSS_ATOL for x in r["losses"]),
              f"{tcfg.name}: losses {r['losses']} (ln V + 0.5 = {want}), grad norms "
              f"{r['grad_norms']}")
        trained[tcfg.name] = dict(
            n_layers=tcfg.n_layers, dtype=tcfg.dtype, batch=[targs.batch_size, targs.seq_len],
            losses=r["losses"], ln_v_plus_half=want, grad_norms=r["grad_norms"],
            step_event_ms=r["step_event_ms"], flash_launches_per_step=n,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

    # deepseek-v2's bf16 smoke step (MLA's widths 24 over 16) through both routes
    scfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="bfloat16")
    sbatch = {kk: torch.from_numpy(a).to(dev)
              for kk, a in train.lm_batch(scfg, np.random.default_rng(0), 4, 256).items()}
    n0 = fa.launches_wgmma
    k_loss, k_norms, k_gn = route_step(scfg, dev, sbatch)
    route_launches = fa.launches_wgmma - n0
    n0 = fa.launches
    with plain_flash(fa):
        p_loss, p_norms, p_gn = route_step(scfg, dev, sbatch)
    check(fa.launches == n0, "the plain route launched the flash kernel")
    leaf_rel = max(abs(a - b) / max(b, 1e-30) for a, b in zip(k_norms, p_norms))
    route = dict(smoke=scfg.name, dtype="bfloat16", batch=[4, 256],
                 wgmma_launches=route_launches, loss=[k_loss, p_loss],
                 loss_rtol=LM_TRAIN_LOSS_RTOL, grad_norm=[k_gn, p_gn],
                 leaf_norm_max_rel_diff=leaf_rel, grad_rtol=LM_ROUTE_GRAD_RTOL)
    check(route_launches == 2 * scfg.n_layers, f"the MLA smoke step launched the bf16 flash "
          f"kernel {route_launches} times for {scfg.n_layers} layers")
    check(abs(k_loss - p_loss) <= LM_TRAIN_LOSS_RTOL * abs(p_loss)
          and abs(k_gn - p_gn) <= LM_ROUTE_GRAD_RTOL * p_gn and leaf_rel <= LM_ROUTE_GRAD_RTOL,
          f"kernel and plain routes of the MLA smoke step disagree: {route}")

    print("LM_FAMILIES " + json.dumps(dict(
        card=card, serve={a: {k: v for k, v in f.items() if k != "split"}
                          for a, f in served.items()},
        split={a: f["split"] for a, f in served.items()},
        train=trained, route_check=route,
        flash={k: v for k, v in row.items() if not k.endswith("_spread")},
        phase_s=time.perf_counter() - t_phase)))
    return row


def autotune_phase(dev, compiled, xp_all, xw_all) -> dict:
    """The autotuner and its cost model on the card, in a fresh cache and
    sidecar (a stale cache would turn the sweeps into no-ops):

    * every candidate of every registry held to its plain version at
      tolerance 0: ``fused_infer``, ``sparse_infer`` and ``term_infer`` on
      the committed artifact at each of ``BATCHES`` (the walks exact and
      early exit), ``fused_train`` and ``fused_infer`` on the training
      shapes (``TRAIN_BATCHES``, the initial and a trained bank);
    * ``policy="sweep"`` for the four kernels (``fused_infer`` and
      ``fused_train`` at every batch above, the walks at the serve bucket on
      its requests), the ``torch-cuda`` model refit from the sidecar, and,
      at each main shape, the default launch's, the winner's and the
      model's top-1's device time (``profile_device``) against the best
      candidate's: ``AUTOTUNE``, and the refit coefficients:
      ``AUTOTUNE_COEFFS``;
    * ``serve_tm --autotune`` under each policy on a copy of the committed
      artifact (never the committed file: a measured tiling re-saves it),
      each run's answers and tiling against the oracle, then ``predict``
      once more on the swept copy: the recorded tiling answers with no
      timing run (``AUTOTUNE_SERVE``);
    * one ``artifact_loader(policy="predict")`` cold load: no timing run,
      its plan serves equal to the oracle (``AUTOTUNE_ZOO``);
    * ``train_tm --autotune`` (40 steps) ends on an untuned run's bank
      (``AUTOTUNE_TRAIN``).
    """
    import ast
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import packetizer, prng, compiler as comp_mod
    from repro_torch.data.synthetic import make_boolean_classification
    from repro_torch.kernels import (autotune, cost_model, fused_infer, fused_train,
                                     sparse_infer, term_infer)
    from repro_torch.launch import serve
    from repro_torch.runtime.zoo import ArtifactZoo, artifact_loader

    tmp = tempfile.mkdtemp(prefix="autotune-")
    env_keys = ("REPRO_TORCH_AUTOTUNE_CACHE", "REPRO_TORCH_TUNE_DATA")
    saved_env = {k: os.environ.get(k) for k in env_keys}

    def fresh_cache(name):
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, name)
        autotune._PROC_CACHE.clear()

    fresh_cache("sweep.json")
    os.environ["REPRO_TORCH_TUNE_DATA"] = os.path.join(tmp, "tune_data.json")
    cost_model._invalidate_model_cache()
    t_phase = time.perf_counter()
    try:
        tabs = compiled.tensors(dev)
        inc, votes = tabs["include_words"], tabs["votes"]
        U, Wa = inc.shape
        K = votes.shape[1]
        iw = compiled.include_words
        ones = torch.ones(U, dtype=torch.int32, device=dev)
        exact = {k: 0 for k in autotune.kernels()}

        # 1. every candidate == its plain version, tolerance 0
        walks = {"sparse_infer": ("sparse", sparse_infer), "term_infer": ("factorized", term_infer)}
        for B in BATCHES:
            xw = xw_all[:B].contiguous()
            want = fused_infer.fused_forward_plain(xw, inc, votes, ones)
            for blk in autotune.candidates_for("fused_infer", B=B, C=U, W=Wa, K=K):
                got = fused_infer.fused_tm_forward(xw, inc, votes, ones, **blk)
                check(torch.equal(got, want), f"fused_infer {blk} B={B} != plain version")
                exact["fused_infer"] += 1
            for kernel, (eng, mod) in walks.items():
                plains = {}
                for blk in autotune.candidates_for(kernel, B=B, K=K, include_words=iw):
                    tiling = {k: v for k, v in blk.items() if k != "block_s"}
                    sched = (compiled.schedule(**tiling) if eng == "sparse"
                             else compiled.factorized_schedule(**tiling))
                    t = sched.tensors(dev)
                    for early in (False, True):
                        m = compiled.margin_tensor(eng, dev, **tiling) if early else None
                        key = (tuple(sorted(tiling.items())), early)
                        if eng == "sparse":
                            args = (xw, t["chain_ids"], votes, t["tiles"], t["indptr"])
                            kw = dict(block_c=sched.block_c, block_j=sched.block_j,
                                      tile_margin=m)
                            if key not in plains:
                                plains[key] = sparse_infer.sparse_tables_plain(*args, **kw)
                            got = sparse_infer.sparse_tables_cuda(*args, **kw,
                                                                  block_s=blk["block_s"])
                        else:
                            args = (xw, t["term_chain"], t["clause_chain"], votes, t["tiles"],
                                    t["indptr"])
                            kw = dict(block_c=sched.block_c, block_j=sched.block_j,
                                      n_term_tiles=sched.n_term_tiles, tile_margin=m)
                            if key not in plains:
                                plains[key] = term_infer.factorized_tables_plain(*args, **kw)
                            got = term_infer.factorized_tables_cuda(*args, **kw,
                                                                    block_s=blk["block_s"])
                        check(torch.equal(got, plains[key]),
                              f"{kernel} {blk} B={B} early_exit={early} != plain version")
                        exact[kernel] += 1
        print(f"autotune: every candidate of fused_infer, sparse_infer and term_infer == "
              f"plain versions on the committed artifact at B={BATCHES}, the walks exact "
              "and early exit")

        tr = Training(dev)
        init = tr.tm.init(tr.config, prng.PRNGKey(0), dev).ta_state

        def check_training_shapes(bank, label):
            for B in TRAIN_BATCHES:
                t, _, _, kw = tr.batch(bank, B, 7, 12345)
                C, L = t["ta"].shape
                W = t["lit_words"].shape[1]
                want = fused_train.fused_train_plain(t, 7, **kw)
                for blk in autotune.candidates_for("fused_train", B=B, C=C, W=W, L=L, K=K):
                    clauses = fused_train.clauses_a_block(B, W, **blk)
                    got = fused_train.fused_train_cuda(t, 7, clauses=clauses, **kw)
                    check(torch.equal(got, want),
                          f"fused_train {blk} {label} B={B} != plain version")
                    exact["fused_train"] += 1
                kern_ones = torch.ones(C, dtype=torch.int32, device=dev)
                want = fused_infer.fused_forward_plain(t["lit_words"], t["inc_words"],
                                                       tr.votes, kern_ones)
                for blk in autotune.candidates_for("fused_infer", B=B, C=C, W=W, K=K):
                    got = fused_infer.fused_tm_forward(t["lit_words"], t["inc_words"],
                                                       tr.votes, None, **blk)
                    check(torch.equal(got, want),
                          f"fused_infer {blk} {label} training B={B} != plain version")
                    exact["fused_infer"] += 1

        check_training_shapes(init, "initial bank")

        # 2. sweep, refit, and the main shapes' device times
        t64, _, _, _ = tr.batch(init, TRAIN_BATCH, 7, 0)
        Ct, Lt = t64["ta"].shape
        Wt = t64["lit_words"].shape[1]
        lit = xw_all[:BUCKET].contiguous()
        feats = compiled.extract_features()
        main_shapes = {
            "fused_infer": ("fused_infer", dict(B=BUCKET, C=U, W=Wa, K=K)),
            "fused_infer_train": ("fused_infer", dict(B=TRAIN_BATCH, C=Ct, W=Wt, K=K)),
            "fused_train": ("fused_train", dict(B=TRAIN_BATCH, C=Ct, W=Wt, L=Lt, K=K)),
            "sparse_infer": ("sparse_infer", dict(B=BUCKET, K=K, include_words=iw,
                                                  lit_words=lit)),
            "term_infer": ("term_infer", dict(B=BUCKET, K=K, include_words=iw,
                                              lit_words=lit)),
        }
        fit_shapes = [("fused_infer", dict(B=B, C=U, W=Wa, K=K)) for B in BATCHES]
        fit_shapes += [("fused_infer", dict(B=B, C=Ct, W=Wt, K=K)) for B in TRAIN_BATCHES]
        fit_shapes += [("fused_train", dict(B=B, C=Ct, W=Wt, L=Lt, K=K))
                       for B in TRAIN_BATCHES]
        fit_shapes += [main_shapes["sparse_infer"], main_shapes["term_infer"]]
        shipped = {label: autotune.rank_candidates(kernel, device=dev, **shape)[0][0]
                   for label, (kernel, shape) in main_shapes.items()}
        t0, r0 = time.perf_counter(), autotune.TIMING_RUNS
        sweep_us = {}          # shape_key -> {candidate tag: the sweep's reading}

        def shape_key(kernel, shape):
            return (kernel, *sorted((k, v) for k, v in shape.items()
                                    if k not in ("include_words", "lit_words")))

        for kernel, shape in fit_shapes:
            n0 = len(cost_model.load_observations())
            autotune.tune(kernel, device=dev, policy="sweep",
                          features=feats if "include_words" in shape else None, **shape)
            sweep_us[shape_key(kernel, shape)] = {
                "x".join(str(r["blocks"][n]) for n in autotune._REGISTRY[kernel].block_names):
                r["measured_us"] for r in cost_model.load_observations()[n0:]}
        sweep_s, sweep_runs = time.perf_counter() - t0, autotune.TIMING_RUNS - r0
        # the main shapes' winners: recalled from the sweeps' cache entries
        winners = {label: autotune.tune(kernel, device=dev, policy="sweep", **shape)
                   for label, (kernel, shape) in main_shapes.items()}
        check(autotune.TIMING_RUNS == r0 + sweep_runs, "a swept shape was timed again")
        rows = cost_model.load_observations()
        check(len(rows) > 0 and all(r["mode"] == "torch-cuda" for r in rows),
              "the sweeps logged no torch-cuda observation")
        model = cost_model.get_model("torch-cuda", refresh=True)
        print("AUTOTUNE_COEFFS " + json.dumps(dict(
            rows={k: sum(r["kernel"] == k for r in rows) for k in autotune.kernels()},
            coeffs=model.coeffs)))

        report = {}
        for label, (kernel, shape) in main_shapes.items():
            tuner = autotune._REGISTRY[kernel]
            problem = tuner.prepare(**shape)
            clipped = tuner.clip(tuner.default_candidates, problem)
            runs = tuner.make_runs(problem, clipped, dev)
            dev_ms = {c: profile_device(run)[0] for c, run in runs.items()}

            def as_tuple(blk, names=tuner.block_names):
                return tuple(blk[n] for n in names)

            B = shape["B"]
            if kernel == "fused_infer":
                split = fused_infer.occupancy(B, shape["C"])["word_split"]
                default = as_tuple(fused_infer.blocks_for(split, shape["W"]))
            elif kernel == "fused_train":
                default = as_tuple(fused_train.blocks_for(fused_train.DEFAULT_CLAUSES, B,
                                                          shape["W"]))
            else:
                mod = sparse_infer if kernel == "sparse_infer" else term_infer
                base = [mod.DEFAULT_BLOCK_C, mod.DEFAULT_BLOCK_J]
                if kernel == "term_infer":
                    base.append(mod.DEFAULT_BLOCK_T)
                cand = (*base, sparse_infer.covering_slab(B)) + (
                    (0,) if kernel == "term_infer" else ())
                default = tuner.clip([cand], problem)[0]
            refit = as_tuple(autotune.rank_candidates(kernel, device=dev, **shape)[0][0])
            pick = dict(default=default, winner=as_tuple(winners[label]),
                        top1_shipped=as_tuple(shipped[label]), top1_refit=refit)
            best = min(dev_ms, key=lambda c: dev_ms[c]["device_ms"])
            row = dict(kernel=kernel, B=B, n_candidates=len(clipped),
                       best=dict(blocks=dict(zip(tuner.block_names, best)), **dev_ms[best]))
            for name, c in pick.items():
                check(c in dev_ms, f"{label}: {name} {c} is not a candidate")
                row[name] = dict(blocks=dict(zip(tuner.block_names, c)), **dev_ms[c])
            for name in ("winner", "top1_shipped", "top1_refit"):
                row[f"{name}_over_best"] = dev_ms[pick[name]]["device_ms"] / dev_ms[best]["device_ms"]
            row["winner_over_default"] = (dev_ms[pick["winner"]]["device_ms"]
                                          / dev_ms[pick["default"]]["device_ms"])
            row["all_device_ms"] = {"x".join(map(str, c)): v["device_ms"]
                                    for c, v in dev_ms.items()}
            row["all_sweep_us"] = sweep_us[shape_key(kernel, shape)]
            report[label] = row
        print("AUTOTUNE " + json.dumps(dict(sweep_s=sweep_s, sweep_timing_runs=sweep_runs,
                                            exact_checks=exact, shapes=report)))

        # 3. serve_tm --autotune under each policy, on copies of the asset
        mods = {"fused_infer": fused_infer, "sparse_infer": sparse_infer,
                "term_infer": term_infer}
        X, _ = make_boolean_classification(4096, 784, 10, seed=2)
        xp = packetizer.pack_literals(torch.from_numpy(X).to(dev))
        oracle = torch.cat([comp_mod.run_compiled(compiled, xp[i:i + BUCKET], engine="oracle")
                            for i in range(0, 4096, BUCKET)])
        want_hist = np.bincount(oracle.argmax(-1).cpu().numpy(), minlength=10).tolist()

        def serve_autotuned(art, policy):
            argv = ["--arch", "tm-mnist", "--artifact", art, "--device", "cuda",
                    "--requests", "4096", "--bucket", str(BUCKET), "--autotune",
                    "--tune-policy", policy]
            for m in mods.values():
                m.launches = 0
            r0 = autotune.TIMING_RUNS
            buf = io.StringIO()
            with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
                health, gw, *_ = serve.serve_tm(serve.build_parser().parse_args(argv))
            text = buf.getvalue()
            counts = {k: m.launches for k, m in mods.items()}
            check(health["final_engine"] == "factorized" and health["demotions"] == [],
                  f"serve --autotune {policy}: {health['final_engine']}, "
                  f"{health['demotions']}")
            check(gw["answered"] == 4096 and gw["unaccounted"] == 0,
                  f"serve --autotune {policy}: gateway {gw}")
            check(counts["term_infer"] > 0, f"serve --autotune {policy}: no term_infer launch")
            hist = re.search(r"pred class histogram: (\[[^]]*\])", text)
            check(hist is not None and ast.literal_eval(hist.group(1)) == want_hist,
                  f"serve --autotune {policy}: answers != the oracle's")
            m = re.search(r"(autotuned|artifact-recorded) factorized blocks[^:]*: (\{[^}]*\})",
                          text)
            check(m is not None, f"serve --autotune {policy} printed no tiling")
            blocks = ast.literal_eval(m.group(2))
            got = torch.cat([comp_mod.run_compiled(compiled, xp[i:i + BUCKET],
                                                   engine="factorized", **blocks)
                             for i in range(0, 4096, BUCKET)])
            check(torch.equal(got, oracle), f"serve --autotune {policy}: its tiling "
                  f"{blocks} != the oracle")
            return dict(blocks=blocks, source=m.group(1), timing_runs=autotune.TIMING_RUNS - r0,
                        launches=counts, saved="saved artifact" in text)

        serve_report = {}
        fresh_cache("serve.json")
        for policy in autotune.POLICIES:
            art = os.path.join(tmp, f"tm_mnist_{policy}.npz")
            shutil.copy(ASSET, art)
            r = serve_report[policy] = serve_autotuned(art, policy)
            check(r["source"] == "autotuned", f"serve {policy} recalled a tiling from a copy "
                  "of the committed artifact")
            check((r["timing_runs"] == 0) == (policy == "predict"),
                  f"serve {policy}: {r['timing_runs']} timing runs")
            check(r["saved"] == (policy != "predict"), f"serve {policy}: saved={r['saved']}")
        again = serve_report["predict again"] = serve_autotuned(
            os.path.join(tmp, "tm_mnist_sweep.npz"), "predict")
        check(again["timing_runs"] == 0 and again["source"] == "artifact-recorded"
              and again["blocks"] == serve_report["sweep"]["blocks"],
              f"the swept tiling was not recalled from the re-saved artifact: {again}")
        print("AUTOTUNE_SERVE " + json.dumps(serve_report))

        # 4. a zoo cold load under policy="predict"
        fresh_cache("zoo.json")
        zoo = ArtifactZoo(artifact_loader(lambda tenant: ASSET, batch=BUCKET, device=dev),
                          max_entries=1)
        r0 = autotune.TIMING_RUNS
        with zoo.lease("t0") as obj:
            runs_spent = autotune.TIMING_RUNS - r0
            got = comp_mod.run_compiled(obj["compiled"], xp[:BUCKET], engine=obj["engine"],
                                        **obj["blocks"])
        check(runs_spent == 0, f"the zoo's cold load made {runs_spent} timing runs")
        check(torch.equal(got, oracle[:BUCKET]), "the zoo's cold-load plan != the oracle")
        zoo_report = dict(engine=obj["engine"], blocks=obj["blocks"], timing_runs=runs_spent)
        print("AUTOTUNE_ZOO " + json.dumps(zoo_report))

        # 5. train_tm --autotune against an untuned run
        plain_bank, _, plain_wall = tr.run("untuned (autotune phase)")
        fresh_cache("train.json")
        r0 = autotune.TIMING_RUNS
        tuned_bank, counts, wall = tr.run("--autotune", "--autotune")
        check(counts["fused_infer"] > 0 and counts["fused_train"] > 0,
              f"train_tm --autotune launched {counts}")
        check(torch.equal(tuned_bank, plain_bank),
              "train_tm --autotune ended on another bank than the untuned run")
        check_training_shapes(tuned_bank, "trained bank")
        train_report = dict(steps=TRAIN_STEPS, wall_s=wall, untuned_wall_s=plain_wall,
                            timing_runs=autotune.TIMING_RUNS - r0, launches=counts,
                            blocks={k.split(":")[0]: v["blocks"]
                                    for k, v in autotune._load_cache().items()})
        print("AUTOTUNE_TRAIN " + json.dumps(train_report))
        print(f"autotune: {sum(exact.values())} candidate launches == plain versions "
              f"({json.dumps(exact)}); serve under every policy == oracle; zoo cold load "
              "and a recalled tiling made no timing run; train --autotune bank == untuned; "
              f"the phase took {time.perf_counter() - t_phase:.1f} s")
        return dict(shapes=report, serve=serve_report, zoo=zoo_report, train=train_report)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune._PROC_CACHE.clear()
        cost_model._invalidate_model_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# the MESH phase: REPRO_TORCH_FORCE_DEVICE_COUNT logical devices over the
# card, the forward meshes, the training meshes (B 64, and a chunk of 24
# that leaves a ragged tail), fit's steps and the launchers' short runs
MESH_DEVICES = 4
MESH_FORWARD = ("model=2", "model=4", "data=2,model=2")
MESH_TRAIN = ("model=2", "data=2,model=2")
MESH_CHUNK = 24
MESH_FIT_N, MESH_TRAIN_STEPS = 256, 5
# profiler windows and calls a window of the MESH phase's device times
# (fewer than WINDOWS x WINDOW_CALLS: a window of sharded steps holds
# thousands of small launches, and the profiler's summary of them costs
# seconds); serve runs in turns a side
MESH_WINDOWS, MESH_WINDOW_CALLS, MESH_SERVE_TURNS = 3, 10, 3
MESH_SPLIT_TOP = 8          # kernels and copies kept in a serve run's device split
MESH_NOTE = ("one card: the mesh's logical devices share it and its shards run "
             "one after another, so these times are the overhead of sharding, "
             "not a multi-GPU rate")


def mesh_phase(dev, card: str, compiled, xp_all) -> dict:
    """The clause-sharded mesh (``core/sharding.py``) on the card, with
    ``MESH_DEVICES`` logical devices laid over it (MESH):

    (a) the three sharded forward builders on the committed artifact at the
        serve bucket, at each of ``MESH_FORWARD``: class sums equal the
        unsharded kernel's and the oracle's, each kernel launched once a
        shard, each shard's real and padded tile counts (one shard at
        least walks fewer real tiles than its table holds);
    (b) ``sharded_train_step_fn(engine="kernel")`` at tm-mnist's full width,
        B 64, fused, unfused and chunked by ``MESH_CHUNK``, on each of
        ``MESH_TRAIN``: the bank equals the single-device step's, each
        kernel launched once a shard and chunk; ``algorithm="matmul"``
        equals the single-device ``tm_train_step_matmul``;
    (c) ``fit(engine="kernel", mesh=)`` equals ``fit`` without a mesh, with
        one ``fused_infer`` and one ``fused_train`` a shard and step;
    (d) ``train_tm --mesh data=2,model=2`` ends on the unsharded run's bank,
        and ``serve_tm --mesh model=2`` on the committed artifact (4096
        requests in buckets of 512) predicts what the unsharded run does,
        every bucket on ``mesh-factorized``, two ``term_infer`` launches a
        bucket.

    Prints ``MESH``: each case's mesh, ``C_loc``, launches, equality flags
    and wall (event) ms beside the unsharded run's (the serve runs in
    ``MESH_SERVE_TURNS`` pairs of turns), with ``profile_device``
    device ms for (b) and the serve runs' profiled device ms for (d) with
    its largest kernels and copies, and each part's seconds.
    """
    import numpy as np
    import torch

    from repro_torch.configs.matador_tm import TM_MNIST
    from repro_torch.core import compiler as comp_mod, prng, sharding, tm, train
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import (class_sum, clause_eval, fused_infer, fused_train,
                                     ops, sparse_infer, ta_update, term_infer)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launch

    mods = {"fused_infer": fused_infer, "sparse_infer": sparse_infer,
            "term_infer": term_infer, "fused_train": fused_train,
            "clause_eval": clause_eval, "class_sum": class_sum, "ta_update": ta_update}

    def zero():
        for m in mods.values():
            m.launches = 0

    def counts():
        return {k: m.launches for k, m in mods.items() if m.launches}

    saved_env = os.environ.get(mesh_mod.FORCE_ENV)
    os.environ[mesh_mod.FORCE_ENV] = str(MESH_DEVICES)
    t_phase = time.perf_counter()
    line = dict(note=MESH_NOTE, card=card,
                physical_devices=torch.cuda.device_count(),
                logical_devices=MESH_DEVICES)
    try:
        logical = mesh_mod.visible_devices(dev)
        print(f"mesh: {torch.cuda.device_count()} physical device(s), "
              f"{len(logical)} logical devices over them: "
              f"{sorted({str(d) for d in logical})}")

        # (a) the forward builders at the serve bucket
        B = BUCKET
        xp = xp_all[:B].contiguous()
        tabs = compiled.tensors(dev)
        oracle = comp_mod.run_compiled(compiled, xp, engine="oracle")
        stacks, fwd_rows, padded_any, single_ms = {}, [], False, {}
        seconds = {}
        t_part = time.perf_counter()
        for spec in MESH_FORWARD:
            mesh = mesh_mod.parse_mesh_spec(spec, dev)
            n = mesh.shape["model"]
            if n not in stacks:
                fs, *fst, fC = term_infer.stack_shard_factorized(
                    compiled.include_words, compiled.votes, n)
                ss, *sst, sC = sparse_infer.stack_shard_schedules(
                    compiled.include_words, compiled.votes, n)
                dst = sharding.stack_shard_dense(compiled.include_words, compiled.votes, n)
                tiles = {}
                for label, sched, st in (("factorized", fs, fst), ("sparse", ss, sst)):
                    tl = st[-1]
                    per = [dict(real=r, padded=tl.shape[-1] - r) for r in sharding.real_tiles(
                        tl, st[-3].shape[1], sched[0].block_c)]
                    tiles[label] = per
                    padded_any |= any(p["padded"] > 0 for p in per)
                print(f"mesh model={n}: tiles a shard (real, padded) "
                      + json.dumps(tiles))

                def on_card(arrs):
                    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
                stacks[n] = dict(
                    factorized=(fs, on_card(fst), fC), sparse=(ss, on_card(sst), sC),
                    dense=(None, on_card(dst), dst[0].shape[0] // n), tiles=tiles)
            st = stacks[n]
            builders = {
                "factorized": (term_infer, "term_infer", sharding.sharded_factorized_forward_fn(
                    mesh, block_t=st["factorized"][0][0].block_t,
                    block_c=st["factorized"][0][0].block_c,
                    block_j=st["factorized"][0][0].block_j)),
                "sparse": (sparse_infer, "sparse_infer", sharding.sharded_schedule_forward_fn(
                    mesh, block_c=st["sparse"][0][0].block_c,
                    block_j=st["sparse"][0][0].block_j)),
                "dense": (fused_infer, "fused_infer", sharding.sharded_forward_fn(mesh)),
            }
            for eng, (mod, kname, fwd) in builders.items():
                t_in = st[eng][1]

                def sharded(fwd=fwd, t_in=t_in):
                    return fwd(*t_in, xp[:, tabs["word_ids"]])

                def single(eng=eng):
                    return comp_mod.run_compiled(compiled, xp, engine=eng)
                zero()
                got = sharded()
                torch.cuda.synchronize()
                n_launch = counts()
                want = single()
                torch.cuda.synchronize()
                if eng not in single_ms:
                    single_ms[eng] = cuda_time_ms(single)
                eq_kernel, eq_oracle = torch.equal(got, want), torch.equal(got, oracle)
                check(eq_kernel and eq_oracle, f"mesh {spec} {eng}: sharded class sums "
                      f"differ (== unsharded kernel {eq_kernel}, == oracle {eq_oracle})")
                check(n_launch.get(kname) == mesh.size,
                      f"mesh {spec} {eng}: launches {n_launch}, expected {kname} "
                      f"{mesh.size} (one a shard)")
                fwd_rows.append(dict(
                    case="forward", engine=eng, mesh=dict(mesh.shape), shards=mesh.size,
                    C_loc=st[eng][2], B=B, launches=n_launch,
                    equal_unsharded_kernel=eq_kernel, equal_oracle=eq_oracle,
                    ms=cuda_time_ms(sharded), unsharded_ms=single_ms[eng]))
        check(padded_any, "mesh: no shard carried padding tiles")
        print(f"mesh forward: {len(fwd_rows)} sharded forwards == unsharded kernels "
              "== oracle, one launch a shard")
        line["forward"] = fwd_rows
        line["tiles"] = {str(n): s["tiles"] for n, s in stacks.items()}
        seconds["forward"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # (b) the sharded step at tm-mnist's full width, B 64
        cfg = TM_MNIST
        X, Y, _, _ = paper_dataset("mnist", n_train=MESH_FIT_N)
        x = torch.from_numpy(X[:TRAIN_BATCH]).to(dev)
        y = torch.from_numpy(Y[:TRAIN_BATCH]).to(dev)
        ta = tm.init(cfg, prng.PRNGKey(0), dev).ta_state
        seed = 3
        train_rows = []
        variants = {"fused": dict(fuse=True, batch_chunk=None),
                    "unfused": dict(fuse=False, batch_chunk=None),
                    f"chunk{MESH_CHUNK}": dict(fuse=True, batch_chunk=MESH_CHUNK)}
        for vname, kw in variants.items():
            def single(kw=kw):
                return ops.tm_train_step_kernel(cfg, ta, x, y, seed, **kw)[0]
            want = single()
            single_ms = cuda_time_ms(single, reps=10)
            single_dev = profile_device(single, calls=MESH_WINDOW_CALLS,
                                        windows=MESH_WINDOWS)[0]
            for spec in MESH_TRAIN:
                mesh = mesh_mod.parse_mesh_spec(spec, dev)
                step = sharding.sharded_train_step_fn(cfg, mesh, engine="kernel", **kw)
                zero()
                got = step(ta, x, y, seed)
                torch.cuda.synchronize()
                n_launch = counts()
                B_loc = TRAIN_BATCH // mesh.shape.get("data", 1)
                chunks = -(-B_loc // kw["batch_chunk"]) if kw["batch_chunk"] else 1
                names = (("fused_infer", "fused_train") if kw["fuse"]
                         else ("clause_eval", "class_sum", "ta_update"))
                eq = torch.equal(got, want)
                check(eq, f"mesh {spec} train {vname}: bank != the single-device step's")
                check(all(n_launch.get(k) == mesh.size * chunks for k in names),
                      f"mesh {spec} train {vname}: launches {n_launch}, expected "
                      f"{mesh.size * chunks} of each of {names}")
                train_rows.append(dict(
                    case="train_step", variant=vname, mesh=dict(mesh.shape),
                    shards=mesh.size, C_loc=cfg.n_clauses_total // mesh.shape["model"],
                    B_loc=B_loc, chunks=chunks, launches=n_launch, equal_single=eq,
                    ms=cuda_time_ms(lambda: step(ta, x, y, seed), reps=10),
                    single_ms=single_ms,
                    **profile_device(lambda: step(ta, x, y, seed), calls=MESH_WINDOW_CALLS,
                                     windows=MESH_WINDOWS)[0],
                    **{f"single_{k}": v for k, v in single_dev.items()}))
        mesh = mesh_mod.parse_mesh_spec("data=2,model=2", dev)
        mm_want = ops.tm_train_step_matmul(cfg, ta, x, y, seed)[0]
        mm_step = sharding.sharded_train_step_fn(cfg, mesh, algorithm="matmul")
        mm_eq = torch.equal(mm_step(ta, x, y, seed), mm_want)
        check(mm_eq, "mesh data=2,model=2 matmul: bank != tm_train_step_matmul's")
        train_rows.append(dict(
            case="train_step", variant="matmul", mesh=dict(mesh.shape), shards=mesh.size,
            C_loc=cfg.n_clauses_total // 2, equal_single=mm_eq,
            ms=cuda_time_ms(lambda: mm_step(ta, x, y, seed), reps=5),
            single_ms=cuda_time_ms(lambda: ops.tm_train_step_matmul(cfg, ta, x, y, seed),
                                   reps=5)))
        print(f"mesh train: {len(train_rows)} sharded steps == single-device steps")
        line["train_step"] = train_rows
        seconds["train_step"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # (c) fit on the mesh, a few steps
        Xf, Yf = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
        fit_kw = dict(epochs=1, batch_size=TRAIN_BATCH, rng=prng.PRNGKey(7), engine="kernel")
        st0 = tm.init(cfg, prng.PRNGKey(0), dev)
        t0 = time.perf_counter()
        plain = train.fit(cfg, st0, Xf, Yf, **fit_kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        zero()
        t0 = time.perf_counter()
        meshed = train.fit(cfg, st0, Xf, Yf, mesh=mesh, **fit_kw)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        fit_eq = torch.equal(plain.ta_state, meshed.ta_state)
        check(fit_eq, "mesh fit: the bank differs from fit without a mesh")
        fit_counts, fit_steps = counts(), int(meshed.steps) - int(st0.steps)
        check(all(fit_counts.get(k) == mesh.size * fit_steps
                  for k in ("fused_infer", "fused_train")),
              f"mesh fit: launches {fit_counts}, expected {mesh.size * fit_steps} of "
              f"fused_infer and fused_train ({mesh.size} shards x {fit_steps} steps)")
        line["fit"] = dict(mesh=dict(mesh.shape), steps=fit_steps, equal_single=fit_eq,
                           launches=fit_counts, wall_s=mesh_s, single_wall_s=plain_s)
        print(f"mesh fit: {meshed.steps} steps on {dict(mesh.shape)} == fit without a mesh")
        seconds["fit"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # (d) the launchers
        targs = ["--arch", "tm-mnist", "--device", dev.type, "--steps", str(MESH_TRAIN_STEPS),
                 "--batch-size", str(TRAIN_BATCH), "--n-train", "1000",
                 "--log-every", str(MESH_TRAIN_STEPS)]
        t0 = time.perf_counter()
        bank_plain, _ = train_launch.train_tm(train_launch.build_parser().parse_args(targs))
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
        zero()
        t0 = time.perf_counter()
        bank_mesh, _ = train_launch.train_tm(train_launch.build_parser().parse_args(
            targs + ["--mesh", "data=2,model=2"]))
        torch.cuda.synchronize()
        tm_s = time.perf_counter() - t0
        tt_counts = counts()
        tt_eq = torch.equal(bank_plain, bank_mesh)
        check(tt_eq, "mesh train_tm --mesh data=2,model=2: bank != the unsharded run's")
        check(tt_counts.get("fused_train") == 4 * MESH_TRAIN_STEPS,
              f"mesh train_tm: launches {tt_counts}")
        line["train_tm"] = dict(mesh="data=2,model=2", steps=MESH_TRAIN_STEPS,
                                equal_unsharded=tt_eq, launches=tt_counts,
                                wall_s=tm_s, unsharded_wall_s=tp_s)

        from torch.profiler import ProfilerActivity, profile

        sargv = ["--arch", "tm-mnist", "--artifact", ASSET, "--device", dev.type,
                 "--requests", "4096", "--bucket", str(BUCKET)]
        # in turns (unsharded, mesh, mesh, unsharded, ...), then each once
        # under the profiler for its device time
        runs = {"unsharded": dict(ms=[]), "mesh": dict(ms=[])}
        turns = [("unsharded", "mesh") if i % 2 == 0 else ("mesh", "unsharded")
                 for i in range(MESH_SERVE_TURNS)]
        for label in [lb for pair in turns for lb in pair]:
            extra = ["--mesh", "model=2"] if label == "mesh" else []
            zero()
            health, gw, _, preds, ms = serve_run(sargv + extra)
            runs[label].update(health=health, gw=gw, preds=preds, launches=counts())
            runs[label]["ms"].append(ms)
        for label in ("unsharded", "mesh"):
            extra = ["--mesh", "model=2"] if label == "mesh" else []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                serve.serve_tm(serve.build_parser().parse_args(sargv + extra))
                torch.cuda.synchronize()
            split = device_us(prof)
            runs[label]["device_ms"] = sum(u for u, _ in split.values()) / 1e3
            # the device time by kernel and by copy, largest first
            runs[label]["device_split_ms"] = {
                k: round(u / 1e3, 5) for k, (u, _) in
                sorted(split.items(), key=lambda kv: -kv[1][0])[:MESH_SPLIT_TOP]}
        h = runs["mesh"]["health"]
        n_b = h["buckets"]
        check(h["final_engine"] == "mesh-factorized" and h["demotions"] == []
              and h["probe_failures"] == []
              and h["engine_buckets"]["mesh-factorized"] == n_b,
              f"mesh serve_tm: {h['engine_buckets']}, demotions {h['demotions']}")
        check(runs["mesh"]["gw"]["answered"] == 4096 and runs["mesh"]["gw"]["unaccounted"] == 0,
              f"mesh serve_tm: gateway {runs['mesh']['gw']}")
        sv_eq = bool(np.array_equal(runs["mesh"]["preds"], runs["unsharded"]["preds"]))
        check(sv_eq, "mesh serve_tm --mesh model=2: predictions != the unsharded run's")
        check(runs["mesh"]["launches"].get("term_infer") == 2 * (n_b + 1),
              f"mesh serve_tm: launches {runs['mesh']['launches']}, expected term_infer "
              f"{2 * (n_b + 1)} (two shards, {n_b} buckets and the warm probe)")
        line["serve_tm"] = dict(
            mesh="model=2", requests=4096, bucket=BUCKET, buckets=n_b,
            engine_buckets=h["engine_buckets"], demotions=h["demotions"],
            equal_unsharded=sv_eq, launches=runs["mesh"]["launches"],
            unsharded_launches=runs["unsharded"]["launches"],
            ms=runs["mesh"]["ms"], unsharded_ms=runs["unsharded"]["ms"],
            median_ms=statistics.median(runs["mesh"]["ms"]),
            unsharded_median_ms=statistics.median(runs["unsharded"]["ms"]),
            device_ms=runs["mesh"]["device_ms"],
            unsharded_device_ms=runs["unsharded"]["device_ms"],
            device_split_ms=runs["mesh"]["device_split_ms"],
            unsharded_device_split_ms=runs["unsharded"]["device_split_ms"])
        print(f"mesh serve_tm --mesh model=2: {n_b} buckets on mesh-factorized, "
              "predictions == the unsharded run's")
        seconds["launchers"] = time.perf_counter() - t_part
        line["seconds"] = seconds
    finally:
        if saved_env is None:
            os.environ.pop(mesh_mod.FORCE_ENV, None)
        else:
            os.environ[mesh_mod.FORCE_ENV] = saved_env
    line["phase_s"] = time.perf_counter() - t_phase
    print("MESH " + json.dumps(line))
    return line


# the LM_MESH phase: 8 logical devices over the card; the two MoE families
# at full width cut to 2 layers (as LM_FAMILIES), served on data=2,model=4
# and on data=8,model=1 (every axis a data axis: serving's counterpart of the
# train step's pure_dp); the bf16 smoke MoE configs trained on data=2,model=4
# in both layouts; tinyllama-1.1b's step at LM_TRAIN's shape on
# data=2,model=2 against the single-device step; the int8 all-reduce
LM_MESH_DEVICES = 8
LM_MESH_FAMILIES = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
LM_MESH_LAYERS = 2
LM_MESH_SERVE = {"tp": {"data": 2, "model": 4}, "dp": {"data": 8, "model": 1}}
LM_MESH_B, LM_MESH_PROMPT, LM_MESH_DECODE = 16, 1024, 8
LM_MESH_TRAIN_STEPS, LM_MESH_TRAIN_B, LM_MESH_TRAIN_S = 2, 8, 256
LM_MESH_DENSE = {"data": 2, "model": 2}
LM_MESH_COMPRESS = (8, 1 << 20)          # shards, float32 elements a shard


def lm_mesh_phase(dev, card: str) -> None:
    """LM_MESH: the LM substrate on a mesh of ``LM_MESH_DEVICES`` logical
    devices laid over the card (``REPRO_TORCH_FORCE_DEVICE_COUNT``).

    (a) qwen3-moe-235b-a22b and deepseek-v2-236b at full width with
        ``LM_MESH_LAYERS`` layers: ``make_prefill_step(cfg, mesh)`` on B 16
        x 1024-token prompts and ``LM_MESH_DECODE`` decode steps, on each
        mesh of ``LM_MESH_SERVE``: MoE's experts run a (data, model) shard at
        a time, each shard's capacity from its own tokens.  Flash launches
        in the prefill (> 0), finite logits, the prefill's and the last
        decode step's last-token cross-entropy held to the same mesh step
        on the plain route (``FAMILIES_LOGIT_RTOL``: a bf16 rounding can
        move a token to another expert, as in LM_FAMILIES), and a warm
        profiled prefill and decode's event ms and device ms by profiler
        range (``moe_route``/``moe_experts`` once a shard);
    (b) ``make_train_step(cfg, mesh)`` for ``LM_MESH_TRAIN_STEPS`` steps of
        the MoE families' bf16 smoke configs on data=2,model=4, ``pure_dp``
        off and on: finite losses near ln V, flash launched;
    (c) tinyllama-1.1b at full width, LM_TRAIN's 4 x 1024, one step on
        ``LM_MESH_DENSE`` and one on no mesh from the same weights and
        batch: the dense layers are layout only, so the losses are equal
        bit for bit;
    (d) ``compress.quantize_psum`` over ``LM_MESH_COMPRESS`` shards, two
        rounds of error feedback, on the card and on the CPU: equal.

    Prints ``LM_MESH``."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw, compress

    saved_env = os.environ.get(mesh_mod.FORCE_ENV)
    os.environ[mesh_mod.FORCE_ENV] = str(LM_MESH_DEVICES)
    t_phase = time.perf_counter()
    line = dict(card=card, logical_devices=LM_MESH_DEVICES, note=MESH_NOTE)
    try:
        meshes = {k: mesh_mod.make_mesh(v, "cuda") for k, v in LM_MESH_SERVE.items()}
        B, P, n_new = LM_MESH_B, LM_MESH_PROMPT, LM_MESH_DECODE
        served = {}
        for arch in LM_MESH_FAMILIES:
            cfg = dataclasses.replace(get_config(arch), n_layers=LM_MESH_LAYERS)
            model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                            dev)
            rng = np.random.default_rng(0)
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).to(dev)
            labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, B)).to(dev)
            # the decode steps' tokens: the same on both routes
            fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n_new, B, 1))).to(dev)
            n_moe = sum(spec[1] == "moe" for spec in transformer.layer_specs(cfg))
            fam = {}
            for layout, mesh in meshes.items():
                prefill = steps.make_prefill_step(cfg, mesh)
                decode = steps.make_decode_step(cfg, mesh)

                def run():
                    caches = model.init_caches(B, P + n_new)
                    first, caches = prefill(model, {"tokens": tokens}, caches)
                    for i in range(n_new):
                        last, caches = decode(model, caches, {"tokens": fed[i]}, P + i)
                    return first, last

                fa.launches = fa.launches_wgmma = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first, last = run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launches = fa.launches
                check(launches == fa.launches_wgmma > 0,
                      f"{arch} {layout}: the mesh prefill launched the flash kernel "
                      f"{launches} times ({fa.launches_wgmma} tensor-core)")
                check(first.shape == (B, cfg.vocab_size)
                      and bool(torch.isfinite(first).all() and torch.isfinite(last).all()),
                      f"{arch} {layout}: logits {tuple(first.shape)} not finite")
                n0 = fa.launches
                with plain_flash(fa):
                    p_first, p_last = run()
                check(fa.launches == n0, f"{arch} {layout}: the plain route launched flash")
                row = dict(mesh=LM_MESH_SERVE[layout], flash_launches=launches,
                           first_run_ms=wall_ms,
                           prefill_against_plain_route=logits_agree(
                               f"{arch} {layout} prefill", first, p_first, labels, True),
                           decode_against_plain_route=logits_agree(
                               f"{arch} {layout} decode", last, p_last, labels, True))
                split = family_split(model, cfg, tokens, P + n_new, n_new, mesh)
                shards = math.prod(LM_MESH_SERVE[layout].values())
                for label, sp in split.items():
                    check(sp["device_ms"]["moe_experts"] > 0 and sp["device_ms"]["attention"] > 0,
                          f"{arch} {layout} {label}: no device time under the MoE or "
                          f"attention ranges: {sp['device_ms']}")
                row.update(split=split, moe_shard_ranges_a_pass=n_moe * shards)
                fam[layout] = row
                del first, last, p_first, p_last
            served[arch] = fam
            print(f"lm_mesh {arch}: " + json.dumps(fam))
            del model
            torch.cuda.empty_cache()
        line["serve"] = served

        trained = {}
        tmesh = meshes["tp"]
        for arch in LM_MESH_FAMILIES:
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
            for pure_dp in (False, True):
                model = transformer.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev)
                opt = adamw.adamw_init(model.parameters())
                step = steps.make_train_step(cfg, tmesh, pure_dp=pure_dp)
                nprng = np.random.default_rng(3)
                losses, norms, ms = [], [], []
                n0 = fa.launches_wgmma
                for _ in range(LM_MESH_TRAIN_STEPS):
                    batch = {k: torch.from_numpy(a).to(dev) for k, a in train.lm_batch(
                        cfg, nprng, LM_MESH_TRAIN_B, LM_MESH_TRAIN_S).items()}
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    opt, info = step(model, opt, batch)
                    ev[1].record()
                    torch.cuda.synchronize()
                    losses.append(float(info["loss"]))
                    norms.append(float(info["grad_norm"]))
                    ms.append(ev[0].elapsed_time(ev[1]))
                want = math.log(cfg.vocab_size) + 0.5
                n_flash = fa.launches_wgmma - n0
                check(n_flash > 0 and all(np.isfinite(losses + norms))
                      and all(abs(x - want) <= FAMILIES_LOSS_ATOL for x in losses),
                      f"{cfg.name} pure_dp={pure_dp}: losses {losses} (ln V + 0.5 = {want}), "
                      f"grad norms {norms}, flash launches {n_flash}")
                trained[f"{cfg.name}|{'dp' if pure_dp else 'tp'}"] = dict(
                    losses=losses, grad_norms=norms, step_event_ms=ms, flash_launches=n_flash)
                del model, opt
        line["train_smoke"] = trained

        # (c) the dense model: a mesh step is the single-device step
        cfg = get_config("tinyllama-1.1b")
        dmesh = mesh_mod.make_mesh(LM_MESH_DENSE, "cuda")
        batch = {k: torch.from_numpy(a).to(dev) for k, a in train.lm_batch(
            cfg, np.random.default_rng(4), 4, 1024).items()}
        dense = {}
        for label, mesh in (("one_device", None), ("on_mesh", dmesh)):
            model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                            dev)
            opt = adamw.adamw_init(model.parameters())
            n0 = fa.launches_wgmma
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            opt, info = steps.make_train_step(cfg, mesh)(model, opt, batch)
            ev[1].record()
            torch.cuda.synchronize()
            dense[label] = dict(loss=float(info["loss"]), grad_norm=float(info["grad_norm"]),
                                step_event_ms=ev[0].elapsed_time(ev[1]),
                                flash_launches=fa.launches_wgmma - n0)
            del model, opt, info
            torch.cuda.empty_cache()
        check(dense["on_mesh"]["loss"] == dense["one_device"]["loss"]
              and dense["on_mesh"]["flash_launches"] == dense["one_device"]["flash_launches"] > 0,
              f"tinyllama-1.1b on {LM_MESH_DENSE} against one device: {dense}")
        line["dense"] = dict(mesh=LM_MESH_DENSE, batch=[4, 1024], **dense)

        # (d) the int8 all-reduce with error feedback, card against CPU
        n_sh, n_el = LM_MESH_COMPRESS
        g = torch.from_numpy(np.random.default_rng(5).normal(
            size=(n_sh, n_el)).astype(np.float32))
        outs = {}
        for where in ("cpu", dev):
            gs = [x.to(where) for x in g]
            errs = [torch.zeros_like(x) for x in gs]
            rounds = []
            for _ in range(2):
                mean, errs = compress.quantize_psum(gs, errs)
                rounds.append((mean.cpu(), [e.cpu() for e in errs]))
            outs[str(where)] = rounds
        same = all(torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
                   for a, b in zip(outs["cpu"], outs[str(dev)]))
        exact = g.mean(0)
        err_max = float((outs[str(dev)][0][0] - exact).abs().max())
        check(same, "compress.quantize_psum on the card differs from its CPU result")
        line["compress"] = dict(shards=n_sh, elements=n_el, card_equals_cpu=same,
                                round1_max_abs_err_vs_mean=err_max,
                                scale=float(g.abs().max()) / 127)
    finally:
        if saved_env is None:
            os.environ.pop(mesh_mod.FORCE_ENV, None)
        else:
            os.environ[mesh_mod.FORCE_ENV] = saved_env
    line["phase_s"] = time.perf_counter() - t_phase
    print("LM_MESH " + json.dumps(line))


# the DRYRUN phase's full-width cell, and LM_TRAIN's shape on one device
DRYRUN_CELL = ("tinyllama-1.1b", "train_4k", "pod")


def dryrun_phase(card: str, lm_train_step_ms: float) -> None:
    """DRYRUN (no card needed): ``dryrun.run_cell`` on ``DRYRUN_CELL`` at
    full width on the meta device, its record printed; then LM_TRAIN's own
    step (tinyllama-1.1b, 4 x 1024, one device) traced on meta, and its
    roofline bound on the card's datasheet peaks beside that phase's
    measured step ms, as ``bound_ms / step_ms``.  The bound is the larger
    of two terms: the traced FLOPs (remat's recompute included) over the
    bf16 peak, and the bytes the step must move over the memory rate:
    parameters, AdamW's moments and step read and written once, the batch
    read once, the gradients written and read once (the global-norm clip
    needs them all before the first update), and each block's input that
    remat keeps, written in the forward and read in the backward.  The
    eager op stream's bytes (every intermediate written and read back, the
    plain chunked attention in the flash kernel's place) are printed apart,
    as ``eager_bytes_ms``: they bound nothing."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, op_analysis, roofline, specs
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models import steps
    import torch
    from repro_torch.optim import adamw

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    t_phase = time.perf_counter()
    rec = dryrun.run_cell(*DRYRUN_CELL)
    check(rec["n_devices"] == 256 and all(rec[k] > 0 for k in (
        "flops", "hbm_bytes", "coll_bytes", "arg_bytes", "temp_bytes", "output_bytes")),
        f"dry-run cell {DRYRUN_CELL}: {rec}")
    print("DRYRUN_CELL " + json.dumps(rec))
    cfg = get_config("tinyllama-1.1b")
    B, S = 4, 1024
    shapes = {"lm_train": specs.ShapeSpec("lm_train", S, B, "train")}
    model = specs.meta_model(cfg)
    opt = adamw.adamw_init(model.parameters())
    batch = specs.input_specs(cfg, "lm_train", shapes)
    _, an = op_analysis.analyze(steps.make_train_step(cfg), model, opt, batch)
    params = list(model.parameters())
    act = torch.empty((), dtype=params[0].dtype).element_size()
    state = nbytes(params) + nbytes(opt.m) + nbytes(opt.v) + 4
    kept = cfg.n_layers * B * S * cfg.d_model * act
    need = 2 * state + nbytes(batch.values()) + 2 * nbytes(params) + 2 * kept
    t_comp = an.cost.flops / PEAK_FLOPS_BF16 * 1e3
    t_mem = need / HBM_BW * 1e3
    bound_ms = roofline.bound_seconds(an.cost.flops, need) * 1e3
    mf = roofline.model_flops(cfg, "train", B, S)
    check(bound_ms > 0 and lm_train_step_ms > 0, "the LM_TRAIN bound or step is 0")
    print("DRYRUN " + json.dumps(dict(
        card=card, cell=dict(zip(("arch", "shape", "mesh"), DRYRUN_CELL)),
        cell_bottleneck=rec["bottleneck"],
        cell_bottleneck_approximate=rec["bottleneck_approximate"],
        cell_trace_s=rec["compile_seconds"],
        lm_train=dict(arch=cfg.name, batch=[B, S], devices=1, flops=an.cost.flops,
                      bytes_needed=need, t_comp_ms=t_comp, t_mem_ms=t_mem,
                      bound_ms=bound_ms, bound_by="operations" if t_comp >= t_mem else "bytes",
                      eager_bytes=an.cost.bytes, eager_bytes_ms=an.cost.bytes / HBM_BW * 1e3,
                      model_flops=mf, model_flops_ms=mf / PEAK_FLOPS_BF16 * 1e3,
                      step_ms=lm_train_step_ms, bound_over_step=bound_ms / lm_train_step_ms,
                      compute_over_step=t_comp / lm_train_step_ms),
        phase_s=time.perf_counter() - t_phase)))


def main() -> None:
    t_start = time.perf_counter()
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
        from repro_torch.kernels import (_build, class_sum, fused_infer, ref, sparse_infer,
                                         term_infer)
        from repro_torch.launch import serve
    except ImportError as e:
        fail(f"the port's package is not importable from {ROOT}/src: {e}")
    mods = {"fused_infer": fused_infer, "sparse_infer": sparse_infer,
            "term_infer": term_infer}
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # float32 products in full float32 (the plain versions' and the BNN's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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
    # profiler, split by launch: the event times above also hold the host's
    # launch work
    for name in KERNELS:
        for margin_on in ([False] if name == "fused_infer" else [False, True]):
            dev_ms, per = profile_device(calls(name, xw_all[:BUCKET].contiguous(), margin_on)[0],
                                         key="early_exit_device_ms" if margin_on else "device_ms")
            times[name][BUCKET].update(dev_ms)
            print(f"{name} device work per call at B={BUCKET}"
                  f"{' (early exit)' if margin_on else ''}: {json.dumps(per)}")
    K = votes.shape[1]
    # class_sum on the unfused dense rung's shape: the bucket's fire matrix
    # over the artifact's clauses (int8, as clause_fire gives it)
    fired = ref.clause_fire_ref(xw_all[:BUCKET].contiguous(), inc)
    a = (fired, votes)
    got, want = class_sum.class_sum_cuda(*a), class_sum.class_sum_plain(*a)
    torch.cuda.synchronize()
    cs_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(cs_err == 0, f"class_sum B={BUCKET}: kernel differs from its plain version by {cs_err}")
    U = fired.shape[1]
    cs_serve = dict(shape=dict(B=BUCKET, C=U, K=K),
                    ms=cuda_time_ms(lambda: class_sum.class_sum_cuda(*a)),
                    plain_ms=cuda_time_ms(lambda: class_sum.class_sum_plain(*a), reps=5),
                    **profile_device(lambda: class_sum.class_sum_cuda(*a))[0],
                    occupancy=class_sum.occupancy(BUCKET, U, K))
    cs_serve["bound_ms"], cs_serve["bound_by"] = bound(
        nbytes(fired, votes) + BUCKET * K * 4, BUCKET * U * K / INT32_OPS_PER_S * 1e3)
    print("CLASS_SUM_SERVE " + json.dumps(cs_serve))
    print("INFER_OCCUPANCY " + json.dumps(dict(
        B=BUCKET, C=inc.shape[0], W=inc.shape[1], K=K,
        fused_infer=fused_infer.occupancy(BUCKET, inc.shape[0]),
        sparse_infer=sparse_infer.occupancy(BUCKET, sched.n_cblocks, sched.block_c, K),
        term_infer=term_infer.occupancy(BUCKET, fsched.n_cblocks, fsched.block_c, K))))
    # 5b. term_infer's slab design at the benchmark's batch (SLAB)
    slab = slab_phase(dev)

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
        health, gw, *_ = serve.serve_tm(serve.build_parser().parse_args(argv))
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
    from torch.profiler import ProfilerActivity, profile

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

    # 7. the training path, its kernels, resume, train -> compile -> serve
    for name in TRAIN_KERNELS:
        max_err[name] = 0
    max_err["class_sum"] = cs_err
    train_times, train_work = train_phases(dev, max_err, launches)

    # 7b. the reference's jax.random trainer: serve_tm trains the committed
    # artifact again (JNP_TRAIN)
    jnp_train_phase(dev, card)

    # 8. the online loop (live bank, drill, serve --online) and the zoo
    online_phase(dev)

    # 9. the BNN baseline and the LM serving path
    extra_rows = {"xnor_popcount": (BNN_KERNEL, bnn_phase(dev)),
                  "flash_attention": (FLASH_KERNEL, lm_phase(dev))}

    # 9b. the LM training path (LM_TRAIN): the flash row's train_* fields
    extra_rows["flash_attention"][1].update(lm_train_phase(dev, card))

    # 9c. the MoE, MLA, RG-LRU and xLSTM families (LM_FAMILIES): the flash
    # row's qwen3_* and mla_* fields, the kernel at qwen3-moe's serve shape
    # and at MLA's qk width 192 over v width 128
    extra_rows["flash_attention"][1].update(lm_families_phase(dev, card))

    # 10. the autotuner and its cost model (AUTOTUNE)
    autotune_phase(dev, compiled, xp_all, xw_all)

    # 10b. the clause-sharded mesh over logical devices on the card (MESH)
    mesh_phase(dev, card, compiled, xp_all)

    # 10c. the LM substrate on a mesh of logical devices on the card (LM_MESH)
    lm_mesh_phase(dev, card)

    # 10d. the dry-run on the meta device, and LM_TRAIN's roofline share (DRYRUN)
    dryrun_phase(card, extra_rows["flash_attention"][1]["train_step_ms"])

    # 11. the kernels line.  Bound: the bytes the function must move (each
    # input it reads once, the output once; for the schedule kernels the
    # chain ids this run's walk needs, not the padded tables) over the
    # memory rate, against its integer operations over the issue rate
    B = BUCKET
    xw = xw_all[:B]
    fired = ref.clause_fire_ref(xw, inc).to(torch.int64)
    fold_ops = int(fired.sum()) * votes.shape[1]
    U, K = votes.shape
    io_bytes = nbytes(xw, votes) + B * K * 4
    lit_t = sparse_infer.bit_transpose_literals(xw, xw.shape[1] * 32)
    s_bytes, s_ops = chain_need(
        lit_t, stab["chain_ids"], stab["tiles"][1], stab["indptr"], n_rows=U,
        block_c=sched.block_c, block_j=sched.block_j, tile_off=0,
        sentinel=sched.n_lit_bits)
    work = {
        # one three-input logic op (viol |= inc & ~lit) per sample, clause, word
        "fused_infer": (io_bytes + nbytes(inc, nonempty),
                        B * inc.shape[0] * inc.shape[1] + fold_ops),
        "sparse_infer": (io_bytes + s_bytes + 2 * sched.n_tiles * 4
                         + nbytes(stab["indptr"]),
                         s_ops + fold_ops),
        "term_infer": factorized_work(xw, inc, votes, fsched, ftab),
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
                   library_ms=None, library_device_ms=None,
                   library_device_ms_spread=None,
                   library_note="no single PyTorch call computes this function",
                   tolerance=0)
        for extra in ("device_ms", "device_ms_spread", "early_exit_ms",
                      "early_exit_device_ms", "early_exit_device_ms_spread"):
            if extra in times[name][B]:
                row[extra] = times[name][B][extra]
        if name in train_times:   # fused_infer: also its launch in every fused step
            row.update({f"train_{k}": v for k, v in train_times[name].items()})
        if name == "term_infer":  # also its slab design at the benchmark's batch
            row["slab"] = slab
        rows.append(row)
    for name, meta in TRAIN_KERNELS.items():
        nb, ops = train_work[name]
        t_bytes, t_ops = nb / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        tt = train_times[name]
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[name],
                   max_abs_err=max_err[name], ms=tt["ms"], plain_ms=tt["plain_ms"],
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=tt.get("library_ms"),
                   library_device_ms=tt.get("library_device_ms"),
                   library_device_ms_spread=tt.get("library_device_ms_spread"),
                   device_ms=tt["device_ms"], device_ms_spread=tt["device_ms_spread"],
                   tolerance=0)
        if row["library_ms"] is None:
            row["library_note"] = "no single PyTorch call computes this function"
        if name == "class_sum":   # also its launch on the unfused dense rung
            row.update({f"serve_{k}": v for k, v in cs_serve.items() if k != "occupancy"})
        rows.append(row)
    for name, (meta, r) in extra_rows.items():
        rows.append(dict(name=name, route="cuda", source=meta["source"],
                         replaces=meta["replaces"], **r))
    check(len(rows) == 9 and all(r["launches"] > 0 and r["max_abs_err"] <= r["tolerance"]
                                 for r in rows), "kernels line incomplete")
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
