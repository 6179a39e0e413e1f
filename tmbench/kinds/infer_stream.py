"""Traffic kind ``infer_stream``: one client in a closed loop streams batches
of packed literal words through the artifact runner.

Set-up loads the configuration's serving artifact with the program's
loader, makes ``pool_batches`` batches of ``batch`` datapoints from the
seed (``datagen``), packs them and keeps them in pinned host memory, and
warms the loop's one shape.  Each batch of the window is copied to the
card (``non_blocking``), run through ``run_compiled(compiled, x,
engine="auto")`` and its (B, K) class sums are read back into pinned host
memory; the read ends the batch, and its latency runs from the copy's
issue to the sums on the host.  Batch ``i`` is pool batch ``i % pool``.

The check compares the class sums of ``checked_batches`` batches of the
window, drawn from the seed (reservoir sampling), entry by entry with the
reference's, which computes them from the trained bank the artifact was
compiled from (the configuration's ``serve_bank``), not from the
artifact's rows.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tmbench import datagen, work
from tmbench.reference import tm_reference

# the keys of a configuration that name files this kind reads
CONFIG_FILES = ("serve_artifact", "serve_bank")

# the program's launch counters that tell which route "auto" took
ROUTES = {"factorized": "term_infer", "sparse": "sparse_infer", "dense": "fused_infer"}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.model = ctx.config["model"]
        self.artifact = os.path.join(ctx.root, ctx.config["serve_artifact"])
        self.bank = os.path.join(ctx.root, ctx.config["serve_bank"])

    def setup(self) -> None:
        import importlib

        from repro_torch.core.compiler import CompiledTM, run_compiled

        ctx, dev = self.ctx, self.ctx.device
        self.run_compiled = run_compiled
        self.compiled = CompiledTM.load(self.artifact)
        B, P = self.tr["batch"], self.tr["pool_batches"]
        data = ctx.config["data"]
        protos = datagen.prototypes(data["dataset"], data["data_seed"])
        g = datagen.generator(ctx.seed, "infer_stream", dev)
        W = datagen.n_words(2 * self.model["n_features"])
        pin = dev.type == "cuda"
        self.pool = torch.empty((P, B, W), dtype=torch.int32, pin_memory=pin)
        for i in range(P):
            x, _ = datagen.sample(protos, B, g, dev)
            self.pool[i].copy_(datagen.pack_literals(x))
        self.out = torch.empty((B, self.model["n_classes"]), dtype=torch.int32,
                               pin_memory=pin)
        mods = {r: importlib.import_module(f"repro_torch.kernels.{m}")
                for r, m in ROUTES.items()}
        before = {r: m.launches for r, m in mods.items()}
        for i in range(self.tr["warmup_batches"]):
            self.batch(i % P)
        self.route = {r: m.launches - before[r] for r, m in mods.items()
                      if m.launches > before[r]}

    def batch(self, i: int):
        tr = self.ctx.tracer
        with tr.range("tmbench.h2d"):
            xd = self.pool[i].to(self.ctx.device, non_blocking=True)
        t0 = time.perf_counter()
        with tr.range("tmbench.runner"):
            sums = self.run_compiled(self.compiled, xd, engine="auto")
        t1 = time.perf_counter()
        with tr.range("tmbench.readback"):
            self.out.copy_(sums, non_blocking=True)
            datagen.sync(self.ctx.device)
        return t1 - t0

    def window(self, seconds: float) -> dict:
        P, k = self.tr["pool_batches"], self.tr["checked_batches"]
        rng = np.random.default_rng(datagen.sub_seed(self.ctx.seed, "checked_batches"))
        kept, lat, runner = [], [], []
        i = 0
        t0 = time.perf_counter()
        while True:
            ti = time.perf_counter()
            runner.append(self.batch(i % P))
            te = time.perf_counter()
            lat.append(te - ti)
            if i < k:
                kept.append((i, self.out.clone()))
            else:
                j = int(rng.integers(0, i + 1))
                if j < k:
                    kept[j] = (i, self.out.clone())
            i += 1
            if te - t0 >= seconds:
                break
        self.kept = kept
        self.n_batches = i
        B = self.tr["batch"]
        return dict(kind="infer", window_s=te - t0, batches=i, items=i * B,
                    attempted=i * B, failed=0, latencies_s=lat,
                    spans={"runner": runner}, route=self.route)

    def check(self) -> list:
        """``[(name, value, limit)]``: the class sums that differ from the
        reference's over the checked batches."""
        dev = self.ctx.device
        self.ref = tm_reference.Bank(self.bank, tm_reference.TM(self.model), dev)
        P = self.tr["pool_batches"]
        want = {}
        bad = 0
        for i, got in self.kept:
            p = i % P
            if p not in want:
                want[p] = tm_reference.infer_class_sums(self.ref, self.pool[p].to(dev)).cpu()
            ref = want[p]
            if tuple(got.shape) != tuple(ref.shape):
                bad += ref.numel()
            else:
                bad += int((got.to(torch.int64) != ref).sum())
        return [("sums_mismatch", bad, 0)]

    def controls(self) -> dict:
        """Readings of the control and the faults, each put in the
        program's place over the checked batches and compared as
        ``check`` compares: the reference serving every clause but each
        ``control_drop_every``-th (a clause budget, which breaks the
        guarantee that every clause votes), and half of each batch left
        out (its sums zero)."""
        dev, P = self.ctx.device, self.tr["pool_batches"]
        keep = self.ref.keep_all_but_every(self.tr["control_drop_every"])
        out = {"control_dropped_clauses": 0, "fault_half_batch": 0}
        for p in sorted({i % P for i, _ in self.kept}):
            n = sum(i % P == p for i, _ in self.kept)
            x = self.pool[p].to(dev)
            want = tm_reference.infer_class_sums(self.ref, x)
            pre = tm_reference.infer_class_sums(self.ref, x, keep=keep)
            half = want.clone()
            half[want.shape[0] // 2:] = 0
            out["control_dropped_clauses"] += n * int((pre != want).sum())
            out["fault_half_batch"] += n * int((half != want).sum())
        return out

    def bounds(self) -> dict:
        """Bounds (seconds) of the window's work, summed over its batches:
        ``{"step": ..., "term_infer": ...}`` (one batch's work is the
        kernel's), counted from the artifact's rows."""
        dev, pk = self.ctx.device, work.peaks()
        P = self.tr["pool_batches"]
        rows = work.ArtifactRows(self.artifact, dev)
        per = []
        for p in range(P):
            fire = rows.fire(self.pool[p].to(dev))
            w = work.infer_batch(fire, rows.votes, rows.n_active_words)
            per.append(work.bound_s(w["ops"], w["bytes"], pk))
        total = sum(per[i % P] for i in range(self.n_batches))
        return {"step": total, "term_infer": total}
