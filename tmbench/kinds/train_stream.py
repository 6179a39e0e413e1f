"""Traffic kind ``train_stream``: the hash-RNG training step in a closed
loop, batches of ``batch`` samples.

Set-up makes a pool of ``pool`` samples on the card (``datagen``: the
configuration's dataset prototypes, the rows drawn from the run's seed),
the initial bank (automata uniform in {-1, 0}, padded clauses at
``-n_states``, as ``tm.init`` draws them) and the epochs' orders
(``ShardedBatcher``'s, for the first ``orders`` epochs, then again from
the first), all from the run's seed; the seed also picks which step of
the window is checked besides the last.  It then drives the bank through
the window's own call and feed for ``checked_steps`` steps, keeping each
bank.  The window continues from there: step ``s`` (seeded with ``s``)
gathers its batch on the card and calls ``ops.tm_train_step_kernel(config,
bank, x, y, s)``; the host does not wait for a step, and the window ends
when the last step it issued has finished.

The check runs the reference's steps from the initial bank over the
set-up steps' batches and compares each bank with the program's, automaton
by automaton, and two steps of the window, the last and one drawn from the
seed, each from the program's bank before it.  A traced run keeps every
bank of the window, so that the work of each step can be counted from the
reference's feedback afterwards.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tmbench import datagen, work
from tmbench.reference import tm_reference

# the keys of a configuration that name files this kind reads: none, the
# pool and the bank are drawn from the seed
CONFIG_FILES = ()

# share of the card's free memory set aside, in a traced run, for the banks
# the window keeps
KEEP_SHARE = 0.5


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.model = ctx.config["model"]
        self.tmc = tm_reference.TM(self.model)

    def setup(self) -> None:
        from repro_torch.core.tm import TMConfig
        from repro_torch.kernels import ops

        ctx, dev, m = self.ctx, self.ctx.device, self.model
        self.step_fn = ops.tm_train_step_kernel
        self.config = TMConfig(
            n_features=m["n_features"], n_classes=m["n_classes"],
            clauses_per_class=m["clauses_per_class"], n_states=m["n_states"],
            threshold=m["threshold"], s=m["s"],
            boost_true_positive=m["boost_true_positive"],
            clause_pad_multiple=m["clause_pad_multiple"])
        N, B = self.tr["pool"], self.tr["batch"]
        data = ctx.config["data"]
        protos = datagen.prototypes(data["dataset"], data["data_seed"])
        seed = ctx.seed
        self.X, self.Y = datagen.sample(protos, N, datagen.generator(seed, "train_pool", dev), dev)
        self.orders = torch.from_numpy(np.stack(
            [datagen.epoch_order(seed, e, N) for e in range(self.tr["orders"])])).to(dev)
        self.per_epoch = N // B
        g = datagen.generator(seed, "bank", dev)
        tmc = self.tmc
        bank = torch.randint(-1, 1, (tmc.C, tmc.L), generator=g, device=dev, dtype=torch.int8)
        bank[tmc.C_raw:] = -tmc.n_states
        self.bank0 = bank.clone()
        self.banks = []
        for s in range(self.tr["checked_steps"]):
            bank = self.step(bank, s)
            self.banks.append(bank.clone())
        datagen.sync(dev)
        self.bank, self.first = bank, self.tr["checked_steps"]

    def batch(self, s: int):
        e, k = divmod(s, self.per_epoch)
        B = self.tr["batch"]
        idx = self.orders[e % self.orders.shape[0], k * B:(k + 1) * B]
        return self.X.index_select(0, idx), self.Y.index_select(0, idx)

    def step(self, bank, s: int):
        tr = self.ctx.tracer
        with tr.range("tmbench.feed"):
            x, y = self.batch(s)
        with tr.range("tmbench.step"):
            new, _ = self.step_fn(self.config, bank, x, y, s)
        return new

    def window(self, seconds: float) -> dict:
        dev = self.ctx.device
        keep = self.ctx.tracer.enabled
        if keep and dev.type == "cuda":
            # room for the kept banks, so that the window allocates nothing
            # new; the set-aside is not part of the run's memory peak
            self.peak_setup = torch.cuda.max_memory_allocated(dev)
            free, _ = torch.cuda.mem_get_info(dev)
            spare = torch.empty(int(free * KEEP_SHARE), dtype=torch.uint8, device=dev)
            del spare
            torch.cuda.reset_peak_memory_stats(dev)
        self.kept = []
        rng = np.random.default_rng(datagen.sub_seed(self.ctx.seed, "checked_step"))
        bank, s = self.bank, self.first
        t0 = time.perf_counter()
        while s == self.first or time.perf_counter() - t0 < seconds:
            if keep:
                self.kept.append(bank)
            self.prev = bank
            bank = self.step(bank, s)
            if rng.integers(0, s - self.first + 1) == 0:     # reservoir of one step
                self.sampled = (s, self.prev, bank)
            s += 1
        datagen.sync(dev)
        t1 = time.perf_counter()
        self.bank, self.last = bank, s - 1
        n = s - self.first
        B = self.tr["batch"]
        return dict(kind="train", window_s=t1 - t0, steps=n, items=n * B,
                    attempted=n * B, failed=0)

    def check(self) -> list:
        """``[(name, value, limit)]``: automata that differ from the
        reference's after the set-up steps, and after the window's last
        step and its step drawn from the seed, each from the program's
        bank before it."""
        bad = 0
        bank = self.bank0
        for s, got in enumerate(self.banks):
            x, y = self.batch(s)
            bank, _, _ = tm_reference.train_step(self.tmc, bank, x, y, s)
            bad += int((bank != got).sum())
        window = 0
        for s, before, after in ((self.last, self.prev, self.bank), self.sampled):
            x, y = self.batch(s)
            want, _, _ = tm_reference.train_step(self.tmc, before, x, y, s)
            window += int((want != after).sum())
        return [("first_steps_mismatch", bad, 0), ("window_steps_mismatch", window, 0)]

    def controls(self) -> dict:
        """Readings of the control and the faults, each put in the
        program's place and compared as ``check`` compares: the reference
        with its selection probabilities and draws in bfloat16, a step
        that returns its bank unchanged, and a step over the first half of
        the batch only."""
        tmc = self.tmc
        out = {"control_bf16_first": 0, "control_bf16_last": 0,
               "fault_unchanged_first": 0, "fault_half_batch_first": 0}
        want = low = self.bank0
        for s in range(len(self.banks)):
            x, y = self.batch(s)
            prev = want
            want, _, _ = tm_reference.train_step(tmc, prev, x, y, s)
            low, _, _ = tm_reference.train_step(tmc, low, x, y, s, probs_dtype=torch.bfloat16)
            half, _, _ = tm_reference.train_step(tmc, prev, x[:x.shape[0] // 2],
                                                 y[:x.shape[0] // 2], s)
            out["control_bf16_first"] += int((low != want).sum())
            out["fault_unchanged_first"] += int((prev != want).sum())
            out["fault_half_batch_first"] += int((half != want).sum())
        x, y = self.batch(self.last)
        want, _, _ = tm_reference.train_step(tmc, self.prev, x, y, self.last)
        low, _, _ = tm_reference.train_step(tmc, self.prev, x, y, self.last,
                                            probs_dtype=torch.bfloat16)
        out["control_bf16_last"] = int((low != want).sum())
        return out

    def bounds(self) -> dict:
        """Bounds (seconds) of the window's steps, summed, from the
        reference's feedback on each kept bank: ``{"step", "fused_train"}``."""
        pk, m, tmc = work.peaks(), self.model, self.tmc
        out = {"step": 0.0, "fused_train": 0.0}
        for i, bank in enumerate(self.kept):
            s = self.first + i
            x, y = self.batch(s)
            fire, ftype = tm_reference.train_feedback(tmc, bank, x, y, s)
            w = work.train_step(fire, ftype, y, tmc.F, tmc.L, tmc.K, tmc.cpc)
            for k in out:
                out[k] += work.bound_s(w[k]["ops"], w[k]["bytes"], pk)
        self.kept = []
        return out
