"""Traffic kind ``longcat_prefill``: one client in a closed loop prefills
batches of prompts through the port's serving path of a LongCat-Flash
configuration.

The configuration file keeps the model's ``config.json`` at its top level
with the held counts (double layers, FFN experts, vocabulary rows) at their
held values, and the published values in ``published``; its ``deployment``
names the FFN experts this chip holds.  Set-up builds the model with
``configs.longcat_flash_560b.from_config_json`` from the published values
and the held layout (``transformer.Transformer`` on ``meta``), draws the
held share's weights from the seed on the card under the plain reference's
names and scales (``reference.weight_shapes``), each weight from its own
stream (``datagen.generator(seed, "weights/" + name)``) and rounded to the
configuration's bf16, loads them into the model (``load_state_dict``,
strict: the program must hold exactly those names and shapes), and makes
a pool of ``pool_per_shape`` batches of each of ``shapes`` ([prompt
tokens, prompts]) in pinned host memory, in the order of ``shapes``
repeated; window batch ``i`` is pool batch ``i % pool``.  Token ids follow
Zipf's law: rank r is drawn with probability proportional to
r^-``zipf_exponent`` over the held vocabulary rows, and the ranks map to
rows through a permutation drawn from the seed.  Each shape has its caches
(``model.init_caches``: two latent caches a double layer), reused from
position 0 each batch, and a pinned logits buffer.  Every pool batch is
warmed up in set-up (a batch's routing sets the row counts of the experts'
products, and a count's first product is slow).  A program without
``configs/longcat_flash_560b.py`` exits with 2 in set-up.

A batch: the token ids copied to the card (``non_blocking``),
``steps.make_prefill_step``'s step with the caches written, and the
last-position logits (B, V) read back into pinned memory; the read ends
the batch, and its latency runs from issuing the copy to the logits on
the host.  A datapoint is a prompt token: ``items`` counts them.  The
window runs at least one batch of every shape.

The check takes the first window batch of each shape (its logits and a
copy of its latent caches, made after its latency was taken), frees the
program's model, and runs the plain reference's float32 forward of the
same prompts on the same weights (``reference/longcat_flash_reference.py``),
drawn again from the seed one double layer at a time, over the layers,
experts and vocabulary rows the configuration file holds:

* ``logits_err``: the relative Frobenius error of the last-position logits
  over all those prompts together;
* ``cache_err``: the largest over the 2 L MLA sublayers of the relative
  Frobenius error of the latent cache (``c_kv`` and ``k_rope``) over every
  position;
* ``moe_err``: the relative Frobenius error of the first double layer's
  expert layer over those prompts: the program's (``moe.moe_ff`` on that
  layer's weights in float32) against the reference's, both on the
  reference's input.  The router's rule is checked here, in float32, where
  bf16 rounding does not hide it: the router's bias used in the gates too
  changes a chosen gate by ~15%, and the caches and logits no more than
  bf16 rounding does.

The limits lie between the sound runs' readings and the controls' (PERF.md
§2 gives both), each put in the program's place: the MoE output added
right after FFN_0 with no shortcut, the identity experts adding nothing,
the router's bias used in the gates too, MLA without its LoRA scales, and
every linear weight rounded through float8 e4m3 with a per-tensor scale, a
precision below the configuration's bf16.
"""

from __future__ import annotations

import sys
import time

import torch

from tmbench import datagen, longcat_work, work
from tmbench.kinds.lm_prefill import _fp8, _rel_parts
from tmbench.reference import longcat_flash_reference as reference

CONFIG_FILES = ()

# relative Frobenius errors against the float32 reference (PERF.md §2).
# The port's bf16 run: sound runs read 0.014-0.020 (logits, 15 last
# positions) and 0.016-0.018 (caches), float8 e4m3 weights 0.15-0.17 on
# both, the MoE added with no shortcut, the identity experts dropped and
# no LoRA scales 0.34 or more.  The first expert layer in float32: sound
# runs read up to 0.0012 (a few tokens whose choice flips on a rounding
# tie), the bias in the gates 0.057-0.099, which moves the caches and
# logits no more than bf16 does (0.02-0.04)
LIMITS = {"logits_err": 0.06, "cache_err": 0.05, "moe_err": 0.02}


class Cell:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic
        cfg = ctx.config
        # the published config.json: the catalog's keys with their published values
        self.published = dict(cfg, **cfg["published"])
        self.held, self.deployment = cfg["held"], cfg["deployment"]
        self.dims = longcat_work.dims(cfg)
        self.experts = range(*self.deployment["experts"])
        if len(self.experts) != self.held["n_routed_experts"]:
            raise ValueError(f"experts {self.deployment['experts']} are not "
                             f"{self.held['n_routed_experts']}")
        self.spec = dict(self.published, held_experts=self.deployment["experts"],
                         held_layers=self.held["num_layers"],
                         held_vocab=self.held["vocab_size"])
        self.shapes_w = reference.weight_shapes(self.spec)

    def setup(self) -> None:
        try:
            from repro_torch.configs.longcat_flash_560b import from_config_json
        except ImportError as e:
            print(f"tmbench: the program has no LongCat-Flash configuration: {e}", file=sys.stderr)
            raise SystemExit(2) from e
        from repro_torch.models import steps, transformer

        ctx, dev, tr = self.ctx, self.ctx.device, self.tr
        self.cfg = from_config_json(self.published, experts=self.experts,
                                    n_layers=self.held["num_layers"],
                                    vocab_rows=self.held["vocab_size"],
                                    dtype=ctx.config["torch_dtype"])
        self.model = transformer.Transformer(self.cfg, None, device="meta")
        dtypes = {k: v.dtype for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(
            self._draw(self.shapes_w, lambda k: dtypes.get(k, torch.float32)),
            strict=True, assign=True)
        self.step = steps.make_prefill_step(self.cfg)
        self.shapes = [tuple(s) for s in tr["shapes"]]
        V = self.held["vocab_size"]
        g = datagen.generator(ctx.seed, "prompts", dev)
        rank_p = torch.arange(1, V + 1, dtype=torch.float64, device=dev) ** -tr["zipf_exponent"]
        rows = torch.randperm(V, generator=g, device=dev)
        pin = dev.type == "cuda"
        self.pool = []                      # (shape index, pinned (B, S) int64 ids)
        for _ in range(tr["pool_per_shape"]):
            for j, (S, B) in enumerate(self.shapes):
                ranks = torch.multinomial(rank_p, B * S, replacement=True, generator=g)
                host = torch.empty((B, S), dtype=torch.int64, pin_memory=pin)
                host.copy_(rows[ranks].view(B, S))
                self.pool.append((j, host))
        self.caches = [self.model.init_caches(B, S) for S, B in self.shapes]
        self.out = [torch.empty((B, V), dtype=torch.float32, pin_memory=pin)
                    for _, B in self.shapes]
        # every pool batch, not one a shape: the held experts' products take
        # the row counts each batch's routing gives
        for p in range(len(self.pool)):
            self.batch(p)

    def batch(self, p: int) -> None:
        tr, dev = self.ctx.tracer, self.ctx.device
        j, ids = self.pool[p]
        caches = self.caches[j]
        for block in caches:
            for c in block:
                c["pos"] = 0
        with tr.range("tmbench.h2d"):
            xd = ids.to(dev, non_blocking=True)
        with tr.range("tmbench.prefill"):
            logits, _ = self.step(self.model, {"tokens": xd}, caches)
        with tr.range("tmbench.readback"):
            self.out[j].copy_(logits, non_blocking=True)
            datagen.sync(dev)

    def window(self, seconds: float) -> dict:
        P, n_shapes = len(self.pool), len(self.shapes)
        lat, kept, items = [], {}, 0
        i = 0
        t0 = time.perf_counter()
        while True:
            ti = time.perf_counter()
            self.batch(i % P)
            te = time.perf_counter()
            lat.append(te - ti)
            j, ids = self.pool[i % P]
            items += ids.numel()
            if j not in kept:
                kept[j] = (i % P, self.out[j].clone(),
                           [(c["c_kv"].clone(), c["k_rope"].clone())
                            for block in self.caches[j] for c in block])
            i += 1
            if te - t0 >= seconds and i >= n_shapes:
                break
        self.kept, self.n_batches = kept, i
        return dict(kind="infer", window_s=te - t0, batches=i, items=items, attempted=items,
                    failed=0, latencies_s=lat)

    def _draw(self, names, dtype_of) -> dict:
        """The weights ``names`` of the held share from the seed, each from
        its own stream: N(0, std^2) drawn in float32 on the card and rounded
        to the configuration's type, a norm's offset 0; each then in
        ``dtype_of(name)``."""
        dev, seed = self.ctx.device, self.ctx.seed
        wt = getattr(torch, self.ctx.config["torch_dtype"])
        out = {}
        for name in names:
            shape, std = self.shapes_w[name]
            if std:
                g = datagen.generator(seed, "weights/" + name, dev)
                w = torch.randn(shape, generator=g, device=dev).mul_(std).to(wt)
            else:
                w = torch.zeros(shape, dtype=wt, device=dev)
            out[name] = w.to(dtype_of(name))
        return out

    def _weights(self, names) -> dict:
        """The reference's float32 weights ``names``: the model's draw, again."""
        return self._draw(names, lambda _: torch.float32)

    def _reference(self, p: int, weights=None, spec=None) -> dict:
        ids = self.pool[p][1].to(self.ctx.device)
        return reference.forward(weights or self._weights, ids,
                                 self.spec if spec is None else spec,
                                 block=self.tr["reference_block"])

    def _free_program(self) -> None:
        """Drop the program's model, step and caches (the kept outputs are
        copies), so that the reference's float32 layers fit."""
        for name in ("model", "step", "caches"):
            self.__dict__.pop(name, None)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @staticmethod
    def _errors(outs: dict, wants: dict) -> dict:
        """``{"logits_err", "cache_err", "moe_err"}`` of ``outs`` against
        ``wants``, each ``{pool batch: (logits, [(c_kv, k_rope)] an MLA
        sublayer, the first double layer's MoE output)}``."""
        lg, mo, subs = [0.0, 0.0], [0.0, 0.0], None
        for p, (logits, cache, moe_out) in outs.items():
            w_logits, w_cache, w_moe = wants[p]
            for acc, (d, n) in ((lg, _rel_parts(logits, w_logits)),
                                (mo, _rel_parts(moe_out, w_moe))):
                acc[0] += d
                acc[1] += n
            if subs is None:
                subs = [[0.0, 0.0] for _ in cache]
            for acc, (c, r), (wc, wr) in zip(subs, cache, w_cache):
                for x, y in (_rel_parts(c, wc), _rel_parts(r, wr)):
                    acc[0] += x
                    acc[1] += y
        return {"logits_err": (lg[0] / lg[1]) ** 0.5,
                "cache_err": max((a / b) ** 0.5 for a, b in subs),
                "moe_err": (mo[0] / mo[1]) ** 0.5}

    def _program_moe(self):
        """The program's expert layer (``moe.moe_ff``) on the first double
        layer's weights in float32: a function of the layer's input."""
        from repro_torch.models import moe

        p = "blocks.0.moe."
        w = {k.removeprefix(p): v
             for k, v in self._weights([k for k in self.shapes_w if k.startswith(p)]).items()}
        return lambda u: moe.moe_ff(self.cfg, w, u)

    def check(self) -> list:
        """``[(name, value, limit)]``: the first window batch of each shape
        against the reference."""
        self._free_program()
        program_moe = self._program_moe()
        self.want, self.pairs, got = {}, {}, {}
        for p, logits, cache in self.kept.values():
            r = self._reference(p)
            u, out = r.pop("moe")
            self.want[p] = (r["logits"], r["cache"], out)
            self.pairs[p] = r["held_pairs"]
            got[p] = (logits, cache, program_moe(u))
            del r, u
        del program_moe
        errs = self._errors(got, self.want)
        return [(n, errs[n], LIMITS[n]) for n in LIMITS]

    def controls(self) -> dict:
        """Readings of the controls put in the program's place over the
        checked batches, compared as ``check`` compares."""
        def fp8(names):
            return {k: (_fp8(v) if v.dim() >= 2 and k != "embed" else v)
                    for k, v in self._weights(names).items()}

        s = self.spec
        variants = {"control_sequential_moe": (None, dict(s, variant="sequential_moe")),
                    "control_zero_dropped": (None, dict(s, variant="zero_dropped")),
                    "control_bias_in_gate": (None, dict(s, variant="bias_in_gate")),
                    "control_no_lora_scale": (None, dict(s, mla_scale_q_lora=False,
                                                         mla_scale_kv_lora=False)),
                    "fault_fp8_weights": (fp8, s)}
        out = {}
        for name, (weights, spec) in variants.items():
            got = {}
            for p in self.want:
                r = self._reference(p, weights, spec)
                got[p] = (r["logits"], r["cache"], r["moe"][1])
            for k, v in self._errors(got, self.want).items():
                out[f"{name}.{k}"] = v
        return out

    def bounds(self) -> dict:
        """Bounds (s) of the window's work, summed over its batches:
        ``{"step", "flash"}`` (``longcat_work``), the held experts' pairs
        from the reference's routing of each pool batch."""
        pk = work.peaks()
        per = {}
        for p, (j, _) in enumerate(self.pool):
            if p not in self.pairs:
                self.pairs[p] = self._reference(p)["held_pairs"]
            S, B = self.shapes[j]
            per[p] = longcat_work.prefill_bounds(self.dims, B, S, self.pairs[p], pk)
        P = len(self.pool)
        return {k: sum(per[i % P][k] for i in range(self.n_batches)) for k in ("step", "flash")}
