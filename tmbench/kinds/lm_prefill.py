"""Traffic kind ``lm_prefill``: one client in a closed loop prefills batches
of prompts through the port's serving path of a DeepSeek-V2 configuration.

The configuration file keeps the model's ``config.json`` at its top level
with the held counts (layers, experts, vocabulary rows) at their held
values, and the published values in ``published``; its ``deployment``
names the routing group this chip holds.  Set-up builds the model with
``configs.deepseek_v2_236b.from_config_json`` from the published values
and the held layout (``transformer.Transformer`` on ``meta``), draws the
held share's weights from the seed on the card under the plain
reference's names and scales (``reference.weight_shapes``, rounded to the
configuration's bf16), loads them into the model (``load_state_dict``,
strict: the program must hold exactly those names and shapes), and makes
a pool of ``pool_per_shape`` batches of each of ``shapes`` ([prompt
tokens, prompts]), token ids drawn uniformly from the held vocabulary rows
by the seed, kept in pinned host memory, in the order of ``shapes``
repeated; window batch ``i`` is pool batch ``i % pool``.  Each shape has its caches (``model.init_caches``),
reused from position 0 each batch, and a pinned logits buffer.  Every
shape is warmed up in set-up.

A batch: the token ids copied to the card (``non_blocking``),
``steps.make_prefill_step``'s step with the caches written, and the
last-position logits (B, V) read back into pinned memory; the read ends
the batch, and its latency runs from the copy's issue to the logits on
the host.  A datapoint is a prompt token: ``items`` counts them.  The
window runs at least one batch of every shape.

The check takes the first window batch of each shape (its logits and a
copy of its latent caches, made after its latency was taken) and the
plain reference's float32 forward of the same prompts on the same weights,
drawn again from the seed (``reference/deepseek_v2_reference.py``), over
the layers, experts and vocabulary rows the configuration file holds:

* ``logits_err``: the relative Frobenius error of the last-position logits
  over all those prompts together;
* ``cache_err``: the largest over the layers of the relative Frobenius
  error of the latent cache (``c_kv`` and ``k_rope``) over every position.

Aggregate norms, so that a near-tie router choice that bf16 and float32
settle differently for a few tokens does not decide the run alone.  The
limits lie between the sound runs' readings and the controls' (PERF.md
§2 gives both): the reference with the routing's group limit removed,
with plain RoPE and the qk width^-0.5 scale (the port before DeepSeek-V2's
settings), and with every linear weight rounded through float8 e4m3 with
a per-tensor scale, a precision below the configuration's bf16.
"""

from __future__ import annotations

import time

import torch

from tmbench import datagen, lm_work, work
from tmbench.reference import deepseek_v2_reference as reference

CONFIG_FILES = ()

# relative Frobenius errors of the port's bf16 run against the float32
# reference (PERF.md §2).  cache_err: sound runs read 0.079-0.084, every
# control 0.265 or more (the float8 weights 0.31); logits_err, over 15 last
# positions, swings with the few tokens whose routing bf16 settles
# otherwise (sound 0.025-0.196), and catches plain RoPE (1.06 or more)
LIMITS = {"logits_err": 0.5, "cache_err": 0.15}
FP8_MAX = 448.0


def _rel_parts(got, want):
    """(squared norm of the difference, squared norm of ``want``), float64."""
    d = (got.to(want.device, torch.float64) - want.to(torch.float64)).pow(2).sum()
    return float(d), float(want.to(torch.float64).pow(2).sum())


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded through float8 e4m3 with a per-tensor scale (its largest
    magnitude to e4m3's largest finite value)."""
    s = FP8_MAX / w.abs().amax().clamp(min=1e-30)
    return (w * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Cell:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic
        cfg = ctx.config
        # the published config.json: the catalog's keys with their published values
        self.published = dict(cfg, **cfg["published"])
        self.held, self.deployment = cfg["held"], cfg["deployment"]
        self.dims = lm_work.dims(cfg)
        self.spec = dict(self.published, held_group=self.deployment["group"],
                         held_layers=self.held["num_hidden_layers"],
                         held_vocab=self.held["vocab_size"])
        if len(reference.held_range(self.spec)) != self.held["n_routed_experts"]:
            raise ValueError(f"group {self.deployment['group']} of {self.published['n_group']} "
                             f"is not {self.held['n_routed_experts']} experts")

    def setup(self) -> None:
        from repro_torch.configs.deepseek_v2_236b import from_config_json
        from repro_torch.models import steps, transformer

        ctx, dev, tr = self.ctx, self.ctx.device, self.tr
        self.cfg = from_config_json(self.published, group=self.deployment["group"],
                                    n_layers=self.held["num_hidden_layers"],
                                    vocab_rows=self.held["vocab_size"],
                                    dtype=ctx.config["torch_dtype"])
        self.model = transformer.Transformer(self.cfg, None, device="meta")
        dtypes = {k: v.dtype for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(self._draw(lambda k: dtypes.get(k, torch.float32)),
                                   strict=True, assign=True)
        self.step = steps.make_prefill_step(self.cfg)
        self.shapes = [tuple(s) for s in tr["shapes"]]
        g = datagen.generator(ctx.seed, "prompts", dev)
        pin = dev.type == "cuda"
        V = self.held["vocab_size"]
        self.pool = []                      # (shape index, pinned (B, S) int64 ids)
        for _ in range(tr["pool_per_shape"]):
            for j, (S, B) in enumerate(self.shapes):
                ids = torch.randint(0, V, (B, S), generator=g, device=dev)
                host = torch.empty((B, S), dtype=torch.int64, pin_memory=pin)
                host.copy_(ids)
                self.pool.append((j, host))
        self.caches = [self.model.init_caches(B, S) for S, B in self.shapes]
        self.out = [torch.empty((B, V), dtype=torch.float32, pin_memory=pin)
                    for _, B in self.shapes]
        for p in range(len(self.shapes)):
            self.batch(p)

    def batch(self, p: int) -> None:
        tr, dev = self.ctx.tracer, self.ctx.device
        j, ids = self.pool[p]
        caches = self.caches[j]
        for c in caches:
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
                           [(c["c_kv"].clone(), c["k_rope"].clone()) for c in self.caches[j]])
            i += 1
            if te - t0 >= seconds and i >= n_shapes:
                break
        self.kept, self.n_batches = kept, i
        return dict(kind="infer", window_s=te - t0, batches=i, items=items, attempted=items,
                    failed=0, latencies_s=lat)

    def _draw(self, dtype_of) -> dict:
        """The held share's weights from the seed, by the reference's names:
        N(0, std^2) drawn in float32 on the card and rounded to the
        configuration's type, a norm's offset 0; each then in ``dtype_of(name)``."""
        dev = self.ctx.device
        g = datagen.generator(self.ctx.seed, "weights", dev)
        wt = getattr(torch, self.ctx.config["torch_dtype"])
        out = {}
        for name, (shape, std) in reference.weight_shapes(self.spec).items():
            w = (torch.randn(shape, generator=g, device=dev) * std if std
                 else torch.zeros(shape, device=dev))
            out[name] = w.to(wt).to(dtype_of(name))
        return out

    def _weights(self) -> dict:
        """The reference's float32 weights: the same draw as the model's."""
        if not hasattr(self, "w"):
            self.w = self._draw(lambda _: torch.float32)
        return self.w

    def _reference(self, p: int, w=None, spec=None) -> dict:
        ids = self.pool[p][1].to(self.ctx.device)
        return reference.forward(self._weights() if w is None else w, ids,
                                 self.spec if spec is None else spec,
                                 block=self.tr["reference_block"])

    @staticmethod
    def _errors(outs: dict, wants: dict) -> dict:
        """``{"logits_err", "cache_err"}`` of ``outs`` against ``wants``, each
        ``{pool batch: (logits, [(c_kv, k_rope)] a layer)}``."""
        lg, layers = [0.0, 0.0], None
        for p, (logits, cache) in outs.items():
            w_logits, w_cache = wants[p]
            d, n = _rel_parts(logits, w_logits)
            lg[0] += d
            lg[1] += n
            if layers is None:
                layers = [[0.0, 0.0] for _ in cache]
            for acc, (c, r), (wc, wr) in zip(layers, cache, w_cache):
                for x, y in (_rel_parts(c, wc), _rel_parts(r, wr)):
                    acc[0] += x
                    acc[1] += y
        return {"logits_err": (lg[0] / lg[1]) ** 0.5,
                "cache_err": max((a / b) ** 0.5 for a, b in layers)}

    def check(self) -> list:
        """``[(name, value, limit)]``: the first window batch of each shape
        against the reference."""
        self.want, self.pairs = {}, {}
        for p, logits, cache in self.kept.values():
            r = self._reference(p)
            self.want[p] = (r["logits"], r["cache"])
            self.pairs[p] = r["held_pairs"]
        got = {p: (logits, cache) for p, logits, cache in self.kept.values()}
        errs = self._errors(got, self.want)
        return [(n, errs[n], LIMITS[n]) for n in ("logits_err", "cache_err")]

    def controls(self) -> dict:
        """Readings of the controls put in the program's place over the
        checked batches, compared as ``check`` compares."""
        w = self._weights()
        fp8 = {k: (_fp8(v) if v.dim() >= 2 and k != "embed" else v) for k, v in w.items()}
        variants = {"control_no_group_limit": (w, dict(self.spec, topk_method="greedy")),
                    "control_plain_rope": (w, dict(self.spec, rope_scaling=None)),
                    "fault_fp8_weights": (fp8, self.spec)}
        out = {}
        for name, (wv, spec) in variants.items():
            got = {}
            for p in self.want:
                r = self._reference(p, wv, spec)
                got[p] = (r["logits"], r["cache"])
            for k, v in self._errors(got, self.want).items():
                out[f"{name}.{k}"] = v
        return out

    def bounds(self) -> dict:
        """Bounds (s) of the window's work, summed over its batches:
        ``{"step", "flash"}`` (``lm_work``), the held experts' pairs from
        the reference's routing of each pool batch."""
        pk = work.peaks()
        per = {}
        for p, (j, _) in enumerate(self.pool):
            if p not in self.pairs:
                self.pairs[p] = self._reference(p)["held_pairs"]
            S, B = self.shapes[j]
            per[p] = lm_work.prefill_bounds(self.dims, B, S, self.pairs[p], pk)
        P = len(self.pool)
        return {k: sum(per[i % P][k] for i in range(self.n_batches)) for k in ("step", "flash")}
