"""Causal LM assembly over every layer family, as ``nn.Module``s.

One :class:`Block` per layer (the reference stacks each group's layers and
scans over them; here the layers are a ``ModuleList``), built from its
spec ``(kind, ff)``: the mixer is global or local (windowed) attention, GQA
or MLA, an RG-LRU, an mLSTM or an sLSTM; the feed-forward a dense MLP, the
sLSTM's 4/3-wide one, a mixture of experts, or none (mLSTM).  LongCat-Flash's
layer kind ``scmoe`` is a :class:`ScMoEBlock`, a double layer.  Parameter
names and shapes follow the reference's tree (``norm1``, ``mix``,
``norm2``, ``ff``, MoE's ``ff.shared``; ``embed``, ``unembed``,
``final_norm``), so :func:`params_from_numpy` carries a reference
``init_params`` tree across and :func:`params_to_numpy` carries one back.
Parameters are trainable; serving runs under ``torch.no_grad()``
(``models/steps.py``).  :func:`loss_fn` is the training objective.

:class:`RunCtx` is the reference's distribution context: a mesh
(``launch/mesh.Mesh``) and its layout.  The reference's sharding
constraints (``constrain``, ``boundary``, ``seq_shard``) only lay out what
GSPMD partitions and change no result, so the port has none; what runs per
shard is MoE's experts, which take the mesh unless ``pure_dp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.models import attention, layers, mla, moe, rglru, xlstm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """The distribution context threaded through the forward pass.

    ``pure_dp``: the batch over ALL mesh axes (ZeRO-3 data parallelism, no
    tensor parallelism; MoE's experts then run unsharded).
    """

    mesh: Optional[object] = None
    pure_dp: bool = False

    @property
    def dp_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        axes = ("pod", "data", "model") if self.pure_dp else ("pod", "data")
        return tuple(a for a in axes if a in self.mesh.axis_names)

    @property
    def moe_mesh(self):
        """The mesh MoE's experts are split over: none under ``pure_dp``."""
        return None if self.pure_dp else self.mesh


def _ff_kind(cfg: ModelConfig, layer_idx: int, kind: str) -> str:
    if kind == "scmoe":
        return "scmoe"
    if kind == "mlstm":
        return "none"
    if kind == "slstm":
        return "dense43"
    if cfg.is_moe and layer_idx >= cfg.first_dense_layers:
        return "moe"
    return "dense"


def layer_specs(cfg: ModelConfig) -> list:
    """Each layer's ``(kind, ff)``, as the reference's ``layer_specs``."""
    return [(kind, _ff_kind(cfg, i, kind)) for i, kind in enumerate(cfg.layer_kinds)]


def group_layers(cfg: ModelConfig) -> list:
    """[(unit: tuple of specs, repeats)] covering all layers in order, as the
    reference groups them into the units of its parameter tree: maximal runs
    of the pattern's unit of specs, else single layers (so deepseek-v2's
    dense layer 0 is a group of its own before its MoE layers)."""
    specs = layer_specs(cfg)
    p = len(cfg.pattern)
    groups, i, L = [], 0, len(specs)
    while i < L:
        unit = tuple(specs[i:i + p])
        r = 0
        while i + (r + 1) * p <= L and tuple(specs[i + r * p:i + (r + 1) * p]) == unit:
            r += 1
        if r >= 1 and len(unit) == p:
            groups.append((unit, r))
            i += r * p
        else:
            groups.append(((specs[i],), 1))
            i += 1
    return groups


def _param(t):
    return nn.Parameter(t)


def _init_mix(generator, cfg: ModelConfig, kind: str, dtype, device) -> dict:
    if kind in ("attn", "local"):
        init = mla.init_mla if cfg.attn_kind == "mla" else attention.init_attention
    else:
        init = {"rec": rglru.init_rglru, "mlstm": xlstm.init_mlstm,
                "slstm": xlstm.init_slstm}[kind]
    return init(generator, cfg, dtype, device)


class Block(nn.Module):
    """Pre-norm mixer and (unless the spec's ff is ``none``) feed-forward,
    each with a residual."""

    def __init__(self, cfg: ModelConfig, spec, generator, dtype, device):
        super().__init__()
        self.cfg, self.spec = cfg, tuple(spec)
        kind, ff = spec
        d = cfg.d_model
        self.norm1 = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.mix = layers.parameters(_init_mix(generator, cfg, kind, dtype, device))
        if ff != "none":
            self.norm2 = _param(torch.zeros((d,), dtype=dtype, device=device))
            if ff == "moe":
                tree = moe.init_moe(generator, cfg, dtype, device)
            else:
                d_ff = int(4 * d / 3) if ff == "dense43" else cfg.d_ff
                tree = layers.init_mlp(generator, d, d_ff, dtype, gated=cfg.gated_mlp,
                                       device=device)
            self.ff = layers.parameters(tree)

    def forward(self, x, positions, cache=None, arange: bool = False,
                ctx: RunCtx = RunCtx()):
        cfg = self.cfg
        kind, ff = self.spec
        h = layers.rms_norm(x, self.norm1, cfg.norm_eps)
        if kind in ("attn", "local"):
            if cfg.attn_kind == "mla":
                h, cache = mla.mla_block(cfg, self.mix, h, positions, cache=cache,
                                         arange=arange)
            else:
                h, cache = attention.attention_block(cfg, self.mix, h, positions, kind=kind,
                                                     cache=cache, arange=arange)
        elif kind == "rec":
            h, cache = rglru.rglru_block(cfg, self.mix, h, cache=cache)
        elif kind == "mlstm":
            h, cache = xlstm.mlstm_block(cfg, self.mix, h, cache=cache)
        else:
            h, cache = xlstm.slstm_block(cfg, self.mix, h, cache=cache)
        x = x + h
        if ff == "none":
            return x, cache
        h2 = layers.rms_norm(x, self.norm2, cfg.norm_eps)
        if ff == "moe":
            h2 = moe.moe_ff(cfg, self.ff, h2, ctx.moe_mesh, ctx.dp_axes)
        else:
            h2 = layers.mlp(self.ff, h2)
        return x + h2, cache

    def init_cache(self, batch: int, s_max: int, dtype) -> dict:
        """This layer's cache: a KV cache (a ring under ``local``), MLA's
        latent cache, or the recurrent state."""
        cfg, kind, dev = self.cfg, self.spec[0], self.norm1.device
        if kind == "attn":
            if cfg.attn_kind == "mla":
                return mla.init_mla_cache(cfg, batch, s_max, dtype, dev)
            return attention.init_cache(cfg, batch, s_max, dtype, dev)
        if kind == "local":
            return attention.init_ring_cache(cfg, batch, s_max, dtype, dev)
        if kind == "rec":
            return rglru.init_rglru_cache(cfg, batch, dtype, dev)
        if kind == "mlstm":
            return xlstm.init_mlstm_cache(cfg, batch, dev)
        return xlstm.init_slstm_cache(cfg, batch, dev)


class ScMoEBlock(nn.Module):
    """LongCat-Flash's double layer (``LongcatFlashDecoderLayer``): two
    pre-norm MLA sublayers, each followed by a pre-norm dense SwiGLU, and a
    mixture of experts on sublayer 0's feed-forward input whose output
    joins after sublayer 1 (the shortcut):

        h = x + MLA_0(n_0(x));  u = m_0(h);  h = h + FFN_0(u)
        h = h + MLA_1(n_1(h));  y = h + FFN_1(m_1(h)) + MoE(u)

    with ``norm1[j]`` = n_j, ``mix[j]`` = MLA_j, ``norm2[j]`` = m_j,
    ``ff[j]`` = FFN_j and ``moe``.  Its cache is the list of the two
    sublayers' latent caches."""

    def __init__(self, cfg: ModelConfig, spec, generator, dtype, device):
        super().__init__()
        self.cfg, self.spec = cfg, tuple(spec)
        d = cfg.d_model

        def norms():
            return nn.ParameterList(_param(torch.zeros((d,), dtype=dtype, device=device))
                                    for _ in range(2))

        self.norm1, self.norm2 = norms(), norms()
        self.mix = nn.ModuleList(
            layers.parameters(mla.init_mla(generator, cfg, dtype, device)) for _ in range(2))
        self.ff = nn.ModuleList(
            layers.parameters(layers.init_mlp(generator, d, cfg.d_ff, dtype, device=device))
            for _ in range(2))
        self.moe = layers.parameters(moe.init_moe(generator, cfg, dtype, device))

    def forward(self, x, positions, cache=None, arange: bool = False,
                ctx: RunCtx = RunCtx()):
        cfg = self.cfg
        for j in range(2):
            h = layers.rms_norm(x, self.norm1[j], cfg.norm_eps)
            h, _ = mla.mla_block(cfg, self.mix[j], h, positions,
                                 cache=None if cache is None else cache[j], arange=arange)
            x = x + h
            u = layers.rms_norm(x, self.norm2[j], cfg.norm_eps)
            if j == 0:
                shortcut = moe.moe_ff(cfg, self.moe, u, ctx.moe_mesh, ctx.dp_axes)
            x = x + layers.mlp(self.ff[j], u)
        return x + shortcut, cache

    def init_cache(self, batch: int, s_max: int, dtype) -> list:
        dev = self.norm1[0].device
        return [mla.init_mla_cache(self.cfg, batch, s_max, dtype, dev) for _ in range(2)]


class Transformer(nn.Module):
    """Embedding (none under ``audio_stub``, whose inputs are frame
    embeddings), ``n_layers`` blocks, final norm, and an unembedding
    matrix (d, V x n_codebooks) unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        dev = _device.resolve(device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        if cfg.frontend != "audio_stub":
            self.embed = _param(layers.normal(generator, (V, d), 0.02, dtype, dev))
        if not cfg.tie_embeddings:
            self.unembed = _param(layers.dense(generator, d, V * cfg.n_codebooks, dtype, dev))
        self.blocks = nn.ModuleList(
            (ScMoEBlock if spec[0] == "scmoe" else Block)(cfg, spec, generator, dtype, dev)
            for spec in layer_specs(cfg))
        self.final_norm = _param(torch.zeros((d,), dtype=dtype, device=dev))

    def forward(self, tokens=None, positions=None, caches=None, *, embeds=None,
                remat: bool = False, ctx: RunCtx = RunCtx()):
        """tokens (B, S_txt) and/or stub ``embeds`` (B, S_emb, d), the
        embeds first -> (hidden (B, S, d), caches or None); the caches are
        written in place.  ``remat`` recomputes each block's activations in
        the backward (``torch.utils.checkpoint``, a block at a time, as the
        reference's ``jax.checkpoint``).  ``ctx`` places the pass on a mesh."""
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.final_norm.dtype))
        if tokens is not None:
            parts.append(self.embed[tokens])
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        B, S, _ = x.shape
        arange = positions is None
        if arange:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None].expand(B, S)
        for i, block in enumerate(self.blocks):
            cache = None if caches is None else caches[i]
            if remat and cache is None and torch.is_grad_enabled():
                x, _ = checkpoint(block, x, positions, None, arange, ctx,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                x, _ = block(x, positions, cache, arange, ctx)
        return layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), caches

    def init_caches(self, batch: int, s_max: int, dtype=None) -> list:
        dtype = dtype or self.final_norm.dtype
        return [block.init_cache(batch, s_max, dtype) for block in self.blocks]

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def loss_fn(cfg: ModelConfig, model: Transformer, batch: dict,
            ctx: RunCtx = RunCtx(), remat: bool = True) -> torch.Tensor:
    """The training objective (``repro/models/transformer.py:loss_fn``):
    the chunked cross-entropy of the next-token labels; the mean over
    codebooks when there are several (labels (B, S, n_codebooks)); only the
    trailing label positions when a frontend prepends embeds."""
    hidden, _ = model(batch.get("tokens"), embeds=batch.get("embeds"), remat=remat,
                      ctx=ctx)
    labels = batch["labels"]
    w = model.unembed_matrix()
    if cfg.n_codebooks > 1:
        nc, V = labels.shape[-1], cfg.vocab_size
        wb = w.view(cfg.d_model, nc, V)
        tot = 0.0
        for c in range(nc):
            tot = tot + layers.chunked_ce_loss(hidden, wb[:, c], labels[..., c])
        return tot / nc
    if labels.shape[1] != hidden.shape[1]:
        hidden = hidden[:, -labels.shape[1]:]
    return layers.chunked_ce_loss(hidden, w, labels)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Transformer:
    """Random weights as the reference draws them (normal embeddings x 0.02,
    N(0, 1/d_in) matrices, zero norm scales), from ``generator`` in
    ``cfg.dtype`` (MoE's router and the RG-LRU's ``lam`` in float32)."""
    return Transformer(cfg, generator, device)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    # bf16: ml_dtypes' numpy bfloat16, or the 2-byte void a checkpoint
    # written by either package loads as
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as numpy's 2-byte void (numpy has no bfloat16),
    as ``np.savez`` writes the reference's bf16 arrays."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """A reference ``init_params`` tree with numpy leaves (each group's
    leaves stacked ``(repeats, ...)``, nested to any depth, as MoE's
    ``ff.shared``) -> a :class:`Transformer`."""
    model = Transformer(cfg, None, device)
    with torch.no_grad():
        for name in ("embed", "unembed", "final_norm"):
            if name in tree:
                getattr(model, name).copy_(_tensor(tree[name]))
        i = 0
        for (unit, repeats), group in zip(group_layers(cfg), tree["groups"]):
            for r in range(repeats):
                for li in range(len(unit)):
                    params = dict(model.blocks[i].named_parameters())
                    leaves = _flatten(group[li])
                    if set(leaves) != set(params):
                        raise ValueError(f"layer {i}: tree has {sorted(leaves)}, "
                                         f"the block {sorted(params)}")
                    for key, val in leaves.items():
                        params[key].copy_(_tensor(np.asarray(val)[r]))
                    i += 1
    return model


def params_tree(cfg: ModelConfig, model: Transformer, values=None) -> dict:
    """The reference's ``init_params`` tree of the model's tensors
    (``embed``, ``unembed``, ``final_norm``, and ``groups[g][li]`` nested
    dicts whose leaves stack the group's layers ``(repeats, ...)``), detached.
    ``values`` (tensors in ``model.parameters()`` order: gradients,
    optimizer moments) are laid out in the parameters' places instead.  On
    the ``meta`` device this is a tree of shapes (``models/sharding.py``)."""
    swap = ({id(p): t for p, t in zip(model.parameters(), values)}
            if values is not None else None)

    def leaf(p):
        return (p if swap is None else swap[id(p)]).detach()

    tree = {name: leaf(getattr(model, name))
            for name in ("embed", "unembed", "final_norm") if hasattr(model, name)}
    tree["groups"] = _stack_groups(cfg, [dict(b.named_parameters()) for b in model.blocks],
                                   leaf)
    return tree


def _stack_groups(cfg: ModelConfig, per_layer: list, leaf) -> list:
    """Per-layer flat dicts ({dotted key: value}) -> the reference's groups:
    a list of units, each a list of nested dicts whose leaves stack the
    group's layers."""
    groups, i = [], 0
    for unit, repeats in group_layers(cfg):
        unit_trees = []
        for li in range(len(unit)):
            layers_ = [per_layer[i + r * len(unit) + li] for r in range(repeats)]
            sub: dict = {}
            for key in layers_[0]:
                *path, name = key.split(".")
                node = sub
                for part in path:
                    node = node.setdefault(part, {})
                node[name] = torch.stack([leaf(lay[key]) for lay in layers_])
            unit_trees.append(sub)
        groups.append(unit_trees)
        i += repeats * len(unit)
    return groups


def caches_tree(cfg: ModelConfig, caches: list) -> list:
    """The port's per-layer caches -> the reference's ``init_caches`` layout
    (a list a group of units, leaves stacked ``(repeats, ...)``); a host
    position becomes an int32 0-d tensor, as the reference keeps it."""
    dev = next(v.device for c in caches for v in c.values() if torch.is_tensor(v))

    def leaf(v):
        return v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.int32, device=dev)

    return _stack_groups(cfg, list(caches), leaf)


def params_to_numpy(cfg: ModelConfig, model: Transformer, values=None) -> dict:
    """The inverse of :func:`params_from_numpy`: :func:`params_tree` with
    numpy leaves."""
    tree = params_tree(cfg, model, values)
    return {k: ([[_numpy_tree(u) for u in g] for g in v] if k == "groups" else _numpy(v))
            for k, v in tree.items()}


def _numpy_tree(tree: dict) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else _numpy(v) for k, v in tree.items()}
