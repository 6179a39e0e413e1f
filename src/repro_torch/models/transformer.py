"""Causal LM assembly for the dense GQA families, as ``nn.Module``s.

One :class:`Block` per layer (the reference stacks each group's layers and
scans over them; here the layers are a ``ModuleList``).  Parameter names
and shapes follow the reference's tree (``norm1``, ``mix``, ``norm2``,
``ff``; ``embed``, ``unembed``, ``final_norm``), so
:func:`params_from_numpy` carries a reference ``init_params`` tree across
and :func:`params_to_numpy` carries one back.  Parameters are trainable;
serving runs under ``torch.no_grad()`` (``models/steps.py``).  Ported for
configs whose layers are all global attention with a dense MLP, with or
without a stub modality frontend (precomputed frame or patch embeddings)
and codebook heads (:func:`check_servable`); :func:`loss_fn` is the
training objective.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig


def check_servable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a family the port cannot run yet,
    naming what is missing and the ROADMAP item that brings it."""
    missing = []
    if cfg.attn_kind != "gqa":
        missing.append(f"{cfg.attn_kind} attention")
    if cfg.is_moe:
        missing.append("mixture-of-experts feed-forward layers")
    other = sorted(set(cfg.layer_kinds) - {"attn"})
    if other:
        missing.append(f"{'/'.join(other)} layers")
    if cfg.window:
        missing.append("local attention windows")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP queue 1 "
            "item 9, the LM substrate); the port runs the dense GQA families "
            "(tinyllama-1.1b, smollm-360m, qwen3-32b, starcoder2-7b) and the "
            "stub frontends (pixtral-12b, musicgen-large)")


def group_layers(cfg: ModelConfig) -> list:
    """[(unit: tuple of layer kinds, repeats)] covering all layers in order,
    as the reference groups them into the units of its parameter tree (for
    the servable configs every layer is global attention + dense MLP)."""
    kinds = cfg.layer_kinds
    p = len(cfg.pattern)
    groups, i, L = [], 0, len(kinds)
    while i < L:
        unit = kinds[i:i + p]
        r = 0
        while i + (r + 1) * p <= L and kinds[i + r * p:i + (r + 1) * p] == unit:
            r += 1
        if r >= 1 and len(unit) == p:
            groups.append((unit, r))
            i += r * p
        else:
            groups.append(((kinds[i],), 1))
            i += 1
    return groups


def _param(t):
    return nn.Parameter(t)


def _zeros_or(generator, draw, shape, dtype, device):
    if generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return draw().to(device)


class Block(nn.Module):
    """Pre-norm attention + dense MLP with residuals."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.norm1 = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.mix = attention.init_attention(generator, cfg, dtype, device)
        self.norm2 = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.ff = nn.ParameterDict({
            k: _param(v) for k, v in layers.init_mlp(
                generator, d, cfg.d_ff, dtype, gated=cfg.gated_mlp, device=device).items()})

    def forward(self, x, positions, cache=None, arange: bool = False):
        cfg = self.cfg
        h, cache = attention.attention_block(
            cfg, self.mix, layers.rms_norm(x, self.norm1, cfg.norm_eps), positions,
            cache=cache, arange=arange)
        x = x + h
        return x + layers.mlp(self.ff, layers.rms_norm(x, self.norm2, cfg.norm_eps)), cache


class Transformer(nn.Module):
    """Embedding (none under ``audio_stub``, whose inputs are frame
    embeddings), ``n_layers`` blocks, final norm, and an unembedding
    matrix (d, V x n_codebooks) unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        check_servable(cfg)
        dev = _device.resolve(device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        if cfg.frontend != "audio_stub":
            self.embed = _param(_zeros_or(
                generator, lambda: (torch.randn((V, d), generator=generator,
                                                device=generator.device) * 0.02).to(dtype),
                (V, d), dtype, dev))
        if not cfg.tie_embeddings:
            self.unembed = _param(_zeros_or(
                generator, lambda: layers.init_dense(generator, d, V * cfg.n_codebooks, dtype),
                (d, V * cfg.n_codebooks), dtype, dev))
        self.blocks = nn.ModuleList(Block(cfg, generator, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(torch.zeros((d,), dtype=dtype, device=dev))

    def forward(self, tokens=None, positions=None, caches=None, *, embeds=None,
                remat: bool = False):
        """tokens (B, S_txt) and/or stub ``embeds`` (B, S_emb, d), the
        embeds first -> (hidden (B, S, d), caches or None); the caches are
        written in place.  ``remat`` recomputes each block's activations in
        the backward (``torch.utils.checkpoint``, a block at a time, as the
        reference's ``jax.checkpoint``)."""
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
                x, _ = checkpoint(block, x, positions, None, arange,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                x, _ = block(x, positions, cache, arange)
        return layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), caches

    def init_caches(self, batch: int, s_max: int, dtype=None) -> list:
        dtype = dtype or self.final_norm.dtype
        return [attention.init_cache(self.cfg, batch, s_max, dtype, self.final_norm.device)
                for _ in self.blocks]

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def loss_fn(cfg: ModelConfig, model: Transformer, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """The training objective (``repro/models/transformer.py:loss_fn``):
    the chunked cross-entropy of the next-token labels; the mean over
    codebooks when there are several (labels (B, S, n_codebooks)); only the
    trailing label positions when a frontend prepends embeds."""
    hidden, _ = model(batch.get("tokens"), embeds=batch.get("embeds"), remat=remat)
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
    ``cfg.dtype``."""
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


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    """A reference ``init_params`` tree with numpy leaves (each group's
    leaves stacked ``(repeats, ...)``) -> a :class:`Transformer`."""
    model = Transformer(cfg, None, device)
    with torch.no_grad():
        for name in ("embed", "unembed", "final_norm"):
            if name in tree:
                getattr(model, name).copy_(_tensor(tree[name]))
        i = 0
        for (unit, repeats), group in zip(group_layers(cfg), tree["groups"]):
            for r in range(repeats):
                for li in range(len(unit)):
                    block = model.blocks[i]
                    params = dict(block.named_parameters())
                    leaves = {}
                    for key, val in group[li].items():
                        if isinstance(val, dict):
                            leaves.update({f"{key}.{k}": v for k, v in val.items()})
                        else:
                            leaves[key] = val
                    if set(leaves) != set(params):
                        raise ValueError(f"layer {i}: tree has {sorted(leaves)}, "
                                         f"the block {sorted(params)}")
                    for key, val in leaves.items():
                        params[key].copy_(_tensor(np.asarray(val)[r]))
                    i += 1
    return model


def params_to_numpy(cfg: ModelConfig, model: Transformer, values=None) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's
    ``init_params`` tree (``embed``, ``unembed``, ``final_norm``, and
    ``groups[g][li]`` dicts whose leaves stack the group's layers
    ``(repeats, ...)``) with numpy leaves.  ``values`` (tensors in
    ``model.parameters()`` order: gradients, optimizer moments) are laid
    out in the parameters' places instead of the parameters."""
    swap = ({id(p): t for p, t in zip(model.parameters(), values)}
            if values is not None else None)

    def leaf(p):
        return p if swap is None else swap[id(p)]

    tree = {name: _numpy(leaf(getattr(model, name)))
            for name in ("embed", "unembed", "final_norm") if hasattr(model, name)}
    tree["groups"], i = [], 0
    for unit, repeats in group_layers(cfg):
        unit_trees = []
        for li in range(len(unit)):
            blocks = [model.blocks[i + r * len(unit) + li] for r in range(repeats)]
            sub: dict = {}
            for key, _ in blocks[0].named_parameters():
                stacked = _numpy(torch.stack([leaf(dict(b.named_parameters())[key])
                                              for b in blocks]))
                head, _, rest = key.partition(".")
                if rest:
                    sub.setdefault(head, {})[rest] = stacked
                else:
                    sub[head] = stacked
            unit_trees.append(sub)
        tree["groups"].append(unit_trees)
        i += repeats * len(unit)
    return tree
