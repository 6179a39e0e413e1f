"""Causal LM assembly for the dense GQA families, as ``nn.Module``s.

One :class:`Block` per layer (the reference stacks each group's layers and
scans over them; here the layers are a ``ModuleList``).  Parameter names
and shapes follow the reference's tree (``norm1``, ``mix``, ``norm2``,
``ff``; ``embed``, ``unembed``, ``final_norm``), so
:func:`params_from_numpy` carries a reference ``init_params`` tree across.
Serving is ported for configs whose layers are all global attention with a
dense MLP, without a modality frontend or codebook heads
(:func:`check_servable`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig


def check_servable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a family the port cannot serve yet,
    naming what is missing and the ROADMAP item that brings it."""
    missing = []
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} modality frontend")
    if cfg.n_codebooks != 1:
        missing.append(f"{cfg.n_codebooks} codebook heads")
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
            "item 9, the LM substrate); the port serves dense GQA families "
            "(tinyllama-1.1b, smollm-360m, qwen3-32b, starcoder2-7b)")


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
    return nn.Parameter(t, requires_grad=False)


def _zeros_or(generator, draw, shape, dtype, device):
    if generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return draw().to(device)


class Block(nn.Module):
    """Pre-norm attention + dense MLP with residuals."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.norm1 = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.mix = attention.init_attention(generator, cfg, dtype, device)
        self.norm2 = _param(torch.zeros((d,), dtype=dtype, device=device))
        names = (("gate", d, f), ("up", d, f), ("down", f, d))
        self.ff = nn.ParameterDict({
            name: _param(_zeros_or(generator,
                                   lambda a=a, b=b: layers.init_dense(generator, a, b, dtype),
                                   (a, b), dtype, device))
            for name, a, b in names if cfg.gated_mlp or name != "gate"})

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        h, cache = attention.attention_block(
            cfg, self.mix, layers.rms_norm(x, self.norm1, cfg.norm_eps), positions,
            cache=cache)
        x = x + h
        return x + layers.mlp(self.ff, layers.rms_norm(x, self.norm2, cfg.norm_eps)), cache


class Transformer(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm, and an unembedding
    matrix unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        check_servable(cfg)
        dev = _device.resolve(device)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = _param(_zeros_or(
            generator, lambda: (torch.randn((V, d), generator=generator,
                                            device=generator.device) * 0.02).to(dtype),
            (V, d), dtype, dev))
        if not cfg.tie_embeddings:
            self.unembed = _param(_zeros_or(
                generator, lambda: layers.init_dense(generator, d, V, dtype),
                (d, V), dtype, dev))
        self.blocks = nn.ModuleList(Block(cfg, generator, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(torch.zeros((d,), dtype=dtype, device=dev))

    def forward(self, tokens, positions=None, caches=None):
        """tokens (B, S) -> (hidden (B, S, d), caches or None); the caches
        are written in place."""
        x = self.embed[tokens]
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None].expand(B, S)
        for i, block in enumerate(self.blocks):
            x, _ = block(x, positions, None if caches is None else caches[i])
        return layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), caches

    def init_caches(self, batch: int, s_max: int, dtype=None) -> list:
        dtype = dtype or self.embed.dtype
        return [attention.init_cache(self.cfg, batch, s_max, dtype, self.embed.device)
                for _ in self.blocks]

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Transformer:
    """Random weights as the reference draws them (normal embeddings x 0.02,
    N(0, 1/d_in) matrices, zero norm scales), from ``generator`` in
    ``cfg.dtype``."""
    return Transformer(cfg, generator, device)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


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
