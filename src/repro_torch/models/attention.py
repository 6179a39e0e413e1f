"""Attention: GQA (+ qk-norm, RoPE, local windows), the flash kernel for a
prefill or a training forward from position 0, a chunked online softmax
otherwise, the reference's recomputing backward for training, and dense
single-step attention for decode.

Parameters live in an ``nn.ParameterDict`` with the reference's names and
shapes (``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd), ``wo`` (H, hd, d),
``q_norm``/``k_norm`` (hd,) with qk-norm).  A global layer's KV cache is a
dict of ``k``/``v`` (B, S_max, K, hd) tensors and the host int ``pos``; a
local layer's is a ring of ``min(S_max, window)`` slots with each slot's
position in ``kv_pos`` (-1 while empty).  Both are written in place.
"""

from __future__ import annotations

import torch
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.trace_scope import trips, unfolded

NEG_INF = -1e30
# the profiler range around the flash backward's tile ops
BACKWARD_RANGE = "flash_attention_backward"
# the profiler range around a layer's attention and its cache update (the
# projections outside it), in every attention and MLA layer
ATTEND_RANGE = "attention"


def init_attention(generator, cfg: ModelConfig, dtype, device) -> dict:
    """Random weights from ``generator`` (None: zeros, to be loaded)."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def dense(d_in, d_out, shape):
        return layers.dense(generator, d_in, d_out, dtype, device, shape)

    p = {"wq": dense(d, H * hd, (d, H, hd)), "wk": dense(d, K * hd, (d, K, hd)),
         "wv": dense(d, K * hd, (d, K, hd)), "wo": dense(H * hd, d, (H, hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, params, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, T, K, d) -> (B, T, H, d), each kv head repeated H // K times."""
    K = x.shape[2]
    return x if K == H else x.repeat_interleave(H // K, dim=2)


def _flash_fwd(q, k, v, q_pos, kv_pos, window, q_chunk, kv_chunk, scale=None):
    """The reference's jnp route (``attention.py:_flash_fwd``): online
    softmax over (q_chunk x kv_chunk) tiles with explicit positions, kv
    expanded to H heads -> (out (B, S, H, dv), lse (B, S, H) float32).
    ``scale`` multiplies the scores (default hd^-0.5)."""
    B, S, H, hd = q.shape
    T, dv = k.shape[1], v.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    outs, lses = [], []
    q_starts = range(0, S, q_chunk)
    for q0 in trips(q_starts):
        qc = q[:, q0:q0 + q_chunk].to(torch.float32)
        qpc = q_pos[:, q0:q0 + q_chunk]
        n = qc.shape[1]
        m = torch.full((B, n, H), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, n, H), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, n, H, dv), dtype=torch.float32, device=q.device)
        for k0 in trips(range(0, T, kv_chunk)):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpc = kv_pos[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhd,bthd->bqht", qc, kc.to(torch.float32)) * scale
            s = torch.where(_tile_mask(qpc, kpc, window)[:, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqht,bthv->bqhv", p.to(vc.dtype), vc).to(torch.float32)
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    return (torch.cat(unfolded(outs, q_starts), dim=1).to(q.dtype),
            torch.cat(unfolded(lses, q_starts), dim=1))


def _tile_mask(qpc, kpc, window):
    """(B, q, t): key position <= query position, and within ``window``."""
    mask = kpc[:, None, :] <= qpc[:, :, None]
    if window:
        mask &= kpc[:, None, :] > qpc[:, :, None] - window
    return mask


def _flash_tile_p(qc, kc, qpc, kpc, lse_c, scale, window):
    """Recompute the (q_chunk x kv_chunk) probability tile in the backward
    -> (B, q, H, t) float32."""
    s = torch.einsum("bqhd,bthd->bqht", qc.to(torch.float32), kc.to(torch.float32)) * scale
    p = torch.exp(s - lse_c[..., None])
    return torch.where(_tile_mask(qpc, kpc, window)[:, :, None, :], p, 0.0)


def _flash_bwd(q, k, v, q_pos, kv_pos, out, lse, do, window, q_chunk, kv_chunk,
               scale=None):
    """The reference's two recomputing passes (``attention.py:bwd``) on kv
    expanded to H heads -> (dq, dk, dv) with dk, dv per query head, in
    float32: pass A sums dq over kv tiles for each q tile, pass B dk and
    dv over q tiles for each kv tile.  ``ds`` and ``p`` are cast to the
    operand's type before each product, and the products summed in
    float32."""
    B, S, H, hd = q.shape
    T, dv_ = k.shape[1], v.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    delta = torch.sum(do.to(torch.float32) * out.to(torch.float32), dim=-1)   # (B, S, H)
    qs = [slice(i, min(i + q_chunk, S)) for i in range(0, S, q_chunk)]
    ks = [slice(i, min(i + kv_chunk, T)) for i in range(0, T, kv_chunk)]

    def tile(qi, ki):
        qc, kc, vc = q[:, qi], k[:, ki], v[:, ki]
        p = _flash_tile_p(qc, kc, q_pos[:, qi], kv_pos[:, ki], lse[:, qi], scale, window)
        dp = torch.einsum("bqhv,bthv->bqht", do[:, qi].to(torch.float32),
                          vc.to(torch.float32))
        return qc, kc, p, p * (dp - delta[:, qi][..., None])

    dq = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    for qi in trips(qs):                            # pass A
        for ki in trips(ks):
            _, kc, _, ds = tile(qi, ki)
            dq[:, qi] += torch.einsum("bqht,bthd->bqhd", ds.to(kc.dtype),
                                      kc).to(torch.float32) * scale
    dk = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, T, H, dv_), dtype=torch.float32, device=q.device)
    for ki in trips(ks):                            # pass B
        for qi in trips(qs):
            qc, _, p, ds = tile(qi, ki)
            doc = do[:, qi]
            dv[:, ki] += torch.einsum("bqht,bqhv->bthv", p.to(doc.dtype),
                                      doc).to(torch.float32)
            dk[:, ki] += torch.einsum("bqht,bqhd->bthd", ds.to(qc.dtype),
                                      qc).to(torch.float32) * scale
    return dq, dk, dv


def _group_sum(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, T, H, d) per query head -> (B, T, K, d) summed over each kv
    head's H // K query heads (the transpose of ``_expand_kv``)."""
    B, T, H, d = x.shape
    return x if K == H else x.view(B, T, K, H // K, d).sum(dim=3)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's recomputing VJP
    (``attention.py:_flash_custom``).  Residuals are only q, k, v (grouped
    kv heads), the positions, ``out`` and ``lse``: the backward recomputes
    each probability tile, O(S) memory.  The forward is the flash kernel
    with its ``lse`` output when ``kernel`` (the caller's routing), else
    the chunked route."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, q_chunk, kv_chunk, kernel, scale=None):
        H = q.shape[2]
        if kernel:
            out, lse = _flash_kernel.flash_forward(q, k, v, causal=True, return_lse=True,
                                                   scale=scale)
        else:
            out, lse = _flash_fwd(q, _expand_kv(k, H), _expand_kv(v, H), q_pos, kv_pos,
                                  window, q_chunk, kv_chunk, scale)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.cfg = (window, q_chunk, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        H, K = q.shape[2], k.shape[2]
        # a named range, so a profile can split the step's device time
        with torch.profiler.record_function(BACKWARD_RANGE):
            dq, dk, dv = _flash_bwd(q, _expand_kv(k, H), _expand_kv(v, H), q_pos, kv_pos,
                                    out, lse, do, *ctx.cfg)
        return (dq.to(q.dtype), _group_sum(dk, K).to(k.dtype),
                _group_sum(dv, K).to(v.dtype), None, None, None, None, None, None, None)


def _is_arange(q_pos, kv_pos) -> bool:
    """Whether both position tensors are 0..S-1 in every row, so the
    kernel's row-index causal mask is the position mask (one device sync)."""
    ar = torch.arange(q_pos.shape[1], device=q_pos.device, dtype=q_pos.dtype)
    return bool(((q_pos == ar) & (kv_pos == ar)).all())


def flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024, arange=None, scale=None):
    """Causal (optionally windowed) attention: q (B, S, H, hd), k (B, T, K,
    hd) and v (B, T, K, dv) with K dividing H, positions (B, S) and (B, T).

    On the card with ``window == 0`` and S == T at positions 0..S-1, at
    head widths the kernel takes (``flash_attention.takes``: hd == dv <=
    128, or qk width hd up to 192 over v width dv <= 128, MLA's), it
    launches the flash kernel on the grouped kv heads; otherwise it runs
    the chunked online softmax of the reference's jnp route (a windowed
    layer always, as the reference routes it).  ``arange``
    says the positions are 0..S-1 in every row (the caller made them so);
    None checks on the device, one sync.  When q, k or v needs a gradient
    it goes through the recomputing VJP (``_FlashAttention``), whose
    forward takes the same route.  ``scale`` multiplies the scores
    (default hd^-0.5).
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    kernel = (q.is_cuda and window == 0 and S == T
              and _flash_kernel.takes(hd, v.shape[-1])
              and (arange if arange is not None else _is_arange(q_pos, kv_pos)))
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    while S % q_chunk:
        q_chunk //= 2
    while T % kv_chunk:
        kv_chunk //= 2
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_pos, kv_pos, window, q_chunk, kv_chunk,
                                     bool(kernel), scale)
    if kernel:
        return _flash_kernel.flash_forward(q, k, v, causal=True, scale=scale)
    return _flash_fwd(q, _expand_kv(k, H), _expand_kv(v, H), q_pos, kv_pos,
                      window, q_chunk, kv_chunk, scale)[0]


def _decode_attention(cfg: ModelConfig, q, k, v, positions, kv_pos, window):
    """q (B, 1, H, hd) against a cache (B, T, K, hd) with explicit kv_pos;
    the query heads of one kv head are grouped instead of expanding kv."""
    B, _, H, hd = q.shape
    T, K, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q[:, 0].to(torch.float32).reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(torch.float32)) * hd ** -0.5
    mask = (kv_pos >= 0) & (kv_pos <= positions[:, :1])       # (B, T)
    if window:
        mask &= kv_pos > positions[:, :1] - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkv->bkgv", p.to(v.dtype), v)
    return out.reshape(B, 1, H, dv).to(q.dtype)


def attention_block(cfg: ModelConfig, params, x, positions, *, kind: str = "attn",
                    cache: dict | None = None, arange: bool = False):
    """Self-attention, global (``kind`` "attn") or within ``cfg.window``
    ("local"), with an optional KV cache -> (y (B, S, d), cache).

    ``arange``: the caller made ``positions`` 0..S-1 in every row, so the
    flash kernel's route needs no check on the device.

    With a global cache, k and v are written at ``cache["pos"]`` in place.
    A prefill from position 0 attends over its own q, k and v (empty cache
    slots would get weight 0 anyway); one token decodes against the cache;
    a later chunk attends over the cache with its empty slots masked.  A
    local layer's cache is a ring (``_ring_cache_attention``).
    """
    window = cfg.window if kind == "local" else 0
    q, k, v = _project_qkv(cfg, params, x, positions)
    S = x.shape[1]
    with torch.profiler.record_function(ATTEND_RANGE):
        if cache is None:
            out = flash_attention(q, k, v, positions, positions, window=window,
                                  arange=arange or None)
        elif "kv_pos" in cache:
            out = _ring_cache_attention(cfg, q, k, v, positions, window, cache)
        else:
            pos, ck, cv = cache["pos"], cache["k"], cache["v"]
            S_max = ck.shape[1]
            if pos + S > S_max:
                raise ValueError(f"cache of {S_max} slots cannot take {S} tokens at {pos}")
            ck[:, pos:pos + S] = k
            cv[:, pos:pos + S] = v
            cache["pos"] = pos + S
            kv_pos = torch.arange(S_max, dtype=positions.dtype,
                                  device=x.device)[None, :].expand(x.shape[0], S_max)
            if S == 1:
                out = _decode_attention(cfg, q, ck, cv, positions, kv_pos, window)
            elif pos == 0:
                out = flash_attention(q, k, v, positions, positions, window=window,
                                      arange=arange or None)
            else:
                kv_pos = torch.where(kv_pos < pos + S, kv_pos, 2 ** 30)  # mask empties
                out = flash_attention(q, ck, cv, positions, kv_pos, window=window)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def _ring_cache_attention(cfg: ModelConfig, q, k, v, positions, window, cache):
    """A sliding-window ring of KV slots (slot = position % ring), written
    in place.  One token goes to its slot and attends over the ring's
    filled slots in the window; a prefill (from position 0, as serving
    starts) attends over its own tokens in the window and leaves its last
    ``min(S, ring)`` tokens in the ring."""
    S = q.shape[1]
    ck, cv, kv_pos, pos = cache["k"], cache["v"], cache["kv_pos"], cache["pos"]
    ring = ck.shape[1]
    if S == 1:
        slot = pos % ring
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        kv_pos[:, slot] = pos
        out = _decode_attention(cfg, q, ck, cv, positions, kv_pos, window)
    else:
        out = flash_attention(q, k, v, positions, positions, window=window)
        r = min(S, ring)
        idx = (pos + S - r + torch.arange(r, device=q.device)) % ring
        ck[:, idx] = k[:, -r:]
        cv[:, idx] = v[:, -r:]
        kv_pos[:, idx] = positions[:, -r:].to(kv_pos.dtype)
    cache["pos"] = pos + S
    return out


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device) -> dict:
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, s_max, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, s_max, K, hd), dtype=dtype, device=device),
            "pos": 0}


def init_ring_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device) -> dict:
    """A local layer's cache: ``min(s_max, window)`` slots, ``kv_pos`` -1."""
    ring = min(s_max, cfg.window) if cfg.window else s_max
    c = init_cache(cfg, batch, ring, dtype, device)
    c["kv_pos"] = torch.full((batch, ring), -1, dtype=torch.int32, device=device)
    return c
