"""Multi-head latent attention (DeepSeek-V2, ``repro/models/mla.py``).

Queries through a low-rank ``q_lora`` projection; keys and values from a
shared ``kv_lora`` latent ``c_kv`` plus one RoPE key ``k_rope`` shared by
every head.  The cache keeps only the latent and the rope key a token
(``kv_lora + rope_head_dim`` values against GQA's ``2 K hd``) and the host
int ``pos``, written in place.  A forward without a cache, or a prefill
from position 0, expands the latent to per-head k (qk width ``head_dim +
rope_head_dim``) and v (``v_head_dim``) and attends over its own tokens,
which on the card is the flash kernel at qk width != v width; one decoded
token attends in the latent space (``_mla_decode``), with ``wk_b`` folded
into the query and ``wv_b`` into the output.

Under a ``yarn`` setting (:class:`config.DeepSeekV2Config`) the rope
dimensions rotate by YaRN's frequencies, and the softmax scale is
``(nope + rope)^-0.5 mscale(factor, mscale_all_dim)^2``, as DeepSeek-V2
publishes them; otherwise plain RoPE and ``(nope + rope)^-0.5``.

LongCat-Flash's LoRA scales (:func:`lora_scales`): q, nope and rope parts,
times ``sqrt(d_model / q_lora)``, which is folded into the softmax scale
(exact where the factor is a power of two, as LongCat-Flash's 2 is;
otherwise the scores round once where q times the factor would round in
q's type first); the normed latent times ``sqrt(d_model / kv_lora)``
before ``wk_b`` and ``wv_b``, in the latent's type on the prefill routes
and in float32 in ``_mla_decode``.  The cache keeps the unscaled normed
latent and the rotated rope key, as DeepSeek-V2's does.

The shared rope key rotates in torch (the cache stores it).  q's rotation
and k's assembly from ``k_nope`` and that key (``_operands``) are one
launch of ``kernels/mla_rope.py`` on the card, q rotated in place (in a
copy under autograd), the same bits as the torch chain the CPU takes.
"""

from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.kernels import mla_rope
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig

# MLA forwards on the card, and the ``mla_rope`` launches their RoPE and
# operand assembly made, as program counters (``spans.count``)
FORWARDS_COUNTER = "mla.forwards"
FUSED_COUNTER = "mla.rope_fused"


def init_mla(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope_d = cfg.resolved_head_dim, cfg.rope_head_dim
    vd = cfg.v_head_dim or nope
    ql, kvl = cfg.q_lora, cfg.kv_lora

    def dense(d_in, d_out, shape=None):
        return layers.dense(generator, d_in, d_out, dtype, device, shape)

    return {"wq_a": dense(d, ql),
            "q_norm": torch.zeros((ql,), dtype=dtype, device=device),
            "wq_b": dense(ql, H * (nope + rope_d), (ql, H, nope + rope_d)),
            "wkv_a": dense(d, kvl + rope_d),
            "kv_norm": torch.zeros((kvl,), dtype=dtype, device=device),
            "wk_b": dense(kvl, H * nope, (kvl, H, nope)),
            "wv_b": dense(kvl, H * vd, (kvl, H, vd)),
            "wo": dense(H * vd, d, (H, vd, d))}


def softmax_scale(cfg: ModelConfig) -> float:
    """The attention scale: qk width^-0.5, times YaRN's mscale^2 under ``yarn``."""
    scale = (cfg.resolved_head_dim + cfg.rope_head_dim) ** -0.5
    if cfg.yarn is not None and cfg.yarn.mscale_all_dim:
        scale *= layers.yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim) ** 2
    return scale


def lora_scales(cfg: ModelConfig) -> tuple:
    """(q's, the latent's) LoRA scales: ``sqrt(d_model / q_lora)`` under
    ``mla_scale_q_lora`` and ``sqrt(d_model / kv_lora)`` under
    ``mla_scale_kv_lora``, else 1."""
    return ((cfg.d_model / cfg.q_lora) ** 0.5 if cfg.mla_scale_q_lora else 1.0,
            (cfg.d_model / cfg.kv_lora) ** 0.5 if cfg.mla_scale_kv_lora else 1.0)


def _scores_scale(cfg: ModelConfig) -> float:
    """What the scores q . k are multiplied by: the softmax scale times q's
    LoRA scale."""
    return softmax_scale(cfg) * lora_scales(cfg)[0]


def _rope_tables(cfg: ModelConfig, positions):
    """The rope dimensions' (cos, sin) tables (B, S, rope/2) float32:
    YaRN's frequencies and mscale under ``yarn``."""
    y = cfg.yarn
    if y is None:
        return layers.rope_tables(positions, cfg.rope_head_dim, cfg.rope_theta)
    freqs = layers.yarn_frequencies(cfg.rope_head_dim, cfg.rope_theta, y, positions.device)
    mscale = (layers.yarn_mscale(y.factor, y.mscale)
              / layers.yarn_mscale(y.factor, y.mscale_all_dim))
    return layers.rope_tables(positions, cfg.rope_head_dim, cfg.rope_theta, freqs, mscale)


def _mla_qkv(cfg: ModelConfig, params, x, positions):
    """-> q (B, S, H, nope + rope) with its rope dims not yet rotated, the
    rope tables (cos, sin) of ``positions``, c_kv (B, S, kv_lora) and the
    rotated rope key k_rope (B, S, rope)."""
    q_lat = layers.rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    rope = _rope_tables(cfg, positions)
    kv = x @ params["wkv_a"]
    c_kv = layers.rms_norm(kv[..., :cfg.kv_lora], params["kv_norm"], cfg.norm_eps)
    k_rope = layers.rotate_halves(kv[..., cfg.kv_lora:][:, :, None, :], *rope)
    return q, rope, c_kv, k_rope[:, :, 0]


def _operands(cfg: ModelConfig, params, q, rope, c_kv=None, k_rope=None):
    """-> (q with its rope dims rotated; and, given the latent c_kv (B, T,
    kv_lora) and the rotated rope keys k_rope (B, T, rope), k (B, T, H, nope
    + rope), the rope key repeated over the heads, and v (B, T, H, vd);
    else None, None).  ``mla_rope.rope_assemble``: on the card one launch of
    its kernel, q rotated in place; on the CPU the torch chain."""
    nope = cfg.resolved_head_dim
    k_nope = v = None
    if c_kv is not None:
        kv_scale = lora_scales(cfg)[1]
        if kv_scale != 1.0:
            c_kv = c_kv * kv_scale
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", c_kv, params["wv_b"])
    n0 = mla_rope.launches
    q, k = mla_rope.rope_assemble(q, *rope, nope, k_nope, k_rope)
    if q.is_cuda:
        spans.count(FORWARDS_COUNTER, 1)
        spans.count(FUSED_COUNTER, mla_rope.launches - n0)
    return q, k, v


def mla_block(cfg: ModelConfig, params, x, positions, *, cache: dict | None = None,
              arange: bool = False):
    """-> (y (B, S, d), cache).  ``arange`` as in ``attention.attention_block``."""
    q, rope, c_kv, k_rope = _mla_qkv(cfg, params, x, positions)
    S = x.shape[1]
    scale = _scores_scale(cfg)
    with torch.profiler.record_function(attention.ATTEND_RANGE):
        if cache is None:
            q, k, v = _operands(cfg, params, q, rope, c_kv, k_rope)
            out = attention.flash_attention(q, k, v, positions, positions, arange=arange or None,
                                            scale=scale)
        else:
            pos, cc, cr = cache["pos"], cache["c_kv"], cache["k_rope"]
            S_max = cc.shape[1]
            if pos + S > S_max:
                raise ValueError(f"cache of {S_max} slots cannot take {S} tokens at {pos}")
            cc[:, pos:pos + S] = c_kv
            cr[:, pos:pos + S] = k_rope
            cache["pos"] = pos + S
            if S == 1:
                q, _, _ = _operands(cfg, params, q, rope)
                out = _mla_decode(cfg, params, q, cc, cr, positions)
            elif pos == 0:
                # the empty slots past the prompt would get weight 0: attend over
                # the prompt's own k and v, the flash kernel's route on the card
                q, k, v = _operands(cfg, params, q, rope, c_kv, k_rope)
                out = attention.flash_attention(q, k, v, positions, positions,
                                                arange=arange or None, scale=scale)
            else:
                q, k, v = _operands(cfg, params, q, rope, cc, cr)
                kv_pos = torch.arange(S_max, dtype=positions.dtype,
                                      device=x.device)[None, :].expand(x.shape[0], S_max)
                kv_pos = torch.where(kv_pos < pos + S, kv_pos, 2 ** 30)   # mask empties
                out = attention.flash_attention(q, k, v, positions, kv_pos, scale=scale)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def _mla_decode(cfg: ModelConfig, params, q, c_kv, k_rope, positions):
    """One query (B, 1, H, nope + rope) against the latent cache (B, T,
    kv_lora) and rope keys (B, T, rope), in float32: ``wk_b`` folded into
    the query, ``wv_b`` into the output, the latent times its LoRA scale ->
    (B, 1, H, vd) in q's type."""
    nope = cfg.resolved_head_dim
    f32 = torch.float32
    c32 = c_kv.to(f32)
    kv_scale = lora_scales(cfg)[1]
    if kv_scale != 1.0:
        c32 = c32 * kv_scale
    q_lat = torch.einsum("bshk,rhk->bshr", q[..., :nope], params["wk_b"])[:, 0]
    s = torch.einsum("bhr,btr->bht", q_lat.to(f32), c32)
    s = s + torch.einsum("bshk,btk->bht", q[..., nope:].to(f32), k_rope.to(f32))
    s = s * _scores_scale(cfg)
    T = c_kv.shape[1]
    mask = torch.arange(T, dtype=positions.dtype, device=q.device)[None, :] <= positions[:, :1]
    p = torch.softmax(torch.where(mask[:, None, :], s, attention.NEG_INF), dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", p, c32)
    out = torch.einsum("bhr,rhk->bhk", o_lat, params["wv_b"].to(f32))
    return out[:, None].to(q.dtype)


def init_mla_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device) -> dict:
    return {"c_kv": torch.zeros((batch, s_max, cfg.kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, s_max, cfg.rope_head_dim), dtype=dtype,
                                  device=device),
            "pos": 0}
