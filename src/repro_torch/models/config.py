"""Model configuration for the assigned architecture pool.

One frozen dataclass covers all 10 families via a layer-kind ``pattern``
(tiled over ``n_layers``) and per-family sub-configs (MoE, MLA, RG-LRU,
xLSTM).  ``[audio]``/``[vlm]`` archs specify the transformer backbone only;
their modality frontends are stubs fed by ``input_specs()`` with precomputed
frame/patch embeddings (per assignment).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    # layer kinds tiled over n_layers: "attn" (global), "local" (windowed),
    # "rec" (RG-LRU), "mlstm", "slstm". MoE replaces the FF of attn layers.
    pattern: Tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0                       # local-attention window
    norm_eps: float = 1e-6
    gated_mlp: bool = True                # SwiGLU (True) vs GELU 2-matrix MLP
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0           # leading layers use dense FF
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    attn_kind: str = "gqa"                # "gqa" | "mla"
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- recurrent families ---
    conv_width: int = 4                   # RG-LRU / mLSTM short conv
    rnn_width: int = 0                    # RG-LRU width (0 -> d_model)
    # --- frontends / heads ---
    frontend: str = "none"                # "none" | "audio_stub" | "vision_stub"
    n_codebooks: int = 1                  # musicgen: parallel codebook heads
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # long-context capability (sub-quadratic): run long_500k iff True
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = (self.n_layers + len(self.pattern) - 1) // len(self.pattern)
        return (self.pattern * reps)[: self.n_layers]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6 N D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)


def _ff_params(cfg: ModelConfig, kind: str, layer_idx: int, active: bool) -> int:
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):
        return 0  # recurrent blocks carry their own FF inside block params
    if cfg.is_moe and layer_idx >= cfg.first_dense_layers:
        fe = cfg.d_ff_expert
        routed = cfg.n_experts * 3 * d * fe
        if active:
            routed = cfg.top_k * 3 * d * fe
        shared = cfg.n_shared_experts * 3 * d * fe
        router = d * cfg.n_experts
        return routed + shared + router
    n_mats = 3 if cfg.gated_mlp else 2
    return n_mats * d * cfg.d_ff


def _mix_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    if kind in ("attn", "local"):
        if cfg.attn_kind == "mla":
            vd = cfg.v_head_dim or hd
            qd = hd + cfg.rope_head_dim
            q = (d * cfg.q_lora + cfg.q_lora * H * qd) if cfg.q_lora else d * H * qd
            kv = d * (cfg.kv_lora + cfg.rope_head_dim)
            up = cfg.kv_lora * H * (hd + vd)
            out = H * vd * d
            return q + kv + up + out
        return d * H * hd + 2 * d * K * hd + H * hd * d
    if kind == "rec":
        w = cfg.rnn_width or d
        # in/gate proj, conv, 2 gates, lambda, out proj
        return 2 * d * w + cfg.conv_width * w + 2 * w * w // 8 + w + w * d
    if kind == "mlstm":
        up = 2 * d  # x2 up-projection
        inner = 2 * d
        return d * up * 2 // 2 + up * d + inner * (3 * inner // 1) // 1  # approx
    if kind == "slstm":
        hd_s = d // cfg.n_heads
        return 4 * d * d + 4 * cfg.n_heads * hd_s * hd_s + 2 * d * int(4 * d / 3)
    raise ValueError(kind)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d * cfg.n_codebooks  # embed
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size * cfg.n_codebooks  # lm head(s)
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "mlstm":
            # x2 up proj (gate+val), qkv from inner, out proj
            inner = 2 * d
            total += d * inner * 2 + inner * d + 3 * inner * inner // cfg.n_heads
            continue
        if kind == "slstm":
            hd_s = d // cfg.n_heads
            ff = int(4 * d / 3)
            total += 4 * d * d + 4 * cfg.n_heads * hd_s * hd_s + 2 * d * ff
            continue
        total += _mix_params(cfg, kind)
        total += _ff_params(cfg, kind, i, active_only)
        total += 2 * d  # norms
    return total
