"""Model configuration for the assigned architecture pool.

One frozen dataclass covers the reference's 10 families via a layer-kind
``pattern`` (tiled over ``n_layers``) and per-family sub-configs (MoE, MLA,
RG-LRU, xLSTM); two subclasses carry the published settings of DeepSeek-V2
(:class:`DeepSeekV2Config`) and of LongCat-Flash
(:class:`LongcatFlashConfig`, whose layer kind ``scmoe`` is a double
layer).  ``[audio]``/``[vlm]`` archs specify the transformer backbone only;
their modality frontends are stubs fed by ``input_specs()`` with
precomputed frame/patch embeddings (per assignment).
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

    # DeepSeek-V2's published routing, dispatch and RoPE scaling, at the
    # values that give every other configuration its rule (a softmax top-k
    # renormalized, capacity dispatch over all experts, plain RoPE).  Class
    # constants, not fields: the reference's config has none of them, and
    # only :class:`DeepSeekV2Config` sets them.
    topk_method = "greedy"
    n_group = 1
    topk_group = 1
    norm_topk_prob = True
    routed_scaling_factor = 1.0
    dropless = False
    held_group = None
    yarn = None
    # LongCat-Flash's (:class:`LongcatFlashConfig`), at the values that
    # leave every other configuration as it is: no zero-compute experts, no
    # selection bias on the router, no LoRA scales in MLA, no held range
    zero_experts = 0
    score_bias = False
    mla_scale_q_lora = False
    mla_scale_kv_lora = False
    held_range = None

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

    @property
    def router_width(self) -> int:
        """The router's outputs: the FFN experts, then the zero-compute ones."""
        return self.n_experts + self.zero_experts

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6 N D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's RoPE scaling (``rope_scaling`` of type ``yarn`` in a config.json):
    the context ``factor`` over ``original_max_position_embeddings``, the
    rotation counts ``beta_fast`` and ``beta_slow`` that bound the ramp
    between extrapolated and interpolated frequencies, and the ``mscale``
    factors of the rotation and of the attention scale."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


# DeepSeek-V2's ``rope_scaling`` (its config.json)
DEEPSEEK_V2_YARN = Yarn(factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
                        beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """A :class:`ModelConfig` with DeepSeek-V2's published settings
    (``DeepseekV2MoEGate``, ``DeepseekV2MoE.moe_infer``,
    ``DeepseekV2YarnRotaryEmbedding``), by default at its published values.

    ``topk_method`` "group_limited_greedy" keeps each token's ``topk_group``
    best of ``n_group`` expert groups (a group scores its best expert's
    probability) before its top-k; the gates are renormalized only under
    ``norm_topk_prob``, then scaled by ``routed_scaling_factor``.  The
    dispatch is always dropless: every routed (token, expert) pair is
    computed, with no capacity.  ``held_group``: the routing group whose
    experts this device holds (the router still scores all ``n_experts``),
    None for all.  ``yarn``: YaRN frequencies and the mscale^2 softmax scale
    on MLA's rope dimensions.
    """

    topk_method: str = "group_limited_greedy"
    n_group: int = 8
    topk_group: int = 3
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 16.0
    held_group: Optional[int] = None
    yarn: Optional[Yarn] = DEEPSEEK_V2_YARN
    dropless = True

    def __post_init__(self):
        if self.n_experts % self.n_group:
            raise ValueError(f"{self.n_group} groups do not divide {self.n_experts} experts")
        if self.held_group is not None and not 0 <= self.held_group < self.n_group:
            raise ValueError(f"held group {self.held_group} of {self.n_group}")


@dataclasses.dataclass(frozen=True)
class LongcatFlashConfig(ModelConfig):
    """A :class:`ModelConfig` with LongCat-Flash's published settings
    (``LongcatFlashDecoderLayer``, ``LongcatFlashTopkRouter``,
    ``LongcatFlashMLA``), by default at its published values.

    Every layer is a double layer (layer kind ``scmoe``, ``n_layers`` of
    them): two MLA sublayers, each followed by a dense SwiGLU of width
    ``d_ff``, and one mixture of experts on sublayer 0's feed-forward input
    whose output joins after sublayer 1 (the shortcut).  The router scores
    ``n_experts`` FFN experts and then ``zero_experts`` zero-compute
    (identity) experts in one float32 softmax; a token's ``top_k`` are
    chosen by the scores plus a learned bias (``score_bias``, for the
    choice only), and their gates are the chosen scores times
    ``routed_scaling_factor``, not renormalized.  A chosen identity expert
    adds its gate times the token.  The dispatch is always dropless.
    ``held_range``: the FFN experts ``(start, stop)`` this device holds
    (the router still scores all of them), None for all.  MLA's q is
    scaled by ``sqrt(d_model / q_lora)`` under ``mla_scale_q_lora`` and its
    normed latent by ``sqrt(d_model / kv_lora)`` before ``wk_b`` and
    ``wv_b`` under ``mla_scale_kv_lora``.
    """

    pattern: Tuple[str, ...] = ("scmoe",)
    zero_experts: int = 256
    routed_scaling_factor: float = 6.0
    mla_scale_q_lora: bool = True
    mla_scale_kv_lora: bool = True
    held_range: Optional[Tuple[int, int]] = None
    attn_kind: str = "mla"
    norm_topk_prob = False
    score_bias = True
    dropless = True

    def __post_init__(self):
        if self.pattern != ("scmoe",):
            raise ValueError(f"LongCat-Flash's layers are double layers, not {self.pattern}")
        if self.held_range is not None and not 0 <= self.held_range[0] < self.held_range[1] \
                <= self.n_experts:
            raise ValueError(f"held experts {self.held_range} of {self.n_experts}")


def held_experts(cfg: ModelConfig) -> range:
    """The FFN experts this device holds of ``cfg.n_experts``: the range
    ``held_range`` where one is set, one routing group's under
    ``held_group``, else all of them."""
    if cfg.held_range is not None:
        return range(*cfg.held_range)
    if cfg.held_group is None:
        return range(cfg.n_experts)
    size = cfg.n_experts // cfg.n_group
    return range(cfg.held_group * size, (cfg.held_group + 1) * size)


def _ff_params(cfg: ModelConfig, kind: str, layer_idx: int, active: bool) -> int:
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):
        return 0  # recurrent blocks carry their own FF inside block params
    if cfg.is_moe and layer_idx >= cfg.first_dense_layers:
        return _moe_params(cfg, active)
    n_mats = 3 if cfg.gated_mlp else 2
    return n_mats * d * cfg.d_ff


def _moe_params(cfg: ModelConfig, active: bool) -> int:
    """An expert layer's: the held (or, ``active``, top-k) experts, the
    shared ones and the router (with its selection bias)."""
    d, fe = cfg.d_model, cfg.d_ff_expert
    routed = (cfg.top_k if active else len(held_experts(cfg))) * 3 * d * fe
    shared = cfg.n_shared_experts * 3 * d * fe
    router = (d + cfg.score_bias) * cfg.router_width
    return routed + shared + router


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
        if kind == "scmoe":
            # two MLA sublayers and dense SwiGLUs, four norms, one expert layer
            total += 2 * (_mix_params(cfg, "attn") + 3 * d * cfg.d_ff + 2 * d)
            total += _moe_params(cfg, active_only)
            continue
        total += _mix_params(cfg, kind)
        total += _ff_params(cfg, kind, i, active_only)
        total += 2 * d  # norms
    return total
