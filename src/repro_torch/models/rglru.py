"""RG-LRU recurrent block (Griffin / RecurrentGemma, ``repro/models/rglru.py``).

The real-gated linear recurrent unit, a diagonal recurrence

    a_t = exp(-c softplus(Lambda) r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

with gates r_t, i_t = sigmoid(linear(u_t)) in float32, inside Griffin's
gated branch merge: ``out = W_out(gelu(W_gate x) * RG-LRU(conv4(W_x x)))``.
Training and prefill run the recurrence over the sequence as a log-depth
scan (:func:`linear_scan`, the counterpart of the reference's
``jax.lax.associative_scan``); decode is one step on the carried ``h``.
The cache holds ``h`` (B, w) float32, the causal conv's last
``conv_width - 1`` inputs and the host int ``pos``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

_C = 8.0
# the profiler range around the recurrence (the scan, or a decode step)
SCAN_RANGE = "rglru_scan"


def init_rglru(generator, cfg: ModelConfig, dtype, device) -> dict:
    """Weights as the reference draws them; ``lam`` (w,) float32 whatever
    ``dtype`` is, set so that a spans [0.9, 0.999] at r = 1 (Griffin)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(lin) / _C)).to(device)

    def dense(d_in, d_out):
        return layers.dense(generator, d_in, d_out, dtype, device)

    return {"wx": dense(d, w), "wgate": dense(d, w),
            "conv": layers.normal(generator, (cfg.conv_width, w), 0.1, dtype, device),
            "w_r": dense(w, w), "w_i": dense(w, w), "lam": lam, "wout": dense(w, d)}


def _causal_conv(u, w, state):
    """Depthwise causal conv of width cw: u (B, S, w), state (B, cw - 1, w)
    or None (zeros) -> (out, the last cw - 1 inputs)."""
    cw = w.shape[0]
    S = u.shape[1]
    pad = (torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype, device=u.device)
           if state is None else state.to(u.dtype))
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i:i + S] * w[i] for i in range(cw))
    return out, (full[:, -(cw - 1):] if cw > 1 else None)


def _rglru_gates(params, u):
    """-> (a, b) (B, S, w) float32 of h_t = a_t h_{t-1} + b_t."""
    r = torch.sigmoid((u @ params["w_r"]).to(torch.float32))
    i = torch.sigmoid((u @ params["w_i"]).to(torch.float32))
    log_a = -_C * F.softplus(params["lam"]) * r
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * u.to(torch.float32))
    return torch.exp(log_a), b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, in ceil(log2 S)
    doubling steps (Hillis-Steele): after the step of offset o, each t holds
    the composition of elements t - 2o + 1 .. t, (A, B) o (A', B') =
    (A A', B A' + B'), the reference's ``combine``."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]], dim=1)
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_block(cfg: ModelConfig, params, x, *, cache: dict | None = None):
    """(B, S, d) -> (y (B, S, d), cache), the cache updated in place."""
    gate = F.gelu(x @ params["wgate"], approximate="tanh")
    u, conv_state = _causal_conv(x @ params["wx"], params["conv"],
                                 None if cache is None else cache["conv"])
    a, b = _rglru_gates(params, u)
    S = x.shape[1]
    with torch.profiler.record_function(SCAN_RANGE):
        if cache is None or S > 1:
            if cache is not None:   # a carried h folds into the first step's offset
                b = torch.cat([b[:, :1] + a[:, :1] * cache["h"][:, None], b[:, 1:]], dim=1)
            h = linear_scan(a, b)
            if cache is not None:
                cache.update(h=h[:, -1], conv=conv_state, pos=cache["pos"] + S)
        else:
            h1 = a[:, 0] * cache["h"] + b[:, 0]
            cache.update(h=h1, conv=conv_state, pos=cache["pos"] + 1)
            h = h1[:, None]
    return (gate * h.to(gate.dtype)) @ params["wout"], cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
            "pos": 0}
