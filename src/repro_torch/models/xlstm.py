"""xLSTM blocks (``repro/models/xlstm.py``): the chunkwise-parallel mLSTM
and the sequential sLSTM.

mLSTM: a matrix memory per head with scalar gates,

    S_t = f_t S_{t-1} + i_t k_t v_t^T,  n_t = f_t n_{t-1} + i_t k_t,
    h_t = (S_t^T q_t) / max(|n_t^T q_t|, 1)

(the reference's sigmoid input gate, float32 sums), computed chunkwise:
a quadratic form inside a chunk, the recurrence across chunks.  The
prefill's final (S, n) goes to the cache; decode is one recurrent step.

sLSTM: scalar memory with exponential gates and the m_t stabilizer
(m starts at -30), block-diagonal recurrent weights per head: a step loop
within 64-token chunks, each chunk under ``torch.utils.checkpoint`` when a
gradient is needed (the reference's ``jax.checkpoint``), so the backward
holds the chunk boundaries' states and one chunk's steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.trace_scope import fold_backward, trips, unfolded

_GATES = ("z", "i", "f", "o")
# profiler ranges around the mLSTM core (chunkwise, or a decode step) and
# the sLSTM step loop
MLSTM_RANGE = "mlstm_core"
SLSTM_RANGE = "slstm_steps"


# -- mLSTM -------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    di = 2 * cfg.d_model               # projection factor 2
    return di, di // cfg.n_heads


def init_mlstm(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    di, dh = _mlstm_dims(cfg)

    def dense(d_in, d_out):
        return layers.dense(generator, d_in, d_out, dtype, device)

    def heads():
        return layers.normal(generator, (H, dh, dh), dh ** -0.5, dtype, device)

    return {"w_up": dense(d, di), "w_gate": dense(d, di), "wq": heads(), "wk": heads(),
            "wv": heads(), "w_f": dense(di, H), "w_i": dense(di, H),
            "out_norm": torch.zeros((dh,), dtype=dtype, device=device),
            "w_down": dense(di, d)}


def _mlstm_core_chunked(q, k, v, log_f, i_gate, chunk: int = 512, state=None):
    """q, k, v (B, S, H, dh) in the model's type; log_f (<= 0) and i_gate
    (B, S, H) float32; ``state`` (S (B, H, dh, dh), n (B, H, dh)) float32 or
    None (zeros) -> (out (B, S, H, dh) float32, the final (S, n)).

    ``chunk`` halves until it divides S.  q . k is a float32-accumulated
    product with a float32 result (the reference's ``dot_general`` with
    ``preferred_element_type``): the operands are cast to float32 first.
    The products with v take their operands in v's type and are cast to
    float32 after, as the reference's einsums are."""
    B, S, H, dh = q.shape
    f32 = torch.float32
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if state is None:
        state = (torch.zeros((B, H, dh, dh), dtype=f32, device=q.device),
                 torch.zeros((B, H, dh), dtype=f32, device=q.device))
    S_st, n_st = state
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, lf, ig = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], i_gate[:, sl]
        clf = torch.cumsum(lf, dim=1)                   # decay from the chunk's start
        dec_q = torch.exp(clf)[..., None]
        tot = torch.exp(clf[:, -1])                     # (B, H) the whole chunk's decay
        qd = qc.to(f32) * dec_q
        o_inter = torch.einsum("bthk,bhkv->bthv", qd, S_st)
        d_inter = torch.einsum("bthk,bhk->bth", qd, n_st)
        # att[t, s] = (q_t . k_s) exp(clf_t - clf_s) i_s for s <= t.  The
        # exponent is masked before exp, the reference's exp after: above the
        # diagonal clf_t - clf_s > 0 grows with the chunk and passes float32's
        # exp range at full length, where the reference's gradient is then
        # 0 x inf = NaN; the values are the same
        w_ts = torch.exp(torch.where(causal[None, :, :, None],
                                     clf[:, :, None, :] - clf[:, None, :, :], -torch.inf))
        w_ts = w_ts * ig[:, None]                                           # (B, t, s, H)
        att = torch.einsum("bthk,bshk->btsh", qc.to(f32), kc.to(f32)) * w_ts
        o_intra = torch.einsum("btsh,bshv->bthv", att.to(kc.dtype), vc).to(f32)
        d_intra = att.sum(dim=2)
        kw = kc.to(f32) * (torch.exp(clf[:, -1:, :] - clf) * ig)[..., None]
        S_st = S_st * tot[:, :, None, None] + torch.einsum(
            "bshk,bshv->bhkv", kw.to(kc.dtype), vc).to(f32)
        n_st = n_st * tot[:, :, None] + kw.sum(dim=1)
        den = torch.clamp(torch.abs(d_inter + d_intra), min=1.0)[..., None]
        outs.append((o_inter + o_intra) / den)
    return torch.cat(outs, dim=1), (S_st, n_st)


def mlstm_block(cfg: ModelConfig, params, x, *, cache: dict | None = None):
    """(B, S, d) -> (y (B, S, d), cache), the cache updated in place."""
    B, S, _ = x.shape
    H = cfg.n_heads
    di, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    u = x @ params["w_up"]
    g = x @ params["w_gate"]
    uh = u.view(B, S, H, dh)
    q = torch.einsum("bshk,hkj->bshj", uh, params["wq"])
    k = torch.einsum("bshk,hkj->bshj", uh, params["wk"]) * dh ** -0.5
    v = torch.einsum("bshk,hkj->bshj", uh, params["wv"])
    log_f = F.logsigmoid((u @ params["w_f"]).to(f32))          # (B, S, H)
    i_g = torch.sigmoid((u @ params["w_i"]).to(f32))
    with torch.profiler.record_function(MLSTM_RANGE):
        if cache is None or S > 1:
            state = None if cache is None else (cache["S"], cache["n"])
            h, (S_f, n_f) = _mlstm_core_chunked(q, k, v, log_f, i_g, state=state)
            if cache is not None:
                cache.update(S=S_f, n=n_f, pos=cache["pos"] + S)
        else:   # one recurrent step, float32 (the bf16 operands promote)
            f = torch.exp(log_f[:, 0])[..., None]                  # (B, H, 1)
            ik = i_g[:, 0, :, None] * k[:, 0].to(f32)
            S_new = cache["S"] * f[..., None] + torch.einsum("bhk,bhv->bhkv", ik,
                                                              v[:, 0].to(f32))
            n_new = cache["n"] * f + ik
            q0 = q[:, 0].to(f32)
            num = torch.einsum("bhk,bhkv->bhv", q0, S_new)
            den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", q0, n_new)), min=1.0)
            h = (num / den[..., None])[:, None]
            cache.update(S=S_new, n=n_new, pos=cache["pos"] + 1)
    h = layers.rms_norm(h.to(x.dtype), params["out_norm"], cfg.norm_eps)
    h = h.reshape(B, S, di) * F.silu(g)
    return h @ params["w_down"], cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    _, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    return {"S": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
            "pos": 0}


# -- sLSTM -------------------------------------------------------------------

def init_slstm(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    p = {}
    for name in _GATES:
        p[f"w_{name}"] = layers.dense(generator, d, d, dtype, device)
        p[f"r_{name}"] = layers.normal(generator, (H, dh, dh), dh ** -0.5, dtype, device)
    p["w_out"] = layers.dense(generator, d, d, dtype, device)
    return p


def _slstm_chunk(H, dtype, w_in, r_rec, c, n, h, m, xc):
    """One chunk's steps: xc (B, c, d); the state c, n, h, m (B, H, dh)
    float32 -> (c, n, h, m, hs (B, c, H, dh) float32).  ``w_in`` (d, 4 d)
    and ``r_rec`` (H, dh, 4 dh) hold the four gates' weights side by side
    (z, i, f, o): one product a step gives each gate's columns as its own
    product would."""
    B, T, d = xc.shape
    dh = d // H
    f32 = torch.float32
    gx = (xc @ w_in).to(f32).view(B, T, 4, H, dh)
    hs = []
    for t in range(T):
        rec = torch.einsum("bhk,hkj->bhj", h.to(dtype), r_rec).to(f32).view(B, H, 4, dh)
        gz, gi, gf, go = (gx[:, t, j] + rec[:, :, j] for j in range(4))
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        m_new = torch.maximum(gf + m, gi)       # log-space exponential gates
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(gf + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return c, n, h, m, torch.stack(hs, dim=1)


def _slstm_scan(cfg: ModelConfig, params, x, state: dict, chunk: int = 64):
    """x (B, S, d); ``state`` c, n, h, m (B, H, dh) float32 -> (out (B, S, d)
    in x's type, the final state).  ``chunk`` halves until it divides S."""
    B, S, d = x.shape
    H = cfg.n_heads
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    w_in = torch.cat([params[f"w_{g}"] for g in _GATES], dim=1)
    r_rec = torch.cat([params[f"r_{g}"] for g in _GATES], dim=2)
    st = tuple(state[key] for key in ("c", "n", "h", "m"))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_in, r_rec, *st))
    outs = []
    starts = range(0, S, chunk)
    for c0 in trips(starts):
        args = (w_in, r_rec, *st, x[:, c0:c0 + chunk])
        if grad:
            *st, hs = fold_backward(
                lambda *a: checkpoint(_slstm_chunk, H, x.dtype, *a, use_reentrant=False,
                                      preserve_rng_state=False), *args)
        else:
            *st, hs = _slstm_chunk(H, x.dtype, *args)
        outs.append(hs)
    out = torch.cat(unfolded(outs, starts), dim=1).reshape(B, S, d).to(x.dtype)
    return out, dict(zip(("c", "n", "h", "m"), st))


def slstm_block(cfg: ModelConfig, params, x, *, cache: dict | None = None):
    """(B, S, d) -> (y (B, S, d), cache), the cache updated in place."""
    state = (init_slstm_state(cfg, x.shape[0], x.device) if cache is None
             else {k: cache[k] for k in ("c", "n", "h", "m")})
    with torch.profiler.record_function(SLSTM_RANGE):
        h, state = _slstm_scan(cfg, params, x, state)
    if cache is not None:
        cache.update(state, pos=cache["pos"] + x.shape[1])
    return h @ params["w_out"], cache


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    dh = cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z, "h": z, "m": z - 30.0}


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    return dict(init_slstm_state(cfg, batch, device), pos=0)
