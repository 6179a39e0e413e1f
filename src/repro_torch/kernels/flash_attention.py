"""Causal flash attention forward, the LM substrate's attention kernel:
q (B, S, H, hd) x k (B, T, KH, hd), v (B, T, KH, dv) -> (B, S, H, dv) in
q's dtype, with grouped-query heads (query head h reads kv head
h // (H / KH)).  The qk width hd and the v width dv are separate, as in
the reference kernel: the kernels take hd == dv up to 128, and qk widths
up to 192 over v widths up to 128 (DeepSeek-V2's MLA: 128 + 64 over 128);
:func:`takes` says which.

:func:`flash_forward` runs ``csrc/flash_attention.cu`` for CUDA tensors and
:func:`flash_forward_plain` for CPU tensors.  On the card the input type
picks the kernel: bf16 goes to the tensor-core kernels (Hopper's ``wgmma``;
past qk width 64 with 16-byte aligned rows, the warp-specialized TMA
design, :func:`tma_design`), float32 to the CUDA-core one (the tensor cores
take float32 only as TF32, which would not keep the reference's 2e-5
tolerance); any other type raises.  ``models/attention.py`` routes a
prefill that starts at position 0 here on the card, and a training
forward, which also asks for each row's log-sum-exp ``lse`` (B, S, H)
float32, the recomputing backward's residual (``return_lse``; serving
passes no lse pointer and the kernels skip it).
Both versions compute the reference kernel's function
(``repro/kernels/flash_attention.py``): scores and softmax in float32, the
unnormalized probabilities cast to v's dtype before the product with v,
the sum in float32, and the output ``acc / max(l, 1e-30)``.  The causal
mask compares row indices: key t is visible to query s iff t <= s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spans
from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128      # hd == dv up to this
MAX_QK_DIM = 192        # hd past MAX_HEAD_DIM, with dv <= MAX_HEAD_DIM
# C entry point of each input type's kernel
_ENTRY = {torch.bfloat16: "flash_forward_wgmma_launch",
          torch.float32: "flash_forward_simt_launch"}

# kernel launches through flash_forward on CUDA tensors: all of them, the
# bf16 tensor-core kernels' (of which the warp-specialized TMA design's) and
# the float32 CUDA-core kernel's
launches = 0
launches_wgmma = 0
launches_tma = 0
launches_simt = 0
# the same two counts as program counters (``spans.count``) while a profiler records
LAUNCHES_COUNTER = "flash.launches"
TMA_COUNTER = "flash.tma_launches"


def takes(hd: int, dv: int) -> bool:
    """Whether the kernels take qk width ``hd`` with v width ``dv``: each
    width pads to the kernels' tile widths, dv <= hd (the narrower v tile's
    pad is zero), both up to 128, or hd up to 192 over dv up to 128."""
    return 0 < dv <= hd and (hd <= MAX_HEAD_DIM or (hd <= MAX_QK_DIM and dv <= MAX_HEAD_DIM))


def tma_design(hd: int, dv: int, aligned: bool) -> bool:
    """Whether a bf16 launch at qk width ``hd`` over v width ``dv`` takes
    the warp-specialized TMA design (``flash_fwd_wgmma_kernel_tma``): qk
    widths past 64 (hd 128; MLA's 192 over 128) whose rows are whole
    16-byte units at 16-byte aligned addresses (``aligned``: q, k, v and the
    output), as TMA needs; every other launch takes
    ``flash_fwd_wgmma_kernel``, hd 64 among them (two blocks an SM, bound by
    its exponentials, GQA already sharing k and v).  The rule
    ``flash_forward_wgmma_launch`` applies."""
    return takes(hd, dv) and hd > 64 and hd % 8 == 0 and dv % 8 == 0 and aligned


def _check(q, k, v):
    for name, t in dict(q=q, k=k, v=v).items():
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, seq, heads, dim), got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} "
                             f"on {q.device}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide {H} query heads")
    if k.shape[1] < 1:
        raise ValueError("attention over an empty key sequence")


def flash_forward_plain(q, k, v, *, causal: bool = True, return_lse: bool = False,
                        scale: float | None = None):
    """Plain PyTorch version (any device): one masked softmax over all
    keys in float32 -> (B, S, H, dv) (v's width dv may differ from the qk
    width hd; the scale is ``scale``, default hd^-0.5), and with
    ``return_lse`` also each row's log-sum-exp (B, S, H) float32,
    ``max + log(max(l, 1e-30))``."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, G = k.shape[1], H // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.to(torch.float32), kf) * (
        hd ** -0.5 if scale is None else scale)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)                     # (B, H, S)
    acc = torch.einsum("bhqt,bthv->bqhv", p.to(v.dtype).to(torch.float32),
                       vf.to(torch.float32))
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    if not return_lse:
        return out
    return out, (m[..., 0] + torch.log(l)).transpose(1, 2).contiguous()


def flash_forward_cuda(q, k, v, *, causal: bool = True, return_lse: bool = False,
                       scale: float | None = None):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors -> (B, S, H, dv):
    the tensor-core kernel for bf16, the CUDA-core kernel for float32; with
    ``return_lse`` the kernel also writes each row's log-sum-exp (B, S, H)
    float32 -> ``(out, lse)``.  ``scale`` multiplies the scores (default
    hd^-0.5)."""
    global launches, launches_wgmma, launches_tma, launches_simt
    _check(q, k, v)
    if not q.is_cuda:
        raise ValueError("flash_forward_cuda takes CUDA tensors")
    if q.dtype not in _ENTRY:
        raise TypeError(f"the kernels take bfloat16 or float32, got {q.dtype}")
    for name, t in dict(q=q, k=k, v=v).items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, S, H, hd = q.shape
    T, KH, dv = k.shape[1], k.shape[2], v.shape[3]
    if not takes(hd, dv):
        raise ValueError(f"the kernel takes dv <= hd <= {MAX_HEAD_DIM}, or hd <= "
                         f"{MAX_QK_DIM} with dv <= {MAX_HEAD_DIM}; got hd {hd}, dv {dv}")
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    P, I = _build.P, _build.I
    args = [P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float, P]
    bf16 = q.dtype == torch.bfloat16
    tma = ctypes.c_int(0)       # the bf16 entry reports the design it ran
    fn = _build.entry("flash_attention", _ENTRY[q.dtype],
                      args + [ctypes.POINTER(ctypes.c_int)] if bf16 else args)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             P(None) if lse is None else _build.ptr(lse),
             B, S, T, H, KH, hd, dv, int(causal), hd ** -0.5 if scale is None else scale,
             _build.stream_ptr(q.device), *((ctypes.byref(tma),) if bf16 else ()))
    _build.check("flash_attention", err)
    launches += 1
    if bf16:
        launches_wgmma += 1
        launches_tma += tma.value
    else:
        launches_simt += 1
    spans.count(LAUNCHES_COUNTER, 1)
    spans.count(TMA_COUNTER, tma.value)
    return (out, lse) if return_lse else out


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, return_lse: bool = False,
                  scale: float | None = None):
    """Attention forward == ``repro.kernels.ref.flash_ref`` (kv heads
    grouped, not expanded; v's width may differ from q's and k's);
    ``return_lse`` adds each row's log-sum-exp
    (B, S, H) float32, the training backward's residual; ``scale``
    multiplies the scores (default hd^-0.5)."""
    if q.is_cuda:
        return flash_forward_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, return_lse=return_lse, scale=scale)
    return flash_forward_plain(q, k, v, causal=causal, return_lse=return_lse, scale=scale)
