"""Device resolution shared by the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``).  A
CUDA request on a machine without a card raises: nothing falls back to
the CPU behind the caller's back.  ``meta`` (shapes and types, no data)
is accepted when asked for by name: the dry-run traces on it.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda', 'cpu' or 'meta'")
    return dev
