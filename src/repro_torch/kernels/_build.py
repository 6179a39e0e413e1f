"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` process into a shared
library with a plain C interface, all sources in parallel, and loads with
``ctypes``.  No source includes PyTorch's headers, so a build takes seconds
rather than the minutes a ``torch.utils.cpp_extension`` build takes.  The
build runs at first CUDA use (never at import, so the CPU tests import every
module) into ``build/repro_torch_kernels/`` at the root of the checkout.
A library's file name carries a hash of its sources and flags, so an edited
source never loads a stale library.

A missing toolkit, a failed compile or a library that does not load raises
:class:`KernelBuildError`: the kernels are absent, so the engine ladder lets
it through instead of serving from a slower rung (``kernels/ops.py``).

Wrappers pass device pointers (``tensor.data_ptr()``) and PyTorch's current
stream as ``c_void_p``; each C entry point returns ``cudaGetLastError()``
right after its launch, and the wrapper raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

from repro_torch import spans

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_infer", "sparse_infer", "term_infer", "clause_eval",
           "class_sum", "ta_update", "fused_train", "xnor_popcount",
           "flash_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_lock = threading.Lock()
_libs: dict = {}
# seconds the last build() spent compiling (0.0 when every library was cached)
last_build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels build only where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every missing library (one nvcc per source, all at once) and
    load all of them; returns ``{name: ctypes.CDLL}``.  Thread-safe."""
    global last_build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            log = out.with_suffix(".log").open("w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
        failed = []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name}: nvcc exit {rc}\n"
                              + out.with_suffix(".log").read_text())
        last_build_seconds = time.perf_counter() - t0 if procs else 0.0
        if failed:
            raise KernelBuildError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            try:
                _libs[name] = ctypes.CDLL(str(_lib_path(name)))
            except OSError as e:
                raise KernelBuildError(f"cannot load the {name} kernels: {e}") from e
        return _libs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) from the build of ``name``, or "" when it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def entry(name: str, fn: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry point ``fn`` of library ``name``, built on first use."""
    f = getattr(build()[name], fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        es = getattr(build()[name], f"{name}_error_string")
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({es(err).decode()})")


def occupancy(name: str, *shape: int, extra: tuple = ()) -> dict:
    """What ``<name>_occupancy(*shape, info)`` reports of the kernel's launch
    at that shape: registers a thread, threads a block, resident blocks per
    SM, shared bytes a block and local (spill) bytes a thread, then the
    ``extra`` fields the entry point writes after them."""
    keys = ("registers", "threads", "blocks_per_sm", "shared_bytes", "local_bytes",
            *extra)
    info = (ctypes.c_int * len(keys))()
    f = entry(name, f"{name}_occupancy", [I] * len(shape) + [P])
    check(name, f(*shape, ctypes.cast(info, P)))
    return dict(zip(keys, info))


# (what, id(tensor)) -> (weak reference, versions and tag, deps' references,
# value); an entry leaves with its tensor
_derived: dict = {}


def derived(what: str, tensor, fn, *deps, tag=None):
    """``fn(tensor, *deps)``, derived once (in a build span,
    ``spans.BUILD_RANGE``) and reused while ``tensor`` and ``deps`` are the
    same tensors at the same versions and ``tag`` is equal, so the kernels'
    wrappers launch nothing for it after the first call.  ``what`` keeps
    apart the derivations of one tensor."""
    key = (what, id(tensor))
    ver = (tensor._version, tag, *(d._version for d in deps))
    hit = _derived.get(key)
    if (hit is not None and hit[0]() is tensor and hit[1] == ver
            and all(r() is d for r, d in zip(hit[2], deps))):
        return hit[3]
    with spans.span(spans.BUILD_RANGE):
        value = fn(tensor, *deps)
    _derived[key] = (weakref.ref(tensor, lambda _: _derived.pop(key, None)), ver,
                     tuple(weakref.ref(d) for d in deps), value)
    return value


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint32
