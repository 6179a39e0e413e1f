"""Fault-tolerant checkpointing: atomic, async, with retention.

The on-disk layout is the reference's, so a checkpoint written by one
package restores in the other: ``<dir>/step_<n:010d>/arrays.npz`` (one
compressed array per key) beside ``manifest.json`` (step, structure,
array count and the caller's ``extra`` dict).

  * **flat dicts**: a checkpoint holds ``{key: tensor or ndarray}``; the
    reference's ``{"ta": bank}`` pytree flattens to the same key ``ta``,
    and its LM ``{"params": tree}`` to ``params/groups/0/0/mix/wq`` and
    the like, to any depth (MoE's ``params/groups/1/0/ff/shared/gate``:
    the reference joins a leaf's path with ``/``);
  * **bf16** is written as the reference writes it, numpy's 2-byte void
    (numpy has no bfloat16), and restored into a bf16 target bit for bit;
  * **atomic**: written to ``step_<n>.tmp`` then renamed, so a writer
    killed mid-save never corrupts the latest checkpoint, and a manager
    removes such ``.tmp`` debris when it opens the directory;
  * **async**: ``CheckpointManager.save(..., blocking=False)`` copies the
    arrays to the host and hands them to a writer thread; a failed write
    surfaces on the next ``wait()`` or ``save()``;
  * retention: keep the newest ``max_to_keep`` steps;
  * elastic restore: ``shardings`` places arrays block by block on a
    mesh's devices (``core/sharding.NamedSharding``), whatever layout
    wrote them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime import faults


def _step_of(name: str) -> Optional[int]:
    """Parse a ``step_<n>`` directory name; None for tmp/malformed entries
    (a killed writer's ``step_*.tmp`` debris or a stray file must not crash
    ``latest_step`` or the retention sweep)."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def _to_host(arrays: dict) -> dict:
    out = {}
    for k, v in arrays.items():
        if not isinstance(k, str):
            raise ValueError(f"checkpoint keys are strings, got {k!r}")
        if isinstance(v, torch.Tensor):
            # a copy, so an async write never sees a later in-place update
            v = v.detach().to("cpu", copy=True)
            out[k] = (v.view(torch.int16).numpy().view("V2")
                      if v.dtype == torch.bfloat16 else v.numpy())
        else:
            out[k] = np.array(v)
    return out


def _from_host(host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    host = np.ascontiguousarray(host)
    if dtype == torch.bfloat16 and host.dtype.kind == "V" and host.dtype.itemsize == 2:
        return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(host).to(dtype=dtype)


def save_checkpoint(directory: str, step: int, arrays: dict,
                    extra: Optional[dict] = None) -> str:
    """Atomic synchronous save of a flat dict; returns the final path."""
    faults.raise_if("ckpt.write_fail")
    flat = _to_host(arrays)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez_compressed(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "treedef": "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in sorted(flat)) + "})",
        "n_arrays": len(flat),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [s for s in map(_step_of, os.listdir(directory)) if s is not None]
    return max(steps) if steps else None


def load_checkpoint(directory: str, target: dict, *,
                    step: Optional[int] = None,
                    shardings: Optional[dict] = None) -> tuple:
    """Restore the keys of ``target`` -> ``(arrays, extra)``.

    A key whose target value is a tensor comes back as a tensor of that
    dtype on that device; any other target value gives a numpy array.
    A key that ``shardings`` maps to a ``core/sharding.NamedSharding``
    comes back as a ``ShardedTensor``: each mesh coordinate's block on its
    device (elastic restore onto any mesh).
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, like in target.items():
            host = z[key]
            shd = (shardings or {}).get(key)
            if isinstance(like, torch.Tensor):
                t = _from_host(host, like.dtype)
                out[key] = t.to(like.device) if shd is None else shd.place(t)
            else:
                out[key] = host if shd is None else shd.place(host)
    return out, manifest.get("extra", {})


class CheckpointManager:
    """Async writer + retention policy around save/load.

    A failed background write is never swallowed: the exception is captured
    in the writer thread and re-raised on the next ``wait()`` (which
    ``save()`` calls first), so a training loop cannot run on for hours
    believing its checkpoints are landing when the disk is full.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        # a writer killed mid-save leaves a step_*.tmp dir; it is garbage
        # (the atomic rename never happened) and would otherwise accumulate
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    def wait(self) -> None:
        """Join the async writer; re-raise its failure if it died."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, arrays: dict, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        host = _to_host(arrays)   # device -> host before the step loop goes on

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra)
                self._gc()
            except BaseException as e:  # surfaced by the next wait()/save()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, target: dict, shardings: Optional[dict] = None,
                step: Optional[int] = None) -> tuple:
        return load_checkpoint(self.directory, target, step=step,
                               shardings=shardings)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(s for s in map(_step_of, os.listdir(self.directory))
                       if s is not None)
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
