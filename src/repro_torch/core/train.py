"""Tsetlin-machine training and evaluation steps, and the ``fit`` loop.

Two steps, both equal to the reference's bit for bit from the same bank:

  * ``train_step``: the per-sample ``jax.random`` step
    (``feedback.batch_feedback_delta``), the paper-faithful trainer and
    ``fit``'s default (``engine="jnp"``); its draws are torch ops on the
    bank's device (``core/prng.py``);
  * ``train_step_kernel``: the hash-RNG batch step of ``kernels/ops.py``
    (``tm_train_step_kernel``, ``engine="kernel"``): on a CUDA device the
    fused form is two kernel launches, the unfused form three; on the CPU
    the kernels' plain versions run.

``fit(mesh=...)`` runs the hash-RNG step clause-sharded over a device
mesh (``core/sharding.py``), with the same bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import feedback, prng, tm


def _metrics(new_ta: torch.Tensor, delta: torch.Tensor) -> dict:
    return {"delta_abs_sum": int(delta.abs().sum()),
            "include_frac": float((new_ta >= 0).to(torch.float32).mean())}


def train_step(config: tm.TMConfig, state: tm.TMState, x: torch.Tensor,
               y: torch.Tensor, rng) -> Tuple[tm.TMState, dict]:
    """One per-sample ``jax.random`` batch step of ``state`` from the key
    ``rng`` -> ``(new_state, metrics)``."""
    delta = feedback.batch_feedback_delta(config, state.ta_state, x, y, rng)
    new_ta = feedback.apply_delta(config, state.ta_state, delta)
    return tm.TMState(ta_state=new_ta, steps=state.steps + 1), _metrics(new_ta, delta)


def train_step_kernel(config: tm.TMConfig, state: tm.TMState, x: torch.Tensor,
                      y: torch.Tensor, seed: int, batch_chunk: int | None = None,
                      fuse: bool = True) -> Tuple[tm.TMState, dict]:
    """One batch step of ``state`` (hash RNG seeded by ``seed``) ->
    ``(new_state, metrics)``."""
    from repro_torch.kernels import ops

    new_ta, delta = ops.tm_train_step_kernel(config, state.ta_state, x, y, seed,
                                             batch_chunk=batch_chunk, fuse=fuse)
    return tm.TMState(ta_state=new_ta, steps=state.steps + 1), _metrics(new_ta, delta)


def online_step(config: tm.TMConfig, ta_state: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, seed: int) -> Tuple[torch.Tensor, int]:
    """One streaming-feedback step on a raw bank -> ``(new_ta,
    delta_abs_sum)``.  The previous bank is left as it was (rollback and
    drain checkpoints need it)."""
    from repro_torch.kernels import ops

    new_ta, delta = ops.tm_train_step_kernel(config, ta_state, x, y, seed)
    return new_ta, int(delta.abs().sum())


def eval_step(config: tm.TMConfig, state: tm.TMState, x: torch.Tensor,
              y: torch.Tensor) -> float:
    return tm.accuracy(config, state, x, y)


def fit(
    config: tm.TMConfig,
    state: tm.TMState,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    epochs: int,
    batch_size: int,
    rng,
    x_val=None,
    y_val=None,
    log_every: int = 0,
    engine: str = "jnp",
    batch_chunk: int | None = None,
    mesh=None,
    ckpt_manager=None,
    ckpt_every: int = 0,
    preemption=None,
    monitor=None,
) -> tm.TMState:
    """Host loop over epochs on ``state.ta_state``'s device, with the
    reference's key stream from the key ``rng`` (``prng.PRNGKey``).

    Each epoch splits ``rng`` once and shuffles with
    ``permutation(sub, n)``, then slices contiguous batches; each step
    splits ``rng`` again.  ``engine="jnp"`` (the default) runs
    ``train_step`` on the step's key; ``engine="kernel"`` runs the hash-RNG
    step seeded by the global step index.  Either way the bank equals the
    reference's ``fit`` with the same engine and key.

    ``mesh`` (a ``launch/mesh.Mesh``, with ``engine="kernel"``) runs every
    step through ``core/sharding.py:sharded_train_step_fn(engine="kernel")``:
    automata split over ``model``, the batch over the data axes.  The
    shuffle stream and per-step seeds are unchanged and the sharded step
    gives the single-device step's bits, so the bank does not depend on
    the mesh.

    **Fault tolerance.**  ``ckpt_manager`` with ``ckpt_every > 0`` saves
    the bank, the EPOCH-START key (``"rng"``, uint32 ``(2,)`` as the
    reference saves it) and the ``(epoch, step_in_epoch, gstep)`` cursor,
    and resumes from the newest checkpoint when the directory holds one:
    the epoch's permutation is derived again from the saved key and the
    consumed steps' splits are replayed, so an interrupted run ends on the
    bank of an uninterrupted one, and a checkpoint of either package
    resumes in the other.  ``preemption`` (a ``PreemptionHandler``) turns
    SIGTERM into checkpoint + ``sys.exit(RESUME_EXIT_CODE)`` at the next
    step boundary; ``monitor`` (a ``StragglerMonitor``) flags slow steps.
    Fault sites: ``train.sigterm`` and ``train.slow_step``, keyed by the
    global step index.
    """
    from repro_torch.runtime import faults

    if engine not in ("jnp", "kernel"):
        raise ValueError(f"fit(engine={engine!r}): engine is 'jnp' or 'kernel'")
    sharded_step = None
    if mesh is not None:
        if engine != "kernel":
            raise ValueError("fit(mesh=...) requires engine='kernel' "
                             "(the hash-RNG step; no cross-shard RNG state)")
        from repro_torch.core import sharding

        sharded_step = sharding.sharded_train_step_fn(
            config, mesh, batch_chunk=batch_chunk, engine="kernel")
    dev = state.ta_state.device
    rng = prng.as_key(rng, dev)
    x, y = x.to(dev), y.to(dev)
    n = x.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    gstep = 0
    start_epoch = start_step = 0
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        restored, extra = ckpt_manager.restore(
            {"ta": state.ta_state, "rng": _key_np(rng)})
        rng = prng.as_key(restored["rng"], dev)       # epoch-start key
        start_epoch = int(extra["epoch"])
        start_step = int(extra["step_in_epoch"])
        gstep = int(extra["gstep"])
        state = tm.TMState(ta_state=restored["ta"], steps=gstep)
        print(f"fit: resumed at epoch {start_epoch} step {start_step} "
              f"(global step {gstep})")

    def save_ckpt(ep, next_step, rng_epoch, blocking=True):
        ckpt_manager.save(
            gstep, {"ta": state.ta_state, "rng": _key_np(rng_epoch)},
            extra={"epoch": ep, "step_in_epoch": next_step, "gstep": gstep},
            blocking=blocking)

    for ep in range(start_epoch, epochs):
        rng_epoch = rng                    # resume anchor: key at epoch start
        rng, rp = prng.split(rng).unbind(0)
        perm = prng.permutation(rp, n)
        xs, ys = x[perm], y[perm]          # one shuffle per epoch
        i0 = start_step if ep == start_epoch else 0
        for _ in range(i0):                # replay the consumed steps' splits
            rng = prng.split(rng)[0]
        for i in range(i0, steps_per_epoch):
            if monitor is not None:
                monitor.start_step()
            xb = xs[i * batch_size:(i + 1) * batch_size]
            yb = ys[i * batch_size:(i + 1) * batch_size]
            rng, rs = prng.split(rng).unbind(0)
            if sharded_step is not None:
                state = tm.TMState(ta_state=sharded_step(state.ta_state, xb, yb, gstep),
                                   steps=state.steps + 1)
            elif engine == "kernel":
                state, _ = train_step_kernel(config, state, xb, yb, gstep,
                                             batch_chunk)
            else:
                state, _ = train_step(config, state, xb, yb, rs)
            faults.sleep_if("train.slow_step", step=gstep)
            gstep += 1
            if monitor is not None:
                flag = monitor.end_step(gstep - 1)
                if flag:
                    print(f"fit: straggler flagged: {flag}")
            if (ckpt_manager is not None and ckpt_every
                    and gstep % ckpt_every == 0):
                save_ckpt(ep, i + 1, rng_epoch, blocking=False)
            faults.sigterm_if("train.sigterm", step=gstep - 1)
            if preemption is not None and preemption.preempted:
                print("fit: preempted — checkpointing and exiting for resume")
                preemption.checkpoint_and_exit(
                    (lambda: save_ckpt(ep, i + 1, rng_epoch))
                    if ckpt_manager is not None else (lambda: None))
        if log_every and (ep + 1) % log_every == 0 and x_val is not None:
            print(f"epoch {ep + 1}: val_acc={eval_step(config, state, x_val, y_val):.4f}")
    if ckpt_manager is not None:
        ckpt_manager.wait()              # surface any pending async failure
    return state


def _key_np(key: torch.Tensor) -> np.ndarray:
    """A key as the reference checkpoints it: uint32 (2,)."""
    return key.cpu().numpy().astype(np.uint32)
