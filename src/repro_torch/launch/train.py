"""Training entry point: the paper's Tsetlin machine on the port's kernels,
and the LM substrate's families.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tm-mnist \\
        --steps 200 --batch-size 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch tm-tiny \\
        --device cpu --steps 20 --batch-size 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --device cpu --steps 3

The loop wires the prefetching loader, async atomic checkpoints with
restart-resume, preemption handling and the straggler monitor around the
hash-RNG batch step (``ops.tm_train_step_kernel``): fused (two kernel
launches per step) by default, unfused with ``--no-fuse``; ``--autotune``
launches the two fused kernels as ``kernels/autotune.py``'s cached sweeps
pick (the bank is the same bits either way).  ``--mesh`` runs the step
clause-sharded over a device mesh (``core/sharding.py``, the same bits;
on one card set ``REPRO_TORCH_FORCE_DEVICE_COUNT`` to lay logical devices
over it).  A checkpoint
written by the reference's ``repro.launch.train`` resumes here and the
reverse: the layout, the loader and every draw are the same.  It runs on
the card unless ``--device cpu`` asks for the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch


def train_tm(args) -> tuple[torch.Tensor, dict]:
    """Train ``args.arch`` for ``args.steps`` steps -> ``(bank, health)``.

    The initial bank is ``tm.init`` from ``PRNGKey(--seed)``, the
    reference's bank; step ``s`` is seeded with ``s``; batches come from the
    reference's ``ShardedBatcher`` over its synthetic datasets.  Prints a
    test-accuracy line every ``--log-every`` steps and the ``TRAIN_HEALTH``
    JSON line at the end (also returned).
    """
    from repro_torch import device as _device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.core import prng, tm
    from repro_torch.data.loader import ShardedBatcher
    from repro_torch.data.synthetic import (make_boolean_classification,
                                            paper_dataset)
    from repro_torch.kernels import ops
    from repro_torch.runtime import faults
    from repro_torch.runtime.preemption import (RESUME_EXIT_CODE,
                                                PreemptionHandler)
    from repro_torch.runtime.straggler import StragglerMonitor

    dev = _device.resolve(args.device)
    config = TM_CONFIGS[args.arch]
    name = args.arch.replace("tm-", "")
    if name in ("mnist", "kmnist", "fmnist", "cifar2", "kws6"):
        X, y, Xte, yte = paper_dataset(name, n_train=args.n_train)
    else:
        X, y = make_boolean_classification(
            args.n_train, config.n_features, config.n_classes, seed=0)
        Xte, yte = make_boolean_classification(
            1000, config.n_features, config.n_classes, seed=1)
    x_test = torch.from_numpy(Xte).to(dev)
    y_test = torch.from_numpy(yte).to(dev)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    ta = tm.init(config, prng.PRNGKey(args.seed), dev).ta_state
    start_step = 0
    loader = ShardedBatcher((X, y), args.batch_size, seed=args.seed)
    if mgr and mgr.latest_step() is not None:
        restored, extra = mgr.restore({"ta": ta})
        ta = restored["ta"]
        loader.load_state_dict(extra["loader"])
        start_step = extra["step"]
        print(f"resumed from step {start_step}")

    def save(step, blocking):
        mgr.save(step, {"ta": ta},
                 extra={"step": step, "loader": loader.state_dict()},
                 blocking=blocking)

    sharded_step = None
    if args.mesh:
        sharded_step = _mesh_step(args, config, dev)
    # chains to any handler the host process already registered and is
    # uninstalled in the finally below, so embedding this loop in a
    # serving process never clobbers the gateway's SIGTERM drain
    pre = PreemptionHandler().install()
    mon = StragglerMonitor()
    it = iter(loader)
    try:
        for step in range(start_step, args.steps):
            mon.start_step()
            xb, yb = next(it)
            xt, yt = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
            if sharded_step is not None:
                ta = sharded_step(ta, xt, yt, step)
            else:
                ta, _ = ops.tm_train_step_kernel(
                    config, ta, xt, yt, step, batch_chunk=args.batch_chunk,
                    fuse=not args.no_fuse, autotune=args.autotune)
            faults.sleep_if("train.slow_step", step=step)  # straggler drill
            flag = mon.end_step(step)
            if flag:
                print(f"straggler flagged: {flag}")
            if mgr and (step + 1) % args.ckpt_every == 0:
                save(step + 1, blocking=False)
            faults.sigterm_if("train.sigterm", step=step)  # preemption drill
            if pre.preempted:
                # checkpoint (when durable storage is configured) and exit
                # with the code the launcher restarts on
                print("preempted: checkpointing and exiting for restart "
                      f"(exit code {RESUME_EXIT_CODE})")
                pre.checkpoint_and_exit(
                    (lambda: save(step + 1, blocking=True))
                    if mgr else (lambda: None))
            if (step + 1) % args.log_every == 0:
                acc = tm.accuracy(config, tm.TMState(ta_state=ta, steps=step + 1),
                                  x_test, y_test)
                inc = float((ta >= 0).to(torch.float32).mean())
                print(f"step {step + 1}: test_acc={acc:.4f} "
                      f"include_frac={inc:.4f}")
    finally:
        pre.uninstall()
    if mgr:
        save(args.steps, blocking=True)
        mgr.wait()
    health = dict(steps=args.steps, resumed_from=start_step,
                  stragglers=mon.events)
    print("TRAIN_HEALTH " + json.dumps(health))
    return ta, health


def _mesh_step(args, config, dev):
    """``--mesh``: the clause-sharded step (automata over ``model``, the
    batch over the data axes, the kernels per shard); ``--autotune`` tunes
    the per-shard shape (C_loc clauses, B_loc samples) here, outside the
    step, and pins it."""
    from repro_torch.core import packetizer
    from repro_torch.core import sharding as tm_sharding
    from repro_torch.launch.mesh import parse_mesh_spec

    mesh = parse_mesh_spec(args.mesh, dev)
    n_model = mesh.shape["model"]
    if config.n_clauses_total % n_model:
        raise SystemExit(
            f"clause axis ({config.n_clauses_total}) not divisible by mesh "
            f"model={n_model}; pick a divisor (configs pad via "
            "clause_pad_multiple)")
    blocks = None
    if args.autotune:
        if args.no_fuse:
            print("--autotune ignored: the unfused step has no launch to tune")
        else:
            from repro_torch.kernels import autotune

            d_size = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
            B_loc = max(1, args.batch_size // d_size)
            if args.batch_chunk and B_loc > args.batch_chunk:
                B_loc = args.batch_chunk
            blocks = autotune.autotune_fused_train_blocks(
                B_loc, config.n_clauses_total // n_model,
                packetizer.n_words(config.n_literals), config.n_literals,
                config.n_classes, device=dev)
            print("autotuned sharded blocks:", blocks)
    step = tm_sharding.sharded_train_step_fn(
        config, mesh, batch_chunk=args.batch_chunk, engine="kernel",
        fuse=not args.no_fuse, blocks=blocks)
    print(f"mesh {dict(mesh.shape)}: clause axis sharded over model={n_model}")
    return step


def lm_batch(cfg, nprng: np.random.Generator, batch_size: int, seq_len: int) -> dict:
    """One LM training batch as numpy arrays, drawn from ``nprng`` exactly
    as the reference's ``train_lm`` draws it: tokens (B, S + 1) first;
    ``audio_stub`` then frame embeddings (B, S, d) and codebook labels
    (B, S, n_codebooks); ``vision_stub`` patch embeddings (B, S // 4, d)
    before the text tokens, whose labels are the next tokens."""
    B, S = batch_size, seq_len
    tokens = nprng.integers(0, cfg.vocab_size, (B, S + 1))
    if cfg.frontend == "audio_stub":
        return {"embeds": nprng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "labels": nprng.integers(0, cfg.vocab_size,
                                         (B, S, cfg.n_codebooks)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        si = S // 4
        return {"embeds": nprng.normal(size=(B, si, cfg.d_model)).astype(np.float32),
                "tokens": tokens[:, :S - si].astype(np.int32),
                "labels": tokens[:, 1:S - si + 1].astype(np.int32)}
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


def lm_checkpoint_arrays(cfg, model) -> dict:
    """The model's parameters under the reference's checkpoint keys,
    ``params/<name>`` and ``params/groups/<g>/<li>/<name>[/<sub>...]`` (MoE's
    ``ff/shared/gate`` three levels under a layer), with
    stacked ``(repeats, ...)`` leaves (bf16 as numpy's 2-byte void)."""
    from repro_torch.models import transformer

    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("params", transformer.params_to_numpy(cfg, model))
    return flat


def train_lm(args, cfg=None) -> dict:
    """Train an LM ``--arch`` (``--smoke``: its reduced config; ``cfg``
    overrides both) for ``--steps`` AdamW steps of ``--batch-size`` x
    ``--seq-len`` -> ``{"losses", "grad_norms", "lrs", "step_s",
    "step_event_ms", "flash_launches", "model", "opt_state"}``.

    Weights come from ``torch.Generator(device).manual_seed(--seed)`` (they
    cannot equal ``jax.random.normal``'s); batches from
    ``np.random.default_rng(--seed)`` exactly as the reference draws them
    (:func:`lm_batch`).  Prints ``step k: loss=... gnorm=...`` a step, flags
    stragglers, and with ``--ckpt-dir`` saves the parameters every
    ``--ckpt-every`` steps in the reference's layout.  ``step_event_ms`` is
    each step's CUDA-event time on the card (None on the CPU),
    ``flash_launches`` the flash kernel's launches a step; ``model`` and
    ``opt_state`` are the trained model and its optimizer state.
    """
    from repro_torch import device as _device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.models import steps as lm_steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.straggler import StragglerMonitor

    cfg = cfg or (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = _device.resolve(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        _build.build()                  # compile outside the first step
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = adamw.adamw_init(model.parameters())
    step_fn = lm_steps.make_train_step(cfg)

    nprng = np.random.default_rng(args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    mon = StragglerMonitor()
    out = dict(losses=[], grad_norms=[], lrs=[], step_s=[], step_event_ms=[],
               flash_launches=[], model=model)
    for step in range(args.steps):
        mon.start_step()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in lm_batch(cfg, nprng, args.batch_size, args.seq_len).items()}
        n0 = flash_kernel.launches
        t0 = time.perf_counter()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        opt, info = step_fn(model, opt, batch)
        if cuda:
            ev[1].record()
        loss, gnorm = float(info["loss"]), float(info["grad_norm"])   # waits for the step
        out["step_s"].append(time.perf_counter() - t0)
        out["step_event_ms"].append(ev[0].elapsed_time(ev[1]) if cuda else None)
        out["flash_launches"].append(flash_kernel.launches - n0)
        out["losses"].append(loss)
        out["grad_norms"].append(gnorm)
        out["lrs"].append(float(info["lr"]))
        flag = mon.end_step(step)
        if flag:
            print(f"straggler flagged: {flag}")
        print(f"step {step + 1}: loss={loss:.4f} gnorm={gnorm:.3f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, lm_checkpoint_arrays(cfg, model),
                     extra={"step": step + 1}, blocking=False)
    if mgr:
        mgr.wait()
    out["opt_state"] = opt
    if out["step_s"]:
        print(f"{cfg.name}: {args.steps} steps of {args.batch_size} x {args.seq_len}, "
              f"median step {statistics.median(out['step_s']) * 1e3:.1f} ms, flash "
              f"kernel launches a step {out['flash_launches'][-1]} ({dev})")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the "
                         "kernels' plain PyTorch versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=128, help="LM: tokens a sequence")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the arch's reduced config (runs on one CPU)")
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-chunk", type=int, default=None,
                    help="step through the batch in slices of this size "
                         "(ragged tails are padded and masked; results stay "
                         "bit-identical)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="run the unfused three-kernel training step "
                         "instead of the fused two-kernel one")
    ap.add_argument("--autotune", action="store_true",
                    help="launch the fused kernels as the autotuner's cached "
                         "sweeps pick (resolved on the first step)")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. 'model=2' or 'data=2,model=2': shard "
                         "the clause axis over model and the batch over data")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=20)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch.startswith("tm-"):
        train_tm(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
