"""Serving entry point: batched TM inference of a compiled artifact on the
port's kernels, and the LM substrate's prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tm-mnist \\
        --artifact src/repro_torch/assets/tm_mnist_e1.npz --requests 4096 --bucket 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tm-tiny --online \\
        --swap-policy immediate --artifact /tmp/tiny_online.npz
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch-size 16 --seq-len 2048 --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tm-tiny --device cpu \\
        --epochs 1 --n-train 200 --artifact /tmp/tiny.npz
    REPRO_TORCH_FORCE_DEVICE_COUNT=2 PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tm-mnist --artifact src/repro_torch/assets/tm_mnist_e1.npz --mesh model=2

The TM loop mirrors the MATADOR runtime: train -> compile (or load a
compiled artifact) -> packetize requests -> stream them through the clause
datapath in fixed-size buckets behind the async gateway -> argmax.
Without an existing ``--artifact`` it trains first, as the reference
does, with the per-sample ``jax.random`` trainer (``fit(engine="jnp")``)
on the serving device, and writes the artifact at exit.  ``--zoo N``
serves N round-robin tenants through the artifact zoo; ``--online`` trains
a live bank beside serving and hot-swaps recompiled artifacts
(``runtime/online.py``); ``--mesh`` serves the clause bank sharded over
a device mesh (``core/sharding.py``).  Any other ``--arch`` serves a
language model with random weights (``serve_lm``).
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import os
import signal
import threading
import time

import numpy as np
import torch


def serve_tm(args) -> tuple[dict, dict, dict | None, np.ndarray]:
    """Chunked streaming TM serve loop with an engine degradation ladder.

    Requests stream through fixed-size buckets of ``--bucket`` datapoints
    (the last bucket is zero-padded).  Each bucket runs through an
    ``ops.EngineLadder`` (factorized -> sparse -> dense -> oracle): a
    guarded warm probe catches kernel launch failures before the request
    stream starts (kernels that do not build stop the serve: the oracle
    rung is a fallback for a failing kernel, not for a missing one), any
    per-bucket failure demotes one engine and
    retries that bucket, ``--bucket-deadline N`` also demotes when a bucket
    runs longer than ``N x`` the ``StragglerMonitor`` EWMA, and
    ``--promote-after N`` probes one level up after N healthy buckets.
    Every engine call synchronizes the device before it returns, so a
    fault lands on the bucket that caused it.  On ``--device cpu`` the
    kernel rungs run their plain PyTorch versions.

    ``--autotune`` picks each rung's launch through
    ``kernels/autotune.tune`` under ``--tune-policy``: ``predict`` trusts
    the cost model (zero timing runs, the zoo cold-start mode), ``verify``
    (default) times only the model's top-3, ``sweep`` times every
    candidate (and feeds the model's sidecar).  A measured schedule tiling
    is recorded in the artifact, and ``--artifact`` is saved again at exit
    when one was recorded, so the next cold start recalls it with no
    sweep; a recorded tiling of another mode (the reference's, or the
    CPU's) never answers on the card.

    Requests flow through the async gateway (``runtime/gateway.py``):
    continuous batching with age-based flushes, bounded-queue admission,
    per-request deadlines and graceful drain on SIGTERM.  ``--early-exit``
    serves exact buckets through the certified early-exit mode;
    ``--brownout`` lets the gateway's controller degrade schedule-engine
    buckets to budgeted prefixes with a concrete error bound under
    overload.

    ``--zoo N`` serves N round-robin tenants through the artifact zoo
    (``runtime/zoo.py``): per-tenant circuit breakers and an LRU cache of
    ``N - 1`` entries, so it churns (``N`` under ``--online``).

    ``--mesh SPEC`` (``launch/mesh.parse_mesh_spec``) puts a ``mesh-<top>``
    rung above the ladder: the artifact's unique clauses split over
    ``model`` (the schedule rungs stack one padded tile table a shard,
    ``stack_shard_*``; the dense rung pads the clauses to a multiple of
    ``model`` with zero rows and votes), each shard runs the top rung's
    kernel on its block, one int32 sum over ``model`` completes the class
    sums, and buckets split over the data axes.  A failure of the mesh
    rung demotes to the unsharded ladder.  With ``--autotune`` each shard's
    launch is tuned on ``C_loc`` rows (recorded under those rows).

    Without ``--artifact``, or with a path that does not exist yet, the
    run trains a bank as the reference does: ``tm.init`` from
    ``PRNGKey(0)``, then ``fit(engine="jnp")`` for ``--epochs`` over
    ``--n-train`` synthetic samples (seed 0) at batch 64 from
    ``PRNGKey(1)``, on the device ``--device`` names; it then compiles
    it, serves it and saves it to ``--artifact`` at exit.  ``--online``
    always trains its live bank that way (an artifact has no automata to
    train), serves its compiled artifact through the zoo, and runs ``runtime/online.OnlineUpdater`` on its own thread:
    the request stream's labels are its feedback, every batch is one
    fused training step on the card, and a drift past
    ``--drift-threshold`` recompiles incrementally, canaries the candidate
    on mirrored buckets (or promotes it at once under ``--swap-policy
    immediate``), hot-swaps it and rebinds the ladder.  The updater ends
    once it has trained on the stream's feedback (on SIGTERM it stops at
    once and drains its queue to ``--online-ckpt-dir``), and the promoted
    artifact is saved to ``--artifact`` when one is named.

    The run ends with the ``SERVE_HEALTH`` and ``GATEWAY_HEALTH`` JSON lines
    (the reference's schema; ``GATEWAY_HEALTH["zoo"]`` under the zoo) and,
    under ``--online``, ``ONLINE_HEALTH``; returns the three dicts (the
    last None without ``--online``) and the answered requests' predicted
    classes in request order.
    """
    from repro_torch import device as _device
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.core import compiler, packetizer
    from repro_torch.data.synthetic import make_boolean_classification
    from repro_torch.kernels import ops
    from repro_torch.runtime import faults
    from repro_torch.runtime.gateway import BrownoutController, Gateway
    from repro_torch.runtime.straggler import StragglerMonitor

    if args.online and args.mesh:
        raise SystemExit("--online hot-swaps the unsharded engine ladder; "
                         "combine it with --mesh once the sharded builders "
                         "read the swapped artifact")
    dev = _device.resolve(args.device)
    config = TM_CONFIGS[args.arch]
    path = None
    if args.artifact:
        path = (args.artifact if args.artifact.endswith(".npz")
                else args.artifact + ".npz")
    bank = None
    trained_this_run = False
    if args.online and path and os.path.exists(path):
        # the updater trains a LIVE bank next to serving; a loaded artifact
        # has no automata to train, so --online always trains one and the
        # artifact is rewritten at exit
        print(f"--online: training a live bank (artifact {path} will be "
              "refreshed at exit)")
    if path and os.path.exists(path) and not args.online:
        try:
            compiled = compiler.CompiledTM.load(path)
        except compiler.ArtifactError as e:
            raise SystemExit(f"refusing to serve: {e}")
        if (compiled.n_features != config.n_features
                or compiled.n_classes != config.n_classes):
            raise SystemExit(
                f"artifact {path} was compiled for F={compiled.n_features}/"
                f"K={compiled.n_classes}, but --arch {args.arch} is "
                f"F={config.n_features}/K={config.n_classes}")
        print(f"loaded artifact {path} (U={compiled.n_unique}) on {dev}")
    else:
        # the reference's train path: the per-sample jax.random trainer
        from repro_torch.core import prng, tm, train

        X, y = make_boolean_classification(
            args.n_train, config.n_features, config.n_classes, seed=0)
        state = tm.init(config, prng.PRNGKey(0), dev)
        state = train.fit(config, state, torch.from_numpy(X), torch.from_numpy(y),
                          epochs=args.epochs, batch_size=64, rng=prng.PRNGKey(1))
        bank = state.ta_state
        compiled = compiler.compile_tm(config, bank)
        trained_this_run = True
        if args.online:
            # the default chain schedule, so that a rebuild can reuse its
            # rows (incremental_recompile takes the incremental branch only
            # then)
            compiled.schedule()
        print(f"trained a bank: {args.epochs} epochs on {args.n_train} samples "
              f"(engine jnp); compiled U={compiled.n_unique} on {dev}")
    print("compile stats:", compiled.stats.as_dict())
    tuned_at_start = dict(compiled.tuned)
    # the serving artifact, as a mutable cell: the online updater promotes
    # a successor by updating this and rebinding the ladder, whose engines
    # read it when they are built
    current = {"compiled": compiled}

    bucket = args.bucket
    if args.factorize and args.no_factorize:
        raise SystemExit("--factorize and --no-factorize are exclusive")
    sparse = not args.no_sparse
    factorize = sparse and not args.no_factorize and (
        args.factorize
        or compiled.stats.partial_term_sharing
        >= compiler.FACTORIZE_SHARING_THRESHOLD)

    # anytime serving state: per-engine {level: err_bound} tables (filled
    # when a schedule engine is built, so a rebound engine gets the
    # promoted artifact's bounds) and the served-tier histogram
    ee0 = bool(args.early_exit or args.brownout)
    quality_bounds: dict = {}
    quality_served: dict = {}

    def tuned_blocks(art, n_clauses=None):
        # the dense rung's launch at the shape it runs: the whole unique
        # bank, or a shard's C_loc clauses on the mesh
        if not args.autotune:
            return {}
        from repro_torch.kernels import autotune

        C = art.n_unique if n_clauses is None else n_clauses
        blocks = autotune.tune(
            "fused_infer", B=bucket, C=C, W=art.n_words_active,
            K=art.n_classes, device=dev, policy=args.tune_policy)
        print(f"autotuned dense blocks (C={C}, "
              f"policy={args.tune_policy}):", blocks)
        return blocks

    def tuned_schedule_blocks(art, kernel, label, inc_rows=None):
        # the schedule tiling is swept on the rows the rung serves (the
        # artifact's, or a shard's C_loc on the mesh) under artifact-hashed
        # cache keys; a tiling recorded in the artifact (by an earlier
        # run's save) for this bucket, row count and mode answers a cold
        # start with no sweep (one recorded on another device or by the
        # reference never does)
        if not args.autotune:
            return {}
        from repro_torch.kernels import autotune

        if inc_rows is None:
            inc_rows = art.include_words
        ctx = dict(rows=inc_rows.shape[0], mode=autotune._mode_backend(dev))
        recorded = art.tuned_blocks(kernel, bucket, **ctx)
        if recorded is not None:
            print(f"artifact-recorded {label} blocks:", recorded)
            return recorded
        blocks = autotune.tune(
            kernel, B=bucket, K=art.n_classes, include_words=inc_rows,
            device=dev, policy=args.tune_policy, features=art.features or None)
        if args.tune_policy != "predict":
            # measured tilings persist with the artifact; predictions are
            # re-derived in microseconds and must not masquerade as sweeps
            art.record_tuned(kernel, bucket, blocks, **ctx)
        print(f"autotuned {label} blocks (U={inc_rows.shape[0]}, "
              f"policy={args.tune_policy}):", blocks)
        return blocks

    def _quality_engine(art, engine, blocks):
        # the quality tiers of the schedule the blocks tile (all but the
        # walk's block_s name the schedule)
        tiling = {k: v for k, v in blocks.items() if k != "block_s"}
        quality_bounds[engine] = {
            q["level"]: q["bound"]
            for q in art.quality_levels(engine=engine, **tiling)}

        def run(xw, quality=0):
            q = min(int(quality), max(quality_bounds[engine], default=0))
            return compiler.run_compiled(
                art, xw, engine=engine, quality=q,
                early_exit=ee0 and q == 0, **blocks).argmax(-1)

        run.supports_quality = True
        return run

    def build_mesh(art):
        # clause-sharded serve: the artifact's unique-clause bank splits
        # over `model`, each shard runs the top rung's kernel on its block
        # (the schedule rungs with their own padded tile tables), one (B, K)
        # int32 sum over `model` completes the class sums, and buckets split
        # over the data axes
        from repro_torch.core import sharding as tm_sharding
        from repro_torch.kernels import sparse_infer, term_infer
        from repro_torch.launch.mesh import parse_mesh_spec

        mesh = parse_mesh_spec(args.mesh, dev)
        n_model = mesh.shape["model"]
        U = art.n_unique
        # the rows one shard serves, for its launch's tuning
        shard_rows = np.ascontiguousarray(
            art.include_words[:sparse_infer._rup(-(-max(U, 1) // n_model), 8)])
        if args.autotune:
            tuned_blocks(art, -(-U // n_model))
        if factorize:
            fb = tuned_schedule_blocks(art, "term_infer", "factorized", shard_rows)
            scheds, *stacks, C_loc = term_infer.stack_shard_factorized(
                art.include_words, art.votes, n_model,
                block_c=fb.get("block_c", term_infer.DEFAULT_BLOCK_C),
                block_j=fb.get("block_j", term_infer.DEFAULT_BLOCK_J),
                block_t=fb.get("block_t", term_infer.DEFAULT_BLOCK_T),
                term_w=fb.get("term_w"))
            fwd = tm_sharding.sharded_factorized_forward_fn(
                mesh, block_t=scheds[0].block_t, block_c=scheds[0].block_c,
                block_j=scheds[0].block_j, block_s=fb.get("block_s"))
            print(f"mesh {dict(mesh.shape)}: {C_loc * n_model} unique clauses "
                  f"sharded over model={n_model} ({C_loc}/shard, "
                  f"{stacks[3].shape[-1]} tiles/shard, "
                  f"{stacks[0].shape[1]} term rows/shard)")
        elif sparse:
            sb = tuned_schedule_blocks(art, "sparse_infer", "sparse", shard_rows)
            scheds, *stacks, C_loc = sparse_infer.stack_shard_schedules(
                art.include_words, art.votes, n_model,
                block_c=sb.get("block_c", sparse_infer.DEFAULT_BLOCK_C),
                block_j=sb.get("block_j", sparse_infer.DEFAULT_BLOCK_J))
            fwd = tm_sharding.sharded_schedule_forward_fn(
                mesh, block_c=scheds[0].block_c, block_j=scheds[0].block_j,
                block_s=sb.get("block_s"))
            print(f"mesh {dict(mesh.shape)}: {C_loc * n_model} unique clauses "
                  f"sharded over model={n_model} ({C_loc}/shard, "
                  f"{stacks[2].shape[-1]} chain tiles/shard)")
        else:
            stacks = tm_sharding.stack_shard_dense(art.include_words, art.votes, n_model)
            Up = stacks[0].shape[0]
            blocks = tuned_blocks(art, Up // n_model)
            fwd = tm_sharding.sharded_forward_fn(mesh, blocks=blocks or None)
            print(f"mesh {dict(mesh.shape)}: {Up} unique clauses sharded "
                  f"over model={n_model} ({Up // n_model}/shard)")
        tabs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in stacks]
        word_ids = art.tensors(dev)["word_ids"]
        return lambda xw: fwd(*tabs, xw[:, word_ids]).argmax(-1)

    def build_engine(name):
        # lazy per-level builders: engines the ladder never reaches cost
        # nothing, neither their CUDA build (at the first kernel launch) nor
        # their sweep; the artifact is read from the `current` cell at
        # build time
        art = current["compiled"]
        if name.startswith("mesh-"):
            return build_mesh(art)
        if name in ("factorized", "sparse"):
            kernel = "term_infer" if name == "factorized" else "sparse_infer"
            return _quality_engine(art, name, tuned_schedule_blocks(art, kernel, name))
        if name == "dense":
            blocks = tuned_blocks(art)
            return lambda xw: compiler.run_compiled(
                art, xw, engine="dense", **blocks).argmax(-1)
        return lambda xw: compiler.run_compiled(art, xw, engine=name).argmax(-1)

    levels = []
    if factorize:
        levels.append("factorized")
    if sparse:
        levels.append("sparse")
    levels += ["dense", "oracle"]
    if args.mesh:
        # the sharded engine degrades to the unsharded ladder: a mesh-only
        # failure (bad spec, a shard's launch) still serves every bucket
        levels.insert(0, f"mesh-{levels[0]}")
    ladder = ops.EngineLadder(
        [(name, (lambda n=name: build_engine(n))) for name in levels],
        promote_after=args.promote_after)

    Xr, yr = make_boolean_classification(
        args.requests, config.n_features, config.n_classes, seed=2)
    # requests are packetized on the device, then held on the host the way
    # a server receives them; each bucket goes back to the device.  Under
    # --online the labels double as the labeled feedback stream
    xp = packetizer.pack_literals(torch.from_numpy(Xr).to(dev)).cpu().numpy()
    n, W = xp.shape

    mon = StragglerMonitor(threshold=args.bucket_deadline or 2.0, warmup=2)
    # guarded warm probe: the kernels build here, and launch failures
    # surface here, demoting through the ladder, so the request stream
    # starts on an engine that runs
    ladder.run(lambda: torch.from_numpy(xp[:bucket]).to(dev), bucket="warm",
               count=False)

    bucket_i = itertools.count()
    online_hooks = {"latency": None}   # filled when --online wires the updater

    def run_rows(rows, quality=0):
        # one gateway bucket: zero-pad to the fixed bucket shape, run the
        # engine ladder, keep the straggler/deadline accounting
        i = next(bucket_i)
        t_b = time.perf_counter()
        mon.start_step()
        faults.sleep_if("serve.slow_bucket", step=i)    # deadline drill site
        padded = np.zeros((bucket, W), xp.dtype)
        padded[:len(rows)] = rows
        out = ladder.run(lambda: torch.from_numpy(padded).to(dev), bucket=i,
                         quality=quality)
        preds = out.cpu().numpy()[:len(rows)]
        q = ladder.last_quality
        quality_served[q] = quality_served.get(q, 0) + 1
        info = dict(quality=q,
                    err_bound=quality_bounds.get(
                        ladder.engine, {}).get(q) if q else None)
        flag = mon.end_step(i)
        # an engine's FIRST bucket may pay its build — exempt it from the
        # deadline so one slow bucket cannot cascade down the ladder
        if flag and args.bucket_deadline and ladder.counts[ladder.engine] > 1:
            ladder.demote(
                f"bucket deadline: {flag['seconds'] * 1e3:.1f} ms > "
                f"{args.bucket_deadline:g}x EWMA {flag['ewma'] * 1e3:.1f} ms",
                bucket=i)
        if online_hooks["latency"] is not None:
            # post-swap latency watch: a promoted artifact that blows up
            # bucket wall-time gets rolled back by the updater
            online_hooks["latency"](time.perf_counter() - t_b)
        return preds, info

    def _nbytes(c):
        return int(c.include_words.nbytes + c.word_ids.nbytes + c.votes.nbytes)

    zoo = None
    updater = None
    if args.online:
        # online mode always routes through the zoo (one tenant unless
        # --zoo): the updater's atomic hot-swap IS a zoo operation, and
        # every bucket leases the entry it answers with, so in-flight
        # buckets finish on the version they started on
        from repro_torch.runtime import online as online_mod
        from repro_torch.runtime.zoo import ArtifactZoo

        def make_obj(c):
            # the zoo entry pairs the artifact with the shared ladder
            # runner: leases pin the object (and thus its version); the
            # ladder itself is rebound on promote via on_promote below
            return {"compiled": c, "run": run_rows}, _nbytes(c)

        zoo = ArtifactZoo(lambda tenant: make_obj(current["compiled"]),
                          max_entries=max(args.zoo or 1, 1))
        runner = zoo.runner(lambda obj, rows: obj["run"](rows))

        def canary_serve(obj, rows):
            # candidate side of the shadow canary and the accuracy watch:
            # the oracle on the artifact (its predictions equal every
            # ladder engine's), at the live bucket shape
            padded = np.zeros((bucket, W), xp.dtype)
            padded[:len(rows)] = rows
            xw = torch.from_numpy(padded).to(dev)
            preds = compiler.run_compiled(obj["compiled"], xw, engine="oracle")
            return preds.argmax(-1).cpu().numpy()[:len(rows)]

        def on_promote(cand):
            current["compiled"] = cand
            ladder.rebind(
                [(nm, (lambda n2=nm: build_engine(n2))) for nm in levels])
            print(f"online: promoted artifact live (U={cand.n_unique}); "
                  "engine ladder rebound")

        ckpt_manager = None
        if args.online_ckpt_dir:
            from repro_torch.checkpoint.store import CheckpointManager

            ckpt_manager = CheckpointManager(args.online_ckpt_dir)
        updater = online_mod.OnlineUpdater(
            config, bank, compiled,
            cfg=online_mod.OnlineConfig(
                drift_threshold=args.drift_threshold,
                canary_frac=args.canary_frac,
                swap_policy=args.swap_policy),
            zoo=zoo, tenant="t0", make_obj=make_obj, serve_fn=canary_serve,
            deployed_obj={"compiled": compiled, "run": run_rows},
            deployed_nbytes=_nbytes(compiled),
            ckpt_manager=ckpt_manager, on_promote=on_promote)
        online_hooks["latency"] = updater.record_bucket_latency
    elif args.zoo:
        # multi-tenant mode: requests round-robin over --zoo tenants that
        # share the compiled engines but carry per-tenant circuit breakers;
        # max_entries < tenants keeps the LRU churning under real pressure
        from repro_torch.runtime.zoo import ArtifactZoo

        nbytes = int(compiled.include_words.nbytes + compiled.votes.nbytes)
        zoo = ArtifactZoo(lambda tenant: (tenant, nbytes),
                          max_entries=max(args.zoo - 1, 1))
        runner = zoo.runner(lambda obj, rows: run_rows(rows))
    else:
        # the single-tenant runner is quality-aware (the zoo runner
        # protocol is exact-only, so the zoo and online paths serve exact
        # under pressure)
        def runner(tenant, rows, quality=0):
            return run_rows(rows, quality)

    def tenant_of(j):
        return f"t{j % args.zoo}" if args.zoo else "t0"

    async def stream():
        gw = await Gateway(
            runner, bucket=bucket, max_queue=args.max_queue or None,
            max_wait=args.max_wait_ms / 1e3, drain_timeout=args.drain_timeout,
            mirror=updater.mirror if updater is not None else None,
            brownout=BrownoutController() if args.brownout else None,
        ).start()
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        try:
            # graceful drain: SIGTERM stops admission, flushes what fits
            # in the drain window, typed-sheds the rest, exits 0
            loop.add_signal_handler(signal.SIGTERM, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
        stop_online = threading.Event()
        online_thread = None
        if updater is not None:
            # the updater's own thread: ingest labeled feedback in batch-
            # sized slices and train/drift-check between gateway buckets;
            # it ends by itself once the stream's feedback is trained on
            feed = iter(range(n))

            def online_loop():
                while not stop_online.is_set():
                    progressed = False
                    for _ in range(updater.cfg.batch_size):
                        j = next(feed, None)
                        if j is None:
                            break
                        updater.ingest(Xr[j], int(yr[j]))
                        progressed = True
                    progressed = updater.step() or progressed
                    if not progressed:
                        return

            online_thread = threading.Thread(
                target=online_loop, name="online-updater", daemon=True)
            online_thread.start()
        deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
        futs = [gw.offer(tenant_of(j), xp[j], deadline=deadline)
                for j in range(n)]
        answered = asyncio.ensure_future(asyncio.gather(*futs))
        sigterm = asyncio.ensure_future(stop.wait())
        await asyncio.wait({answered, sigterm},
                           return_when=asyncio.FIRST_COMPLETED)
        health = await gw.drain()
        t_served = time.perf_counter()
        if online_thread is not None:
            if stop.is_set():
                stop_online.set()
            # off the event loop: the updater may be mid-rebuild
            await asyncio.to_thread(online_thread.join, 600)
            stop_online.set()
        if updater is not None and stop.is_set():
            # SIGTERM: after the gateway drains, flush the pending feedback
            # queue through the checkpoint path — a restarted updater
            # resumes the bank and re-ingests every drained record
            ck_step = updater.drain()
            if ck_step is not None:
                print(f"online: feedback queue drained to checkpoint "
                      f"step {ck_step}")
        sigterm.cancel()
        return await answered, health, stop.is_set(), t_served

    t0 = time.perf_counter()
    responses, gw_health, sigtermed, t_served = asyncio.run(stream())
    # serving time: to the drained gateway, without the updater's tail
    dt = t_served - t0
    if args.online:
        print(f"online: the updater ended {time.perf_counter() - t_served:.2f} s "
              "after the gateway drained")
    if sigtermed:
        print("SIGTERM: gateway drained "
              f"({gw_health['answered']}/{gw_health['offered']} answered, "
              f"{gw_health['shed_total']} typed-shed)")
    if path and (trained_this_run or current["compiled"].tuned != tuned_at_start):
        # a trained artifact (under --online the PROMOTED one) and newly
        # recorded tilings persist for cold starts (saved after the stream,
        # so tilings recorded lazily by ladder builders persist too)
        current["compiled"].save(path)
        print(f"saved artifact (schedules + tuned tilings) to {path}")
    engine_labels = {"factorized": "factorized-schedule",
                     "sparse": "sparse-schedule",
                     "dense": "fused-kernel", "oracle": "oracle"}
    eng = ladder.engine
    label = (f"clause-sharded {engine_labels[eng[len('mesh-'):]]} ({args.mesh})"
             if eng.startswith("mesh-") else engine_labels[eng])
    n_answered = gw_health["answered"]
    n_buckets = gw_health["buckets"]
    print(f"{n_answered} inferences in {n_buckets} buckets of {bucket} "
          f"[{label}, {dev}] in {dt * 1e3:.2f} ms "
          f"({max(n_answered, 1) / dt:,.0f} inf/s, "
          f"{dt / max(n_answered, 1) * 1e6:.2f} us/inf)")
    health = dict(
        requests=n, buckets=n_buckets, bucket_size=bucket,
        ladder=levels, final_engine=ladder.engine,
        engine_buckets=ladder.counts, demotions=ladder.demotions,
        promotions=ladder.promotions, probe_failures=ladder.probe_failures,
        stragglers=mon.events,
        early_exit=ee0, brownout=bool(args.brownout),
        quality_tiers={str(k): v for k, v in sorted(quality_served.items())},
    )
    print("SERVE_HEALTH " + json.dumps(health))
    if zoo is not None:
        gw_health["zoo"] = zoo.health()
    print("GATEWAY_HEALTH " + json.dumps(gw_health))
    online_health = None
    if updater is not None:
        online_health = updater.health()
        print("ONLINE_HEALTH " + json.dumps(online_health))
    if gw_health["unaccounted"]:
        raise SystemExit(
            f"gateway accounting violated: {gw_health['unaccounted']} "
            f"of {gw_health['offered']} requests unaccounted for")
    preds = np.asarray([r.pred for r in responses if r.ok], np.int64)
    hist = np.bincount(preds, minlength=config.n_classes)
    print("pred class histogram:", hist.tolist())
    return health, gw_health, online_health, preds


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    help="a TM config of configs/matador_tm.py (e.g. tm-mnist) "
                         "or an LM of configs.ARCH_IDS or configs.PORT_ARCH_IDS "
                         "(e.g. tinyllama-1.1b, longcat-flash-560b)")
    ap.add_argument("--artifact", default=None,
                    help="TM: compiled-artifact .npz, loaded instead of "
                         "train + compile when it exists, saved at exit when "
                         "this run trained it (under --online the promoted "
                         "artifact) or recorded a tuned tiling")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(the kernels' plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--bucket", type=int, default=512,
                    help="TM streaming bucket size")
    ap.add_argument("--no-sparse", action="store_true",
                    help="serve with the dense fused kernel instead of the "
                         "schedule kernels")
    ap.add_argument("--no-factorize", action="store_true",
                    help="pin the flat chain kernel even when the artifact's "
                         "partial_term_sharing clears the factorized threshold")
    ap.add_argument("--factorize", action="store_true",
                    help="start the ladder on the factorized kernel even when "
                         "the measured term sharing is below the threshold")
    ap.add_argument("--bucket-deadline", type=float, default=None,
                    help="demote the serving engine when a bucket runs longer "
                         "than this multiple of the EWMA of bucket wall-times")
    ap.add_argument("--promote-after", type=int, default=None,
                    help="probe the engine one ladder level up after this many "
                         "consecutive healthy buckets (failed probes double "
                         "the cooldown); default: demote-only")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="gateway: bound the pending-request queue (a full "
                         "queue sheds new requests as queue_full)")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="gateway: flush a partial bucket once its oldest "
                         "request has waited this long")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="gateway: per-request deadline (expired requests "
                         "are shed deadline_expired, never executed)")
    ap.add_argument("--drain-timeout", type=float, default=5.0,
                    help="gateway: seconds the drain may spend flushing "
                         "before shedding the remainder drain_timeout")
    ap.add_argument("--early-exit", action="store_true",
                    help="serve exact buckets through the certified "
                         "early-exit mode (argmax-identical)")
    ap.add_argument("--brownout", action="store_true",
                    help="gateway: degrade answer quality instead of shedding "
                         "under overload (implies --early-exit)")
    ap.add_argument("--zoo", type=int, default=None,
                    help="TM gateway: serve this many round-robin tenants "
                         "through the artifact zoo (per-tenant circuit "
                         "breakers, LRU-capped cache) instead of one")
    ap.add_argument("--online", action="store_true",
                    help="TM: train a live bank and run the online-learning "
                         "updater beside serving: labeled feedback steps the "
                         "bank, include-bit drift arms an incremental "
                         "recompile, the candidate is shadow-canaried and "
                         "hot-swapped through the artifact zoo")
    ap.add_argument("--drift-threshold", type=float, default=0.05,
                    help="TM --online: include-bit drift fraction (live bank "
                         "vs the deployed artifact's bank) that arms a "
                         "recompile")
    ap.add_argument("--canary-frac", type=float, default=0.25,
                    help="TM --online: fraction of live buckets mirrored to "
                         "the candidate during the shadow canary")
    ap.add_argument("--swap-policy", default="canary",
                    choices=("canary", "immediate"),
                    help="TM --online: 'canary' (default) shadow-validates "
                         "the candidate before the atomic swap; 'immediate' "
                         "promotes once the integrity envelope passes")
    ap.add_argument("--online-ckpt-dir", default=None,
                    help="TM --online: checkpoint directory the SIGTERM "
                         "drain writes the live bank + pending feedback "
                         "through (a restart resumes from it)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="TM: epochs of training when the run trains a bank")
    ap.add_argument("--n-train", type=int, default=2000,
                    help="TM: synthetic samples the trained bank learns")
    ap.add_argument("--autotune", action="store_true",
                    help="TM: pick each rung's kernel launch through the "
                         "autotuner (kernels/autotune.py)")
    ap.add_argument("--tune-policy", default="verify",
                    choices=("predict", "verify", "sweep"),
                    help="TM --autotune mode: 'predict' trusts the cost "
                         "model (zero timing runs), 'verify' (default) times "
                         "the model's top-3, 'sweep' times every candidate")
    ap.add_argument("--mesh", default=None,
                    help="TM: mesh spec, e.g. 'model=2' or 'data=2,model=2': "
                         "shard the compiled clause bank over model (the top "
                         "rung's kernel per shard) and buckets over data")
    ap.add_argument("--batch-size", type=int, default=4, help="LM: prompts")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="LM: KV-cache length; the prompts take half of it")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="LM: greedy decode steps")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the architecture's reduced smoke config")
    return ap


def serve_lm(args, cfg=None) -> dict:
    """Prefill a batch of random prompts (half of ``--seq-len``) and decode
    ``--new-tokens`` greedy tokens, on random weights from seed 0, for
    ``--arch`` (``--smoke``: its reduced config; ``cfg`` overrides both,
    as a depth-cut config).  Under
    ``audio_stub`` the prompt is normal frame embeddings and each decode
    input zeros, as the reference serves it; the greedy token is the
    argmax over the first codebook's ``vocab_size`` logits.

    The prefill runs the flash kernel once per global attention layer on
    the card.  Prints the reference's ``prefill ... ms; decode ... ms/step
    (... tok/s)`` line and the prefill's flash-kernel launches; returns the
    prefill logits, the greedy tokens (B, new_tokens + 1), the times, the
    launch count and the model.
    """
    from repro_torch import device as _device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.models import steps, transformer

    cfg = cfg or (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        _build.build()                 # compile outside the timed prefill

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    B, S_max = args.batch_size, args.seq_len
    caches = model.init_caches(B, S_max)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    prompt_len = S_max // 2
    nprng = np.random.default_rng(0)
    V = cfg.vocab_size
    if cfg.frontend == "audio_stub":
        # frame embeddings for the prompt, zeros for each decode input
        batch = {"embeds": torch.from_numpy(
            nprng.normal(size=(B, prompt_len, cfg.d_model)).astype(np.float32)).to(dev)}
        zeros = torch.zeros((B, 1, cfg.d_model), dtype=torch.float32, device=dev)
        mk_inp = lambda tok: {"embeds": zeros}
    else:
        batch = {"tokens": torch.from_numpy(
            nprng.integers(0, V, (B, prompt_len))).to(dev)}
        mk_inp = lambda tok: {"tokens": tok}

    n0 = flash_kernel.launches
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch, caches)
    sync()
    t_prefill = time.perf_counter() - t0
    n_flash = flash_kernel.launches - n0
    prefill_logits = logits
    toks = [torch.argmax(logits[:, :V], -1)[:, None]]

    n_new = args.new_tokens
    t0 = time.perf_counter()
    for i in range(n_new):
        logits, caches = decode(model, caches, mk_inp(toks[-1]), prompt_len + i)
        toks.append(torch.argmax(logits[:, :V], -1)[:, None])
    sync()
    t_decode = time.perf_counter() - t0
    print(f"prefill {prompt_len} tok x {B}: {t_prefill * 1e3:.1f} ms; "
          f"decode {n_new} steps: {t_decode / max(n_new, 1) * 1e3:.2f} ms/step "
          f"({B * n_new / max(t_decode, 1e-9):,.0f} tok/s)")
    print(f"flash kernel launches in the prefill: {n_flash} "
          f"({cfg.n_layers} layers, {cfg.name}, {cfg.dtype}, {dev})")
    return dict(prefill_logits=prefill_logits, tokens=torch.cat(toks, dim=1),
                prefill_s=t_prefill, decode_s=t_decode, flash_launches=n_flash, model=model)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch.startswith("tm-"):
        serve_tm(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
