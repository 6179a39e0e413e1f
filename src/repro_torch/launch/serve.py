"""Serving entry point: batched TM inference of a compiled artifact on the
port's kernels, and the LM substrate's prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tm-mnist \\
        --artifact src/repro_torch/assets/tm_mnist_e1.npz --requests 4096 --bucket 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch-size 16 --seq-len 2048 --new-tokens 64

The TM loop mirrors the MATADOR runtime: load a compiled artifact, packetize
requests, stream them through the clause datapath in fixed-size buckets
behind the async gateway, argmax.  Serving without an artifact trains
first, as the reference does, with the per-sample ``jax.random`` trainer
(``engine="jnp"``), which a later slice of the port brings.  Any other
``--arch`` serves a language model with random weights (``serve_lm``).
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import os
import signal
import time

import numpy as np
import torch

# serve_tm options that need modules not yet ported
_LATER = {"mesh": "clause-sharded multi-GPU serving",
          "autotune": "autotuning and the cost model",
          "zoo": "the multi-tenant artifact zoo",
          "online": "online learning"}


def serve_tm(args) -> tuple[dict, dict]:
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

    Requests flow through the async gateway (``runtime/gateway.py``):
    continuous batching with age-based flushes, bounded-queue admission,
    per-request deadlines and graceful drain on SIGTERM.  ``--early-exit``
    serves exact buckets through the certified early-exit mode;
    ``--brownout`` lets the gateway's controller degrade schedule-engine
    buckets to budgeted prefixes with a concrete error bound under
    overload.  The run ends with the ``SERVE_HEALTH`` and
    ``GATEWAY_HEALTH`` JSON lines (the reference's schema), which are also
    returned.
    """
    from repro_torch import device as _device
    from repro_torch.configs.matador_tm import TM_CONFIGS
    from repro_torch.core import compiler, packetizer
    from repro_torch.data.synthetic import make_boolean_classification
    from repro_torch.kernels import ops
    from repro_torch.runtime import faults
    from repro_torch.runtime.gateway import BrownoutController, Gateway
    from repro_torch.runtime.straggler import StragglerMonitor

    for flag, what in _LATER.items():
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag} needs {what}, which a later slice of "
                             "the port brings; serve without it")
    if not args.artifact:
        raise SystemExit("--artifact is required: serving without one trains "
                         "with the engine='jnp' trainer, which a later slice "
                         "of the port brings")
    dev = _device.resolve(args.device)
    config = TM_CONFIGS[args.arch]
    path = args.artifact if args.artifact.endswith(".npz") else args.artifact + ".npz"
    if not os.path.exists(path):
        raise SystemExit(f"artifact {path} not found; compile one with the "
                         "reference (python -m repro.launch.serve --artifact "
                         "...) or with core.compiler.compile_tm on a bank "
                         "from repro_torch.launch.train")
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
    print("compile stats:", compiled.stats.as_dict())

    bucket = args.bucket
    if args.factorize and args.no_factorize:
        raise SystemExit("--factorize and --no-factorize are exclusive")
    sparse = not args.no_sparse
    factorize = sparse and not args.no_factorize and (
        args.factorize
        or compiled.stats.partial_term_sharing
        >= compiler.FACTORIZE_SHARING_THRESHOLD)

    # anytime serving state: per-engine {level: err_bound} tables (filled
    # when a schedule engine is built) and the served-tier histogram
    ee0 = bool(args.early_exit or args.brownout)
    quality_bounds: dict = {}
    quality_served: dict = {}

    def _quality_engine(engine):
        quality_bounds[engine] = {
            q["level"]: q["bound"] for q in compiled.quality_levels(engine=engine)}

        def run(xw, quality=0):
            q = min(int(quality), max(quality_bounds[engine], default=0))
            return compiler.run_compiled(
                compiled, xw, engine=engine, quality=q,
                early_exit=ee0 and q == 0).argmax(-1)

        run.supports_quality = True
        return run

    def build_engine(name):
        # lazy per-level builders: engines the ladder never reaches cost
        # nothing (the CUDA build runs at the first kernel launch)
        if name in ("factorized", "sparse"):
            return _quality_engine(name)
        return lambda xw: compiler.run_compiled(compiled, xw, engine=name).argmax(-1)

    levels = []
    if factorize:
        levels.append("factorized")
    if sparse:
        levels.append("sparse")
    levels += ["dense", "oracle"]
    ladder = ops.EngineLadder(
        [(name, (lambda n=name: build_engine(n))) for name in levels],
        promote_after=args.promote_after)

    Xr, _ = make_boolean_classification(
        args.requests, config.n_features, config.n_classes, seed=2)
    # requests are packetized on the device, then held on the host the way
    # a server receives them; each bucket goes back to the device
    xp = packetizer.pack_literals(torch.from_numpy(Xr).to(dev)).cpu().numpy()
    n, W = xp.shape

    mon = StragglerMonitor(threshold=args.bucket_deadline or 2.0, warmup=2)
    # guarded warm probe: the kernels build here, and launch failures
    # surface here, demoting through the ladder, so the request stream
    # starts on an engine that runs
    ladder.run(lambda: torch.from_numpy(xp[:bucket]).to(dev), bucket="warm",
               count=False)

    bucket_i = itertools.count()

    def run_rows(rows, quality=0):
        # one gateway bucket: zero-pad to the fixed bucket shape, run the
        # engine ladder, keep the straggler/deadline accounting
        i = next(bucket_i)
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
        return preds, info

    def runner(tenant, rows, quality=0):
        return run_rows(rows, quality)

    async def stream():
        gw = await Gateway(
            runner, bucket=bucket, max_queue=args.max_queue or None,
            max_wait=args.max_wait_ms / 1e3, drain_timeout=args.drain_timeout,
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
        deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
        futs = [gw.offer("t0", xp[j], deadline=deadline) for j in range(n)]
        answered = asyncio.ensure_future(asyncio.gather(*futs))
        sigterm = asyncio.ensure_future(stop.wait())
        await asyncio.wait({answered, sigterm},
                           return_when=asyncio.FIRST_COMPLETED)
        health = await gw.drain()
        sigterm.cancel()
        return await answered, health, stop.is_set()

    t0 = time.perf_counter()
    responses, gw_health, sigtermed = asyncio.run(stream())
    dt = time.perf_counter() - t0
    if sigtermed:
        print("SIGTERM: gateway drained "
              f"({gw_health['answered']}/{gw_health['offered']} answered, "
              f"{gw_health['shed_total']} typed-shed)")
    engine_labels = {"factorized": "factorized-schedule",
                     "sparse": "sparse-schedule",
                     "dense": "fused-kernel", "oracle": "oracle"}
    n_answered = gw_health["answered"]
    n_buckets = gw_health["buckets"]
    print(f"{n_answered} inferences in {n_buckets} buckets of {bucket} "
          f"[{engine_labels[ladder.engine]}, {dev}] in {dt * 1e3:.2f} ms "
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
    print("GATEWAY_HEALTH " + json.dumps(gw_health))
    if gw_health["unaccounted"]:
        raise SystemExit(
            f"gateway accounting violated: {gw_health['unaccounted']} "
            f"of {gw_health['offered']} requests unaccounted for")
    preds = np.asarray([r.pred for r in responses if r.ok], np.int64)
    hist = np.bincount(preds, minlength=config.n_classes)
    print("pred class histogram:", hist.tolist())
    return health, gw_health


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    help="a TM config of configs/matador_tm.py (e.g. tm-mnist) "
                         "or an LM of configs.ARCH_IDS (e.g. tinyllama-1.1b)")
    ap.add_argument("--artifact", default=None,
                    help="TM: compiled-artifact .npz to serve (required)")
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
    for flag, what in _LATER.items():
        ap.add_argument(f"--{flag}", default=None, nargs="?", const=True,
                        help=f"not yet ported ({what}); exits with a message")
    ap.add_argument("--batch-size", type=int, default=4, help="LM: prompts")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="LM: KV-cache length; the prompts take half of it")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="LM: greedy decode steps")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the architecture's reduced smoke config")
    return ap


def serve_lm(args) -> dict:
    """Prefill a batch of random prompts (half of ``--seq-len``) and decode
    ``--new-tokens`` greedy tokens, on random weights from seed 0.

    The prefill runs the flash kernel once per layer on the card.  Prints
    the reference's ``prefill ... ms; decode ... ms/step (... tok/s)`` line
    and the prefill's flash-kernel launches; returns the prefill logits,
    the greedy tokens (B, new_tokens + 1), the times and the launch count.
    """
    from repro_torch import device as _device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.models import steps, transformer

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    transformer.check_servable(cfg)
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
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt_len))
    batch = {"tokens": torch.from_numpy(prompts).to(dev)}

    n0 = flash_kernel.launches
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch, caches)
    sync()
    t_prefill = time.perf_counter() - t0
    n_flash = flash_kernel.launches - n0
    prefill_logits = logits
    toks = [torch.argmax(logits, -1)[:, None]]

    n_new = args.new_tokens
    t0 = time.perf_counter()
    for i in range(n_new):
        logits, caches = decode(model, caches, {"tokens": toks[-1]}, prompt_len + i)
        toks.append(torch.argmax(logits, -1)[:, None])
    sync()
    t_decode = time.perf_counter() - t0
    print(f"prefill {prompt_len} tok x {B}: {t_prefill * 1e3:.1f} ms; "
          f"decode {n_new} steps: {t_decode / max(n_new, 1) * 1e3:.2f} ms/step "
          f"({B * n_new / max(t_decode, 1e-9):,.0f} tok/s)")
    print(f"flash kernel launches in the prefill: {n_flash} "
          f"({cfg.n_layers} layers, {cfg.name}, {cfg.dtype}, {dev})")
    return dict(prefill_logits=prefill_logits, tokens=torch.cat(toks, dim=1),
                prefill_s=t_prefill, decode_s=t_decode, flash_launches=n_flash)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch.startswith("tm-"):
        serve_tm(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
