"""Run one cell of the port's benchmark once.

    python3 tmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, kernel build or cached
build, the cell's inputs from ``--seed``, warm-up of the cell's shapes) is
timed as ``setup_s``; then the window runs for ``--seconds``; then the
plain reference checks what the window produced.  With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiler trace of the window.  The last
line of standard output is the result, a JSON object; the numbers compared
are also the last lines of standard error.  Exit codes: 0 with a result, 2
when the card, the cell or the program is missing (no result), 3 when JAX
or the reference package was loaded (no result).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [p for p in sys.path if p != HERE]

from tmbench import isolation, manifest  # noqa: E402

# every cache of the run inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, "build", "tmbench_cache")
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
    "REPRO_TORCH_AUTOTUNE_CACHE": os.path.join(CACHE, "autotune.json"),
    "REPRO_TORCH_TUNE_DATA": os.path.join(CACHE, "tune_data.json"),
}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def stop(msg: str, code: int) -> None:
    print(f"tmbench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_cell(workload: str):
    """``(cell, config, traffic)`` of a cell, found by name; exits with 2
    when the cell or the program is missing."""
    try:
        cell = manifest.cell(manifest.load(), workload)
    except KeyError as e:
        stop(str(e), 2)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        stop("the program (src/repro_torch) is not in this checkout", 2)
    with open(cell["config_file"]) as f:
        config = json.load(f)
    with open(cell["traffic_file"]) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cuda_device(chips: int):
    """The first card; exits with 2 when fewer than ``chips`` are there."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        stop(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() "
             f"is {torch.cuda.is_available()}", 2)
    return torch.device("cuda", 0)


def make_kind(config, traffic, seed: int, device, tracer):
    """The traffic kind's cell for one run."""
    ctx = types.SimpleNamespace(root=ROOT, config=config, traffic=traffic,
                                seed=seed, device=device, tracer=tracer)
    return manifest.kind(traffic["kind"]).Cell(ctx)


def main(argv=None) -> None:
    args = parse(argv)
    os.environ.update(CACHE_ENV)
    cell, config, traffic = load_cell(args.workload)
    run(args, cell, config, traffic, cuda_device(cell["cell"]["chips"]))


def run(args, cell, config, traffic, device) -> None:
    """Set up, measure and check one cell; print the result."""
    import torch

    from tmbench import datagen, trace

    tracer = trace.Tracer(bool(args.trace))
    kind = make_kind(config, traffic, args.seed, device, tracer)
    kind.setup()
    datagen.sync(device)
    setup_s = time.perf_counter() - T_START
    gc.collect()
    gc.disable()
    with tracer.window():
        rec = kind.window(args.seconds)
    gc.enable()
    peak = (max(getattr(kind, "peak_setup", 0), torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    check_isolation()
    rec.update(setup_s=setup_s, trace=None, bounds=None)
    checks = kind.check()
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else device.type),
                "count": cell["cell"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": rec["attempted"], "failed": rec["failed"]}
    extra = {}
    if args.trace:
        red = trace.reduce(tracer.prof)
        if red is None:
            stop("the profiler recorded none of the window's markers or ranges", 2)
        rec.update(trace=red, bounds=kind.bounds())
        dev_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        extra["breakdown"] = trace.breakdown(red)
        wanted = cell["per_layer"]
    else:
        wanted = cell["end_to_end"]
    metrics = {}
    for mdef in wanted:
        v = manifest.reader(mdef["name"])(rec)
        if v is not None:
            metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
    check_isolation()
    result.update(metrics=metrics, device=dev_info, **extra)
    if "route" in rec:
        result["route"] = rec["route"]
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"compared {n}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result))


def check_isolation() -> None:
    found = isolation.forbidden_modules()
    if found:
        stop(f"modules of JAX or of the reference package were loaded: {found}", 3)


if __name__ == "__main__":
    main()
