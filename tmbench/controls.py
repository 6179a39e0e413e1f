"""Readings of each cell's control and faults, at the cell's own size.

    python3 tmbench/controls.py --workload <cell> --seeds 11,12,13 [--seconds 1]

Not run by the benchmark's runs: it sets the limits of what ``run.py``
compares.  For each seed it sets the cell up, runs a short window at the
cell's own load, and prints one JSON line: the numbers the run compares
(the program's readings) and the readings of the control and of each
fault put in the program's place (``controls()`` of the traffic kind).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(HERE)] + [p for p in sys.path if p != HERE]

from tmbench import run, trace  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    os.environ.update(run.CACHE_ENV)
    cell, config, traffic = run.load_cell(args.workload)
    device = run.cuda_device(cell["cell"]["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        kind = run.make_kind(config, traffic, seed, device, trace.Tracer(False))
        kind.setup()
        kind.window(args.seconds)
        readings = {n: v for n, v, _ in kind.check()}
        readings.update(kind.controls())
        print(json.dumps(dict(workload=args.workload, seed=seed, **readings)), flush=True)


if __name__ == "__main__":
    main()
