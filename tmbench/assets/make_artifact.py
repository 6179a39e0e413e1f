"""Recipe of the benchmark's serving artifacts: ``tm_cifar2_e1.npz``
(``tm-cifar2``) and ``tm_mnist_10k_e1.npz`` (``tm-mnist``).

It trains the port's bank from ``tm.init(PRNGKey(0))`` for one epoch over
10,000 ``paper_dataset(<dataset>, seed=0)`` samples at batch 64 (157
hash-RNG steps of ``ops.tm_train_step_kernel``, step ``s`` seeded with
``s``, the samples in ``default_rng((0, 0)).permutation(10000)`` order,
the last batch 16 samples), compiles it with ``compile_tm`` and saves it
with its default schedules, and saves the trained bank beside it
(``<artifact>_bank.npz``, the (C, L) int8 automata as ``ta_state``): the
reference derives its class sums from the bank, not from the compiled
rows.  The plain PyTorch versions on the CPU give
the kernels' bits, so the artifact does not depend on where it was made.
The benchmark never runs this file: it loads the committed artifacts.

    PYTHONPATH=src python tmbench/assets/make_artifact.py tm-cifar2 [out.npz]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs.matador_tm import TM_CONFIGS
from repro_torch.core import compiler, prng, tm
from repro_torch.data.synthetic import paper_dataset
from repro_torch.kernels import ops

N_TRAIN, BATCH, SEED = 10_000, 64, 0
OUT = {"tm-cifar2": "tm_cifar2_e1.npz", "tm-mnist": "tm_mnist_10k_e1.npz"}


def main() -> None:
    arch = sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(here, OUT[arch])
    config = TM_CONFIGS[arch]
    torch.set_num_threads(min(4, torch.get_num_threads()))
    X, y, _, _ = paper_dataset(arch.replace("tm-", ""), n_train=N_TRAIN, seed=SEED)
    order = np.random.default_rng((SEED, 0)).permutation(N_TRAIN)
    ta = tm.init(config, prng.PRNGKey(SEED), "cpu").ta_state
    t0 = time.perf_counter()
    for step, lo in enumerate(range(0, N_TRAIN, BATCH)):
        idx = order[lo:lo + BATCH]
        ta, _ = ops.tm_train_step_kernel(config, ta, torch.from_numpy(X[idx]),
                                         torch.from_numpy(y[idx]), step)
    compiled = compiler.compile_tm(config, ta)
    path = compiled.save(out)
    bank = os.path.splitext(path)[0] + "_bank.npz"
    np.savez_compressed(bank, ta_state=ta.cpu().numpy().astype(np.int8))
    print(json.dumps(dict(path=path, bank=bank, steps=step + 1,
                          train_s=time.perf_counter() - t0, stats=compiled.stats.as_dict())))


if __name__ == "__main__":
    main()
