"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on an NVIDIA GPU.  No JAX needed: run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compiler, packetizer, tm

ENGINES = ("factorized", "sparse", "dense", "oracle")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bank(n_features, n_classes, cpc, density, seed):
    rng = np.random.default_rng(seed)
    C, L = n_classes * cpc, 2 * n_features
    ta = np.where(rng.random((C, L)) < density, rng.integers(0, 127, (C, L)),
                  rng.integers(-128, 0, (C, L))).astype(np.int8)
    cfg = tm.TMConfig(n_features=n_features, n_classes=n_classes,
                      clauses_per_class=cpc)
    return compiler.compile_tm(cfg, ta)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 33, 97, 300])
def test_cuda_engines_equal_plain_versions(cuda_device, batch):
    comp = _bank(48, 4, 40, 0.08, batch)
    x = np.random.default_rng(batch).integers(0, 2, (batch, 48), dtype=np.uint8)
    x_cpu = packetizer.pack_literals(torch.from_numpy(x))
    x_gpu = x_cpu.to(cuda_device)
    for eng in ENGINES:
        want = compiler.run_compiled(comp, x_cpu, engine=eng)
        got = compiler.run_compiled(comp, x_gpu, engine=eng)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=eng)
    for eng in ("sparse", "factorized"):
        for kw in (dict(early_exit=True), dict(quality=1), dict(quality=3),
                   dict(block_c=8, block_j=4), dict(block_c=8, early_exit=True)):
            want = compiler.run_compiled(comp, x_cpu, engine=eng, **kw)
            got = compiler.run_compiled(comp, x_gpu, engine=eng, **kw)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                          err_msg=f"{eng} {kw}")


@pytest.mark.cuda
def test_cuda_all_empty_and_wide_classes(cuda_device):
    empty = _bank(16, 2, 4, 0.0, 0)
    x = packetizer.pack_literals(torch.ones((5, 16), dtype=torch.uint8))
    for eng in ENGINES:
        assert not compiler.run_compiled(empty, x.to(cuda_device), engine=eng).any()
    wide = _bank(20, 32, 6, 0.1, 1)               # K = 32 classes
    x = packetizer.pack_literals(torch.from_numpy(
        np.random.default_rng(2).integers(0, 2, (70, 20), dtype=np.uint8)))
    for eng in ENGINES:
        for ee in (False, True):
            want = compiler.run_compiled(wide, x, engine=eng, early_exit=ee)
            got = compiler.run_compiled(wide, x.to(cuda_device), engine=eng,
                                        early_exit=ee)
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
