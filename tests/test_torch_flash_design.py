"""Which design a bf16 flash launch takes on the card, as a pure function of
what the launch observes (``flash_attention.tma_design``): the
warp-specialized TMA design (``flash_fwd_wgmma_kernel_tma``) past qk width
64 when every row is whole 16-byte units at 16-byte aligned addresses,
the present ``flash_fwd_wgmma_kernel`` everywhere else.  No card needed:
the rule is plain Python, held here at the configurations' own widths and
at the edges of the rule; ``tests/test_torch_cuda.py`` holds the launcher
to it on the card.
"""

import pytest

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa


def _widths(arch):
    """(qk width, v width) of a configuration's attention: MLA's nope + rope
    over v, else the head width twice."""
    c = configs.get_config(arch)
    if c.v_head_dim:
        return c.resolved_head_dim + c.rope_head_dim, c.v_head_dim
    return c.resolved_head_dim, c.resolved_head_dim


@pytest.mark.parametrize("arch,tma", [
    ("deepseek-v2-236b", True),          # MLA: 128 + 64 over 128
    ("qwen3-moe-235b-a22b", True),       # hd 128, 64 query heads over 4
    ("qwen3-32b", True),                 # hd 128
    ("tinyllama-1.1b", False)])          # hd 64: two blocks an SM, exp-bound
def test_configurations_take_their_design(arch, tma):
    hd, dv = _widths(arch)
    assert fa.takes(hd, dv)
    assert fa.tma_design(hd, dv, aligned=True) is tma
    assert fa.tma_design(hd, dv, aligned=False) is False


@pytest.mark.parametrize("hd,dv,aligned,tma", [
    (192, 128, True, True), (192, 128, False, False),
    (136, 128, True, True),              # just past 128: three 64-column boxes, zero-filled
    (160, 96, True, True), (192, 8, True, True),
    (190, 128, True, False),             # a row of 380 bytes: no TMA stride
    (192, 100, True, False),             # v rows of 200 bytes
    (128, 128, True, True), (128, 64, True, True), (72, 72, True, True),
    (128, 128, False, False), (64, 64, True, False), (64, 40, True, False),
    (16, 16, True, False),
    (192, 160, True, False),             # v wider than 128: no kernel takes it
    (200, 128, True, False)])            # qk past 192: no kernel takes it
def test_rule_at_its_edges(hd, dv, aligned, tma):
    assert fa.tma_design(hd, dv, aligned) is tma
    if tma:
        assert fa.takes(hd, dv)


def test_counters_are_named_for_the_benchmark():
    """The program counters the benchmark's ``flash_tma_share.infer`` reads."""
    assert (fa.LAUNCHES_COUNTER, fa.TMA_COUNTER) == ("flash.launches", "flash.tma_launches")
