"""Port parity: the dry-run (``launch/specs.py``, ``launch/op_analysis.py``,
``launch/roofline.py``, ``launch/dryrun.py``) against the JAX reference.

Shapes, input and cache stand-ins and ``model_flops`` are held exactly.
``op_analysis`` is held to the reference's known-FLOP programs
(``tests/test_hlo_analysis.py``) written in torch, and its trip scope to
the unfolded trace.  The reference's smoke cells run in ONE subprocess
with 8 host devices and an Auto-axis (2, 4) mesh (jax 0.9's default
Explicit axes fail the reference's LM cells); the port's per-device
``flops``, ``coll_bytes`` and all-gather and all-reduce bytes are held to
the ratios measured here against them (the port counts eager ops and the
collectives its specs imply, the reference XLA's partitioned program, so
the ratios are not 1; ``REF_RATIOS`` says which collective makes each
gap).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as r_configs  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.matador_tm import TM_CONFIGS  # noqa: E402
from repro_torch import trace_scope  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import roofline as t_roofline  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")

# (arch, shape) -> the port's per-device flops, coll_bytes, and all-gather
# and all-reduce wire bytes over the reference's on the (2, 4) smoke cells,
# as measured on this code (2% slack).  The port's flops are the eager op
# stream's, its collectives the Megatron-style count of
# dryrun.implied_collectives; the reference's are XLA's partitioned program.
# Kind by kind (the reference's HLO text, read on these cells):
#   * all-gather (35-52% of the reference's train and prefill bytes): the
#     port counts only FSDP gathers of data-sharded weights, 2-7% of the
#     reference's.  XLA also gathers activations: the K/V heads where the
#     smoke configs' kv heads do not divide ``model`` (f32[8,128,2,16]),
#     the causal mask (pred[8,128,128]), softmax statistics (f32[8,128,8]),
#     layer-boundary activations (f32[8,128,64]), and whole model-split
#     weights it does not keep split (f32[64,176]);
#   * all-reduce (41-51%): the port's output-projection sums and gradient
#     all-reduces, 0.48-2.37x the reference's;
#   * all-to-all and collective-permute (3-27%): XLA's reshardings between
#     layouts (the "involuntary full rematerialization" copies) and the
#     RG-LRU's shifts (184 permutes of f32[8,1,64]); the port counts none;
#   * reduce-scatter: the port's FSDP gradient scatter; the reference has none
#     (its gradient sums are all-reduces).
# decode_32k, whose collectives are the cache gathers and the output sums,
# agrees kind by kind.
REF_RATIOS = {
    ("tinyllama-1.1b", "train_4k"): (1.061, 0.554, 0.0454, 1.0403),
    ("tinyllama-1.1b", "prefill_32k"): (0.986, 1.166, 0.0, 2.3273),
    ("tinyllama-1.1b", "decode_32k"): (0.830, 1.000, 1.0, 1.0),
    ("qwen3-moe-235b-a22b", "train_4k"): (1.072, 0.444, 0.0548, 0.8227),
    ("recurrentgemma-2b", "train_4k"): (0.987, 1.020, 0.0715, 2.3741),
    ("xlstm-1.3b", "train_4k"): (0.998, 0.212, 0.0187, 0.4796),
}

_REF = """
import os, sys, json
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
from repro.launch import dryrun
import jax
from jax.sharding import AxisType
dryrun._mesh = lambda name: jax.make_mesh((2, 4), ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, shape in json.loads(sys.argv[2]):
    rec = dryrun.run_cell(arch, shape, "2x4", smoke=True)
    out[arch + "|" + shape] = {k: rec[k] for k in ("flops", "coll_bytes", "coll_by_kind",
                                                   "arg_bytes", "output_bytes")}
json.dump(out, open(sys.argv[1], "w"))
print("REF_DONE")
"""


# -- shapes and stand-ins -------------------------------------------------------

def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_specs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in r_specs.SHAPES.items()}
    for arch in r_configs.ARCH_IDS:
        for s in r_specs.SHAPES:
            assert t_specs.cell_is_runnable(t_configs.get_config(arch), s) \
                == r_specs.cell_is_runnable(r_configs.get_config(arch), s)


def _shapes(tree, port: bool) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", "") if port
                                      else str(v.dtype))
            for p, v in leaves}


@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_inputs_caches_and_params_equal_reference(arch):
    """Every shape's inputs, every serving shape's caches (the reference's
    stacked layout; the port's host ``pos`` as int32) and the parameters,
    at full width, shapes and dtypes."""
    rcfg, tcfg = r_configs.get_config(arch), t_configs.get_config(arch)
    model = t_specs.meta_model(tcfg)
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert _shapes(t_specs.params_struct(tcfg, model), True) \
        == _shapes(r_specs.params_struct(rcfg), False)
    for s in r_specs.SHAPES:
        got = t_specs.input_specs(tcfg, s)
        assert all(t.device.type == "meta" for t in got.values())
        assert _shapes(got, True) == _shapes(r_specs.input_specs(rcfg, s), False)
        if r_specs.SHAPES[s].kind != "train" and r_specs.cell_is_runnable(rcfg, s):
            assert _shapes(t_specs.cache_specs_struct(tcfg, s, model=model), True) \
                == _shapes(r_specs.cache_specs_struct(rcfg, s), False)


def test_model_flops_equal_reference():
    for arch in r_configs.ARCH_IDS:
        rcfg, tcfg = r_configs.get_config(arch), t_configs.get_config(arch)
        for kind in ("train", "prefill", "decode"):
            assert t_roofline.model_flops(tcfg, kind, 256, 4096) \
                == r_roofline.model_flops(rcfg, kind, 256, 4096)


# -- op_analysis on known programs ------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device=META)


def test_scanned_matmul_trip_counts():
    """A loop of 10 tanh(x @ w_i): folded by the trip scope to one pass
    times 10, and unrolled, both at 10 x 2 x 32 x 128 x 128."""
    def step(w, x):
        for i in trace_scope.trips(range(w.shape[0])):
            x = torch.tanh(x @ w[i])
        return x

    expected = 10 * 2 * 32 * 128 * 128
    costs = []
    for fold in (True, False):
        out, an = op_analysis.analyze(step, _meta(10, 128, 128), _meta(32, 128), fold=fold)
        assert out.shape == (32, 128)
        assert 0.95 < an.cost.flops / expected < 1.10, an.cost.flops / expected
        costs.append((an.cost.flops, an.cost.bytes))
    assert costs[0] == costs[1]
    # FlopCounterMode sees the folded body once, as XLA's cost_analysis does
    _, an = op_analysis.analyze(step, _meta(10, 128, 128), _meta(32, 128))
    assert an.flop_counter_flops == 2 * 32 * 128 * 128


def test_plain_matmul_flops():
    _, an = op_analysis.analyze(lambda a, b: a @ b, _meta(64, 256), _meta(256, 32))
    expected = 2 * 64 * 256 * 32
    assert 0.95 < an.cost.flops / expected < 1.05
    assert an.flop_counter_flops == expected


def test_bytes_reasonable_for_elementwise():
    _, an = op_analysis.analyze(lambda x: x * 2 + 1, _meta(1024, 1024))
    # read + write = 8 MB an op: eager's two ops within the reference's bound
    assert 8e6 <= an.cost.bytes <= 2.5e7, an.cost.bytes
    assert an.peak_bytes == 2 * 4 * 1024 * 1024 or an.peak_bytes == 4 * 1024 * 1024


def test_collective_wire_model():
    assert op_analysis.collective_wire_bytes("all-gather", 64 * 256 * 4, 4) \
        == 64 * 256 * 4 * 3 / 4
    assert op_analysis.collective_wire_bytes("all-reduce", 4096, 8) == 2 * 4096 * 7 / 8
    assert op_analysis.collective_wire_bytes("reduce-scatter", 100, 4) == 300
    assert op_analysis.collective("all-reduce", 4096, 1).coll_bytes == 0
    c = op_analysis.collective("all-gather", 400, 4, 2) + op_analysis.collective(
        "all-reduce", 8, 2)
    assert c.coll_bytes == 600 + 8 and c.coll_by_kind == {"all-gather": 600, "all-reduce": 8}


def test_trip_scope_refuses_a_ragged_loop():
    """A loop whose last pass is shorter than its first cannot fold: under
    the counter it raises, outside it runs every pass."""
    def chunks(x, step):
        outs = [x[i:i + step] * 2 for i in trace_scope.trips(range(0, x.shape[0], step))]
        return torch.cat(trace_scope.unfolded(outs, range(0, x.shape[0], step)))

    assert chunks(torch.ones(10), 4).shape == (10,)
    _, an = op_analysis.analyze(chunks, _meta(12), 4)
    assert an.cost.flops == 12
    with pytest.raises(ValueError, match="ragged"):
        op_analysis.analyze(chunks, _meta(10), 4)
    tiles = [slice(0, 4), slice(4, 8), slice(8, 10)]
    with pytest.raises(ValueError, match="ragged"):
        op_analysis.analyze(lambda x: [x[t] for t in trace_scope.trips(tiles)], _meta(10))


@pytest.mark.parametrize("arch,seq,mesh", [("tinyllama-1.1b", 2048, None),
                                           ("xlstm-1.3b", 128, None),
                                           ("qwen3-moe-235b-a22b", 128, "2x4")])
def test_trip_scope_counts_what_the_unfolded_trace_counts(arch, seq, mesh):
    """A train step (remat on) folded and unfolded: the chunked attention's
    tiles at S 2048 (2 x 2 of 1024), the sLSTM's 64-token chunks and MoE's
    (data, model) shards.  Attention's fold is exact; the sLSTM's and MoE's
    count a little less (measured under 0.04% of the FLOPs and 0.7% of the
    bytes: the carried state's and the shards' slices' gradients, which
    only the unfolded passes sum)."""
    cfg = t_configs.get_smoke_config(arch)
    shapes = {"t": t_specs.ShapeSpec("t", seq, 2 if mesh is None else 16, "train")}
    m = mesh_mod.meta_mesh(mesh_mod.parse_mesh_axes(mesh)) if mesh else None
    got = []
    for fold in (False, True):
        model = t_specs.meta_model(cfg)
        _, an = op_analysis.analyze(steps.make_train_step(cfg, m), model,
                                    adamw.adamw_init(model.parameters()),
                                    t_specs.input_specs(cfg, "t", shapes), fold=fold)
        got.append(an)
    full, folded = got
    assert folded.n_ops < full.n_ops
    assert folded.cost.flops == pytest.approx(full.cost.flops, rel=1e-3)
    assert folded.cost.bytes == pytest.approx(full.cost.bytes, rel=1e-2)


# -- the dry-run -------------------------------------------------------------

def _main_ok(capsys, *argv) -> dict:
    assert dryrun.main(list(argv)) == 0
    line = capsys.readouterr().out.splitlines()[0]
    rec = json.loads(line)
    assert rec["status"] == "ok", rec
    return rec


@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_dryrun_smoke_train_cell(capsys, arch):
    rec = _main_ok(capsys, "--smoke", "--arch", arch, "--shape", "train_4k", "--mesh", "2x4")
    assert rec["t_comp"] > 0 and rec["t_mem"] > 0 and rec["temp_bytes"] > 0


@pytest.mark.parametrize("shape", list(dryrun.TM_SHAPES))
def test_dryrun_smoke_tm_cells(capsys, shape):
    rec = _main_ok(capsys, "--smoke", "--arch", "tm-mnist", "--shape", shape, "--mesh", "2x4")
    assert rec["t_mem"] > 0


def test_dryrun_full_width_decode_on_the_pod():
    """A full-width cell on the (16, 16) pod: tinyllama's decode step at
    B 128 over 32,768 cached positions, and the skip rules."""
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "pod")
    assert rec["n_devices"] == 256 and rec["mesh"] == "pod"
    cfg = t_configs.get_config("tinyllama-1.1b")
    assert rec["model_flops_global"] == 2.0 * cfg.active_param_count() * 128
    assert rec["flops"] * 256 > rec["model_flops_global"]
    assert rec["arg_bytes"] > rec["output_bytes"] > 0
    with pytest.raises(dryrun.SkipCell):
        dryrun.run_cell("tinyllama-1.1b", "long_500k", "pod")
    with pytest.raises(dryrun.SkipCell):
        dryrun.run_cell("qwen3-32b", "train_4k_dp", "pod")


def test_dryrun_cli_imports_no_jax(tmp_path):
    code = ("import sys; from repro_torch.launch import dryrun; "
            "rc = dryrun.main(['--smoke', '--arch', 'recurrentgemma-2b', '--shape', "
            f"'train_4k', '--mesh', '2x4', '--out', {str(tmp_path / 'c.jsonl')!r}]); "
            "bad = [m for m in sys.modules if m == 'jax' or m.split('.')[0] == 'repro']; "
            "print('BAD', bad) if bad else print('CLEAN'); sys.exit(rc)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stdout + r.stderr
    assert json.loads((tmp_path / "c.jsonl").read_text())["status"] == "ok"


def test_dryrun_smoke_cells_against_reference(tmp_path):
    path = tmp_path / "ref.json"
    r = subprocess.run(
        [sys.executable, "-c", _REF, str(path), json.dumps(list(REF_RATIOS))],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu"))
    assert "REF_DONE" in r.stdout, r.stdout + r.stderr
    ref = json.loads(path.read_text())
    for (arch, shape), (flops_ratio, coll_ratio, ag_ratio, ar_ratio) in REF_RATIOS.items():
        want = ref[arch + "|" + shape]
        got = dryrun.run_cell(arch, shape, "2x4", smoke=True)
        assert got["flops"] / want["flops"] == pytest.approx(flops_ratio, rel=0.02), \
            (arch, shape)
        assert got["coll_bytes"] / want["coll_bytes"] == pytest.approx(coll_ratio, rel=0.02), \
            (arch, shape)
        kinds, ref_kinds = got["coll_by_kind"], want["coll_by_kind"]
        for kind, ratio in (("all-gather", ag_ratio), ("all-reduce", ar_ratio)):
            assert kinds.get(kind, 0.0) / ref_kinds[kind] == pytest.approx(ratio, rel=0.02), \
                (arch, shape, kind)
        assert not {"all-to-all", "collective-permute"} & set(kinds), (arch, shape)
        assert "reduce-scatter" not in ref_kinds, (arch, shape)
        # a bottleneck read off the collective term is marked approximate
        assert got["bottleneck_approximate"] == (got["bottleneck"] == "collective")
        # the specs' local shapes give the reference's argument bytes exactly
        assert got["arg_bytes"] == want["arg_bytes"], (arch, shape)


def test_tm_configs_cover_the_reference_cells():
    assert set(dryrun.TM_SHAPES) == {"tm_train", "tm_train_matmul", "tm_train_fused",
                                     "tm_infer", "tm_infer_fused"}
    assert {"tm-mnist", "tm-edge-xl"} <= set(TM_CONFIGS)
    cells = list(dryrun.all_cells())
    assert len(cells) == 10 * 5 + 2 * 5 and len(set(cells)) == len(cells)
    assert np.all([c[0] in r_configs.ARCH_IDS or c[0].startswith("tm-") for c in cells])
