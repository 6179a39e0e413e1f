"""Port parity: the LM substrate on a device mesh (``models/sharding.py``,
``transformer.RunCtx``, MoE's expert-parallel ``moe_ff``, the mesh
``make_train_step``, ``optim/compress.py``) against the JAX reference.

The spec rules are pure functions of names, shapes and axis sizes, so they
are held entry for entry at full width on the production meshes through
duck-typed reference meshes over ``jax.eval_shape`` trees (the port's
trees are ``meta`` tensors).  The numerical cases come from ONE reference
subprocess that forces 8 host devices and builds its meshes with Auto
axes (jax 0.9's ``jax.make_mesh`` defaults to Explicit axes, under which
the reference's ``with_sharding_constraint`` and embedding gather fail);
the port runs here with ``REPRO_TORCH_FORCE_DEVICE_COUNT=8``.

Tolerances: ``moe_ff`` float32 atol 1e-5 x max|out| (the partial sums over
``model`` in another order); the loss atol 1e-5 and the train steps those
of ``tests/test_torch_lm_train.py`` (loss atol 1e-5, grad_norm rtol 1e-5,
lr rtol 1e-6, m and v atol 1e-6, params atol 5e-6; AdamW eps 1e-3 as
there); compression 0 (the same float32 and int32 operations).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as r_configs  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro.models import sharding as r_shd  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import device as t_device  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import sharding as t_shd  # noqa: E402
from repro_torch.models import steps as t_steps  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compress as t_compress  # noqa: E402

pytestmark = pytest.mark.multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4))}
MESH_ARCHS = ("tinyllama-1.1b", "qwen3-moe-235b-a22b")
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)
B, S = 8, 16

_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro import jax_compat
from repro.configs import get_smoke_config
from repro.models import moe, steps, transformer
from repro.models.transformer import RunCtx
from repro.optim import adamw, compress

B, S = {B}, {S}
OPT = {OPT!r}
out = {{}}

def mk(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

mesh = mk((2, 4), ("data", "model"))
# moe_ff at the default capacity factor: each (data, model) shard's capacity
cfg = get_smoke_config("qwen3-moe-235b-a22b")
params = moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)), jnp.float32)
flat("moe_params", params)
out["moe_x"] = np.asarray(x)
out["moe_local"] = np.asarray(jax.jit(lambda p, xx: moe.moe_ff(cfg, p, xx))(params, x))
out["moe_mesh"] = np.asarray(jax.jit(
    lambda p, xx: moe.moe_ff(cfg, p, xx, mesh=mesh, dp_axes=("data",)))(params, x))

for arch in {MESH_ARCHS!r}:
    cfg = get_smoke_config(arch)
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)         # tests/test_sharding.py's loss batch
    batch = {{k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
              for k in ("tokens", "labels")}}
    out[f"{{arch}}/loss_batch_tokens"] = batch["tokens"]
    out[f"{{arch}}/loss_batch_labels"] = batch["labels"]
    jb = {{k: jnp.asarray(v) for k, v in batch.items()}}
    out[f"{{arch}}/loss_1dev"] = np.asarray(jax.jit(
        lambda p, b: transformer.loss_fn(cfg, p, b, remat=False))(params, jb))
    for pure_dp in (False, True):
        ctx = RunCtx(mesh=mesh, pure_dp=pure_dp)
        out[f"{{arch}}/loss_{{pure_dp}}"] = np.asarray(jax.jit(
            lambda p, b: transformer.loss_fn(cfg, p, b, ctx=ctx, remat=False))(params, jb))
        step = jax.jit(steps.make_train_step(cfg, mesh, opt_cfg=adamw.AdamWConfig(**OPT),
                                             pure_dp=pure_dp))
        p, opt = params, adamw.adamw_init(params)
        nprng = np.random.default_rng(5)
        for i in range(3):
            b = {{k: nprng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                  for k in ("tokens", "labels")}}
            p, opt, info = step(p, opt, {{k: jnp.asarray(v) for k, v in b.items()}})
            tag = f"{{arch}}/step_{{pure_dp}}_{{i}}"
            for k, v in b.items():
                out[f"{{tag}}/batch_{{k}}"] = v
            for k in ("loss", "grad_norm", "lr"):
                out[f"{{tag}}/{{k}}"] = np.asarray(info[k])
            flat(f"{{tag}}/params", p)
            flat(f"{{tag}}/m", opt.m)
            flat(f"{{tag}}/v", opt.v)

# int8 quantized all-reduce over 8 data shards, twice (error feedback)
cmesh = mk((8,), ("data",))
rng = np.random.default_rng(1)
g_all = rng.normal(size=(8, 64)).astype(np.float32)
tree = {{"a": rng.normal(size=(8, 5, 3)).astype(np.float32),
         "b": [rng.normal(size=(8, 7)).astype(np.float32) * 1e-3]}}
out["compress_g"] = g_all
flat("compress_tree", tree)

def one(g, e):
    o, ne = compress.quantize_psum(g[0], e[0], "data")
    return o[None], ne[None]

def many(g, e):
    sq = lambda t: jax.tree.map(lambda a: a[0], t)
    o, ne = compress.compressed_allreduce(sq(g), sq(e), "data")
    return jax.tree.map(lambda a: a[None], o), jax.tree.map(lambda a: a[None], ne)

sm = lambda f, specs: jax.jit(jax_compat.shard_map(
    f, mesh=cmesh, in_specs=specs, out_specs=specs, check_vma=False))
err = jnp.zeros_like(jnp.asarray(g_all))
terr = jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)), tree)
tspec = jax.tree.map(lambda a: P("data"), tree)
for i in range(2):
    o, err = sm(one, (P("data"), P("data")))(jnp.asarray(g_all), err)
    out[f"compress_out_{{i}}"], out[f"compress_err_{{i}}"] = np.asarray(o), np.asarray(err)
    to, terr = sm(many, (tspec, tspec))(jax.tree.map(jnp.asarray, tree), terr)
    flat(f"compress_tree_out_{{i}}", to)
    flat(f"compress_tree_err_{{i}}", terr)
np.savez(sys.argv[1], **out)
print("REF_DONE")
""".format(B=B, S=S, OPT=OPT, MESH_ARCHS=MESH_ARCHS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_lm_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env,
                       capture_output=True, text=True, timeout=900, cwd=REPO)
    assert "REF_DONE" in r.stdout, r.stdout + r.stderr
    return dict(np.load(path))


@pytest.fixture
def mesh(monkeypatch):
    monkeypatch.setenv(mesh_mod.FORCE_ENV, "8")
    return mesh_mod.make_host_mesh(2, 4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sub(ref, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the spec rules, entry for entry at full width ------------------------

def _flat_port(tree) -> dict:
    out = {}

    def go(path, t):
        if isinstance(t, dict):
            for k, v in t.items():
                go(path + (k,), v)
        elif isinstance(t, (list, tuple)) and not isinstance(t, t_shd.PartitionSpec):
            for i, v in enumerate(t):
                go(path + (i,), v)
        else:
            out[path] = t
    go((), tree)
    return out


def _flat_ref(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in leaves}


def _same_specs(got, want, what):
    got, want = _flat_port(got), _flat_ref(want)
    assert set(got) == set(want), what
    for k, spec in want.items():
        assert tuple(got[k]) == tuple(spec), (what, k, got[k], spec)
    return len(want)


@pytest.mark.parametrize("arch", r_configs.ARCH_IDS)
def test_specs_equal_reference_at_full_width(arch):
    """``param_specs`` (train and serve, ``pure_dp`` both ways),
    ``cache_specs`` (prefill_32k, decode_32k, long_500k where runnable) and
    ``batch_specs`` of every shape, on the pod, multipod and 2x4 meshes."""
    rcfg, tcfg = r_configs.get_config(arch), t_configs.get_config(arch)
    model = t_specs.meta_model(tcfg)
    t_params, r_params = t_specs.params_struct(tcfg, model), r_specs.params_struct(rcfg)
    n = 0
    for mname, (names, shape) in MESHES.items():
        rm = types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))
        tm = mesh_mod.meta_mesh(dict(zip(names, shape)))
        for train in (True, False):
            for pure_dp in (False, True):
                n += _same_specs(
                    t_shd.param_specs(tcfg, t_params, tm, train=train, pure_dp=pure_dp),
                    r_shd.param_specs(rcfg, r_params, rm, train=train, pure_dp=pure_dp),
                    (mname, train, pure_dp))
        for sname in ("prefill_32k", "decode_32k", "long_500k"):
            if not r_specs.cell_is_runnable(rcfg, sname):
                assert not t_specs.cell_is_runnable(tcfg, sname)
                continue
            n += _same_specs(
                t_shd.cache_specs(tcfg, t_specs.cache_specs_struct(tcfg, sname, model=model), tm),
                r_shd.cache_specs(rcfg, r_specs.cache_specs_struct(rcfg, sname), rm),
                (mname, sname))
        for sname in r_specs.SHAPES:
            for pure_dp in (False, True):
                n += _same_specs(
                    t_shd.batch_specs(tcfg, t_specs.input_specs(tcfg, sname), tm,
                                      pure_dp=pure_dp),
                    r_shd.batch_specs(rcfg, r_specs.input_specs(rcfg, sname), rm,
                                      pure_dp=pure_dp),
                    (mname, sname, pure_dp))
    assert n > 100


def test_named_sharding_slices_tile_the_array():
    """``to_named``'s per-device slices: every coordinate's block has the
    local shape, and the blocks tile the global array."""
    m = mesh_mod.meta_mesh({"pod": 2, "data": 2, "model": 2})
    spec = t_shd.P(("pod", "data"), None, "model")
    ns = t_shd.to_named({"w": spec}, m)["w"]
    shape = (8, 3, 6)
    assert ns.shard_shape(shape) == (2, 3, 3)
    seen = np.zeros(shape, np.int32)
    for coord in m.coords():
        idx = ns.index(coord, shape)
        assert tuple(s.stop - s.start for s in idx) == (2, 3, 3)
        seen[idx] += 1
    assert (seen == 1).all()                   # every axis splits: no replicas
    assert t_shd.to_named({"r": t_shd.P(None, None)}, m)["r"].shard_shape((4, 5)) == (4, 5)


# -- MoE's expert-parallel path ---------------------------------------------

def _moe_port(ref):
    cfg = t_configs.get_smoke_config("qwen3-moe-235b-a22b")
    params = {k.strip("[]'"): _t(v) for k, v in _sub(ref, "moe_params").items()}
    return cfg, params, _t(ref["moe_x"])


def test_moe_mesh_equals_reference_shard_map(ref, mesh):
    """(2, 4) at the default capacity factor: the per-shard capacity."""
    cfg, params, x = _moe_port(ref)
    got = t_moe.moe_ff(cfg, params, x, mesh, ("data",)).numpy()
    want = ref["moe_mesh"]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    local = t_moe.moe_ff(cfg, params, x).numpy()
    np.testing.assert_allclose(local, ref["moe_local"],
                               atol=1e-5 * np.abs(ref["moe_local"]).max(), rtol=0)


def test_moe_mesh_differs_from_unsharded_where_reference_does(ref, mesh):
    cfg, params, x = _moe_port(ref)
    tol = 1e-5 * np.abs(ref["moe_local"]).max()
    ref_diff = np.abs(ref["moe_mesh"] - ref["moe_local"]).max(-1) > tol      # (B, S)
    got = t_moe.moe_ff(cfg, params, x, mesh, ("data",)).numpy()
    port_diff = np.abs(got - t_moe.moe_ff(cfg, params, x).numpy()).max(-1) > tol
    assert ref_diff.any()
    np.testing.assert_array_equal(port_diff, ref_diff)


def test_moe_mesh_rejects_what_does_not_divide(mesh):
    cfg = t_configs.get_smoke_config("qwen3-moe-235b-a22b")
    params = t_moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="must divide"):
        t_moe.moe_ff(cfg, params, torch.zeros((3, 4, cfg.d_model)), mesh, ("data",))


# -- the mesh loss and train steps -------------------------------------------

def _model(arch):
    rcfg, tcfg = r_configs.get_smoke_config(arch), t_configs.get_smoke_config(arch)
    params = r_tr.init_params(rcfg, jax.random.PRNGKey(0))
    return tcfg, t_tr.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_loss_equals_reference(ref, mesh, arch):
    """``loss_fn`` with a ``RunCtx`` on (2, 4), both layouts: the MoE's
    per-shard capacity moves qwen3-moe's loss off the unsharded one, as the
    reference's: 6.690259 against 6.719836 on ``tests/test_sharding.py``'s
    batch (B 4, S 32)."""
    tcfg, model = _model(arch)
    batch = {k: _t(ref[f"{arch}/loss_batch_{k}"]) for k in ("tokens", "labels")}
    with torch.no_grad():
        one = float(t_tr.loss_fn(tcfg, model, batch, remat=False))
    np.testing.assert_allclose(one, float(ref[f"{arch}/loss_1dev"]), atol=1e-5, rtol=0)
    for pure_dp in (False, True):
        with torch.no_grad():
            got = float(t_tr.loss_fn(tcfg, model, batch, remat=False,
                                     ctx=t_tr.RunCtx(mesh=mesh, pure_dp=pure_dp)))
        np.testing.assert_allclose(got, float(ref[f"{arch}/loss_{pure_dp}"]), atol=1e-5,
                                   rtol=0)
    if arch == "tinyllama-1.1b":                   # dense: the mesh is layout only
        assert float(ref[f"{arch}/loss_False"]) == pytest.approx(one, abs=1e-5)
    else:
        assert one == pytest.approx(6.719836, abs=1e-5)
        assert float(ref[f"{arch}/loss_False"]) == pytest.approx(6.690259, abs=1e-5)


@pytest.mark.parametrize("pure_dp", [False, True], ids=["tp", "dp"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_train_step_three_steps_equal_reference(ref, mesh, arch, pure_dp):
    tcfg, model = _model(arch)
    step = t_steps.make_train_step(tcfg, mesh, opt_cfg=t_adamw.AdamWConfig(**OPT),
                                   pure_dp=pure_dp)
    opt = t_adamw.adamw_init(model.parameters())
    for i in range(3):
        tag = f"{arch}/step_{pure_dp}_{i}"
        batch = {k: _t(ref[f"{tag}/batch_{k}"]) for k in ("tokens", "labels")}
        opt, info = step(model, opt, batch)
        np.testing.assert_allclose(float(info["loss"]), float(ref[f"{tag}/loss"]), atol=1e-5)
        np.testing.assert_allclose(float(info["grad_norm"]), float(ref[f"{tag}/grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(info["lr"]), float(ref[f"{tag}/lr"]), rtol=1e-6)
        for what, values, atol in (("params", None, 5e-6), ("m", opt.m, 1e-6),
                                   ("v", opt.v, 1e-6)):
            got = _keyed(t_tr.params_to_numpy(tcfg, model, values))
            want = _sub(ref, f"{tag}/{what}")
            assert set(got) == set(want), what
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=f"{what}{k}")


def test_mesh_steps_without_moe_equal_the_single_device_steps(mesh):
    """tinyllama-smoke: the mesh train, prefill and decode steps compute
    what the single-device steps do, bit for bit."""
    tcfg, a = _model("tinyllama-1.1b")
    _, b = _model("tinyllama-1.1b")
    rng = np.random.default_rng(2)
    batch = {k: _t(rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32))
             for k in ("tokens", "labels")}
    sa, sb = t_steps.make_train_step(tcfg), t_steps.make_train_step(tcfg, mesh)
    oa_, ob = t_adamw.adamw_init(a.parameters()), t_adamw.adamw_init(b.parameters())
    for _ in range(2):
        oa_, ia = sa(a, oa_, batch)
        ob, ib = sb(b, ob, batch)
        assert torch.equal(ia["loss"], ib["loss"])
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    ca, cb = a.init_caches(B, S + 2), b.init_caches(B, S + 2)
    la, _ = t_steps.make_prefill_step(tcfg)(a, {"tokens": batch["tokens"]}, ca)
    lb, _ = t_steps.make_prefill_step(tcfg, mesh)(b, {"tokens": batch["tokens"]}, cb)
    assert torch.equal(la, lb)
    tok = {"tokens": batch["tokens"][:, :1]}
    da, _ = t_steps.make_decode_step(tcfg)(a, ca, tok, S)
    db, _ = t_steps.make_decode_step(tcfg, mesh)(b, cb, tok, S)
    assert torch.equal(da, db)


# -- compression ----------------------------------------------------------------

def test_quantize_psum_equals_reference_exactly(ref):
    g = [_t(r) for r in ref["compress_g"]]
    err = [torch.zeros_like(x) for x in g]
    for i in range(2):
        out, err = t_compress.quantize_psum(g, err)
        for k in range(len(g)):
            np.testing.assert_array_equal(out.numpy(), ref[f"compress_out_{i}"][k])
            np.testing.assert_array_equal(err[k].numpy(), ref[f"compress_err_{i}"][k])


def test_compressed_allreduce_equals_reference_exactly(ref):
    full = {"a": ref["compress_tree['a']"], "b": [ref["compress_tree['b'][0]"]]}
    shards = [{"a": _t(full["a"][k]), "b": [_t(full["b"][0][k])]} for k in range(8)]
    errs = [t_compress.init_error(s) for s in shards]
    assert all(e["a"].dtype == torch.float32 and not e["a"].any() for e in errs)
    for i in range(2):
        mean, errs = t_compress.compressed_allreduce(shards, errs)
        for key, pick in (("['a']", lambda t: t["a"]), ("['b'][0]", lambda t: t["b"][0])):
            for k in range(8):
                np.testing.assert_array_equal(pick(mean).numpy(),
                                              ref[f"compress_tree_out_{i}{key}"][k])
                np.testing.assert_array_equal(pick(errs[k]).numpy(),
                                              ref[f"compress_tree_err_{i}{key}"][k])


# -- meshes and devices ---------------------------------------------------------

def test_production_meshes_and_meta_device():
    pod, multi = mesh_mod.make_production_mesh(), mesh_mod.make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert {d.type for d in multi.devices} == {"meta"}
    assert mesh_mod.parse_mesh_axes("2x4") == {"data": 2, "model": 4}
    assert t_device.resolve("meta") == torch.device("meta")
    assert mesh_mod.PEAK_FLOPS_BF16 == 989e12 and mesh_mod.HBM_BW == 3.35e12
