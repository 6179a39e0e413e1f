"""Dry-run: every (arch x shape x mesh) cell's per-device roofline, without
a card (``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --arch xlstm-1.3b \\
        --shape train_4k --mesh 2x4

The reference lowers each cell's jitted step with XLA on 512 fabricated
host devices and reads the compiled, partitioned HLO.  The port has no
compiler and no partitioner: it builds the model on the ``meta`` device
(shapes, no data), runs the cell's step once there under
``launch/op_analysis.analyze`` and counts what eager PyTorch dispatches.
On ``meta`` every kernel wrapper takes its plain route, so the count is
the plain versions' op stream.  LM cells trace:

  * train: ``make_train_step(cfg, mesh)`` with AdamW, ``microbatches`` 4
    above 5e10 parameters, ``pure_dp`` for the ``dp`` layout;
  * prefill and decode: ``make_prefill_step(cfg, mesh)`` and
    ``make_decode_step(cfg, mesh)`` (one token at position seq_len - 1)
    against the cell's caches.

The traced program is the global one (MoE's experts per shard, the rest
unpartitioned), so the per-device figures follow a rule:

  * ``arg_bytes`` is exact, from the specs' local shapes
    (``models/sharding.py``): params, AdamW's float32 moments and step,
    and the batch (train); params, batch and caches (prefill); params,
    caches, inputs and the int32 position (decode).  ``output_bytes``
    counts the same way what the step returns: params, moments, step and
    three float32 metrics (train); the caches and the last-token float32
    logits split like the batch (serving).  The reference's compiler picks
    its outputs' layouts, so its figure can differ by those choices (6% at
    most on the smoke cells of ``tests/test_torch_dryrun.py``);
  * ``flops`` and ``hbm_bytes`` are the traced global counts over the
    device count;
  * ``temp_bytes`` is the trace's peak of live bytes over the product of
    the batch's mesh axes;
  * ``coll_bytes`` is the Megatron-style count the specs imply
    (:func:`implied_collectives`): FSDP all-gathers of data-sharded
    weights at each use (forward and remat recompute, a microbatch),
    their gradients' reduce-scatter, the gradient all-reduce of leaves
    not sharded over a batch axis, the all-reduce of a layer's
    model-sharded output projection (attention, MLP, recurrent mixer) and
    of MoE's partial sum over ``model``, once a pass (train: forward,
    recompute and backward), and a decode step's all-gather of the
    attention caches whose sequence axis is split (:func:`cache_gathers`).
    Attention-score and softmax-statistic collectives and logit gathers
    are not counted, nor XLA's activation all-gathers, all-to-alls and
    collective-permutes between layouts.  On the reference's (2, 4) smoke
    cells the count is 0.21-1.17x the reference's (all-gathers 0-7%,
    all-reduces 0.48-2.37x; ``tests/test_torch_dryrun.py`` says which kind
    makes each gap), so a ``collective`` bottleneck is approximate: the
    record says so in ``bottleneck_approximate``.

``xla_cost_flops`` holds ``FlopCounterMode``'s total over the device
count: the matmul-like FLOPs of the op stream with each folded loop's body
once (the reference's XLA ``cost_analysis`` also counts a loop body once).

TM cells run ``core/sharding.py``'s builders on ``meta`` tensors over a
``meta`` mesh: ``sharded_train_step_fn`` (``gspmd`` and ``kernel``
engines, ``matmul`` algorithm) and ``sharded_predict_fn`` (oracle and
kernel routes).  The one host read on their paths, the plain delta's
choice of drawn rows (``kernels/ref.ta_delta_ref``), takes its dense bound
on ``meta``; no builder needs CPU tensors.  TM collectives are not
counted.  ``--smoke`` cuts LM cells to the smoke configs at seq <= 128 and
batch <= 16, as the reference's, and TM cells' batches to 64.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.matador_tm import TM_CONFIGS
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.models import sharding as shd
from repro_torch.models import steps, transformer
from repro_torch.optim import adamw

META = torch.device("meta")
SMOKE_SEQ, SMOKE_BATCH, SMOKE_TM_BATCH = 128, 16, 64


class SkipCell(Exception):
    pass


def _mesh(name: str):
    if name == "multipod":
        return mesh_mod.make_production_mesh(multi_pod=True)
    if name == "pod":
        return mesh_mod.make_production_mesh(multi_pod=False)
    return mesh_mod.meta_mesh(mesh_mod.parse_mesh_axes(name))


def _itemsize(t) -> int:
    return torch.empty((), dtype=t.dtype).element_size()


def local_bytes(tree, spec_tree, mesh) -> int:
    """Bytes a device holds of ``tree`` laid out by ``spec_tree``."""
    return sum(math.prod(shd.NamedSharding(mesh, spec).shard_shape(tuple(t.shape)))
               * _itemsize(t)
               for t, spec in zip(shd.tree_leaves(tree), shd.tree_leaves(spec_tree)))


def _axes(spec) -> set:
    out = set()
    for e in spec:
        out.update(e if isinstance(e, tuple) else (e,) if e else ())
    return out


# output projections whose input dim, split over ``model``, leaves a partial
# sum (B, S, d) to all-reduce: attention/MLA, RG-LRU, mLSTM, sLSTM, the dense
# MLP and MoE's expert bank (E over model: the partial sum over experts)
_OUT_PROJ = ("wo", "wout", "w_down", "w_out", "down")


def cache_gathers(cfg, c_tree, mesh) -> op_analysis.Cost:
    """A decode step's all-gather of each attention cache leaf whose
    sequence axis is split (``cache_specs``' fallback): the step attends
    over the whole sequence."""
    c_specs = shd.cache_specs(cfg, c_tree, mesh)
    sizes = shd.axis_sizes(mesh)
    cost = op_analysis.Cost()
    for (path, leaf), spec in zip(_with_paths(c_tree), shd.tree_leaves(c_specs)):
        if path[-1] not in ("k", "v", "c_kv", "k_rope", "kv_pos") or len(spec) < 3:
            continue
        seq_axes = _axes(spec[2:3])
        g = math.prod(sizes[a] for a in seq_axes)
        local = math.prod(shd.NamedSharding(mesh, spec).shard_shape(tuple(leaf.shape)))
        cost = cost + op_analysis.collective("all-gather", local * g * _itemsize(leaf), g)
    return cost


def _with_paths(tree) -> list:
    out = []
    shd.map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


def implied_collectives(cfg, p_tree, p_specs, mesh, *, kind: str, batch: int, seq: int,
                        pure_dp: bool, n_micro: int = 1, remat: bool = True
                        ) -> op_analysis.Cost:
    """The per-device collectives the specs imply (the module docstring's
    list), as wire bytes of ring algorithms."""
    sizes = shd.axis_sizes(mesh)
    dp = [a for a in (("pod", "data", "model") if pure_dp else ("pod", "data")) if a in sizes]
    b_axes = shd._fit(tuple(dp), batch, sizes)
    b_axes = (b_axes,) if isinstance(b_axes, str) else (b_axes or ())
    b_loc = batch // math.prod(sizes[a] for a in b_axes)
    n_model = sizes.get("model", 1)
    act = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    train = kind == "train"
    # model-sharded partial sums: forward; train adds remat's recompute and
    # the backward's input-gradient sum
    passes = n_micro * ((2 if remat else 1) + 1) if train else 1
    act_bytes = (b_loc // n_micro if train else b_loc) * seq * cfg.d_model * act
    cost = op_analysis.Cost()

    def visit(path, leaf, spec):
        nonlocal cost
        name, shape = path[-1], tuple(leaf.shape)
        per_layer = spec[1:] if "groups" in path else spec
        repeats = shape[0] if "groups" in path else 1
        lb = math.prod(shd.NamedSharding(mesh, spec).shard_shape(shape)) * _itemsize(leaf)
        if train:
            g_axes = [a for a in ("pod", "data") if a in _axes(spec)]
            g = math.prod(sizes[a] for a in g_axes)
            r = math.prod(sizes[a] for a in b_axes if a not in _axes(spec))
            uses = n_micro * (2 if remat else 1)
            cost = (cost + op_analysis.collective("all-gather", lb * g, g, uses)
                    + op_analysis.collective("reduce-scatter", lb, g, n_micro)
                    + op_analysis.collective("all-reduce", lb, r, n_micro))
        if name in _OUT_PROJ and per_layer and "model" in _axes(per_layer[:1]):
            cost = cost + op_analysis.collective("all-reduce", act_bytes, n_model,
                                                 passes * repeats)

    for (path, leaf), spec in zip(_with_paths(p_tree), shd.tree_leaves(p_specs)):
        visit(path, leaf, spec)
    if "embed" in p_tree and "model" in _axes(p_specs["embed"][:1]):   # vocab-split lookup
        cost = cost + op_analysis.collective("all-reduce", act_bytes, n_model,
                                             n_micro if train else 1)
    if train and "model" in _axes(p_specs.get("unembed", (None, None))[1:]):
        # the hidden states' gradient through a vocab-split unembedding
        cost = cost + op_analysis.collective("all-reduce", act_bytes, n_model, n_micro)
    return cost


def _lm_cell(arch: str, shape_name: str, mesh, mesh_name: str, smoke: bool):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    sp = specs.SHAPES[shape_name]
    if smoke:
        sp = dataclasses.replace(sp, seq_len=min(sp.seq_len, SMOKE_SEQ),
                                 global_batch=min(sp.global_batch, SMOKE_BATCH))
    shapes = {shape_name: sp}
    if not specs.cell_is_runnable(cfg, shape_name):
        raise SkipCell(f"{arch} is full-attention; long_500k requires sub-quadratic "
                       "attention")
    if sp.layout == "dp" and cfg.param_count() >= 1e10:
        raise SkipCell("pure-DP layout is for <10B-param archs (weights are gathered "
                       "per use; large models need TP/EP)")
    t0 = time.perf_counter()
    model = specs.meta_model(cfg)
    batch = specs.input_specs(cfg, shape_name, shapes)
    p_tree = transformer.params_tree(cfg, model)
    mf = roofline.model_flops(cfg, sp.kind, sp.global_batch, sp.seq_len)
    pure_dp = sp.layout == "dp"
    train = sp.kind == "train"
    p_specs = shd.param_specs(cfg, p_tree, mesh, train=train, pure_dp=pure_dp)
    b_specs = shd.batch_specs(cfg, batch, mesh, pure_dp=pure_dp)
    p_bytes = local_bytes(p_tree, p_specs, mesh)
    b_bytes = local_bytes(batch, b_specs, mesh)
    n_micro = 1
    if train:
        n_micro = 4 if cfg.param_count() > 5e10 else 1
        opt = adamw.adamw_init(model.parameters())
        f32 = transformer.params_tree(cfg, model, opt.m)
        m_bytes = local_bytes(f32, p_specs, mesh)
        arg = p_bytes + 2 * m_bytes + 4 + b_bytes
        out_b = p_bytes + 2 * m_bytes + 4 + 3 * 4
        fn = steps.make_train_step(cfg, mesh, microbatches=n_micro, pure_dp=pure_dp)
        args = (model, opt, batch)
    else:
        caches = specs.caches_for(model, shape_name, shapes)
        c_tree = transformer.caches_tree(cfg, caches)
        c_bytes = local_bytes(c_tree, shd.cache_specs(cfg, c_tree, mesh), mesh)
        logits = torch.empty((sp.global_batch, cfg.vocab_size * cfg.n_codebooks),
                             dtype=torch.float32, device=META)
        out_b = c_bytes + local_bytes([logits], shd.batch_specs(cfg, [logits], mesh), mesh)
        arg = p_bytes + c_bytes + b_bytes
        if sp.kind == "prefill":
            fn, args = steps.make_prefill_step(cfg, mesh), (model, batch, caches)
        else:
            fn = steps.make_decode_step(cfg, mesh)
            args = (model, caches, batch, sp.seq_len - 1)
            arg += 4
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, an = op_analysis.analyze(fn, *args)
    t_trace = time.perf_counter() - t0
    n = mesh.size
    seq = 1 if sp.kind == "decode" else sp.seq_len
    coll = implied_collectives(cfg, p_tree, p_specs, mesh, kind=sp.kind,
                               batch=sp.global_batch, seq=seq, pure_dp=pure_dp,
                               n_micro=n_micro)
    if sp.kind == "decode":
        coll = coll + cache_gathers(cfg, c_tree, mesh)
    b_axes = [a for a in (("pod", "data", "model") if pure_dp else ("pod", "data"))
              if a in mesh.shape]
    cost = op_analysis.Cost(flops=an.cost.flops / n, bytes=an.cost.bytes / n) + coll
    report = roofline.build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, n_devices=n, cost=cost,
        model_flops_global=mf, arg_bytes=arg, output_bytes=out_b,
        temp_bytes=an.peak_bytes // math.prod(mesh.shape[a] for a in b_axes),
        compile_seconds=t_trace)
    return report, an, t_build


TM_SHAPES = {
    "tm_train": dict(batch=8192, kind="train"),
    "tm_train_matmul": dict(batch=8192, kind="train", algorithm="matmul"),
    "tm_train_fused": dict(batch=8192, kind="train", engine="kernel"),
    "tm_infer": dict(batch=65536, kind="infer"),
    "tm_infer_fused": dict(batch=65536, kind="infer", engine="kernel"),
}


def _tm_cell(arch: str, shape_name: str, mesh, mesh_name: str, smoke: bool):
    from repro_torch.core import packetizer
    from repro_torch.core import sharding as tm_shd

    config = TM_CONFIGS[arch]
    spec = TM_SHAPES[shape_name]
    B = SMOKE_TM_BATCH if smoke else spec["batch"]
    C, L = config.n_clauses_total, config.n_literals
    W = packetizer.n_words(L)
    kernel = spec.get("engine") == "kernel"
    t0 = time.perf_counter()
    if spec["kind"] == "train":
        fn = tm_shd.sharded_train_step_fn(
            config, mesh, algorithm=spec.get("algorithm", "bitwise"),
            engine="kernel" if kernel else "gspmd")
        args = (torch.empty((C, L), dtype=torch.int8, device=META),
                torch.empty((B, config.n_features), dtype=torch.uint8, device=META),
                torch.empty((B,), dtype=torch.int32, device=META), 0)
        # TM "model flops": one bit-op a (sample, clause, literal) for eval
        # and feedback, as equivalent MACs/2
        mf = 2.0 * B * C * L
    else:
        fn = tm_shd.sharded_predict_fn(config, mesh, use_kernel=kernel)
        args = (torch.empty((C, W), dtype=torch.int32, device=META),
                torch.empty((C, config.n_classes), dtype=torch.int32, device=META),
                torch.empty((C,), dtype=torch.uint8, device=META),
                torch.empty((B, W), dtype=torch.int32, device=META))
        mf = 2.0 * B * C * W
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, an = op_analysis.analyze(fn, *args)
    n = mesh.size
    arg = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    report = roofline.build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, n_devices=n,
        cost=op_analysis.Cost(flops=an.cost.flops / n, bytes=an.cost.bytes / n),
        model_flops_global=mf, arg_bytes=arg // n, temp_bytes=an.peak_bytes // n,
        compile_seconds=time.perf_counter() - t0)
    return report, an, t_build


def run_cell(arch: str, shape_name: str, mesh_name: str, *, smoke: bool = False) -> dict:
    mesh = _mesh(mesh_name)
    cell = _tm_cell if arch.startswith("tm-") else _lm_cell
    report, an, t_build = cell(arch, shape_name, mesh, mesh_name, smoke)
    rec = report.as_dict()
    rec["lower_seconds"] = t_build
    rec["xla_cost_flops"] = an.flop_counter_flops / mesh.size
    rec["n_ops"] = an.n_ops
    rec["bottleneck_approximate"] = rec["bottleneck"] == "collective"
    return rec


def all_cells():
    for arch in ARCH_IDS:
        for shape_name in specs.SHAPES:
            yield arch, shape_name
    for arch in ("tm-mnist", "tm-edge-xl"):
        for shape_name in TM_SHAPES:
            yield arch, shape_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", help="pod | multipod | DxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs/shapes (sharding tests)")
    args = ap.parse_args(argv)

    cells = ([(a, s, m) for (a, s) in all_cells() for m in args.meshes.split(",")]
             if args.all else [(args.arch, args.shape, args.mesh)])
    failures = 0
    for arch, shape_name, mesh_name in cells:
        try:
            rec = run_cell(arch, shape_name, mesh_name, smoke=args.smoke)
            status = "ok"
        except SkipCell as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "skipped": str(e)}
            status = "skip"
        except Exception as e:  # noqa: BLE001 - report and continue the sweep
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=20)}
            status = "FAIL"
            failures += 1
        rec["status"] = status
        line = json.dumps(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        brief = {k: rec.get(k) for k in (
            "arch", "shape", "mesh", "status", "bottleneck", "bottleneck_approximate",
            "t_comp", "t_mem", "t_coll", "useful_flops_ratio", "temp_bytes", "compile_seconds", "error", "skipped")
            if k in rec}
        print(json.dumps(brief), flush=True)
        if status == "ok":
            print(f"  memory: args={rec['arg_bytes']:.3e} temp={rec['temp_bytes']:.3e} "
                  f"out={rec['output_bytes']:.3e} bytes/device", flush=True)
            print(f"  cost:   flop_counter={rec['xla_cost_flops']:.3e} "
                  f"(per-device, loop bodies once) op_flops={rec['flops']:.3e} "
                  f"(trip-resolved)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
