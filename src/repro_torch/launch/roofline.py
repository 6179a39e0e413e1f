"""Roofline terms of a dry-run cell (``repro/launch/roofline.py``), against
one NVIDIA H100 80GB HBM3's datasheet peaks (``launch/mesh.py``).

    compute term    t_comp = per_device_FLOPs / peak_FLOP/s
    memory term     t_mem  = per_device_HBM_bytes / HBM_bw
    collective term t_coll = per_device_collective_wire_bytes / link_bw

FLOPs and bytes come from ``launch/op_analysis.py`` (the eager op stream on
``meta``, loops' trip counts resolved); ``launch/dryrun.py`` says how the
global counts become per-device ones.  ``model_flops`` uses the standard
6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode) convention with N_active
for MoE.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.op_analysis import Cost


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: dict
    t_comp: float
    t_mem: float
    t_coll: float
    bottleneck: str
    model_flops_global: float
    useful_flops_ratio: float
    # memory (bytes a device)
    arg_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    compile_seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape_kind: str, global_batch: int, seq_len: int) -> float:
    """6·N·D train, 2·N·D prefill, 2·N·B decode (N_active for MoE)."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * global_batch * seq_len
    if shape_kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch          # decode: one token a sequence


def bound_seconds(flops: float, hbm_bytes: float) -> float:
    """The least time one device could take: the larger of its compute and
    memory terms."""
    return max(flops / PEAK_FLOPS_BF16, hbm_bytes / HBM_BW)


def build_report(*, arch: str, shape: str, mesh_name: str, n_devices: int, cost: Cost,
                 model_flops_global: float, arg_bytes: int = 0, temp_bytes: int = 0,
                 output_bytes: int = 0, compile_seconds: float = 0.0) -> RooflineReport:
    """``cost`` is per device."""
    t_comp = cost.flops / PEAK_FLOPS_BF16
    t_mem = cost.bytes / HBM_BW
    t_coll = cost.coll_bytes / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops=cost.flops, hbm_bytes=cost.bytes, coll_bytes=cost.coll_bytes,
        coll_by_kind=dict(cost.coll_by_kind), t_comp=t_comp, t_mem=t_mem, t_coll=t_coll,
        bottleneck=max(terms, key=terms.get), model_flops_global=model_flops_global,
        useful_flops_ratio=model_flops_global / max(cost.flops * n_devices, 1.0),
        arg_bytes=int(arg_bytes), temp_bytes=int(temp_bytes),
        output_bytes=int(output_bytes), compile_seconds=compile_seconds)
