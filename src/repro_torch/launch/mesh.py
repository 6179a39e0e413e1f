"""Device meshes for the sharded TM paths (``core/sharding.py``), the LM
on a mesh (``models/sharding.py``, ``models/steps.py``) and the dry-run.

A :class:`Mesh` names up to three axes, ``pod``, ``data`` and ``model`` in
that order, and holds one ``torch.device`` for each coordinate.  One
process drives every coordinate, as the reference's single controller does.

The devices a mesh may take are the physical ones of the requested type
(``torch.cuda.device_count()`` cards, or the one CPU), unless
``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` is set: then N logical devices are
laid round-robin over the physical ones, the counterpart of the
reference's ``--xla_force_host_platform_device_count``.  Logical devices
that share a card run their shards one after another on it.  A ``meta``
mesh (:func:`meta_mesh`, :func:`make_production_mesh`) holds as many
``meta`` devices as its shape asks: the dry-run traces on it, without a
card.

The hardware constants below are the roofline's denominators
(``launch/roofline.py``), for one GPU of the target.
"""

from __future__ import annotations

import itertools
import math
import os

import torch

AXES = ("pod", "data", "model")
FORCE_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"


class Mesh:
    """Ordered named axes over a row-major list of logical devices."""

    def __init__(self, shape: dict, devices):
        names = tuple(shape)
        if names != tuple(a for a in AXES if a in shape) or "model" not in shape:
            raise ValueError(f"mesh axes {names}: a subsequence of {AXES} "
                             "that holds 'model'")
        self.axis_names = names
        self.shape = dict(shape)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"mesh {self.shape} over {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self):
        """Every coordinate, row-major (the order of ``devices``)."""
        return itertools.product(*(range(s) for s in self.shape.values()))

    def device(self, coord) -> torch.device:
        flat = 0
        for c, s in zip(coord, self.shape.values()):
            flat = flat * s + c
        return self.devices[flat]


def meta_mesh(shape: dict) -> Mesh:
    """A mesh of ``shape`` over ``meta`` devices (no card, no memory)."""
    return Mesh(shape, ["meta"] * math.prod(shape.values()))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, (data 16, model 16) and (pod 2,
    data 16, model 16), over ``meta`` devices."""
    if multi_pod:
        return meta_mesh({"pod": 2, "data": 16, "model": 16})
    return meta_mesh({"data": 16, "model": 16})


def physical_devices(device) -> list:
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def visible_devices(device) -> list:
    """The devices a mesh of ``device``'s type may take: the physical ones,
    or ``REPRO_TORCH_FORCE_DEVICE_COUNT`` logical ones laid round-robin over
    them."""
    phys = physical_devices(device)
    forced = os.environ.get(FORCE_ENV)
    if not forced or not phys:
        return phys
    if not forced.strip().isdigit() or int(forced) < 1:
        raise ValueError(f"{FORCE_ENV}={forced!r}: a positive device count")
    return [phys[i % len(phys)] for i in range(int(forced))]


def make_mesh(shape: dict, device="cuda", spec: str | None = None) -> Mesh:
    """A mesh of ``shape`` (axis -> size) over the first visible devices of
    ``device``'s type; raises ``ValueError`` when too few are visible."""
    need = math.prod(shape.values())
    devices = visible_devices(device)
    if need > len(devices):
        dev = torch.device(device)
        label = spec if spec is not None else ",".join(f"{k}={v}" for k, v in shape.items())
        raise ValueError(
            f"--mesh {label!r} needs {need} devices but only {len(devices)} "
            f"visible ({dev.type} device_count {len(physical_devices(dev))}); "
            f"export {FORCE_ENV}={need} to lay {need} logical devices over "
            "them before running")
    return Mesh(shape, devices[:need])


def make_host_mesh(data: int = 2, model: int = 4) -> Mesh:
    """Small mesh over CPU devices for tests (needs the forced device count)."""
    return make_mesh({"data": data, "model": model}, "cpu")


def parse_mesh_spec(spec: str, device="cuda") -> Mesh:
    """CLI ``--mesh`` spec -> Mesh over ``device``'s type.

    Accepts ``model=N``, ``data=D,model=M``, ``pod=P,data=D,model=M`` (axis
    order is canonicalised to pod, data, model) and the bare ``DxM``
    shorthand for ``data=D,model=M``.  Raises a clear error when too few
    devices are visible (set ``REPRO_TORCH_FORCE_DEVICE_COUNT=N`` first).
    """
    return make_mesh(parse_mesh_axes(spec), device, spec.strip())


def parse_mesh_axes(spec: str) -> dict:
    """A ``--mesh`` spec -> its axis sizes, in pod, data, model order."""
    spec = spec.strip()

    def _bad():
        return ValueError(
            f"bad --mesh spec {spec!r}: expected e.g. 'model=4', "
            "'data=2,model=4', or 'DxM' (axes: pod, data, model; "
            "'model' is required — it is the clause-shard axis)")

    if "=" not in spec and "x" in spec:
        parts = spec.split("x")
        if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
            raise _bad()
        axes = {"data": int(parts[0]), "model": int(parts[1])}
    else:
        axes = {}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in AXES or not v.strip().isdigit():
                raise _bad()
            axes[k] = int(v)
    if "model" not in axes or any(v < 1 for v in axes.values()):
        raise _bad()
    return {k: axes[k] for k in AXES if k in axes}


# Hardware constants of one NVIDIA H100 80GB HBM3 (SXM, 700 W): datasheet
# figures, not measurements.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor-core peak
HBM_BW = 3.35e12                # bytes/s of HBM3
LINK_BW = 50e9                  # bytes/s a GPU for collectives: a 16-way axis
                                # spans two 8-GPU NVLink domains, so one 400
                                # Gb/s NIC a GPU is the conservative figure
                                # (NVLink 4 gives 450e9 a direction inside one)
