"""Op-stream analysis: FLOPs, HBM bytes and live memory of an eager
PyTorch program, traced on ``meta`` tensors (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference reads its cost from the compiled, partitioned HLO: XLA's
own ``cost_analysis()`` counts each ``while`` body once, so it parses the
HLO text and resolves the loops' trip counts.  The port has no compiler:
the program is the stream of aten ops that eager PyTorch dispatches, so a
``TorchDispatchMode`` records every op as it runs (on ``meta`` tensors
nothing is computed and nothing is allocated), loops included as they
unroll, and costs each one with the reference's conventions:

  * dot ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``):
    2 x result elements x contraction size (``_dot_flops``), plus the
    result elements of an ``add*`` form's accumulate; other ops
    ``torch.utils.flop_counter`` knows (convolutions, fused attention)
    take its formula;
  * elementwise ops (the reference's ``_ELEMENTWISE`` list, by aten
    name): 1 FLOP a result element; everything else 0;
  * bytes: each op's tensor operands plus its result.  Views are free,
    a gather (``index``, ``embedding``, ``gather``, ``index_select``)
    moves 2 x its result and a ``copy_`` 2 x its source, as the
    reference's gather and dynamic-update-slice rules.  Eager has no
    fusion, so this overstates the HBM traffic of a fused program: each
    intermediate is written and read back;
  * collectives: per-device wire bytes of ring algorithms
    (:func:`collective_wire_bytes`, the reference's
    ``_collective_wire_bytes``); eager single-process programs issue
    none, so callers add the ones their layout implies;
  * peak live bytes: storages created inside the trace, freed when their
    last tensor dies (autograd's saved tensors included), at their high
    water mark over the run;
  * loops: the counterpart of the reference's while-loop trip counts
    (``comp_multiplicities``) is a trip scope (``repro_torch/trace_scope.py``):
    a loop written ``for i in trips(seq)`` runs its body once under the
    counter, whose counts are multiplied by ``len(seq)``.  On ``meta`` every
    pass of such a loop is the same ops on the same shapes, so the fold
    changes no count; the sLSTM step chunks, the chunked attention route
    and MoE's mesh shards use it.

:func:`analyze` runs a callable under the counter and, beside it,
``torch.utils.flop_counter.FlopCounterMode`` (its count of matmul-like
FLOPs stands where the reference prints XLA's ``cost_analysis`` flops).
Every kernel of the port takes its plain route on ``meta`` (the CUDA
wrappers launch only on CUDA tensors), so the count is that of the plain
versions' op stream.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.trace_scope import FoldingMode

aten = torch.ops.aten

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# 1-flop-per-element ops (the reference's list, by aten name; in-place forms
# count as theirs); the rest count 0, dots dominate by orders of magnitude
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "tanh",
    "rsqrt", "sqrt", "log", "neg", "pow", "eq", "ne", "lt", "le", "gt", "ge",
    "where", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_not", "_to_copy", "floor", "clamp",
    "clamp_min", "clamp_max", "sin", "cos", "sigmoid",
}
_GATHERS = {aten.index, aten.embedding, aten.gather, aten.index_select}


@dataclasses.dataclass
class Cost:
    """The reference's cost record: FLOPs, HBM bytes, collective wire
    bytes, the latter by kind."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o: "Cost") -> "Cost":
        kinds = dict(self.coll_by_kind)
        for k, v in o.coll_by_kind.items():
            kinds[k] = kinds.get(k, 0.0) + v
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.coll_bytes + o.coll_bytes, kinds)

    def scaled(self, f: float) -> "Cost":
        return Cost(self.flops * f, self.bytes * f, self.coll_bytes * f,
                    {k: v * f for k, v in self.coll_by_kind.items()})


def collective_wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Per-device bytes crossing links for a collective of ``group``
    devices whose result is ``out_bytes`` a device (ring algorithms)."""
    if kind not in _COLLECTIVES:
        raise ValueError(f"collective {kind!r}: one of {_COLLECTIVES}")
    g = max(group, 1)
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes


def collective(kind: str, out_bytes: float, group: int, count: float = 1.0) -> Cost:
    """``count`` collectives of one kind as a :class:`Cost`."""
    wire = count * collective_wire_bytes(kind, out_bytes, group) if group > 1 else 0.0
    return Cost(coll_bytes=wire, coll_by_kind={kind: wire} if wire else {})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args, out: torch.Tensor) -> float:
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm, aten.mv):
        k = args[0].shape[-1]
    elif packet in (aten.addmm, aten.baddbmm):
        k = args[1].shape[-1]
    else:                                              # dot
        k = args[0].numel()
    flops = 2.0 * out.numel() * k
    if packet in (aten.addmm, aten.baddbmm):
        flops += out.numel()
    return flops


_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot, aten.mv}


class OpCounter(FoldingMode):
    """Records the cost of every aten op dispatched while it is active;
    ``fold`` folds the loops written with ``trace_scope.trips``."""

    def __init__(self, fold: bool = True):
        super().__init__(fold)
        self.cost = Cost()
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._storages: set = set()

    def _free(self, key, n):
        self._storages.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.n_ops += 1
        returns = func._schema.returns
        alias = returns[0].alias_info if returns else None
        if alias is not None and not alias.is_write:
            return out                                 # a view: no data moves
        packet = func.overloadpacket
        if packet in _DOTS:
            flops = _dot_flops(func, args, outs[0])
        elif packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet.__name__.rstrip("_") in _ELEMENTWISE:
            flops = float(sum(o.numel() for o in outs))
        else:
            flops = 0.0
        if packet in _GATHERS:
            moved = 2 * sum(_nbytes(o) for o in outs)
        elif packet is aten.copy_:
            moved = 2 * _nbytes(args[1]) if isinstance(args[1], torch.Tensor) else 0
        elif alias is not None:                        # in place: operands, self written
            moved = sum(_nbytes(t) for t in ins) + _nbytes(outs[0])
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(o) for o in outs)
            for o in outs:
                self._track(o)
        self.cost.flops += flops * self.mult
        self.cost.bytes += moved * self.mult
        return out


@dataclasses.dataclass
class Analysis:
    """What :func:`analyze` read: the cost, the peak of bytes live at once
    above what existed before, the aten op count, and FlopCounterMode's
    total."""

    cost: Cost
    peak_bytes: int
    n_ops: int
    flop_counter_flops: float


def analyze(fn, *args, fold: bool = True, **kwargs):
    """``fn(*args, **kwargs)`` under the counter -> (its result, Analysis).
    FlopCounterMode sees the folded loops' one pass (``fold``): its total
    is the unfolded program's only without them."""
    with FlopCounterMode(display=False) as fc, OpCounter(fold) as oc:
        out = fn(*args, **kwargs)
    return out, Analysis(cost=oc.cost, peak_bytes=oc.peak, n_ops=oc.n_ops,
                         flop_counter_flops=float(fc.get_total_flops()))
