"""Trip scopes: loops whose passes a tracing counter may fold into one.

The dry-run (``launch/op_analysis.py``) counts the aten ops an eager
program dispatches on ``meta`` tensors.  A loop whose passes are the same
ops on the same shapes (the chunked attention's tiles, the sLSTM's step
chunks, MoE's mesh shards) is written ``for i in trips(seq)``: with no
folding counter active it iterates all of ``seq``; under one it runs the
first pass only, with the counter's multiplier raised by ``len(seq)``.
:func:`unfolded` repeats what the one pass appended, so the shapes after
the loop are the full loop's, and :func:`fold_backward` runs a body's
backward (and a checkpoint's recompute inside it) under the multiplier its
forward ran under.  A loop whose last pass is shorter than its first (a
ragged last tile) cannot fold and raises under a counter.

The models import this module and nothing of the launch layer; the
counter is any dispatch mode derived from :class:`FoldingMode`.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack


class FoldingMode(TorchDispatchMode):
    """A dispatch mode that scales what it records by ``mult``; ``fold``
    says whether :func:`trips` loops fold under it."""

    def __init__(self, fold: bool = True):
        super().__init__()
        self.fold = fold
        self.mult = 1.0


def _folding_counter():
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, FoldingMode) and mode.fold:
            return mode
    return None


def _extent(seq, i: int) -> int:
    """How much pass ``i`` of ``seq`` covers: a ``range``'s step (cut at its
    stop), a slice's length, else 1."""
    if isinstance(seq, range):
        return min(seq.step, seq.stop - seq[i])
    item = seq[i]
    if isinstance(item, slice):
        return item.stop - item.start
    return 1


def trips(seq):
    """Iterate ``seq`` (a loop whose passes are alike in ops and shapes):
    all of it, or under a folding counter its first item only, with the
    counts of the body multiplied by ``len(seq)``.  A fold computes one
    pass, so it is for ``meta`` tensors, whose values nobody reads."""
    counter = _folding_counter()
    if counter is None or len(seq) <= 1:
        yield from seq
        return
    n = len(seq)
    if _extent(seq, -1) != _extent(seq, 0):
        raise ValueError(f"trips: the last of {n} passes covers {_extent(seq, -1)}, the "
                         f"first {_extent(seq, 0)}; a ragged loop cannot fold")
    counter.mult *= n
    try:
        yield seq[0]
    finally:
        counter.mult /= n


def unfolded(items: list, seq) -> list:
    """What the passes of ``for _ in trips(seq)`` would have appended:
    ``items`` itself, or its one pass repeated ``len(seq)`` times under a
    fold."""
    n = len(seq)
    return items * n if len(items) == 1 and n > 1 and _folding_counter() else items


def _keep(t):
    return t


class _Folded(torch.autograd.Function):
    """A folded body as one autograd node, so its backward runs under the
    multiplier its forward ran under (``torch.autograd.grad`` over the
    body's own graph, as a reentrant checkpoint's backward does)."""

    @staticmethod
    def forward(ctx, counter, mult, fn, *tensors):
        # the body's own saved tensors stay as they are: an enclosing
        # checkpoint's hooks would recompute its whole region again for
        # this backward's graph task
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            ins = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
            outs = fn(*ins)
        # the inputs go through any enclosing checkpoint's hooks, so its
        # recompute runs this body again, as it would the unfolded one
        ctx.save_for_backward(*tensors)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        ctx.counter, ctx.mult, ctx.ins, ctx.outs = counter, mult, ins, outs
        res = tuple(o.detach() for o in outs)
        return res[0] if single else res

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors                       # noqa: B018 - the enclosing recompute
        pairs = [(o, g) for o, g in zip(ctx.outs, grads) if o.requires_grad and g is not None]
        want = [t for t in ctx.ins if t.requires_grad]
        saved, ctx.counter.mult = ctx.counter.mult, ctx.mult
        try:
            got = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs],
                                           allow_unused=True) if pairs and want else ())
        finally:
            ctx.counter.mult = saved
        return (None, None, None, *(next(got, None) if t.requires_grad else None
                                    for t in ctx.ins))


def fold_backward(fn, *tensors):
    """``fn(*tensors)``; inside a folded :func:`trips` body whose inputs need
    gradients, wrapped so its backward (and a checkpoint's recompute inside
    it) counts as many passes as its forward.  Otherwise ``fn`` as it is."""
    counter = _folding_counter()
    if (counter is None or counter.mult == 1.0 or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in tensors)):
        return fn(*tensors)
    return _Folded.apply(counter, counter.mult, fn, *tensors)
