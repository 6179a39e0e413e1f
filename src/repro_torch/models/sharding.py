"""Partitioning rules for the LM substrate (``repro/models/sharding.py``):
a partition spec for every parameter, optimizer, cache and batch leaf.

Name-based rules (MaxText-style logical axes, resolved against the mesh
with divisibility fallbacks), as the reference's:
  * tensor parallelism over ``model``: attention heads, d_ff, vocab, MoE
    expert dim, recurrent width;
  * FSDP over ``data`` in train mode (the non-TP dim of every large matrix);
  * batch over (``pod``, ``data``); KV caches heads-then-head_dim over
    ``model`` with a sequence-over-``data`` fallback for batch-1 serving.

An axis that does not divide its dimension is dropped (replicated), so a
small model on a big mesh still places.  The rules are pure functions of
leaf names, shapes and axis sizes: they take the reference's tree layout
(``embed``, ``unembed``, ``final_norm`` and ``groups[g][li]`` nested dicts
whose leaves stack a group's layers, as ``transformer.params_to_numpy``
and ``params_tree`` write it; caches as ``transformer.caches_tree`` lays
them out) with any leaf that has a ``shape`` (numpy arrays, tensors, meta
tensors), and a mesh that is a ``launch/mesh.Mesh`` or any object with
``axis_names`` and ``devices`` of the mesh's shape.

The port runs the LM on one process over the mesh's logical devices; only
MoE's experts run per shard (``models/moe.py``).  Everywhere else a spec
is layout: :func:`to_named` gives each leaf's per-device shape and the
slice a coordinate holds, which the dry-run's per-device bytes read.
"""

from __future__ import annotations

import math

import numpy as np


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of them, or
    None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def _fit(spec_axes, dim: int, sizes: dict):
    """The spec entry if ``dim`` divides the (product of the) mesh axes,
    else None."""
    if spec_axes is None:
        return None
    axes = spec_axes if isinstance(spec_axes, tuple) else (spec_axes,)
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return None
    total = math.prod(sizes[a] for a in axes)
    if total == 0 or dim % total != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def _mk(sizes: dict, shape, *axes) -> P:
    if len(axes) != len(shape):
        raise ValueError(f"spec {axes} for shape {shape}")
    return P(*[_fit(a, d, sizes) for a, d in zip(axes, shape)])


def _shape(leaf) -> tuple:
    """A leaf's shape; a host int (the port's cache ``pos``) is 0-d."""
    return tuple(getattr(leaf, "shape", ()))


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a path
    holds dict keys (str) and sequence indices (int)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in path order."""
    out = []
    map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    flat = [tree_leaves(t) for t in rest]
    it = iter(range(len(tree_leaves(tree))))

    def one(_, leaf):
        i = next(it)
        return fn(leaf, *(f[i] for f in flat))

    return map_with_path(one, tree)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _in_groups(path) -> bool:
    return "groups" in path


_REPLICATED = {
    "norm1", "norm2", "final_norm", "q_norm", "k_norm", "kv_norm",
    "out_norm", "router", "pos", "steps",
}


def _param_rule(cfg, name: str, shape, fsdp, sizes) -> P:
    nd = len(shape)
    if name in _REPLICATED or nd == 0:
        return P(*([None] * nd))
    if name == "embed":
        return _mk(sizes, shape, "model", fsdp)
    if name == "unembed":
        return _mk(sizes, shape, fsdp, "model")
    if name == "lam":
        return _mk(sizes, shape, "model")
    # attention: shard the (expanded) head axis; when n_heads does not divide
    # the model axis, shard head_dim instead so q and kv stay
    # contraction-consistent; GQA kv with K < model axis is replicated
    heads_ok = _fit("model", cfg.n_heads, sizes) is not None
    if name in ("wq", "wk", "wv") and nd == 3 and shape[0] not in (cfg.n_heads,):
        if heads_ok:
            return _mk(sizes, shape, fsdp, "model", None)
        return _mk(sizes, shape, fsdp, None, "model")
    if name == "wo":
        if heads_ok:
            return _mk(sizes, shape, "model", None, fsdp)
        # non-divisible heads: replicate wo (an hd-sharded wo would make the
        # output projection a (B, S, d) partial-sum all-reduce a layer)
        return _mk(sizes, shape, None, None, fsdp)
    # mla
    if name == "wq_a":
        return _mk(sizes, shape, fsdp, "model")
    if name == "wq_b":
        return _mk(sizes, shape, None, "model", None)
    if name == "wkv_a":
        return _mk(sizes, shape, fsdp, None)
    if name in ("wk_b", "wv_b"):
        return _mk(sizes, shape, None, "model", None)
    # MoE expert banks (E, d, fe) / (E, fe, d): expert-parallel over model,
    # ZeRO-3 over data
    if name in ("gate", "up", "down") and nd == 3:
        return _mk(sizes, shape, "model", fsdp, None)
    # dense mlp
    if name in ("gate", "up"):
        return _mk(sizes, shape, fsdp, "model")
    if name == "down":
        return _mk(sizes, shape, "model", fsdp)
    # rglru
    if name in ("wx", "wgate"):
        return _mk(sizes, shape, fsdp, "model")
    if name == "conv":
        return _mk(sizes, shape, None, "model")
    if name in ("w_r", "w_i") and nd == 2 and shape[0] == shape[1]:
        return _mk(sizes, shape, None, "model")
    if name == "wout":
        return _mk(sizes, shape, "model", fsdp)
    # mlstm / slstm
    if name in ("w_up", "w_gate"):
        return _mk(sizes, shape, fsdp, "model")
    if name in ("wq", "wk", "wv") and nd == 3:        # (H, dh, dh) block-diag
        return _mk(sizes, shape, None, None, "model")
    if name in ("w_f", "w_i") and nd == 2:
        return _mk(sizes, shape, "model", None)
    if name == "w_down":
        return _mk(sizes, shape, "model", fsdp)
    if name in ("w_z", "w_o") or (name.startswith("w_") and nd == 2):
        return _mk(sizes, shape, fsdp, "model")
    if name.startswith("r_") and nd == 3:
        return _mk(sizes, shape, None, None, "model")
    if name == "w_out":
        return _mk(sizes, shape, "model", fsdp)
    return P(*([None] * nd))


def _strip_model(spec: P) -> P:
    return P(*[None if a == "model" else a for a in spec])


def param_specs(cfg, params_tree, mesh, *, train: bool, pure_dp: bool = False):
    """A spec tree matching ``params_tree``.  ``pure_dp``: no tensor-parallel
    (``model``) placement: params are ZeRO-sharded over ``data`` only and
    gathered at use (small models whose batch covers the mesh)."""
    sizes = axis_sizes(mesh)
    fsdp = "data" if train else None

    def rule(path, leaf):
        name = _leaf_name(path)
        shape = _shape(leaf)
        if _in_groups(path) and shape:
            spec = _param_rule(cfg, name, shape[1:], fsdp, sizes)
            spec = _strip_model(spec) if pure_dp else spec
            return P(None, *spec)
        spec = _param_rule(cfg, name, shape, fsdp, sizes)
        return _strip_model(spec) if pure_dp else spec

    return map_with_path(rule, params_tree)


def _cache_rule(cfg, name: str, shape, dp, sizes) -> P:
    nd = len(shape)
    if name == "pos" or nd == 0:
        return P(*([None] * nd))
    b_ok = _fit(dp, shape[0], sizes) is not None if nd else False
    bspec = dp if b_ok else None

    # the sequence axis of attention caches absorbs the data axes when the
    # batch does not divide them (long-context serving) and the model axis
    # when the kv heads do not divide it
    def seq_axes(head_shardable: bool):
        ax = [] if b_ok else list(dp)
        if not head_shardable:
            ax.append("model")
        return tuple(ax) if ax else None

    if name in ("k", "v") and nd == 4:                 # (B, S, K, hd)
        k_ok = _fit("model", shape[2], sizes) is not None
        return _mk(sizes, shape, bspec, seq_axes(k_ok), "model" if k_ok else None, None)
    if name == "kv_pos":
        return _mk(sizes, shape, bspec, seq_axes(False))
    if name == "c_kv":                                  # (B, S, kv_lora)
        return _mk(sizes, shape, bspec, seq_axes(False), None)
    if name == "k_rope":
        return _mk(sizes, shape, bspec, seq_axes(False), None)
    if name == "h" and nd == 2:                         # rglru (B, w)
        return _mk(sizes, shape, bspec, "model")
    if name == "conv" and nd == 3:
        return _mk(sizes, shape, bspec, None, "model")
    if name == "S" and nd == 4:                         # mlstm (B, H, dk, dv)
        return _mk(sizes, shape, bspec, None, None, "model")
    if name == "n" and nd == 3:
        return _mk(sizes, shape, bspec, None, None)
    if name in ("c", "h", "m") and nd == 3:             # slstm (B, H, dh)
        return _mk(sizes, shape, bspec, None, "model")
    return P(*([None] * nd))


def cache_specs(cfg, cache_tree, mesh):
    """A spec tree matching a stacked cache tree (leading repeats dim)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)

    def rule(path, leaf):
        shape = _shape(leaf)
        if shape:
            return P(None, *_cache_rule(cfg, _leaf_name(path), shape[1:], dp, sizes))
        return P()

    return map_with_path(rule, cache_tree)


def batch_specs(cfg, batch_tree, mesh, *, pure_dp: bool = False):
    """The batch dim over (``pod``, ``data``), and ``model`` too under
    ``pure_dp``, where it divides."""
    sizes = axis_sizes(mesh)
    axes = ("pod", "data", "model") if pure_dp else ("pod", "data")
    dp = tuple(a for a in axes if a in sizes)

    def rule(path, leaf):
        shape = _shape(leaf)
        return P(_fit(dp, shape[0], sizes), *([None] * (len(shape) - 1)))

    return map_with_path(rule, batch_tree)


class NamedSharding:
    """A spec over a mesh (``jax.sharding.NamedSharding``): which slice of a
    global array each mesh coordinate holds."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        self.sizes = axis_sizes(mesh)

    def _axes(self, dim: int) -> tuple:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def shard_shape(self, global_shape) -> tuple:
        """Each device's local shape."""
        return tuple(d // math.prod(self.sizes[a] for a in self._axes(i))
                     for i, d in enumerate(global_shape))

    def index(self, coord, global_shape) -> tuple:
        """The slices of a global array that mesh coordinate ``coord`` (one
        index per axis, in ``axis_names`` order) holds."""
        at = dict(zip(axis_sizes(self.mesh), coord))
        local = self.shard_shape(global_shape)
        out = []
        for i, n in enumerate(local):
            k = 0
            for a in self._axes(i):           # row-major over the entry's axes
                k = k * self.sizes[a] + at[a]
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.sizes}, {self.spec!r})"


def to_named(spec_tree, mesh):
    """A :class:`NamedSharding` a leaf of ``spec_tree``."""
    return map_with_path(lambda _, spec: NamedSharding(mesh, spec), spec_tree)
