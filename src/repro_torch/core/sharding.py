"""Mesh sharding for TM training and inference (the reference's
``core/sharding.py``), on a single-process mesh (``launch/mesh.py``).

Layout, as the reference's:
  * automata / include words: clause axis over ``model``, replicated over
    the data axes (``pod``, ``data``);
  * batch: over the data axes;
  * votes: clause axis over ``model``;
  * class sums: partial per model shard -> one exact int32 sum over
    ``model`` (:func:`psum`, the only inference collective);
  * training deltas: computed per (data, model) shard, summed over the
    data axes.

One process drives every shard, as the reference's single controller
does (``jax.jit`` + ``shard_map``).  Each builder returns a callable on
GLOBAL tensors: it splits its inputs by the mesh, runs each shard's body
on that shard's device (the kernels for CUDA tensors, their plain
versions for CPU tensors), completes the int32 partials with
:func:`psum` and assembles the global result on the input's device.
Tables that do not change between calls (include words, votes, schedule
stacks) are split and placed once, and reused while the same tensors come
back; per call only the batch is split.  A clause shard's hash draws are
indexed by global (sample, clause, literal) ids (``b_offset``,
``c_offset``), so every sharded result equals the unsharded one bit for
bit.  Logical devices that share one card run their shards one after
another; nothing updates a shard in place, so replicas may be one tensor.

``engine="gspmd"`` is XLA's partitioning of the whole-bank oracle step in
the reference, where sharding is only layout.  The port has no
partitioner: that engine runs the whole-bank plain step on the mesh's
first device (ROADMAP queue 3), as does ``sharded_predict_fn``'s oracle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import numpy as np
import torch

from repro_torch.core import tm
from repro_torch.kernels.ops import psum


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _engine_dispatch(engine, use_kernel, *, allowed, fuse: bool = True) -> tuple:
    """A builder's ``(oracle, fuse)`` from an ``ops.EngineSpec``/name or the
    low-level ``use_kernel`` override — not both.  Only the engines the
    builder can run (``allowed``) are accepted; ``"oracle"`` or
    ``use_kernel=False`` takes the plain reference route on any device,
    anything else the kernels (their plain versions on CPU tensors)."""
    from repro_torch.kernels import ops

    if engine is None:
        return use_kernel is False, fuse
    if use_kernel is not None:
        raise TypeError("pass engine= or use_kernel=, not both")
    spec = ops.EngineSpec.coerce(engine)
    if spec.name not in allowed:
        raise ValueError(
            f"engine {spec.name!r} does not apply to this sharded builder; "
            f"one of {allowed}")
    return spec.name == "oracle", spec.fuse


@contextlib.contextmanager
def _on(device):
    """Launch on ``device``: a CUDA stream belongs to its card."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def _n_data(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def _shards(mesh) -> list:
    """``[(data index, model index, device)]`` of every coordinate; the
    data index is row-major over the data axes, as the reference's."""
    out = []
    for coord in mesh.coords():
        c = dict(zip(mesh.axis_names, coord))
        di = 0
        for ax in data_axes(mesh):
            di = di * mesh.shape[ax] + c[ax]
        out.append((di, c["model"], mesh.device(coord)))
    return out


def _per_shard(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} ({n}) not divisible by {parts} shards")
    return n // parts


# -- layouts ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How an array lies over a mesh: ``spec`` names, per dimension, the
    mesh axis (or tuple of axes, row-major) it splits over, or None."""

    mesh: object
    spec: tuple

    def index(self, coord, shape) -> tuple:
        """The slices of the block that coordinate ``coord`` holds."""
        c = dict(zip(self.mesh.axis_names, coord))
        out = []
        for i, n in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            parts = math.prod(self.mesh.shape[a] for a in axes)
            k = 0
            for a in axes:
                k = k * self.mesh.shape[a] + c[a]
            size = _per_shard(n, parts, f"dimension {i}")
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def place(self, array) -> "ShardedTensor":
        """Each coordinate's block of ``array`` on its device (replicas of
        one block on one device share a tensor)."""
        t = torch.as_tensor(np.asarray(array)) if not isinstance(array, torch.Tensor) else array
        shards, placed = {}, {}
        for coord in self.mesh.coords():
            idx, dev = self.index(coord, t.shape), self.mesh.device(coord)
            key = (tuple((s.start, s.stop) for s in idx), str(dev))
            if key not in placed:
                placed[key] = t[idx].to(dev).contiguous()
            shards[coord] = placed[key]
        return ShardedTensor(tuple(t.shape), self, shards)


@dataclasses.dataclass
class ShardedTensor:
    """A global array laid over a mesh: ``shards`` maps each coordinate to
    its block on that coordinate's device."""

    shape: tuple
    sharding: NamedSharding
    shards: dict

    @property
    def dtype(self):
        return next(iter(self.shards.values())).dtype

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (default: the mesh's
        first device)."""
        device = self.sharding.mesh.devices[0] if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for coord, t in self.shards.items():
            out[self.sharding.index(coord, self.shape)] = t.to(device)
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.full("cpu").numpy()
        return a if dtype is None else a.astype(dtype)


def tm_shardings(config: tm.TMConfig, mesh):
    """(state_sharding, batch_sharding) for the TM train/serve steps."""
    state = tm.TMState(ta_state=NamedSharding(mesh, ("model", None)),
                       steps=NamedSharding(mesh, ()))
    return state, NamedSharding(mesh, (data_axes(mesh), None))


class _Placed:
    """Per-shard pieces of tables that do not change between calls, made
    by ``split(*tables, **extra)`` on the first call and again only when
    other tensors (or the same ones written since) or other ``extra``
    values come back."""

    def __init__(self, split):
        self._split, self._key, self._value = split, None, None

    def __call__(self, *tables, **extra):
        key = tuple((weakref.ref(t), t._version) for t in tables)
        if self._key is None or self._key[1] != extra or any(
                r() is not t or v != t._version
                for (r, v), t in zip(self._key[0], tables)):
            self._value = self._split(*tables, **extra)
            self._key = key, extra
        return self._value


def _model_pieces(mesh, tables, piece) -> dict:
    """``{(model index, device): tuple}``: ``piece(t, m)`` of each table on
    every device that serves model shard ``m``."""
    out = {}
    for _, m, dev in _shards(mesh):
        if (m, dev) not in out:
            out[m, dev] = tuple(piece(t, m).to(dev).contiguous() for t in tables)
    return out


def _clause_block(mesh):
    n_model = mesh.shape["model"]

    def piece(t, m):
        size = _per_shard(t.shape[0], n_model, "clause axis")
        return t[m * size:(m + 1) * size]
    return piece


def _stack_entry(mesh):
    n_model = mesh.shape["model"]

    def piece(t, m):
        if t.shape[0] != n_model:
            raise ValueError(f"a stack of {t.shape[0]} shards on model={n_model}")
        return t[m]
    return piece


def _forward(mesh, lit_words, body) -> torch.Tensor:
    """Run ``body(m, device, lit_block)`` -> (B_loc, K) int32 partial sums
    on every shard, sum over ``model``, stack the data blocks."""
    n_data = _n_data(mesh)
    B_loc = _per_shard(lit_words.shape[0], n_data, "batch")
    rows, lws = {}, {}
    for d, m, dev in _shards(mesh):
        if (d, dev) not in lws:
            lws[d, dev] = lit_words[d * B_loc:(d + 1) * B_loc].to(dev).contiguous()
        with _on(dev):
            rows.setdefault(d, []).append(body(m, dev, lws[d, dev]))
    return torch.cat([psum(rows[d], lit_words.device) for d in range(n_data)])


# -- inference --------------------------------------------------------------

def sharded_forward_fn(mesh, *, engine=None, use_kernel: bool | None = None,
                       fuse: bool = True, blocks: dict | None = None):
    """Clause-sharded fused forward: ``(inc_words, votes, nonempty,
    lit_words) -> (B, K)`` int32 GLOBAL class sums.

    Each ``model`` shard runs ``ops.tm_forward_packed`` on its clause block
    (the fused dense kernel, or with ``fuse=False`` / ``engine=EngineSpec(
    "dense", fuse=False)`` the ``clause_eval`` -> ``class_sum`` pair;
    ``"oracle"`` the plain reference), and one int32 :func:`psum` over
    ``model`` completes the adder bank.  The clause axis must divide by the
    ``model`` axis; the batch by the data axes.
    """
    from repro_torch.kernels import ops, ref

    oracle, fuse = _engine_dispatch(engine, use_kernel,
                                    allowed=("auto", "dense", "oracle"), fuse=fuse)
    place = _Placed(lambda *t: _model_pieces(mesh, t, _clause_block(mesh)))

    def fwd(inc_words, votes, nonempty, lit_words):
        pieces = place(inc_words, votes, nonempty)

        def body(m, dev, lw):
            inc, vt, ne = pieces[m, dev]
            if oracle:
                fired = ref.clause_fire_ref(lw, inc) * (ne != 0).to(torch.int8)[None, :]
                return ref.class_sum_ref(fired, vt)
            return ops.tm_forward_packed(lw, inc, vt, ne, fuse=fuse, **(blocks or {}))
        return _forward(mesh, lit_words, body)
    return fwd


def stack_shard_dense(include_words, votes, n: int) -> list:
    """The dense mesh rung's tables for ``n`` model shards, as the
    reference's serve pads them: ``[include words (Up, W) int32, votes
    (Up, K) int32, nonempty (Up,) int32]`` with ``U`` rows padded up to a
    multiple ``Up`` of ``n``.  Zero include words never violate, so the
    padding clauses fire, but they carry zero votes and the class sums are
    unchanged.  :func:`sharded_forward_fn` splits each table by clause
    block."""
    U = include_words.shape[0]
    Up = -(-U // n) * n
    return [np.pad(include_words, ((0, Up - U), (0, 0))).view(np.int32),
            np.pad(votes, ((0, Up - U), (0, 0))).astype(np.int32),
            np.ones((Up,), np.int32)]


def _shard_tile_walk(tiles: np.ndarray, n_blocks: int) -> tuple:
    """``(indptr, n_term_tiles)`` of one shard's (4, T) sparse or (6, T)
    factorized tile rows over ``n_blocks`` clause blocks: the CSR pointers
    of its real clause tiles (they end at the last ``last`` flag) and its
    term-tile count, so the walk never reaches the no-op padding tiles.
    The shard's real tiles are ``n_term_tiles + indptr[-1]``."""
    from repro_torch.kernels import sparse_infer

    cb, last = (0, 3) if tiles.shape[0] == 4 else (2, 5)
    n_term_tiles = int((tiles[0] == 0).sum()) if tiles.shape[0] == 6 else 0
    return (sparse_infer.tile_indptr(tiles[cb], tiles[last], n_blocks, n_term_tiles),
            n_term_tiles)


def real_tiles(tile_stack, n_chain_rows: int, block_c: int) -> list:
    """Each shard's real tiles in a stacked (n, 4|6, T) tile table; the
    rest of its ``T`` are no-op padding."""
    out = []
    for t in np.asarray(tile_stack):
        indptr, n_term_tiles = _shard_tile_walk(t, n_chain_rows // block_c)
        out.append(n_term_tiles + int(indptr[-1]))
    return out


def _schedule_placements(mesh, block_c, block_j, *tables, width):
    """Each shard's placement of its schedule tables: ``sparse_infer``'s
    for (chain, votes, tiles) stacks, ``term_infer``'s for (term, chain,
    votes, tiles), with each shard's CSR pointers (and term-tile count)
    derived from its rows of the tile stack (:func:`_shard_tile_walk`) and
    the chains' literal sentinel from the literals' ``width`` in words."""
    from repro_torch.kernels import sparse_infer, term_infer

    pieces = _model_pieces(mesh, tables, _stack_entry(mesh))
    out = {}
    for key, ts in pieces.items():
        chain, tiles = ts[-3], ts[-1]
        if chain.shape[0] % block_c:
            raise ValueError(f"{chain.shape[0]} chain rows are not blocks of "
                             f"block_c={block_c}")
        indptr, n_term_tiles = _shard_tile_walk(tiles.cpu().numpy(),
                                               chain.shape[0] // block_c)
        indptr = torch.from_numpy(indptr).to(tiles.device)
        kw = dict(block_c=block_c, block_j=block_j, n_lit_bits=32 * width)
        out[key] = (term_infer.place_tables(*ts, indptr, n_term_tiles=n_term_tiles, **kw)
                    if len(ts) == 4 else sparse_infer.place_tables(*ts, indptr, **kw))
    return out


def sharded_schedule_forward_fn(mesh, *, block_c: int, block_j: int,
                                block_s: int | None = None, engine=None,
                                use_kernel: bool | None = None):
    """Clause-sharded COMPILED-SCHEDULE forward: each ``model`` shard owns
    its own tile table (``sparse_infer.stack_shard_schedules``) and walks
    its clause block with the chain kernel; one int32 :func:`psum` over
    ``model`` completes the adder bank.  The batch splits over the data
    axes.

    The returned fn: ``(chain_stack (n, Cp, Jp), votes_stack (n, Cp, K),
    tile_stack (n, 4, T), lit_words (B, Wa)) -> (B, K) int32``.  Each
    shard's stacks are placed once (``sparse_infer.place_tables``), its
    CSR pointers from its rows of the tile stack, so a shard's no-op
    padding tiles fold nothing.  ``block_s`` is the walk's sample words a
    block (``sparse_infer.walk_words``; None: the kernel's choice).
    """
    from repro_torch.kernels import sparse_infer

    oracle, _ = _engine_dispatch(engine, use_kernel,
                                 allowed=("auto", "sparse", "oracle"))
    sparse_infer.walk_words(block_s)
    place = _Placed(lambda *t, width: _schedule_placements(mesh, block_c, block_j, *t,
                                                           width=width))

    def fwd(chain_stack, votes_stack, tile_stack, lit_words):
        placed = place(chain_stack, votes_stack, tile_stack, width=lit_words.shape[1])

        def body(m, dev, lw):
            p = placed[m, dev]
            if oracle:
                return sparse_infer.schedule_class_sums_ref(lw, p.chain_ids, p.votes)
            return sparse_infer.sparse_tm_forward(lw, p, block_s=block_s)
        return _forward(mesh, lit_words, body)
    return fwd


def sharded_factorized_forward_fn(mesh, *, block_t: int, block_c: int,
                                  block_j: int, block_s: int | None = None,
                                  engine=None, use_kernel: bool | None = None):
    """Clause-sharded FACTORIZED-schedule forward: each ``model`` shard owns
    its own term table and tile table (``term_infer.stack_shard_factorized``:
    stage 1 evaluates only the terms its clauses reference) and runs the
    two-stage kernel on its clause block; one int32 :func:`psum` over
    ``model`` completes the adder bank.  The batch splits over the data
    axes.

    The returned fn: ``(term_stack (n, Tp, term_w), chain_stack (n, Cp,
    Jp), votes_stack (n, Cp, K), tile_stack (n, 6, T), lit_words (B, Wa))
    -> (B, K) int32``.  Each shard's stacks are placed once
    (``term_infer.place_tables``), its term-tile count and CSR pointers
    from its rows of the tile stack; no-op padding tiles and all-sentinel
    padding term rows change no shard's sums.  ``block_t`` names the
    stage-1 tiling the stacks were built at (the port's stage 1 takes every
    term row in one launch, so it launches nothing by it).
    """
    from repro_torch.kernels import sparse_infer, term_infer

    if block_t < 1:
        raise ValueError(f"block_t={block_t}")
    oracle, _ = _engine_dispatch(engine, use_kernel,
                                 allowed=("auto", "factorized", "oracle"))
    sparse_infer.walk_words(block_s)
    place = _Placed(lambda *t, width: _schedule_placements(mesh, block_c, block_j, *t,
                                                           width=width))

    def fwd(term_stack, chain_stack, votes_stack, tile_stack, lit_words):
        placed = place(term_stack, chain_stack, votes_stack, tile_stack,
                       width=lit_words.shape[1])

        def body(m, dev, lw):
            p = placed[m, dev]
            if oracle:
                return term_infer.factorized_class_sums_ref(lw, p.term_chain,
                                                            p.clause_chain, p.votes)
            return term_infer.factorized_tm_forward(lw, p, block_s=block_s)
        return _forward(mesh, lit_words, body)
    return fwd


def sharded_predict_fn(config: tm.TMConfig, mesh, *, engine=None,
                       use_kernel: bool | None = None, fuse: bool = True,
                       blocks: dict | None = None):
    """Sharded inference: ``(inc_words, votes, nonempty, lit_words) ->``
    (B,) class ids.  On the kernel route the argmax of
    :func:`sharded_forward_fn`; on the oracle route the whole-bank plain
    product on the mesh's first device (the reference's GSPMD branch)."""
    from repro_torch.kernels import ref

    oracle, fuse = _engine_dispatch(engine, use_kernel,
                                    allowed=("auto", "dense", "oracle"), fuse=fuse)
    if not oracle:
        fwd = sharded_forward_fn(mesh, fuse=fuse, blocks=blocks)
        return lambda inc, votes, ne, lw: fwd(inc, votes, ne, lw).argmax(-1)

    def predict(inc_words, votes, nonempty, lit_words):
        dev = mesh.devices[0]
        with _on(dev):
            fired = ref.clause_fire_ref(lit_words.to(dev), inc_words.to(dev))
            fired = fired * (nonempty.to(dev) != 0).to(torch.int8)[None, :]
            sums = ref.class_sum_ref(fired, votes.to(dev))
        return sums.argmax(-1).to(lit_words.device)
    return predict


# -- training ---------------------------------------------------------------

def sharded_train_step_fn(config: tm.TMConfig, mesh,
                          batch_chunk: int | None = 2048,
                          algorithm: str = "bitwise", *,
                          engine: str = "gspmd",
                          use_kernel: bool | None = None,
                          fuse: bool = True,
                          blocks: dict | None = None):
    """A sharded batch training step: ``(ta_state, x, y, seed) -> new_ta``,
    equal to the single-device hash-RNG step bit for bit.

    ``engine`` selects how the clause shards run:

      * ``"gspmd"`` (default) — the reference's XLA partitioning of the
        whole-bank oracle step; here the whole-bank plain step on the mesh's
        first device.
      * ``"kernel"`` — each (data, model) shard runs ``ops.StepShard`` on
        its (C_loc, L) automata and (B_loc,) samples: the fused two-launch
        step (``fuse``, ``blocks`` pass through), the unfused three-launch
        one, or with ``use_kernel=False`` the plain versions.  Each chunk of
        ``batch_chunk`` samples runs in two phases: every shard's partial
        class sums, one int32 :func:`psum` over ``model``, then every
        shard's delta; the deltas sum over the data axes and each clause
        block is updated once.  Requires the clause axis divisible by the
        ``model`` axis (``clause_pad_multiple``) and the batch by the data
        axes.

    ``algorithm="matmul"`` runs the beyond-paper binomial-aggregation step
    (``ops.tm_train_step_matmul_local``) on automata split over both
    axes (clauses over ``model``, literals over the data axes).
    """
    from repro_torch.kernels import ops

    if engine not in ("gspmd", "kernel"):
        # every engine gives the same bits, so a typo falling through would
        # "work" while running the wrong schedule
        raise ValueError(f"unknown engine {engine!r}: expected 'gspmd' or 'kernel'")
    if algorithm not in ("bitwise", "matmul"):
        raise ValueError(f"unknown algorithm {algorithm!r}: 'bitwise' or 'matmul'")
    n_model = mesh.shape["model"]
    if engine == "kernel" and config.n_clauses_total % n_model:
        raise ValueError(
            f"clause axis ({config.n_clauses_total}) not divisible by the "
            f"model axis ({n_model}); align via clause_pad_multiple")
    n_data = _n_data(mesh)
    shards = _shards(mesh)

    def matmul_step(ta, x, y, seed):
        C_loc = _per_shard(ta.shape[0], n_model, "clause axis")
        L_loc = _per_shard(ta.shape[1], n_data, "literal axis")
        B_loc = _per_shard(x.shape[0], n_data, "batch")
        grid = [[None] * n_model for _ in range(n_data)]
        for d, m, dev in shards:
            grid[d][m] = ta[m * C_loc:(m + 1) * C_loc,
                            d * L_loc:(d + 1) * L_loc].to(dev).contiguous()
        new, _ = ops.tm_train_step_matmul_local(
            config, grid, [x[d * B_loc:(d + 1) * B_loc] for d in range(n_data)],
            [y[d * B_loc:(d + 1) * B_loc] for d in range(n_data)], seed)
        return torch.cat([torch.cat([new[d][m].to(ta.device) for d in range(n_data)], 1)
                          for m in range(n_model)])

    def kernel_step(ta, x, y, seed):
        C = config.n_clauses_total
        C_loc = C // n_model
        B_loc = _per_shard(x.shape[0], n_data, "batch")
        y = y.to(torch.int32)
        banks, chunks, run = {}, {}, {}
        for d, m, dev in shards:
            if (m, dev) not in banks:   # data replicas on one device share it
                banks[m, dev] = ta[m * C_loc:(m + 1) * C_loc].to(dev)
            if (d, dev) not in chunks:
                chunks[d, dev] = ops.batch_chunks(
                    x[d * B_loc:(d + 1) * B_loc].to(dev),
                    y[d * B_loc:(d + 1) * B_loc].to(dev), batch_chunk, d * B_loc)
            with _on(dev):
                run[d, m] = (ops.StepShard(config, banks[m, dev], seed, fuse=fuse,
                                           blocks=blocks, c_offset=m * C_loc,
                                           c_total=C, use_kernel=use_kernel is not False),
                             dev, chunks[d, dev])
        deltas = {}
        for i in range(len(chunks[next(iter(chunks))])):
            part = {}
            for key, (sh, dev, ch) in run.items():        # phase 1: partial sums
                with _on(dev):
                    part[key] = sh.sums(ch[i][0])
            for d in range(n_data):                        # sum over model
                full = psum([part[d, m][1] for m in range(n_model)], run[d, 0][1])
                for m in range(n_model):                   # phase 2: deltas
                    sh, dev, ch = run[d, m]
                    _, yc, b_off, valid = ch[i]
                    with _on(dev):
                        dd = sh.delta(part[d, m][0], full.to(dev), yc, b_off, valid)
                    deltas[d, m] = dd if i == 0 else deltas[d, m] + dd
        new = []
        for m in range(n_model):                           # sum over the data axes
            sh, dev, _ = run[0, m]
            total = psum([deltas[d, m] for d in range(n_data)], dev)
            new.append(torch.clamp(sh.ta.to(torch.int32) + total, -config.n_states,
                                   config.n_states - 1).to(torch.int8).to(ta.device))
        return torch.cat(new)

    def gspmd_step(ta, x, y, seed):
        dev = mesh.devices[0]
        with _on(dev):
            new_ta, _ = ops.tm_train_step_kernel(
                config, ta.to(dev), x.to(dev), y.to(dev), seed,
                batch_chunk=batch_chunk, use_kernel=False)
        return new_ta.to(ta.device)

    if algorithm == "matmul":
        return matmul_step
    return kernel_step if engine == "kernel" else gspmd_step
