"""The boolean-to-silicon pass — MATADOR's model compiler, and the runner
that serves its artifacts on the port's kernels.

A trained TM becomes a compact circuit by exploiting include sparsity and
logic sharing between clauses (paper §II, Fig. 3, Fig. 8).  Here that is an
explicit host-side (numpy) pass, identical to the reference compiler:

  1. **Empty-clause removal** — all-exclude clauses are constant 0 at
     inference; drop them.
  2. **Clause deduplication** — identical include rows are evaluated once;
     their votes fold into an int32 (unique_clause x class) vote matrix
     carrying multiplicity x polarity.
  3. **Dead-word elimination** — packed literal words that no surviving
     clause includes are never loaded.
  4. **Chain-schedule emission** — unique clauses are clustered and each
     clause's include bits become a compacted literal-id chain, tiled into
     a block-sparse schedule (``kernels/sparse_infer.py``).
  5. **Shared-term factorization** — unique (word, include-pattern) AND
     terms become a term table and clauses chains of term ids
     (``kernels/term_infer.py``); served by default when the measured
     sharing clears ``FACTORIZE_SHARING_THRESHOLD``.

The artifact format (schema, arrays, meta and checksum) is the reference's
own, so artifacts move between the two packages in both directions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import packetizer, tm
from repro_torch.runtime import faults

# kernel-path default: serve the factorized (two-level) schedule when at
# least this fraction of the artifact's per-word AND terms are absorbed by
# sub-clause sharing
FACTORIZE_SHARING_THRESHOLD = 0.30

# the tiling keys of run_compiled's blocks that name each schedule engine's
# schedule, in the order a placement key holds them
_TILING_KEYS = {"factorized": ("block_c", "block_j", "block_t", "term_w"),
                "sparse": ("block_c", "block_j")}

# host spans of run_compiled (``repro_torch/spans.py``): the whole call, the
# route (kwarg checks, engine choice, the placement's lookup) and the
# dead-word gather
RUN_RANGE = "run_compiled"
ROUTE_RANGE = "run_compiled.route"
GATHER_RANGE = "run_compiled.gather"

# On-disk artifact schema (the reference's).  Version-0 artifacts (no tag)
# predate the integrity envelope and are REJECTED at load.
ARTIFACT_SCHEMA_VERSION = 2   # v2: per-tile-prefix anytime margin metadata

# prefix of the mode tag in tuned-tiling keys recorded by this port
PORT_MODE_PREFIX = "torch-"


class ArtifactError(RuntimeError):
    """A compiled artifact failed integrity verification at load.

    Raised for unreadable/truncated files, schema-version mismatches,
    content-checksum mismatches (bit-rot, partial writes), and schedule
    invariant violations.  The serve path treats this as fatal: a corrupt
    artifact must never serve silently-wrong predictions (out-of-range
    word gathers clamp instead of failing).
    """


def _artifact_checksum(arrays: dict, meta: dict) -> str:
    """Content hash over every artifact array + the meta (sans checksum).

    Arrays hash (name, dtype, shape, bytes) in sorted-name order; the meta
    dict hashes as canonical JSON, so save() and load() agree byte-for-byte
    on the same content.
    """
    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()


def _payload_offset(path: str) -> Optional[int]:
    """Byte offset of real member payload inside the saved npz.

    The bit-rot drill (``artifact.bitflip``) flips one byte of the file;
    aiming at the middle of the *largest member's compressed data* keeps
    the drill meaningful regardless of how the zip layout shifts between
    schema versions — a flip at a naive ``size // 2`` can land in a local
    file header's redundant csize/crc fields, which zipfile never reads
    (it trusts the central directory), so the "corrupt" artifact would
    load cleanly and the drill would assert nothing.
    """
    try:
        with zipfile.ZipFile(path) as zf:
            info = max(zf.infolist(), key=lambda zi: zi.compress_size)
            with open(path, "rb") as f:
                # local header: fnlen @ +26, extralen @ +28 (little-endian)
                f.seek(info.header_offset + 26)
                fnlen, extralen = struct.unpack("<HH", f.read(4))
            data_start = info.header_offset + 30 + fnlen + extralen
            return data_start + info.compress_size // 2
    except Exception:
        return None


@dataclasses.dataclass
class CompileStats:
    n_clauses_dense: int
    n_clauses_nonempty: int
    n_clauses_unique: int
    n_words_dense: int
    n_words_active: int
    n_includes: int
    n_literals: int
    # partial-clause (HCB-term) sharing: two clauses whose include bits agree
    # within word w share that word's AND gate (paper Fig. 5 logic sharing —
    # on FPGA the synthesis absorbs these; we quantify the opportunity)
    n_partial_terms_dense: int = 0
    n_partial_terms_unique: int = 0

    @property
    def include_sparsity(self) -> float:
        tot = self.n_clauses_dense * self.n_literals
        return 1.0 - self.n_includes / max(tot, 1)

    @property
    def clause_sharing(self) -> float:
        """Fraction of non-empty clauses absorbed by sharing (paper Fig. 8)."""
        if self.n_clauses_nonempty == 0:
            return 0.0
        return 1.0 - self.n_clauses_unique / self.n_clauses_nonempty

    @property
    def word_compaction(self) -> float:
        return 1.0 - self.n_words_active / max(self.n_words_dense, 1)

    @property
    def partial_term_sharing(self) -> float:
        """Fraction of per-word AND gates absorbed by sub-clause sharing."""
        if self.n_partial_terms_dense == 0:
            return 0.0
        return 1.0 - self.n_partial_terms_unique / self.n_partial_terms_dense

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            include_sparsity=self.include_sparsity,
            clause_sharing=self.clause_sharing,
            word_compaction=self.word_compaction,
            partial_term_sharing=self.partial_term_sharing,
        )
        return d


@dataclasses.dataclass
class DriftStats:
    """How far a live automata bank has drifted from a reference bank.

    Measured on the DENSE packed include words (every raw clause, before
    dedup/pruning), so the comparison is stable across recompiles: two
    banks compare row-for-row regardless of how their compiled artifacts
    deduped.  ``drift`` is the normalized signal the online updater
    thresholds on — changed include bits relative to the reference bank's
    include count (a freshly-promoted artifact reads 0.0).
    """

    n_clauses: int
    n_clauses_changed: int
    n_bits_changed: int
    n_includes_ref: int
    n_includes_live: int

    @property
    def drift(self) -> float:
        return self.n_bits_changed / max(self.n_includes_ref, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["drift"] = self.drift
        return d


def dense_include_words(config: tm.TMConfig, ta_state) -> np.ndarray:
    """(C_raw, W) packed uint32 include words of a raw automata bank — the
    drift-tracking snapshot (no dedup, no pruning, no clustering).  A bank
    tensor is packed on its device and the words copied to the host."""
    if isinstance(ta_state, torch.Tensor):
        words = packetizer.pack_include_masks(ta_state[: config.n_clauses_raw])
        return words.cpu().numpy().view(np.uint32)
    inc = (np.asarray(ta_state)[: config.n_clauses_raw] >= 0).astype(np.uint8)
    return packetizer.pack_bits_np(inc)


def include_drift(ref_words: np.ndarray, live_words: np.ndarray) -> DriftStats:
    """Compare two dense packed include banks (same shape) bit-for-bit."""
    ref = np.asarray(ref_words, dtype=np.uint32)
    live = np.asarray(live_words, dtype=np.uint32)
    if ref.shape != live.shape:
        raise ValueError(
            f"include_drift: shape mismatch {ref.shape} vs {live.shape} — "
            "drift is only defined against the same clause bank layout")
    x = np.ascontiguousarray(ref ^ live)
    return DriftStats(
        n_clauses=int(ref.shape[0]),
        n_clauses_changed=int(x.any(axis=1).sum()) if ref.size else 0,
        n_bits_changed=int(np.unpackbits(x.view(np.uint8)).sum()),
        n_includes_ref=int(np.unpackbits(
            np.ascontiguousarray(ref).view(np.uint8)).sum()),
        n_includes_live=int(np.unpackbits(
            np.ascontiguousarray(live).view(np.uint8)).sum()),
    )


@dataclasses.dataclass
class CompiledTM:
    """Deployable inference artifact (the "bitstream" analog).

    Rows of ``include_words``/``votes`` are in :func:`cluster_order` (chain
    length, then active-word signature) so the block-sparse schedules built
    from them get chain-length-homogeneous clause blocks.  Schedules are
    memoized per ``(block_c, block_j)`` tiling — the autotuner picks the
    tiling, the artifact answers with the matching tile table.
    """

    include_words: np.ndarray   # (U, Wa) uint32 — deduped, word-compacted
    word_ids: np.ndarray        # (Wa,) int32 — active word indices into dense W
    votes: np.ndarray           # (U, n_classes) int32 — multiplicity x polarity
    n_features: int
    n_classes: int
    stats: CompileStats
    _schedules: dict = dataclasses.field(default_factory=dict, repr=False)
    _fschedules: dict = dataclasses.field(default_factory=dict, repr=False)
    # anytime-inference metadata (kernels/anytime.py): per-tile-prefix
    # residual-swing margins, keyed like the schedule memos; quality-level
    # prefix schedules keyed (engine, schedule key, level)
    _margins: dict = dataclasses.field(default_factory=dict, repr=False)
    _fmargins: dict = dataclasses.field(default_factory=dict, repr=False)
    _prefix_schedules: dict = dataclasses.field(default_factory=dict,
                                                repr=False)
    # autotuned kernel tilings recorded against this artifact (keyed
    # "<kernel>:B<bucket>"), shipped by save() so a cold-start server loads
    # a tuned schedule instead of re-paying the sweep
    tuned: dict = dataclasses.field(default_factory=dict, repr=False)
    # candidate-independent cost-model features
    # (``kernels/cost_model.artifact_features``), shipped by save() so a
    # zoo cold load never recomputes them; a reference artifact's (with
    # its HLO terms) load untouched
    features: dict = dataclasses.field(default_factory=dict, repr=False)
    # device copies of include_words / word_ids / votes, keyed by device,
    # and the schedule engines' placements with their gather index, keyed
    # as run_compiled's route (:meth:`placement`)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _placements: dict = dataclasses.field(default_factory=dict, repr=False)
    # term_infer.pick_term_width of include_words, once computed
    _auto_term_w: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def n_unique(self) -> int:
        return self.include_words.shape[0]

    @property
    def n_words_active(self) -> int:
        return self.include_words.shape[1]

    def tensors(self, device) -> dict:
        """``include_words`` (int32 bit patterns), ``word_ids`` (int64, the
        gather index) and ``votes`` (int32) as tensors on ``device``."""
        key = str(device)
        if key not in self._dev:
            with spans.span(spans.BUILD_RANGE):
                self._dev[key] = dict(
                    include_words=packetizer.words_to_tensor(self.include_words, device),
                    word_ids=torch.from_numpy(
                        np.asarray(self.word_ids, np.int64)).to(device),
                    votes=torch.from_numpy(
                        np.ascontiguousarray(self.votes, np.int32)).to(device),
                )
        return self._dev[key]

    def schedule(self, block_c: int | None = None, block_j: int | None = None):
        """Block-sparse chain schedule for this artifact at the given
        tiling (defaults from ``kernels/sparse_infer.py``), memoized."""
        from repro_torch.kernels import sparse_infer

        key = (
            block_c or sparse_infer.DEFAULT_BLOCK_C,
            block_j or sparse_infer.DEFAULT_BLOCK_J,
        )
        if key not in self._schedules:
            self._schedules[key] = sparse_infer.build_schedule(
                self.include_words, block_c=key[0], block_j=key[1]
            )
        return self._schedules[key]

    @property
    def default_schedule(self):
        return self.schedule()

    def factorized_schedule(self, block_c: int | None = None,
                            block_j: int | None = None,
                            block_t: int | None = None,
                            term_w: int | None = None):
        """Two-level factorized (shared-term) schedule for this artifact
        at the given tiling (defaults from ``kernels/term_infer.py``;
        ``term_w=None`` auto-picks the bit-chain width), memoized."""
        from repro_torch.kernels import term_infer

        if term_w is None:
            # picked once: the serve loop asks for the default on every bucket
            if self._auto_term_w is None:
                with spans.span(spans.BUILD_RANGE):
                    self._auto_term_w = term_infer.pick_term_width(self.include_words)
            term_w = self._auto_term_w
        key = (
            block_c or term_infer.DEFAULT_BLOCK_C,
            block_j or term_infer.DEFAULT_BLOCK_J,
            block_t or term_infer.DEFAULT_BLOCK_T,
            term_w,
        )
        if key not in self._fschedules:
            with spans.span(spans.BUILD_RANGE):
                self._fschedules[key] = term_infer.build_factorized_schedule(
                    self.include_words, block_c=key[0], block_j=key[1],
                    block_t=key[2], term_w=key[3],
                )
        return self._fschedules[key]

    @property
    def default_factorized_schedule(self):
        return self.factorized_schedule()

    def tile_margins(self, block_c: int | None = None,
                     block_j: int | None = None) -> np.ndarray:
        """(T,) residual-swing margin table for the sparse chain schedule
        at the given tiling (``kernels/anytime.py``), memoized; loaded
        artifacts ship the default-tiling table verbatim."""
        from repro_torch.kernels import anytime, sparse_infer

        key = (
            block_c or sparse_infer.DEFAULT_BLOCK_C,
            block_j or sparse_infer.DEFAULT_BLOCK_J,
        )
        if key not in self._margins:
            self._margins[key] = anytime.sparse_tile_margins(
                self.schedule(*key), self.votes)
        return self._margins[key]

    def factorized_tile_margins(self, block_c: int | None = None,
                                block_j: int | None = None,
                                block_t: int | None = None,
                                term_w: int | None = None) -> np.ndarray:
        """(T,) residual-swing margin table for the factorized schedule at
        the given tiling, memoized."""
        from repro_torch.kernels import anytime

        fsched = self.factorized_schedule(block_c, block_j, block_t, term_w)
        # mirror factorized_schedule's memo key exactly (term_w auto-pick)
        key = next(k for k, v in self._fschedules.items() if v is fsched)
        if key not in self._fmargins:
            self._fmargins[key] = anytime.factorized_tile_margins(
                fsched, self.votes)
        return self._fmargins[key]

    def placement(self, key: tuple) -> tuple:
        """``(word_ids, placed)`` for a schedule engine's launches: the gather
        index and the ``PlacedSchedule`` of ``sparse_infer`` or ``term_infer``
        that ``key`` names, ``(engine, tiling, quality, early_exit,
        device)`` as :func:`_route` makes it, placed on the first call (in
        build spans) and recalled by one dict lookup after it."""
        got = self._placements.get(key)
        if got is None:
            got = self._placements[key] = self._place(*key)
        return got

    def _place(self, engine: str, tiling: tuple, quality: int, early_exit: bool,
               device) -> tuple:
        from repro_torch.kernels import sparse_infer, term_infer

        factorized = engine == "factorized"
        tiling = dict(zip(_TILING_KEYS[engine], tiling))
        if quality > 0:
            sched = self.quality_prefix_schedule(quality, engine, **tiling)
        elif factorized:
            sched = self.factorized_schedule(**tiling)
        else:
            sched = self.schedule(**tiling)
        margin = None
        if early_exit and sched.n_tiles:
            margin = (self.factorized_tile_margins(**tiling) if factorized
                      else self.tile_margins(**tiling))
        tabs = self.tensors(device)
        mod = term_infer if factorized else sparse_infer
        return tabs["word_ids"], mod.place(sched, tabs["votes"], tile_margin=margin)

    def quality_levels(self, engine: str = "sparse", **tiling) -> list:
        """Quality tiers for this artifact on the given schedule engine:
        ``[{level, n_tiles, bound, frac}, ...]`` with level 0 = exact full
        walk (bound 0) and levels 1..N progressively shorter tile prefixes
        whose error bound (``kernels/anytime.py`` semantics: the served
        class trails the true winner by at most ``bound`` votes) is the
        residual swing after the prefix."""
        from repro_torch.kernels import anytime

        if engine == "factorized":
            fsched = self.factorized_schedule(**tiling)
            margins = self.factorized_tile_margins(**tiling)
            full, min_tiles = fsched.n_tiles, fsched.n_term_tiles + 1
        else:
            sched = self.schedule(**tiling)
            margins = self.tile_margins(**tiling)
            full, min_tiles = sched.n_tiles, 1
        levels = [dict(level=0, n_tiles=full, bound=0, frac=0.0)]
        levels.extend(anytime.quality_prefixes(
            margins, anytime.total_swing(self.votes), min_tiles=min_tiles))
        return levels

    def quality_prefix_schedule(self, level: int, engine: str = "sparse",
                                **tiling):
        """The tile-prefix schedule serving quality ``level`` (level 0
        returns the full schedule), memoized."""
        from repro_torch.kernels import anytime

        if level <= 0:
            return (self.factorized_schedule(**tiling)
                    if engine == "factorized" else self.schedule(**tiling))
        key = (engine, tuple(sorted(tiling.items())), int(level))
        if key not in self._prefix_schedules:
            levels = self.quality_levels(engine, **tiling)
            q = levels[min(level, len(levels) - 1)]
            if engine == "factorized":
                self._prefix_schedules[key] = anytime.factorized_prefix_schedule(
                    self.factorized_schedule(**tiling), q["n_tiles"])
            else:
                self._prefix_schedules[key] = anytime.sparse_prefix_schedule(
                    self.schedule(**tiling), q["n_tiles"])
        return self._prefix_schedules[key]

    @staticmethod
    def _tuned_key(kernel: str, bucket: int, rows: int | None,
                   mode: str | None) -> str:
        key = f"{kernel}:B{int(bucket)}"
        if rows is not None:
            key += f":U{int(rows)}"      # shard-slice vs full-bank sweeps
        # the port's own tag (``autotune._mode_backend``'s ``torch-cuda`` /
        # ``torch-cpu``, or the bare device type): a tiling the reference
        # recorded on a CPU or TPU backend never answers for the port
        mode = mode or "cuda"
        if not mode.startswith(PORT_MODE_PREFIX):
            mode = PORT_MODE_PREFIX + mode
        return f"{key}:{mode}"

    def record_tuned(self, kernel: str, bucket: int, blocks: dict, *,
                     rows: int | None = None, mode: str | None = None) -> None:
        """Remember an autotuned tiling for this artifact (persisted by
        ``save()``): ``kernel`` is the sweep family (``sparse_infer`` /
        ``term_infer`` / ``fused_infer``), ``bucket`` the request-batch
        size the sweep ran at, ``rows`` the clause-row count the sweep
        actually saw (a mesh run tunes a per-shard SLICE — its winner must
        not answer for the full bank), and ``mode`` the device tag
        (``"torch-cuda"``/``"torch-cpu"``, or ``"cuda"``/``"cpu"`` under
        the port's own prefix) so a tiling recorded elsewhere is never
        recalled on the card."""
        self.tuned[self._tuned_key(kernel, bucket, rows, mode)] = dict(blocks)

    def tuned_blocks(self, kernel: str, bucket: int, *,
                     rows: int | None = None,
                     mode: str | None = None) -> dict | None:
        """Recall a tiling recorded by :meth:`record_tuned` (or shipped
        inside a loaded artifact); None when this exact (kernel, bucket,
        rows, mode) was never tuned."""
        blocks = self.tuned.get(self._tuned_key(kernel, bucket, rows, mode))
        return dict(blocks) if blocks is not None else None

    def extract_features(self, refresh: bool = False) -> dict:
        """Candidate-independent cost-model features of this artifact
        (``kernels/cost_model.artifact_features``), memoized on the
        instance and persisted by :meth:`save`.  The op-stream terms
        degrade as the reference's HLO terms do: a shape whose trace fails
        still yields the schedule-statistic features, so prediction never
        blocks serving."""
        if self.features and not refresh:
            return dict(self.features)
        from repro_torch.kernels import cost_model

        try:
            feats = cost_model.artifact_features(self)
        except Exception:  # noqa: BLE001 - the reference's fallback
            feats = cost_model.artifact_features(self, with_hlo=False)
        self.features = feats
        return dict(feats)

    def save(self, path: str) -> str:
        """Write the artifact atomically with an integrity envelope.

        The default-tiling schedules ship inside the artifact (the
        "bitstream" carries its execution schedules); other tilings are
        rebuilt on demand from the include rows.  Autotuned tilings
        recorded via record_tuned() and the cost-model feature dict ride
        in the meta JSON, so a server cold-starting from this file skips
        both the sweep and the feature extraction entirely.

        Integrity: the meta carries ``ARTIFACT_SCHEMA_VERSION`` and a
        sha256 content checksum over every array + the meta itself, and
        the file is written to a tmp path then ``os.replace``d — a SIGTERM
        mid-save can never truncate the artifact the next run will load,
        and ``load()`` rejects any byte that rotted after the replace.
        Returns the final path (``.npz`` is appended when missing, the
        same normalization ``np.savez`` applies).
        """
        sched = self.default_schedule
        fsched = self.default_factorized_schedule
        arrays = dict(
            include_words=self.include_words,
            word_ids=self.word_ids,
            votes=self.votes,
            sched_margin=np.asarray(self.tile_margins(), np.int64),
            fsched_margin=np.asarray(self.factorized_tile_margins(), np.int64),
            sched_chain_ids=sched.chain_ids,
            sched_tiles=np.stack([sched.tile_cb, sched.tile_jb,
                                  sched.tile_first, sched.tile_last])
            if sched.n_tiles else np.zeros((4, 0), np.int32),
            sched_counts=sched.counts,
            fsched_term_chain=fsched.term_chain,
            fsched_term_table=np.stack([
                fsched.term_word,
                fsched.term_val.astype(np.int64).astype(np.int32)])
            if fsched.n_terms else np.zeros((2, 0), np.int32),
            fsched_clause_chain=fsched.clause_chain,
            fsched_tiles=np.stack([
                fsched.tile_stage, fsched.tile_tb, fsched.tile_cb,
                fsched.tile_jb, fsched.tile_first, fsched.tile_last])
            if fsched.n_tiles else np.zeros((6, 0), np.int32),
            fsched_counts=fsched.counts,
        )
        meta = dict(
            schema=ARTIFACT_SCHEMA_VERSION,
            n_features=self.n_features,
            n_classes=self.n_classes,
            stats=self.stats.as_dict(),
            schedule=dict(block_c=sched.block_c,
                          block_j=sched.block_j,
                          n_rows=sched.n_rows,
                          n_lit_bits=sched.n_lit_bits),
            fschedule=dict(block_c=fsched.block_c,
                           block_j=fsched.block_j,
                           block_t=fsched.block_t,
                           term_w=fsched.term_w,
                           n_rows=fsched.n_rows,
                           n_terms=fsched.n_terms,
                           n_lit_bits=fsched.n_lit_bits),
            tuned=self.tuned,
            features=self.extract_features(),
        )
        meta["checksum"] = _artifact_checksum(arrays, meta)
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = f"{final}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f,
                    meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                    **arrays,
                )
                f.flush()
                os.fsync(f.fileno())
            faults.raise_if("artifact.save_abort")
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):       # failed save leaves no debris
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        faults.corrupt_if("artifact.bitflip", final,
                          default_pos=_payload_offset(final))
        return final

    @staticmethod
    def load(path: str) -> "CompiledTM":
        """Load and VERIFY an artifact; raise :class:`ArtifactError` rather
        than ever returning one that could serve wrong predictions."""
        from repro_torch.kernels import sparse_infer, term_infer

        try:
            z = np.load(path)
            meta = json.loads(bytes(z["meta"]).decode())
            arrays = {k: z[k] for k in z.files if k != "meta"}
        except Exception as e:
            raise ArtifactError(
                f"artifact {path} is unreadable (truncated or not a "
                f"compiled artifact): {type(e).__name__}: {e}") from e
        schema = meta.get("schema", 0)
        if schema != ARTIFACT_SCHEMA_VERSION:
            raise ArtifactError(
                f"artifact {path} has schema version {schema}; this runtime "
                f"requires {ARTIFACT_SCHEMA_VERSION} — recompile the model "
                "(compile_tm + save) instead of serving a stale artifact")
        recorded = meta.pop("checksum", None)
        recomputed = _artifact_checksum(arrays, meta)
        if recorded != recomputed:
            raise ArtifactError(
                f"artifact {path} failed its content checksum (recorded "
                f"{recorded}, recomputed {recomputed}) — the file is corrupt "
                "(bit-rot or a partial write); refusing to serve it")
        st = meta["stats"]
        stats = CompileStats(
            **{k: st[k] for k in (
                "n_clauses_dense", "n_clauses_nonempty", "n_clauses_unique",
                "n_words_dense", "n_words_active", "n_includes", "n_literals",
                "n_partial_terms_dense", "n_partial_terms_unique",
            ) if k in st}
        )
        compiled = CompiledTM(
            include_words=z["include_words"],
            word_ids=z["word_ids"],
            votes=z["votes"],
            n_features=meta["n_features"],
            n_classes=meta["n_classes"],
            stats=stats,
        )
        if "schedule" in meta:   # pre-schedule artifacts rebuild lazily
            sm = meta["schedule"]
            tiles = z["sched_tiles"]
            counts = z["sched_counts"]
            # save() ships the DEFAULT-tiling schedule; memoize it under
            # the default (requested) key — sm["block_c"] is the clipped
            # effective value, which small artifacts would never look up
            compiled._schedules[(sparse_infer.DEFAULT_BLOCK_C,
                                 sparse_infer.DEFAULT_BLOCK_J)] = (
                sparse_infer.SparseSchedule(
                    block_c=sm["block_c"], block_j=sm["block_j"],
                    n_rows=sm["n_rows"], n_lit_bits=sm["n_lit_bits"],
                    chain_ids=z["sched_chain_ids"],
                    tile_cb=tiles[0], tile_jb=tiles[1],
                    tile_first=tiles[2], tile_last=tiles[3],
                    counts=counts,
                    indptr=np.concatenate(
                        [[0], np.cumsum(counts)]).astype(np.int32),
                )
            )
            margin = np.asarray(z["sched_margin"], np.int64)
            if faults.fire_if("anytime.margin_corrupt"):
                # a producer writing wrong margins re-checksums them, so
                # the envelope passes — only validate_artifact's vote-table
                # consistency check stands between this and silently
                # skewed early-exit predictions
                margin = margin.copy()
                if margin.size:
                    margin[0] += 1
                else:
                    margin = np.array([1], np.int64)
            compiled._margins[(sparse_infer.DEFAULT_BLOCK_C,
                               sparse_infer.DEFAULT_BLOCK_J)] = margin
        if "fschedule" in meta:   # pre-factorization artifacts rebuild lazily
            fm = meta["fschedule"]
            ftiles = z["fsched_tiles"]
            fcounts = z["fsched_counts"]
            tt = z["fsched_term_table"]
            compiled._fschedules[(term_infer.DEFAULT_BLOCK_C,
                                  term_infer.DEFAULT_BLOCK_J,
                                  term_infer.DEFAULT_BLOCK_T,
                                  fm["term_w"])] = (
                term_infer.FactorizedSchedule(
                    block_c=fm["block_c"], block_j=fm["block_j"],
                    block_t=fm["block_t"], term_w=fm["term_w"],
                    n_rows=fm["n_rows"], n_terms=fm["n_terms"],
                    n_lit_bits=fm["n_lit_bits"],
                    term_word=tt[0], term_val=tt[1].astype(np.uint32),
                    term_chain=z["fsched_term_chain"],
                    clause_chain=z["fsched_clause_chain"],
                    tile_stage=ftiles[0], tile_tb=ftiles[1],
                    tile_cb=ftiles[2], tile_jb=ftiles[3],
                    tile_first=ftiles[4], tile_last=ftiles[5],
                    counts=fcounts,
                    indptr=np.concatenate(
                        [[0], np.cumsum(fcounts)]).astype(np.int32),
                )
            )
            compiled._fmargins[(term_infer.DEFAULT_BLOCK_C,
                                term_infer.DEFAULT_BLOCK_J,
                                term_infer.DEFAULT_BLOCK_T,
                                fm["term_w"])] = np.asarray(
                z["fsched_margin"], np.int64)
        compiled.tuned.update(meta.get("tuned", {}))
        compiled.features.update(meta.get("features", {}) or {})
        validate_artifact(compiled)
        return compiled


def validate_artifact(compiled: CompiledTM) -> None:
    """Structural invariant checks on an artifact and its shipped schedules.

    A second verification layer behind the checksum: the checksum catches
    bytes that changed after ``save()``, this catches an artifact that was
    *written* wrong (a buggy or adversarial producer) — out-of-range chain
    or term ids would otherwise gather-clamp into silently wrong class
    sums.  Raises :class:`ArtifactError` on the first violation.
    """

    def fail(msg: str):
        raise ArtifactError(f"artifact invariant violated: {msg}")

    inc, votes, wid = compiled.include_words, compiled.votes, compiled.word_ids
    if inc.ndim != 2:
        fail(f"include_words must be 2-D, got shape {inc.shape}")
    U, Wa = inc.shape
    if votes.shape != (U, compiled.n_classes):
        fail(f"votes shape {votes.shape} != ({U}, {compiled.n_classes})")
    if wid.shape != (Wa,):
        fail(f"word_ids shape {wid.shape} != ({Wa},)")
    if Wa and (int(wid[0]) < 0 or (Wa > 1 and np.any(np.diff(wid) <= 0))):
        fail("word_ids must be non-negative and strictly increasing")
    n_dense = compiled.stats.n_words_dense
    if n_dense and Wa and int(wid[-1]) >= n_dense:
        fail(f"word_ids reach {int(wid[-1])} but the dense model has only "
             f"{n_dense} words — gathers would clamp")

    def check_tiles(tag, counts, indptr, n_tiles, tile_cb):
        if indptr.shape[0] != counts.shape[0] + 1 or (indptr.size and indptr[0] != 0):
            fail(f"{tag}: indptr shape/origin inconsistent with counts")
        if np.any(counts < 0) or np.any(np.diff(indptr) != counts):
            fail(f"{tag}: tile indptr is not the monotone prefix sum of counts")
        if int(counts.sum()) > n_tiles:
            fail(f"{tag}: counts claim {int(counts.sum())} tiles but the "
                 f"tile table has {n_tiles}")
        if n_tiles and (np.any(tile_cb < 0) or np.any(tile_cb >= counts.shape[0])):
            fail(f"{tag}: tile clause-block ids out of range")

    for s in compiled._schedules.values():
        if s.n_rows != U:
            fail(f"chain schedule covers {s.n_rows} rows, artifact has {U}")
        if s.n_lit_bits != 32 * Wa:
            fail(f"chain schedule n_lit_bits {s.n_lit_bits} != 32*{Wa}")
        if np.any(s.chain_ids < 0) or np.any(s.chain_ids > s.n_lit_bits):
            fail("chain ids out of range (sentinel is the maximum legal id)")
        if s.chain_ids.shape[0] > s.n_rows and not np.all(
                s.chain_ids[s.n_rows:] == s.n_lit_bits):
            fail("padded chain rows past n_rows must be all-sentinel")
        check_tiles("chain schedule", s.counts, s.indptr, s.n_tiles, s.tile_cb)

    for fs in compiled._fschedules.values():
        if fs.n_rows != U:
            fail(f"factorized schedule covers {fs.n_rows} rows, artifact has {U}")
        if fs.n_lit_bits != 32 * Wa:
            fail(f"factorized schedule n_lit_bits {fs.n_lit_bits} != 32*{Wa}")
        if np.any(fs.term_chain < 0) or np.any(fs.term_chain > fs.n_lit_bits):
            fail("term-chain literal ids out of range")
        if np.any(fs.clause_chain < 0) or np.any(fs.clause_chain > fs.n_terms):
            fail("clause-chain term ids out of range (sentinel == n_terms)")
        if fs.clause_chain.shape[0] > fs.n_rows and not np.all(
                fs.clause_chain[fs.n_rows:] == fs.n_terms):
            fail("padded clause-chain rows past n_rows must be all-sentinel")
        if fs.term_chain.shape[0] > fs.n_terms and not np.all(
                fs.term_chain[fs.n_terms:] == fs.n_lit_bits):
            fail("padded term rows past n_terms must be all-sentinel")
        if fs.term_word.shape[0] != fs.n_terms or fs.term_val.shape[0] != fs.n_terms:
            fail("term table length != n_terms")
        if fs.n_terms and (np.any(fs.term_word < 0) or np.any(fs.term_word >= Wa)):
            fail("term active-word indices out of range")
        if np.any((fs.tile_stage != 0) & (fs.tile_stage != 1)):
            fail("tile_stage entries must be 0 (term) or 1 (clause)")
        n_ctiles = int((fs.tile_stage == 1).sum())
        check_tiles("factorized schedule", fs.counts, fs.indptr, n_ctiles,
                    fs.tile_cb[fs.tile_stage == 1] if fs.n_tiles else fs.tile_cb)

    # anytime margin metadata: monotone non-increasing AND exactly the
    # residual swing the vote table implies — corrupt margins would make
    # early-exit certify too eagerly (wrong argmax) or budgeted mode
    # under-report its error bound
    def check_margins(tag, margins, sched, recompute):
        margins = np.asarray(margins)
        if margins.shape != (sched.n_tiles,):
            fail(f"{tag}: margin table shape {margins.shape} != "
                 f"({sched.n_tiles},)")
        if margins.size == 0:
            return
        if np.any(margins < 0):
            fail(f"{tag}: margin table has negative entries")
        if np.any(np.diff(margins) > 0):
            fail(f"{tag}: margin table is not monotone non-increasing")
        expect = recompute(sched, compiled.votes)
        if not np.array_equal(margins, expect):
            fail(f"{tag}: margin table is inconsistent with the vote table "
                 "(residual swing mismatch)")

    from repro_torch.kernels import anytime

    for key, m in compiled._margins.items():
        s = compiled._schedules.get(key)
        if s is None:
            fail(f"chain margin table for unknown tiling {key}")
        check_margins("chain margins", m, s, anytime.sparse_tile_margins)
    for key, m in compiled._fmargins.items():
        fs = compiled._fschedules.get(key)
        if fs is None:
            fail(f"factorized margin table for unknown tiling {key}")
        check_margins("factorized margins", m, fs,
                      anytime.factorized_tile_margins)


def compile_tm(
    config: tm.TMConfig,
    ta_state,
    *,
    dedup: bool = True,
    prune_words: bool = True,
    cluster: bool = True,
) -> CompiledTM:
    """Compile a trained automata bank into a :class:`CompiledTM`.

    ``cluster`` reorders the surviving unique clauses by (chain length,
    active-word signature) — the row order the block-sparse schedule wants;
    votes move with their rows, so class sums are invariant.
    ``dedup=False, prune_words=False, cluster=False`` is the
    DON'T-TOUCH-pragma analog used by benchmarks/logic_sharing.py to
    measure the savings (paper Fig. 8).
    """
    ta = (ta_state.cpu().numpy() if isinstance(ta_state, torch.Tensor)
          else np.asarray(ta_state))
    C_raw = config.n_clauses_raw
    inc = (ta[:C_raw] >= 0).astype(np.uint8)               # (C, L)
    pol = np.where(np.arange(C_raw) % 2 == 0, 1, -1).astype(np.int32)
    cls = np.arange(C_raw) // config.clauses_per_class

    nonempty = inc.any(axis=1)
    inc_ne = inc[nonempty]
    pol_ne = pol[nonempty]
    cls_ne = cls[nonempty]
    n_nonempty = int(inc_ne.shape[0])

    words_dense = packetizer.pack_bits_np(inc_ne) if n_nonempty else np.zeros(
        (0, packetizer.n_words(config.n_literals)), np.uint32
    )
    W = packetizer.n_words(config.n_literals)

    if dedup and n_nonempty:
        uniq, inv = np.unique(words_dense, axis=0, return_inverse=True)
    else:
        uniq, inv = words_dense, np.arange(n_nonempty)
    U = uniq.shape[0]

    votes = np.zeros((max(U, 1), config.n_classes), np.int32)
    if n_nonempty:
        np.add.at(votes, (inv, cls_ne), pol_ne)
    if U == 0:
        uniq = np.zeros((1, W), np.uint32)  # degenerate all-empty model
        U = 1

    if prune_words:
        active = uniq.any(axis=0)
        if not active.any():
            active[:1] = True
        word_ids = np.nonzero(active)[0].astype(np.int32)
    else:
        word_ids = np.arange(uniq.shape[1], dtype=np.int32)
    uniq = uniq[:, word_ids]

    votes = votes[:U]
    if cluster and U > 1:
        from repro_torch.kernels import anytime, sparse_infer

        # vote-mass bands (|polarity x multiplicity| descending) so the
        # anytime margin decays steeply, density-clustered within bands so
        # tile counts stay near the pure-clustered layout
        order = anytime.margin_order(uniq, votes,
                                     cluster_fn=sparse_infer.cluster_order)
        uniq = uniq[order]
        votes = votes[order]

    # partial-clause sharing opportunity: unique nonzero include words per
    # word column (zero words are free — they never gate anything)
    nonzero_terms = int((uniq != 0).sum())
    unique_terms = sum(
        len(np.unique(col[col != 0])) for col in uniq.T
    )
    stats = CompileStats(
        n_clauses_dense=C_raw,
        n_clauses_nonempty=n_nonempty,
        n_clauses_unique=int(U),
        n_words_dense=int(W),
        n_words_active=int(word_ids.shape[0]),
        n_includes=int(inc.sum()),
        n_literals=config.n_literals,
        n_partial_terms_dense=nonzero_terms,
        n_partial_terms_unique=int(unique_terms),
    )
    return CompiledTM(
        include_words=uniq.astype(np.uint32),
        word_ids=word_ids,
        votes=votes,
        n_features=config.n_features,
        n_classes=config.n_classes,
        stats=stats,
    )


def incremental_recompile(
    config: tm.TMConfig,
    ta_state,
    prev: CompiledTM,
    *,
    dedup: bool = True,
    prune_words: bool = True,
    cluster: bool = True,
) -> tuple[CompiledTM, dict]:
    """Recompile a drifted bank, reusing ``prev``'s schedule work where the
    layout survived.

    The host compile pipeline itself (:func:`compile_tm`) is cheap numpy;
    the expensive artifact state is the chain SCHEDULE (a per-clause python
    compaction loop) and the tuned tilings.  When the new artifact lands on
    the same word layout and row count as ``prev`` — the common case for
    small online drift — the default-tiling chain schedule is rebuilt
    incrementally (``sparse_infer.build_schedule_incremental``: only
    clauses whose include rows moved are re-compacted) and ``prev``'s
    tuned tilings carry over.  Any layout change, or a ``prev`` whose
    default schedule was never built, falls back to the full lazy rebuild.

    Returns ``(compiled, info)``; ``info["mode"]`` is ``"incremental"`` or
    ``"full"``, with ``rows_reused``/``tiles_reused`` counters in the
    incremental case.  Either way the result equals a from-scratch
    ``compile_tm`` (the incremental schedule is exact, and the factorized
    schedule stays lazy).
    """
    from repro_torch.kernels import sparse_infer

    new = compile_tm(config, ta_state, dedup=dedup,
                     prune_words=prune_words, cluster=cluster)
    info: dict = dict(mode="full", rows_reused=0, tiles_reused=0)
    key = (sparse_infer.DEFAULT_BLOCK_C, sparse_infer.DEFAULT_BLOCK_J)
    prev_sched = prev._schedules.get(key)
    if (prev_sched is not None
            and new.include_words.shape == prev.include_words.shape
            and np.array_equal(new.word_ids, prev.word_ids)):
        sched, re_info = sparse_infer.build_schedule_incremental(
            new.include_words, prev_sched, prev.include_words,
            block_c=key[0], block_j=key[1])
        new._schedules[key] = sched
        info = dict(mode="incremental", **re_info)
        # same shape family: prev's tilings remain valid keys for the
        # successor artifact
        new.tuned.update({k: dict(v) for k, v in prev.tuned.items()})
    return new, info


def run_compiled(
    compiled: CompiledTM,
    x_packed: torch.Tensor,
    *,
    engine=None,
    quality: int = 0,
    early_exit: bool = False,
    **blocks,
) -> torch.Tensor:
    """Inference with the compiled artifact: (B, W_dense) packed int32
    literals -> (B, n_classes) int32 class sums, on ``x_packed``'s device.

    ``engine`` is an ``ops.EngineSpec`` or one of the ladder level names
    ``"auto"`` (default) / ``"factorized"`` / ``"sparse"`` / ``"dense"`` /
    ``"oracle"``; ``EngineSpec("dense", fuse=False)`` runs the unfused
    ``clause_eval`` -> ``class_sum`` pipeline.  ``"auto"`` takes the kernel path whenever ``x_packed``
    is on a CUDA device — the FACTORIZED schedule kernel when the
    artifact's ``partial_term_sharing`` clears
    ``FACTORIZE_SHARING_THRESHOLD`` (or a factorized-only tiling key is
    passed), else the flat chain kernel — and the oracle otherwise.  The
    named kernel engines run their plain versions on CPU inputs.  All
    engines give identical class sums.  Empty-clause masking is
    unnecessary: compilation dropped empty clauses (the degenerate
    all-empty artifact keeps one all-zero clause whose votes are zero).

    Launches come from ``blocks``, in the reference's names: the schedule
    engines take ``block_c``/``block_j`` (chain tiling, memoized on the
    artifact), ``block_s`` (sample words a block of the walk) and,
    factorized only, ``block_t``/``term_w``; the fused dense kernel takes
    ``block_b``/``block_c``/``block_w`` when ``block_b`` or ``block_w`` is
    given (a dense tiling; ``fused_infer.word_split``).  Under ``"auto"``
    on the card a dense-only key (``block_b``/``block_w``) pins the dense
    kernel, as in the reference: a dense-tuned launch is never
    reinterpreted as a schedule tiling.  Each engine ignores the keys that
    are not its own, as the reference's do.

    Anytime inference (``kernels/anytime.py``): ``quality > 0`` serves a
    budgeted tile prefix (error bounded by ``compiled.quality_levels()``),
    ``early_exit=True`` runs the exact early-exit mode (argmax-identical to
    the full walk).  Both apply only on the schedule engines; the dense
    and oracle engines serve exact sums (a stronger answer).

    A schedule engine's first call with a tiling, quality level and early
    exit on a device places what its launches read
    (:meth:`CompiledTM.placement`; :func:`place` does it ahead of a call);
    every later call finds it by one dict lookup.
    """
    from repro_torch.kernels import ops

    with spans.span(RUN_RANGE):
        with spans.span(ROUTE_RANGE):
            name, spec, key = _route(compiled, x_packed.device, engine, quality,
                                     early_exit, blocks)
            if key is None:
                tabs = compiled.tensors(x_packed.device)
                word_ids = tabs["word_ids"]
            else:
                word_ids, placed = compiled.placement(key)
        with spans.span(GATHER_RANGE):
            xw = x_packed[:, word_ids]                     # dead-word elimination
        if name == "factorized":
            return ops.tm_forward_factorized(xw, placed, block_s=blocks.get("block_s"))
        if name == "sparse":
            return ops.tm_forward_schedule(xw, placed, block_s=blocks.get("block_s"))
        votes = tabs["votes"]
        if name == "dense":
            dense = ({k: blocks[k] for k in ("block_b", "block_c", "block_w")
                      if k in blocks} if blocks.keys() & {"block_b", "block_w"} else {})
            return ops.tm_forward_packed(xw, tabs["include_words"], votes, None,
                                         fuse=spec.fuse, **dense)
        from repro_torch.kernels import ref

        return ref.class_sum_ref(ref.clause_fire_ref(xw, tabs["include_words"]), votes)


def place(compiled: CompiledTM, device: torch.device, *, engine=None, quality: int = 0,
          early_exit: bool = False, **blocks):
    """Put on ``device`` (as a tensor there reports it) what
    ``run_compiled(compiled, x, ...)`` with these arguments reads for an
    ``x`` there, so that its first call builds nothing: a schedule engine's
    placement, which is returned, or the dense and oracle engines' device
    tables (None returned)."""
    device = torch.device(device)
    _, _, key = _route(compiled, device, engine, quality, early_exit, blocks)
    if key is None:
        compiled.tensors(device)
        return None
    return compiled.placement(key)[1]


def _route(compiled: CompiledTM, device, engine, quality: int, early_exit: bool,
           blocks: dict):
    """:func:`run_compiled`'s checks and engine choice for an input on
    ``device`` -> ``(name, spec, key)``: the engine that runs, its
    ``EngineSpec`` and, for the schedule engines, the key of its placement
    (:meth:`CompiledTM.placement`; None for the others)."""
    from repro_torch.kernels import ops

    known = {"block_b", "block_c", "block_w", "block_j", "block_s",
             "block_t", "term_w"}
    unknown = blocks.keys() - known
    if unknown:
        raise TypeError(f"run_compiled: unknown block kwargs {sorted(unknown)}; "
                        f"expected a subset of {sorted(known)}")
    spec = ops.EngineSpec.coerce(engine)
    name = spec.name
    fact_keys = {"block_t", "term_w"} & blocks.keys()
    dense_keys = {"block_b", "block_w"} & blocks.keys()
    if name == "auto":
        if not ops.kernel_dispatch(device):
            name = "oracle"
        elif dense_keys:
            name = "dense"
        elif (fact_keys or compiled.stats.partial_term_sharing
              >= FACTORIZE_SHARING_THRESHOLD):
            name = "factorized"
        else:
            name = "sparse"
    elif fact_keys and name != "factorized":
        raise TypeError(
            f"run_compiled: engine {name!r} with factorized-only block "
            f"kwargs {sorted(fact_keys)} — they would be silently dropped")
    if name not in _TILING_KEYS:
        return name, spec, None
    quality = quality if quality > 0 else 0
    tiling = tuple(blocks.get(k) for k in _TILING_KEYS[name])
    return name, spec, (name, tiling, quality, bool(early_exit) and not quality, device)


def predict_compiled(compiled: CompiledTM, x: torch.Tensor, **kw) -> torch.Tensor:
    """(B, F) raw boolean features -> predicted class ids (on x's device)."""
    return torch.argmax(run_compiled(compiled, packetizer.pack_literals(x), **kw),
                        dim=-1)


# Re-exported so engine selection and artifact execution come from one
# module, as in the reference.  Lazy (PEP 562): ``kernels/ops`` pulls in
# the whole kernel stack, and kernel modules import ``repro_torch.core``,
# so an eager import here is circular whenever a kernel module is the
# first thing imported.
def __getattr__(name):
    if name in ("EngineSpec", "ENGINE_NAMES"):
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
