"""Analytical cost model for the kernel autotuner: predict, don't sweep.

The port of ``repro.kernels.cost_model`` (numpy only), the predict-first
tier behind ``autotune.tune(policy=...)``:

* **Workload features** (:func:`artifact_features`) -- candidate-independent
  statistics of the compiled artifact: include-bit counts, chain-length
  distribution, ``partial_term_sharing``, term-table size.
  ``CompiledTM.save()`` persists the dict, so a zoo cold load never
  recomputes it.  With ``with_hlo`` (the default, as the reference's) it
  adds the oracle forward's FLOPs and bytes per sample and their roofline
  times (:func:`hlo_forward_features`): the reference reads them from its
  compiled HLO, the port from the op stream on ``meta``
  (``launch/op_analysis``), over the card's datasheet peaks
  (``launch/mesh``).  The keys keep the reference's names.

* **Per-candidate basis** -- each tuned kernel registers a featurizer in
  ``autotune``'s registry that maps ``(shape, artifact, candidate)`` to
  roofline-style work terms (grid steps, chain and fold volume, bytes),
  from the real schedule the candidate would run.

* **The model** (:class:`CostModel`) -- predicted microseconds are a
  non-negative linear combination of the basis terms.  Shipped
  coefficients (:data:`DEFAULT_COEFFS`) are per mode: ``torch-cpu`` keeps
  the reference's CPU coefficients, ``torch-cuda`` was fitted on the H100's
  sweeps.  Every measured sweep logs ``(features, basis, tiling,
  measured_us)`` rows into a training-data sidecar
  (:func:`record_observations`, atomic ``os.replace``) and
  :func:`get_model` refits from it.

The sidecar is the port's own (``$REPRO_TORCH_TUNE_DATA``, else
``~/.cache/repro_torch/tune_data.json``): the reference's sidecar holds
timings of other kernels and is never read here.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np

FEATURE_SCHEMA_VERSION = 1

# -- training-data sidecar ---------------------------------------------------

_DATA_ENV = "REPRO_TORCH_TUNE_DATA"
_DATA_SCHEMA = 1
# FIFO cap: the sidecar is a rolling window, not an unbounded log
_MAX_OBSERVATIONS = 4096
# below this many rows for a (kernel, mode) the fit is underdetermined and
# the shipped defaults answer instead
MIN_FIT_ROWS = 8


def data_path() -> str:
    p = os.environ.get(_DATA_ENV)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune_data.json")


def load_observations() -> list:
    """Sidecar rows from disk; [] on missing, corrupt, or stale-schema
    files (never a crash)."""
    try:
        with open(data_path()) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(raw, dict) or raw.get("schema") != _DATA_SCHEMA:
        return []
    rows = raw.get("observations")
    return rows if isinstance(rows, list) else []


def record_observations(rows: list) -> None:
    """Append sweep observations to the sidecar (read-merge-write under an
    atomic ``os.replace``: concurrent sweeps are last-writer-wins per
    write, never a torn file).  Rows beyond the FIFO cap age out
    oldest-first."""
    if not rows:
        return
    path = data_path()
    merged = load_observations() + list(rows)
    if len(merged) > _MAX_OBSERVATIONS:
        merged = merged[-_MAX_OBSERVATIONS:]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"schema": _DATA_SCHEMA, "observations": merged}, f)
    os.replace(tmp, path)
    _invalidate_model_cache()


def make_observation(kernel: str, mode: str, blocks: dict, basis: dict,
                     measured_us: float, features: dict | None = None) -> dict:
    """One sidecar row.  ``mode`` is ``autotune._mode_backend`` output: CPU
    timings of the plain versions must never train the card's model."""
    return dict(
        kernel=kernel, mode=mode, blocks=dict(blocks),
        basis={k: float(v) for k, v in basis.items()},
        measured_us=float(measured_us),
        features=dict(features) if features else None,
    )


# -- op-stream workload features ---------------------------------------------

_HLO_REF_BATCH = 64


@functools.lru_cache(maxsize=64)
def hlo_forward_features(U: int, Wa: int, K: int, batch: int = _HLO_REF_BATCH) -> dict:
    """FLOPs and HBM bytes per sample of the plain oracle forward
    (``ref.clause_fire_ref`` + ``class_sum_ref``) at this artifact shape,
    and their roofline times on the card (seconds a sample, compute- and
    memory-bound).  Traced on ``meta`` by ``launch/op_analysis.analyze``,
    whose FlopCounterMode count (the matmul FLOPs) stands under the
    reference's ``xla_flops_per_sample``.  Memoized per shape: one trace per
    (U, Wa, K), shared by every candidate and batch bucket."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    def fwd(lit_words, inc_words, votes):
        return ref.class_sum_ref(ref.clause_fire_ref(lit_words, inc_words), votes)

    meta = torch.device("meta")
    _, an = op_analysis.analyze(
        fwd, torch.empty((batch, Wa), dtype=torch.int32, device=meta),
        torch.empty((U, Wa), dtype=torch.int32, device=meta),
        torch.empty((U, K), dtype=torch.int32, device=meta))
    flops, hbm = an.cost.flops / batch, an.cost.bytes / batch
    return dict(
        hlo_flops_per_sample=flops,
        hlo_bytes_per_sample=hbm,
        xla_flops_per_sample=an.flop_counter_flops / batch,
        roofline_t_comp=flops / PEAK_FLOPS_BF16,
        roofline_t_mem=hbm / HBM_BW,
    )


# -- workload features -------------------------------------------------------

def artifact_features(compiled, *, with_hlo: bool = True) -> dict:
    """Candidate-independent workload features of a compiled artifact.

    ``compiled`` is duck-typed (``include_words``/``stats``/``n_classes``:
    a ``core/compiler.CompiledTM`` or anything shape-compatible).  The dict
    is JSON-serializable; ``CompiledTM.save`` persists it under
    ``meta["features"]``.  Key for key the reference's; with
    ``with_hlo=False`` equal to its values too, and with ``with_hlo`` it
    adds :func:`hlo_forward_features`.
    """
    iw = np.ascontiguousarray(np.asarray(compiled.include_words,
                                         dtype=np.uint32))
    U, Wa = iw.shape
    K = int(compiled.n_classes)
    chain = np.unpackbits(iw.view(np.uint8)).reshape(U, -1).sum(axis=1)
    n_includes = int(chain.sum())
    stats = getattr(compiled, "stats", None)
    feats = dict(
        schema=FEATURE_SCHEMA_VERSION,
        n_rows=U,
        n_words_active=Wa,
        n_classes=K,
        n_includes=n_includes,
        include_density=n_includes / max(U * Wa * 32, 1),
        chain_mean=float(chain.mean()) if U else 0.0,
        chain_p95=float(np.percentile(chain, 95)) if U else 0.0,
        chain_max=int(chain.max()) if U else 0,
        partial_term_sharing=(
            float(stats.partial_term_sharing) if stats is not None else 0.0),
        n_partial_terms_unique=(
            int(stats.n_partial_terms_unique) if stats is not None else 0),
    )
    if with_hlo:
        feats.update(hlo_forward_features(U, Wa, K))
    return feats


# -- the model ---------------------------------------------------------------

CPU_MODE = "torch-cpu"
CUDA_MODE = "torch-cuda"

# Shipped coefficients per mode: predicted MICROSECONDS per basis unit.
# Only the ranking matters; a machine's sidecar refits them.
DEFAULT_COEFFS: dict = {
    # The reference's coefficients, fitted on its CPU interpret-mode sweeps
    # (repro/kernels/cost_model.py), kept as they are for the CPU, where the
    # port runs the plain versions.
    CPU_MODE: {
        "fused_infer": {
            "intercept": 8.45, "steps": 99.497,
            "work_melem": 441.127, "fold_melem": 1193.107, "bytes_mb": 0.0,
        },
        "fused_train": {
            "intercept": 22849.81, "steps": 2262.699,
            "work_melem": 74479.131, "l_work_melem": 0.0, "bytes_mb": 72658.346,
        },
        "sparse_infer": {
            "intercept": 40.774, "steps": 27.033,
            "chain_melem": 82.833, "fold_melem": 55197.206, "bytes_mb": 0.0,
        },
        "term_infer": {
            "intercept": 0.0, "steps": 179.94,
            "term_melem": 1220.827, "chain_melem": 1233.48,
            "fold_melem": 45300.49, "bytes_mb": 0.0,
        },
    },
    # The card's: the refit that chip_smoke.py's AUTOTUNE phase printed
    # (AUTOTUNE_COEFFS) after sweeping every candidate with CUDA events on
    # an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: fused_infer at
    # B 1, 33, 97, 512 over the committed tm-mnist artifact's 2000 clauses
    # and at the training batches over 2048, fused_train at B 1, 33, 64,
    # 97, the two walks on the artifact at the serve bucket (78 rows).  The
    # kernels are latency-bound, so the intercepts carry most of the time.
    CUDA_MODE: {
        "fused_infer": {
            "intercept": 5.410537611366118, "steps": 0.000578058955819279,
            "work_melem": 0.07451426052378197, "fold_melem": 0.4766065100580296,
            "bytes_mb": 0.0,
        },
        "fused_train": {
            "intercept": 8.127503906366899, "steps": 2.324330854601104e-05,
            "work_melem": 1.9730000797166296, "l_work_melem": 0.0,
            "bytes_mb": 0.010587835210297731,
        },
        "sparse_infer": {
            "intercept": 4.048802485319342, "steps": 0.0027453912430588268,
            "chain_melem": 0.0, "fold_melem": 15.819905874259552,
            "bytes_mb": 0.055649678726027406,
        },
        "term_infer": {
            "intercept": 11.179318482664879, "steps": 0.0020137980032969628,
            "term_melem": 0.0, "chain_melem": 0.037015734471100084,
            "fold_melem": 2.586227068911921, "bytes_mb": 0.0691065164356687,
        },
    },
}


class CostModel:
    """Non-negative linear timing model over per-candidate basis terms."""

    def __init__(self, coeffs: dict | None = None):
        self.coeffs = {k: dict(v) for k, v in
                       (coeffs or DEFAULT_COEFFS[CPU_MODE]).items()}

    def predict_us(self, kernel: str, basis: dict) -> float:
        theta = self.coeffs.get(kernel)
        if theta is None:
            # an unregistered kernel still gets a deterministic ranking:
            # fewer grid steps first
            return float(basis.get("steps", 0.0))
        us = theta.get("intercept", 0.0)
        for name, value in basis.items():
            us += theta.get(name, 0.0) * float(value)
        return float(us)

    def rank(self, kernel: str, items: list) -> list:
        """``items`` is ``[(candidate, basis_dict), ...]``; returns
        ``[(candidate, predicted_us), ...]`` best-first.  Ties break toward
        the LARGER tiling, as the sweep's noise-floor rule does."""
        scored = [(cand, self.predict_us(kernel, basis))
                  for cand, basis in items]
        return sorted(scored, key=lambda cb: (cb[1], -math.prod(cb[0])))

    def fit(self, observations: list, mode: str,
            min_rows: int = MIN_FIT_ROWS, ridge: float = 1e-3) -> "CostModel":
        """Refit per-kernel coefficients from sidecar rows of the SAME mode.
        Kernels with fewer than ``min_rows`` same-mode rows keep their
        current coefficients.  Ridge-regularized least squares with negative
        weights clipped to zero (a negative work coefficient would rank
        unboundedly large tilings first)."""
        new = CostModel(self.coeffs)
        by_kernel: dict = {}
        for row in observations:
            if not isinstance(row, dict) or row.get("mode") != mode:
                continue
            k = row.get("kernel")
            basis, us = row.get("basis"), row.get("measured_us")
            if k and isinstance(basis, dict) and isinstance(us, (int, float)):
                by_kernel.setdefault(k, []).append((basis, float(us)))
        for kernel, rows in by_kernel.items():
            if len(rows) < min_rows:
                continue
            names = sorted({n for basis, _ in rows for n in basis})
            if not names:
                continue
            X = np.array([[1.0] + [float(b.get(n, 0.0)) for n in names]
                          for b, _ in rows])
            y = np.array([us for _, us in rows])
            # scale-normalized ridge so the penalty is unit-agnostic
            scale = np.maximum(np.abs(X).max(axis=0), 1e-9)
            Xs = X / scale
            A = Xs.T @ Xs + ridge * np.eye(Xs.shape[1])
            try:
                theta = np.linalg.solve(A, Xs.T @ y) / scale
            except np.linalg.LinAlgError:
                continue
            theta = np.maximum(theta, 0.0)
            if not np.any(theta > 0):
                continue
            new.coeffs[kernel] = dict(
                intercept=float(theta[0]),
                **{n: float(t) for n, t in zip(names, theta[1:])})
        return new


_MODEL_CACHE: dict = {}


def _invalidate_model_cache() -> None:
    _MODEL_CACHE.clear()


def get_model(mode: str, refresh: bool = False) -> CostModel:
    """The process-wide model for a mode (``torch-cuda`` or ``torch-cpu``):
    that mode's shipped defaults refit against the sidecar's same-mode
    observations.  Memoized per (sidecar path, mode); a new
    :func:`record_observations` write invalidates the memo."""
    key = (data_path(), mode)
    if not refresh and key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    base = DEFAULT_COEFFS.get(mode, DEFAULT_COEFFS[CPU_MODE])
    model = CostModel(base).fit(load_observations(), mode)
    _MODEL_CACHE[key] = model
    return model
