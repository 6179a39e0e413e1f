"""The port's host spans (``repro_torch/spans.py``) on run_compiled's
factorized path and the hash-RNG training step.

With no profiler recording a span dispatches no ``profiler.*`` op and
records nothing; under ``torch.profiler`` each span is a range in the
trace, nested as the code nests, on the clock of the ops inside it, and
counted in ``spans.totals()``.  Results are the same bits either way.  The
``cuda`` cases check on the card that the ``term_infer`` launches lie
inside ``term_infer.launch``: the three of a small batch, and the slab
design's one of a large batch inside ``term_infer.slab`` as well.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.core import compiler, packetizer, tm
from repro_torch.kernels import ops, term_infer

INFER_SPANS = (compiler.RUN_RANGE, compiler.ROUTE_RANGE, compiler.GATHER_RANGE,
               term_infer.PREP_RANGE)
TRAIN_SPANS = (ops.STEP_RANGE, ops.PREPARE_RANGE, ops.SUMS_RANGE, ops.FEEDBACK_RANGE,
               ops.DELTA_RANGE, ops.APPLY_RANGE)
# each span's parent, as the code nests them
PARENT = {compiler.ROUTE_RANGE: compiler.RUN_RANGE,
          compiler.GATHER_RANGE: compiler.RUN_RANGE,
          term_infer.PREP_RANGE: compiler.RUN_RANGE,
          term_infer.LAUNCH_RANGE: compiler.RUN_RANGE,
          **{s: ops.STEP_RANGE for s in TRAIN_SPANS[1:]}}


class _Ops(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _artifact(seed=0):
    cfg = tm.TMConfig(n_features=40, n_classes=3, clauses_per_class=8)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((cfg.n_clauses_total, cfg.n_literals)) < 0.1,
                  rng.integers(0, 127, (cfg.n_clauses_total, cfg.n_literals)),
                  rng.integers(-128, 0, (cfg.n_clauses_total, cfg.n_literals))).astype(np.int8)
    return compiler.compile_tm(cfg, ta)


def _packed(n_features=40, batch=70, seed=1):
    x = np.random.default_rng(seed).integers(0, 2, (batch, n_features), dtype=np.uint8)
    return packetizer.pack_literals(torch.from_numpy(x))


def _train_problem(seed=3):
    cfg = tm.TMConfig(n_features=24, n_classes=3, clauses_per_class=10, threshold=8)
    g = torch.Generator().manual_seed(seed)
    ta = torch.randint(-3, 3, (cfg.n_clauses_total, cfg.n_literals), generator=g,
                       dtype=torch.int8)
    x = torch.randint(0, 2, (20, cfg.n_features), generator=g, dtype=torch.uint8)
    y = torch.randint(0, cfg.n_classes, (20,), generator=g)
    return cfg, ta, x, y


def _infer(compiled, x):
    return compiler.run_compiled(compiled, x, engine="factorized")


def _train(problem, fuse=True):
    cfg, ta, x, y = problem
    return ops.tm_train_step_kernel(cfg, ta, x, y, 11, fuse=fuse)


def _profiled(fn, *args, **kw):
    """``(fn's result, kineto events)`` of one call under the profiler,
    with the span totals reset before it."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, list(prof.profiler.kineto_results.events())


def _ranges(events, name):
    """The host's ranges named ``name`` (a CUDA trace repeats each on the
    device's user-annotation track)."""
    return [(e.start_ns(), e.end_ns()) for e in events
            if e.name() == name and not str(e.device_type()).endswith("CUDA")]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_no_profiler_no_profiler_ops_and_no_totals():
    compiled, x, problem = _artifact(), _packed(), _train_problem()
    _infer(compiled, x)                    # builds outside the mode
    spans.reset()
    for fn, args in ((_infer, (compiled, x)), (_train, (problem,))):
        with _Ops() as mode:
            fn(*args)
        assert mode.names and not [n for n in mode.names if n.startswith("profiler.")]
    assert spans.totals() == {}


def test_a_span_off_is_one_shared_object():
    spans.reset()
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        pass
    assert spans.totals() == {}


@pytest.mark.parametrize("path", ["infer", "train", "train_unfused"])
def test_spans_nest_under_the_profiler_once_a_call(path):
    if path == "infer":
        compiled, x = _artifact(), _packed()
        _infer(compiled, x)
        _, events = _profiled(_infer, compiled, x)
        names, top = INFER_SPANS, compiler.RUN_RANGE
    else:
        _, events = _profiled(_train, _train_problem(), fuse=path == "train")
        names, top = TRAIN_SPANS, ops.STEP_RANGE
    assert len(_ranges(events, top)) == 1
    totals = spans.totals()
    for name in names:
        got = _ranges(events, name)
        assert len(got) == 1, (name, got)
        if name != top:
            assert _inside(got[0], _ranges(events, PARENT[name])[0]), name
        calls, ns = totals[name]
        assert calls == 1 and ns > 0
    # a span's host time covers its profiler range
    assert totals[top][1] >= np.diff(_ranges(events, top)[0])[0]
    assert spans.BUILD_RANGE not in totals and term_infer.LAUNCH_RANGE not in totals


def test_the_gather_lies_inside_its_span_on_one_clock():
    compiled, x = _artifact(), _packed()
    _infer(compiled, x)
    _, events = _profiled(_infer, compiled, x)
    (gather,) = _ranges(events, compiler.GATHER_RANGE)
    index = _ranges(events, "aten::index")
    assert index and any(_inside(r, gather) for r in index)
    (route,) = _ranges(events, compiler.ROUTE_RANGE)
    assert route[1] <= gather[0]


def test_results_are_the_same_bits_with_and_without_the_profiler():
    compiled, x = _artifact(), _packed()
    want = _infer(compiled, x)
    got, _ = _profiled(_infer, compiled, x)
    assert torch.equal(got, want)
    for fuse in (True, False):
        problem = _train_problem()
        want_ta, want_d = _train(problem, fuse=fuse)
        (got_ta, got_d), _ = _profiled(_train, problem, fuse=fuse)
        assert torch.equal(got_ta, want_ta) and torch.equal(got_d, want_d)
        assert int(want_d.abs().sum()) > 0


def test_only_the_first_call_on_an_artifact_builds():
    compiled, x = _artifact(seed=5), _packed()
    _, events = _profiled(_infer, compiled, x)
    first = spans.totals()
    assert first[spans.BUILD_RANGE][0] >= 2       # device tables, factorized schedule
    (run,) = _ranges(events, compiler.RUN_RANGE)
    assert all(_inside(r, run) for r in _ranges(events, spans.BUILD_RANGE))
    _profiled(_infer, compiled, x)
    assert spans.BUILD_RANGE not in spans.totals()
    assert spans.totals()[compiler.RUN_RANGE][0] == 1


def _shared_bank():
    """A bank whose clauses share word-level AND terms (every clause
    includes literals 0 and 1, one of 4 in its second word and one of 3 in
    its third): ``run_compiled(engine="auto")`` takes the factorized
    schedule on the card."""
    cfg = tm.TMConfig(n_features=40, n_classes=3, clauses_per_class=8)
    ta = np.full((cfg.n_clauses_total, cfg.n_literals), -100, np.int8)
    c = np.arange(cfg.n_clauses_total)
    ta[:, [0, 1]] = 100
    ta[c, 32 + c % 4] = 100
    ta[c, 64 + c % 3] = 100
    return cfg, ta


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_swapped_in_artifact_builds_nothing_on_its_first_call(where, request):
    """The online updater places a candidate before it swaps it in, so the
    first ``run_compiled(engine="auto")`` on the promoted artifact opens no
    build span: on the CPU its oracle tables, on the card its factorized
    placement."""
    from repro_torch.runtime import online

    dev = request.getfixturevalue("cuda_device") if where == "cuda" else torch.device("cpu")
    cfg, ta = _shared_bank()
    first = compiler.compile_tm(cfg, ta)
    upd = online.OnlineUpdater(cfg, torch.from_numpy(ta).to(dev), first,
                               cfg=online.OnlineConfig(drift_threshold=0.0, batch_size=4,
                                                       swap_policy="immediate"))
    x = np.random.default_rng(2).integers(0, 2, (4, cfg.n_features), dtype=np.uint8)
    for i in range(4):
        assert upd.ingest(x[i], i % cfg.n_classes)
    assert upd.step() and upd.promotions == 1 and upd.deployed is not first
    art = upd.deployed
    assert art.stats.partial_term_sharing >= compiler.FACTORIZE_SHARING_THRESHOLD
    xp = _packed().to(dev)
    n0 = term_infer.launches
    got, _ = _profiled(compiler.run_compiled, art, xp, engine="auto")
    assert spans.BUILD_RANGE not in spans.totals()
    assert term_infer.launches - n0 == (where == "cuda")
    want = compiler.run_compiled(art, xp.cpu(), engine="oracle")
    assert torch.equal(got.cpu(), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _term_infer_kernels(events):
    """The device's term_infer kernels and the host's launches of them."""
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")
               and not e.is_user_annotation()
               and any(k in e.name() for k in ("bit_transpose_kernel", "term_eval_kernel",
                                               "chain_exact_kernel"))]
    ids = {i for e in kernels for i in (e.correlation_id(), e.linked_correlation_id()) if i}
    launches = [e for e in events if not str(e.device_type()).endswith("CUDA")
                and e.correlation_id() in ids and "aunch" in e.name()]
    return kernels, launches


@pytest.mark.cuda
def test_term_infer_launches_lie_inside_the_launch_span(cuda_device):
    # 1,024 samples: too few slabs for the card, so the three launches
    compiled, x = _artifact(), _packed(batch=1024).to(cuda_device)
    want = _infer(compiled, x)
    torch.cuda.synchronize()
    before = term_infer.launches
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = _infer(compiled, x)
        torch.cuda.synchronize()
    assert term_infer.launches == before + 1 and torch.equal(got, want)
    assert spans.totals()[term_infer.LAUNCH_RANGE][0] == 1
    assert term_infer.SLAB_RANGE not in spans.totals()
    events = list(prof.profiler.kineto_results.events())
    kernels, launches = _term_infer_kernels(events)
    assert len(kernels) >= 3, [e.name() for e in events if "kernel" in e.name()]
    assert len(launches) >= 3, sorted({e.name() for e in events})
    (launch,) = _ranges(events, term_infer.LAUNCH_RANGE)
    assert all(_inside((e.start_ns(), e.end_ns()), launch) for e in launches)


@pytest.mark.cuda
def test_slab_launch_lies_inside_the_slab_span(cuda_device):
    # 65,536 samples: the slab design's one launch, inside both spans
    compiled, x = _artifact(), _packed(batch=65536).to(cuda_device)
    want = _infer(compiled, x)
    torch.cuda.synchronize()
    before = term_infer.launches
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = _infer(compiled, x)
        torch.cuda.synchronize()
    assert term_infer.launches == before + 1 and torch.equal(got, want)
    totals = spans.totals()
    assert totals[term_infer.LAUNCH_RANGE][0] == 1 and totals[term_infer.SLAB_RANGE][0] == 1
    events = list(prof.profiler.kineto_results.events())
    kernels, launches = _term_infer_kernels(events)
    assert [e.name() for e in kernels if "slab_term_eval_kernel" in e.name()] == [
        e.name() for e in kernels], [e.name() for e in kernels]
    assert len(kernels) == 1 and len(launches) == 1, sorted({e.name() for e in events})
    (launch,), (slab,) = (_ranges(events, n) for n in (term_infer.LAUNCH_RANGE,
                                                        term_infer.SLAB_RANGE))
    assert _inside(slab, launch) and _inside((launches[0].start_ns(), launches[0].end_ns()), slab)
