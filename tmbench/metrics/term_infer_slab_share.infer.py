"""term_infer_slab_share.infer: the share of the window's batches whose
factorized call took the slab-resident design (one launch, the literal rows
and the term table in shared memory), the calls of the program's span
``term_infer.slab`` over the batches, in %.  Nothing when run_compiled did
not run once a batch, or when the program has no such span."""

from tmbench import program_spans


def read(run):
    got = program_spans.calls_match(run, "infer", "run_compiled")
    if got is None:
        return None
    try:
        from repro_torch.kernels import term_infer
    except ImportError:
        return None
    span = getattr(term_infer, "SLAB_RANGE", None)
    if span is None:
        return None
    return 100.0 * got.get(span, (0, 0))[0] / run["batches"]
