"""flash_tma_share.infer: the window's flash attention launches that took
the warp-specialized TMA design (``flash_fwd_wgmma_kernel_tma``), over all
its flash launches, in %: the program's counters ``flash.tma_launches`` and
``flash.launches``.  Nothing when the program has no such counters or the
window launched no flash kernel."""

LAUNCHES, TMA = "flash.launches", "flash.tma_launches"


def read(run):
    if run.get("kind") != "infer":
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counts = getattr(spans, "counts", None)
    got = counts() if counts else {}
    if not got.get(LAUNCHES):
        return None
    return 100.0 * got.get(TMA, 0) / got[LAUNCHES]
