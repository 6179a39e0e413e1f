"""flash_mla_roofline: the bound of the window's causal attention core (the
prefill's query-key and probability-value products at or below the
diagonal, ``tmbench/lm_work.py``) over the device time of the flash
kernel's launches (``flash_fwd_wgmma_kernel``), in percent.  Nothing when
the window launched none."""

KERNEL = "flash_fwd_wgmma_kernel"


def read(run):
    tr, bounds = run.get("trace"), run.get("bounds") or {}
    if run["kind"] != "infer" or not tr or "flash" not in bounds:
        return None
    t = sum(s for n, s in tr["by_name"].items() if KERNEL in n)
    if not t:
        return None
    return 100.0 * bounds["flash"] / t
