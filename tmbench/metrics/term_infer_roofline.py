"""term_infer_roofline: the bound of the window's inference work
(tmbench/work.py) over the device time of the factorized schedule kernel's
launches (bit transpose, term evaluation, the chain walk), in percent.
Nothing when the route launched no term evaluation."""

PARTS = ("bit_transpose_kernel", "term_eval_kernel", "chain_exact_kernel")


def read(run):
    tr, bounds = run.get("trace"), run.get("bounds") or {}
    if run["kind"] != "infer" or not tr or "term_infer" not in bounds:
        return None
    names = tr["by_name"]
    if not any("term_eval_kernel" in n for n in names):
        return None
    t = sum(s for n, s in names.items() if any(p in n for p in PARTS))
    return 100.0 * bounds["term_infer"] / t
