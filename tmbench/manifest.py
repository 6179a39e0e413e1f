"""``BENCHMARK.json``: its schema, and what belongs to a cell, found by name.

A cell (``workloads`` entry) names a configuration (``configs``, whose
``file`` holds its sizes) and a traffic mix, the file
``tmbench/traffic/<traffic>.json``; the traffic's ``kind`` names the module
``tmbench/kinds/<kind>.py``.  Every metric, end-to-end or per-layer, is
read by ``tmbench/metrics/<metric>.py``.  A metric belongs to a cell when
its ``workloads`` list names the cell; a per-layer metric without the key
belongs to every cell that reports the end-to-end metric it moves.  A
configuration's file keeps to ``config_errors``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = ("host_clock", "device_trace")
# the contract's four: a later per-layer metric may read a span or a
# counter of the program without an edit here
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _line(s, what, errors) -> None:
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def _name(s, what, errors) -> None:
    if not isinstance(s, str) or not NAME.fullmatch(s):
        errors.append(f"{what} {s!r} is not a name (letters, digits, _ . -; at most 64)")


def validate(m: dict, root: str = ROOT) -> list:
    """The ways ``m`` breaks the benchmark's contract (empty when none)."""
    errors = []
    if set(m) != set(TOP_KEYS):
        errors.append(f"top-level keys must be exactly {TOP_KEYS}")
    paths = m.get("paths", [])
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.fullmatch(str(p)) or str(p).startswith("/") or ".." in str(p).split("/"):
            errors.append(f"path {p!r} is not a relative path inside the repository")
    cmd = m.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errors.append("command: a list of 1 to 32 strings")
    for w in cmd:
        _line(w, "command word", errors)
        if str(w).startswith("/") or ".." in str(w).split("/"):
            errors.append(f"command word {w!r} leaves the repository")
    rs = m.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")
    names = set()

    def unique(n, what):
        if n in names:
            errors.append(f"{what} {n!r}: name used twice")
        names.add(n)

    configs = m.get("configs", [])
    if not 1 <= len(configs) <= 24:
        errors.append("configs: 1 to 24")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            errors.append(f"config {c.get('name')!r}: keys must be {sorted(CONFIG_KEYS)}")
        _name(c.get("name"), "config", errors)
        unique(c.get("name"), "config")
        _line(c.get("source"), f"config {c.get('name')} source", errors)
        _line(c.get("why"), f"config {c.get('name')} why", errors)
        f = c.get("file", "")
        if f in files or not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            errors.append(f"config {c.get('name')}: file {f!r} not under paths or shared")
        files.add(f)
        cfg = {}
        if os.path.isfile(os.path.join(root, f)):
            with open(os.path.join(root, f)) as fh:
                cfg = json.load(fh)
        else:
            errors.append(f"config {c.get('name')}: no file {f}")
        errors += config_errors(c, cfg)
    cfg_names = {c.get("name") for c in configs}
    cells = m.get("workloads", [])
    if not 1 <= len(cells) <= 24:
        errors.append("workloads: 1 to 24 cells")
    pairs = set()
    for w in cells:
        if set(w) != WORKLOAD_KEYS:
            errors.append(f"cell {w.get('name')!r}: keys must be {sorted(WORKLOAD_KEYS)}")
        _name(w.get("name"), "cell", errors)
        unique(w.get("name"), "cell")
        _name(w.get("traffic"), "traffic", errors)
        _line(w.get("why"), f"cell {w.get('name')} why", errors)
        if w.get("config") not in cfg_names:
            errors.append(f"cell {w.get('name')}: unknown config {w.get('config')!r}")
        if w.get("chips") not in (1, 4):
            errors.append(f"cell {w.get('name')}: chips is 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errors.append(f"cell {w.get('name')}: configuration and traffic used twice")
        pairs.add(pair)
    if sum(w.get("chips") == 4 for w in cells) > max(1, len(cells) // 4):
        errors.append("too many four-chip cells")
    used = {w.get("config") for w in cells}
    for c in cfg_names - used:
        errors.append(f"config {c!r} is used by no cell")
    cell_names = {w.get("name") for w in cells}
    e2e = m.get("end_to_end", [])
    if not 1 <= len(e2e) <= 16:
        errors.append("end_to_end: 1 to 16 metrics")
    if "setup_s" not in {e.get("name") for e in e2e}:
        errors.append("end_to_end has no setup_s")
    for e in e2e:
        _metric(e, E2E_KEYS, E2E_SOURCES, cell_names, unique, errors)
        b = e.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            errors.append(f"metric {e.get('name')}: bound from 0.01 to 0.25")
    e2e_names = {e.get("name") for e in e2e}
    layers = m.get("per_layer", [])
    if not 1 <= len(layers) <= 128:
        errors.append("per_layer: 1 to 128 metrics")
    for p in layers:
        _metric(p, LAYER_KEYS, SOURCES, cell_names, unique, errors)
        _line(p.get("layer"), f"metric {p.get('name')} layer", errors)
        if p.get("moves") not in e2e_names:
            errors.append(f"metric {p.get('name')}: moves {p.get('moves')!r}, no "
                          "end-to-end metric")
    for w in cells:
        got = [e["name"] for e in e2e if applies(e, w["name"])]
        if "setup_s" not in got or len(got) < 2:
            errors.append(f"cell {w.get('name')}: needs setup_s and another "
                          "end-to-end metric")
        lay = [p for p in layers if applies_layer(p, w["name"], e2e)]
        if not lay:
            errors.append(f"cell {w.get('name')}: no per-layer metric")
        for p in lay:
            if p.get("moves") not in got:
                errors.append(f"cell {w.get('name')}: {p.get('name')} moves "
                              f"{p.get('moves')}, which the cell does not report")
    return errors


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def config_errors(entry: dict, cfg: dict) -> list:
    """The ways the file ``cfg`` of the configuration ``entry`` breaks the
    contract of a configuration (empty when none).

    ``model`` holds the widths, which are never cut; ``held``, where the
    file has it, the counts cut to one chip's share (layers, experts held,
    vocabulary rows), each listed in ``reduced``; ``published`` the
    source's own value of every key of ``model`` and ``held``.  A number at
    the top level of the file that ``published`` names (where a published
    model's own ``config.json`` is copied) reads its ``held`` value where
    the key is held, else its published one.
    """
    errors = []
    name = entry.get("name")
    model, held = cfg.get("model", {}), cfg.get("held", {})
    published = cfg.get("published", {})
    if not all(isinstance(b, dict) for b in (model, held, published)):
        return [f"config {name}: model, held and published are objects"]
    red = entry.get("reduced", [])
    if not isinstance(red, list) or len(red) > 16:
        errors.append(f"config {name}: reduced is a list of at most 16 keys")
        red = []
    for k in red:
        _name(k, "reduced key", errors)
        if k in model:
            errors.append(f"config {name}: reduced names a width {k!r} "
                          "(a key of the configuration's model)")
    if "held" in cfg and "published" not in cfg:
        errors.append(f"config {name}: held without published")
    for k, v in held.items():
        if k not in red:
            errors.append(f"config {name}: held key {k!r} is not in reduced")
        if k not in published:
            errors.append(f"config {name}: held key {k!r} has no published value")
        elif not (_number(v) and _number(published[k]) and 0 < v <= published[k]):
            errors.append(f"config {name}: held {k!r} is {v!r}, not above 0 and at most "
                          f"its published {published[k]!r}")
    for k, v in model.items():
        if k in published and v != published[k]:
            errors.append(f"config {name}: model key {k!r} is {v!r}, unlike its "
                          f"published {published[k]!r}")
    for k, v in cfg.items():
        want = held.get(k, published.get(k))
        if _number(v) and k in published and v != want:
            errors.append(f"config {name}: top-level {k!r} is {v!r}, not its held or "
                          f"published {want!r}")
    return errors


def _metric(e, keys, sources, cell_names, unique, errors) -> None:
    extra = set(e) - keys - {"workloads"}
    if extra or not keys <= set(e):
        errors.append(f"metric {e.get('name')!r}: keys must be {sorted(keys)} "
                      "and optionally workloads")
    _name(e.get("name"), "metric", errors)
    unique(e.get("name"), "metric")
    if not isinstance(e.get("unit"), str) or not UNIT.fullmatch(e.get("unit")):
        errors.append(f"metric {e.get('name')}: unit {e.get('unit')!r}")
    if e.get("better") not in ("lower", "higher"):
        errors.append(f"metric {e.get('name')}: better is lower or higher")
    if e.get("source") not in sources:
        errors.append(f"metric {e.get('name')}: source {e.get('source')!r}")
    for w in e.get("workloads", []):
        if w not in cell_names:
            errors.append(f"metric {e.get('name')}: unknown cell {w!r}")


def applies(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def applies_layer(metric: dict, cell: str, e2e: list) -> bool:
    """Whether a per-layer metric is reported in ``cell``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = [e for e in e2e if e["name"] == metric["moves"]]
    return bool(moves) and applies(moves[0], cell)


def cell(m: dict, name: str) -> dict:
    """The workload ``name`` with its configuration entry and the paths of
    its files: ``{"cell", "config", "config_file", "traffic_file",
    "end_to_end", "per_layer"}``."""
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in m['workloads']]}")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    return dict(
        cell=w, config=c,
        config_file=os.path.join(ROOT, c["file"]),
        traffic_file=os.path.join(HERE, "traffic", w["traffic"] + ".json"),
        end_to_end=[e for e in m["end_to_end"] if applies(e, name)],
        per_layer=[p for p in m["per_layer"] if applies_layer(p, name, m["end_to_end"])])


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module of traffic kind ``name``."""
    return load_module(os.path.join(HERE, "kinds", name + ".py"), f"tmbench_kind_{name}")


def reader(metric: str):
    """The ``read(run)`` function of metric ``metric``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return load_module(path, "tmbench_metric_" + metric.replace(".", "_").replace("-", "_")).read
