"""`BENCHMARK.json` and the files it names, found by name.

A cell is one entry of `workloads`: a configuration (`configs/<name>.json`,
whose `family` names `families/<family>.py`) under a traffic mix
(`traffic/<name>.json`, whose `kind` names `kinds/<kind>.py`). Its metrics
are the `end_to_end` entries that list it (or list no cells) and the
`per_layer` entries that list it, or that list no cells and move an
end-to-end metric the cell reports. Each per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a mix or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict         # {number: limit} of the correctness check
    not_compared: dict   # {number: why} read and printed, held to nothing


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str):
    """(end_to_end, per_layer): the entries that `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None
              ) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e, per_layer = cell_metrics(bench, name)
    limits_path = Path(root) / "portbench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(Path(root) / conf["file"]),
                traffic=load_json(Path(root) / "portbench" / "traffic"
                                  / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=limits.get("limits", {}),
                not_compared=limits.get("not_compared", {}))


def load_module(kind: str, name: str, root: Path = ROOT):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
