"""Cells shrunk to a size a CPU test can hold: fewer rows, narrower towers,
smaller batches. Only the tests use this; the benchmark's cells keep their
published widths."""
from __future__ import annotations

import torch

from portbench import run, spec

SHRINK = {
    "dlrm": {"dim": 16, "bottom_mlp": [32, 16], "top_mlp": [64, 32, 1]},
    "dcn": {"dim": 16, "cross_rank": 32, "deep_mlp": [64, 32]},
}
TRAFFIC = {
    "train": {"batch": 1024, "steps_per_call": 4, "batches": 4},
}


def shrink(c):
    cfg = dict(c.config)
    cfg["vocab_sizes"] = [max(3, v // (20000 * cfg.get("placement", {}).get(
        "cards", 1))) for v in cfg["vocab_sizes"]]
    cfg.update(SHRINK[cfg["family"]])
    c.config = cfg
    c.traffic = {**c.traffic, **TRAFFIC[c.traffic["kind"]]}
    return c


def with_held(bench: dict, name: str) -> dict:
    """`bench` with the entries of the held-back cell `name`
    (`held/<name>.json`: a cell built and run on the card but not in
    BENCHMARK.json) added."""
    held = spec.load_json(spec.PACKAGE / "held" / f"{name}.json")
    return {k: v + held[k] if k in held else v for k, v in bench.items()}


def cell(name: str):
    """The cell `name` of BENCHMARK.json, or held back, shrunk."""
    bench = spec.load_benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        bench = with_held(bench, name)
    return shrink(spec.load_cell(name, bench=bench))


def run_tiny(c, seed: int = 2**31 + 7, seconds: float = 0.5) -> dict:
    return run.run_cell(c, seed, seconds, False, torch.device("cpu"))
