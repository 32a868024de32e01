"""BENCHMARK.json against the contract the driver checks, and every name in
it resolved to the files under `portbench/` that serve it."""
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("dim", "rank", "hidden", "intermediate", "latent", "state",
               "projection", "head", "expansion", "experts_per_token",
               "mlp", "cross")
BENCH = spec.load_benchmark()
HELD = sorted(p.stem for p in (spec.PACKAGE / "held").glob("*.json"))


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_in_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)
        names.add(("config", c["name"]))
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.add(("cell", w["name"]))
    assert {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_reports_what_it_must(cell):
    e2e, per_layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        # every cell a per-layer metric lists reports the metric it moves
        for c in m.get("workloads", [cell]):
            assert m["moves"] in {x["name"] for x in spec.cell_metrics(
                BENCH, c)[0]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    fam = spec.load_module("families", c.config["family"])
    for fn in ("port_config", "port_model", "tower_leaves"):
        assert callable(getattr(fam, fn))
    assert hasattr(spec.load_module("kinds", c.traffic["kind"]), "Runner")
    for m in c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert c.limits, f"{cell} has no limits/{cell}.json"
    assert set(c.limits) | set(c.not_compared) >= {"grad_gap", "change_gap"}


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new mix and a new cell: a traffic file and entries in
    BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(spec.PACKAGE, tmp_path / "portbench")
    bench = json.loads(json.dumps(BENCH))
    traffic = spec.load_json(spec.PACKAGE / "traffic" / "train_zipf.json")
    traffic.update(batch=8192, zipf_a=1.05)
    (tmp_path / "portbench" / "traffic" / "train_zipf_b8192.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": "dlrm.train.small", "config":
                               "dlrm_mlperf", "traffic": "train_zipf_b8192",
                               "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dlrm.train.zipf" in m.get("workloads", []):
            m["workloads"].append("dlrm.train.small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("dlrm.train.small", tmp_path)
    assert c.traffic["batch"] == 8192 and c.config["family"] == "dlrm"
    assert {m["name"] for m in c.per_layer} == {
        m["name"] for m in spec.load_cell("dlrm.train.zipf").per_layer}


def test_configs_state_their_cut():
    for c in BENCH["configs"]:
        f = spec.load_json(spec.ROOT / c["file"])
        assert set(c["reduced"]) == set(f["reduced"])
        assert "assumed" in f and "deployment" in f
        if "vocab_sizes" in f["reduced"]:
            # one card's share of the 4-card row-sharded deployment
            share = [-(-v // 4) if v > 1_000_000 else v
                     for v in f["vocab_sizes_published"]]
            assert f["vocab_sizes"] == share


@pytest.mark.parametrize("name", HELD)
def test_a_held_cell_comes_back_by_entries_alone(name):
    """A cell held back (`held/<name>.json`) is whole once its entries are
    in BENCHMARK.json: every name resolves to a file that is already
    here, and its cell reports what a cell must."""
    bench = tiny.with_held(BENCH, name)
    c = spec.load_cell(name, bench=bench)
    e2e, per_layer = spec.cell_metrics(bench, name)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer and c.limits
    assert spec.load_module("families", c.config["family"])
    assert all(callable(spec.load_module("metrics", m["name"]).read)
               for m in per_layer)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
