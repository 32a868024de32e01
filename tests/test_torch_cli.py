"""The port's training command lines (`embeddingtables_tpu_torch/scripts/`)
against the JAX package's (`scripts/train_*.py`).

Every flag of each JAX command, read with `ast` from its source (no
subprocess, no JAX import), is a flag of its port with the same option
strings, default, type, choices, `nargs` and action; the port adds only
`--device`. Each command's `main([..., "--device", "cpu"])` trains a tiny
model for 3 steps with finite losses; JAX's checks of the flags are the
port's (`ap.error`, a `SystemExit`). The `--mesh --auto-shard` DLRM run is
in `test_torch_planner_tt.py`, inside that file's 4-rank group.
"""
import ast
import importlib
import os

import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("dlrm", "dcn", "deepfm", "two_tower")


def jax_flags(family: str) -> dict:
    """{option strings: keywords} of every `add_argument` call in JAX's
    `scripts/train_<family>.py`, the keywords that describe a flag's value
    (`help` aside) as Python values."""
    path = os.path.join(ROOT, "scripts", f"train_{family}.py")
    tree = ast.parse(open(path).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument":
            names = tuple(ast.literal_eval(a) for a in node.args)
            kw = {}
            for k in node.keywords:
                if k.arg == "help":
                    continue
                kw[k.arg] = (k.value.id if k.arg == "type"
                             else ast.literal_eval(k.value))
            out[names] = kw
    return out


def port(family: str):
    return importlib.import_module(
        f"embeddingtables_tpu_torch.scripts.train_{family}")


def port_flags(family: str) -> dict:
    out = {}
    for a in port(family).build_parser()._actions:
        if a.option_strings and a.option_strings != ["-h", "--help"]:
            out[tuple(a.option_strings)] = a
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_every_jax_flag_is_a_port_flag(family):
    want, got = jax_flags(family), port_flags(family)
    assert len(want) > 15
    assert set(got) - set(want) == {("--device",)}
    for names, kw in want.items():
        a = got[names]
        if kw.get("action") == "store_true":
            assert a.const is True and a.default is False and a.nargs == 0
        else:
            assert a.default == kw.get("default"), names
            assert (a.type.__name__ if a.type else None) == kw.get("type"), \
                names
            assert a.choices == kw.get("choices"), names
            assert a.nargs == kw.get("nargs"), names
    assert got[("--device",)].default == "cuda"


TINY = {
    "dlrm": ["--tables", "3", "--vocab", "100", "--dim", "8", "--batch",
             "64", "--eval-every", "3", "--eval-batches", "1"],
    "dcn": ["--tables", "3", "--vocab", "100", "--dim", "8", "--batch", "64",
            "--deep-mlp", "16,8", "--cross-rank", "4", "--num-cross", "2"],
    "deepfm": ["--tables", "3", "--vocab", "100", "--dim", "8", "--batch",
               "64", "--deep-mlp", "16,8", "--evict-every", "2"],
    "two_tower": ["--query-vocabs", "30", "40", "--item-vocab", "200",
                  "--dim", "8", "--embed-dim", "8", "--batch", "32",
                  "--eval-every", "3", "--eval-batches", "1", "--k", "5"],
}


@pytest.mark.parametrize("family", FAMILIES)
def test_each_command_trains_three_steps_on_the_cpu(family, capsys):
    res = port(family).main(["--device", "cpu", "--steps", "3",
                             "--log-every", "1"] + TINY[family])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    out = capsys.readouterr().out
    assert "device=cpu ranks=1" in out and "examples/s" in out
    assert ("final recall@5" if family == "two_tower"
            else "final AUC" if family == "dlrm" else "telemetry") in out


@pytest.mark.parametrize("family,argv,what", [
    ("dlrm", ["--auto-shard"], "requires --mesh"),
    ("dcn", ["--auto-shard"], "requires --mesh"),
    ("dlrm", ["--stochastic-rounding"], "bf16 tables"),
    ("deepfm", ["--stochastic-rounding", "--table-dtype", "bfloat16",
                "--opt", "ftrl"], "sgd/adagrad/adam"),
    ("two_tower", ["--stochastic-rounding"], "bfloat16"),
    ("dlrm", ["--criteo", "/nonexistent", "--tables", "3"], "26"),
])
def test_the_flag_checks_are_jax_checks(family, argv, what, capsys):
    with pytest.raises(SystemExit):
        port(family).main(["--device", "cpu", "--steps", "1"] + argv)
    assert what in capsys.readouterr().err
