"""The port stands alone: it imports neither JAX nor the JAX package, builds
nothing at import time, and never falls back to the CPU on its own."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import embeddingtables_tpu_torch as ett

PKG = Path(ett.__file__).resolve().parent
REPO = PKG.parent


def test_importing_the_port_loads_no_jax():
    code = ("import sys, embeddingtables_tpu_torch, "
            "embeddingtables_tpu_torch.ops.cuda._lib as lib;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'embeddingtables_tpu'"
            " or m.startswith('embeddingtables_tpu.')];"
            "assert not bad, bad; assert not lib._libs; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_source_file_names_jax_in_an_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|embeddingtables_tpu)(\s|\.|$|,)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f.relative_to(REPO)}:{n}: {line.strip()}"
                 for f in files
                 for n, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert len(files) > 10 and not offenders, offenders


@pytest.mark.parametrize("entry", ["init_dlrm", "dlrm_from_arrays"])
def test_entry_points_without_a_device_raise_when_there_is_no_card(
        entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                         bottom_mlp=(4,), top_mlp=(3, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_dlrm":
            ett.init_dlrm(cfg)
        else:
            model = ett.init_dlrm(cfg, device="cpu")
            def arrays(layers):
                return [(w.detach().numpy(), b.detach().numpy())
                        for w, b in layers]
            ett.dlrm_from_arrays(cfg, arrays(model.bottom), arrays(model.top),
                                 np.zeros((11, 4), np.float32),
                                 model.tables.offsets)
    assert ett.config.resolve_device("cpu") == torch.device("cpu")
