"""The port's input pipeline against the JAX package's, on the CPU.

  - The native Criteo parser (built by the port from the shared
    `native/criteo_parser.cpp`) against the pure-Python oracle
    `criteo_kaggle_batches` and against JAX's `native_parse_batch`, bitwise;
    `CriteoFileLoader` with epochs and a skipped prefix against JAX's.
  - `csr_to_padded` and `padded_to_csr` against JAX's.
  - `NativeSyntheticCriteo` bitwise JAX's native batches.
  - The Criteo-format file writer byte-equal to
    `scripts/make_criteo_file.py`.
  - `PrefetchLoader`, `parallel_batches` and `DevicePrefetcher` (the CPU's
    thread and queue): order, contents, and a producer's error at the
    consumer.
  - `train_dlrm(device_prefetch=2)` bitwise `device_prefetch=0`.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from embeddingtables_tpu import data as JDATA
from embeddingtables_tpu.io import loader as JL
from embeddingtables_tpu.io import synth as JS
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import data as PDATA
from embeddingtables_tpu_torch.io import criteo_file, loader as PL
from embeddingtables_tpu_torch.io import synth as PS
from _torch_threads import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
VOCAB = 500
VOCABS = (VOCAB,) * 26


@pytest.fixture(scope="module")
def criteo_path(tmp_path_factory):
    """A 2,000-row Criteo-format file from the port's writer, with one
    malformed row and one row with empty fields appended."""
    path = tmp_path_factory.mktemp("criteo") / "train.txt"
    criteo_file.write_criteo_file(str(path), 2000, VOCAB, seed=3)
    with open(path, "ab") as f:
        f.write(b"x\t1\n")
        f.write(b"1" + b"\t" * 39 + b"\n")
    return str(path)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_native_parser_matches_the_oracle_and_jax(criteo_path):
    assert PL.native_available(), PL.native_error()
    buf = open(criteo_path, "rb").read()
    got = PL.native_parse_batch(buf, 2100, VOCABS)
    want = JL.native_parse_batch(buf, 2100, VOCABS)
    assert got[0] == want[0] == 2001 and got[4:] == want[4:]
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    _assert_batches_equal(PL.CriteoFileLoader(criteo_path, VOCABS, 500),
                          PDATA.criteo_kaggle_batches(criteo_path, VOCABS,
                                                      500))
    _assert_batches_equal(PDATA.criteo_kaggle_batches(criteo_path, VOCABS,
                                                      300, 4),
                          JDATA.criteo_kaggle_batches(criteo_path, VOCABS,
                                                      300, 4))
    with pytest.raises(ValueError, match="26 sparse"):
        PL.native_parse_batch(buf, 10, VOCABS[:3])


@pytest.mark.parametrize("kw", [dict(epochs=2, skip_batches=1),
                                dict(epochs=None, max_batches=9,
                                     skip_batches=2)],
                         ids=["two_epochs_skip", "cycling_max_batches"])
def test_criteo_file_loader_matches_jax(criteo_path, kw):
    _assert_batches_equal(PL.CriteoFileLoader(criteo_path, VOCABS, 400, **kw),
                          JL.CriteoFileLoader(criteo_path, VOCABS, 400, **kw))


def test_csr_and_padded_bags_match_jax():
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 6, 40)
    values = rng.integers(0, 100, lengths.sum())
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for bag in (None, 3):
        got, n_got = PDATA.csr_to_padded(values, offsets, bag=bag, pad_idx=-1)
        want, n_want = JDATA.csr_to_padded(values, offsets, bag=bag,
                                           pad_idx=-1)
        assert n_got == n_want and got.dtype == want.dtype
        assert np.array_equal(got, want)
        for g, w in zip(PDATA.padded_to_csr(got), JDATA.padded_to_csr(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError):
        PDATA.csr_to_padded(values, offsets[::-1])


@pytest.mark.parametrize("bag", [None, 3])
def test_native_synthesizer_is_bitwise_jax(bag):
    kw = dict(vocab_sizes=(700, 300, 20), num_dense=5, batch_size=256,
              seed=2, bag=bag, nthreads=2)
    assert PS.native_synth_available()
    _assert_batches_equal(PS.NativeSyntheticCriteo(**kw).batches(3),
                          JS.NativeSyntheticCriteo(**kw).batches(3))


def test_file_writer_writes_the_scripts_bytes(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "make_criteo_file", REPO / "scripts" / "make_criteo_file.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = tmp_path / "script.txt"
    monkeypatch.setattr(sys, "argv", ["make_criteo_file.py", str(want),
                                      "--rows", "9000", "--vocab", "700",
                                      "--seed", "5"])
    script.main()
    got = tmp_path / "port.txt"
    criteo_file.main([str(got), "--rows", "9000", "--vocab", "700",
                      "--seed", "5"])
    assert got.read_bytes() == want.read_bytes()


def test_prefetch_loader_and_parallel_batches_keep_order_and_errors():
    items = [{"i": i} for i in range(7)]
    assert list(PL.PrefetchLoader(iter(items), depth=2)) == items

    def failing():
        yield {"i": 0}
        raise RuntimeError("producer failed")

    pf = PL.PrefetchLoader(failing())
    assert next(pf) == {"i": 0}
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)
    got = list(PL.parallel_batches(lambda w: iter([(w, j) for j in range(5)]),
                                   workers=3, depth=2))
    assert sorted(got) == [(w, j) for w in range(3) for j in range(5)]
    for w in range(3):                 # each worker's items in its order
        assert [j for v, j in got if v == w] == list(range(5))
    with pytest.raises(RuntimeError, match="producer failed"):
        list(PL.parallel_batches(lambda w: failing(), workers=2))


def test_device_prefetcher_on_the_cpu_is_a_thread_and_a_queue():
    host = [{"x": np.full(3, i, np.float32)} for i in range(5)]
    pf = ett.io.DevicePrefetcher(iter(host), lambda b: torch.as_tensor(
        b["x"]) * 2, depth=2, device="cpu")
    for want in host:
        batch, arg = next(pf)
        assert batch is want
        assert torch.equal(arg, torch.from_numpy(want["x"]) * 2)
    for _ in range(2):                 # stays exhausted
        with pytest.raises(StopIteration):
            next(pf)

    def boom(b):
        raise ValueError("put failed")

    with pytest.raises(ValueError, match="put failed"):
        next(ett.io.DevicePrefetcher(iter(host), boom))


def test_train_dlrm_with_device_prefetch_is_bitwise_without():
    cfg = ett.DLRMConfig(vocab_sizes=(13, 29, 7), num_dense=3, dim=8,
                         bottom_mlp=(16, 8), top_mlp=(16, 1))
    data = dict(vocab_sizes=cfg.vocab_sizes, num_dense=3, batch_size=32,
                seed=4)
    runs = [ett.train_dlrm(cfg, PDATA.SyntheticCriteo(**data).batches(), 5,
                           sparse_opt=ett.SparseRowWiseAdaGrad(0.1),
                           device_prefetch=n, log_every=1, verbose=False,
                           device="cpu") for n in (0, 2)]
    assert runs[0].losses == runs[1].losses
    for (k, a), (_, b) in zip(runs[0].model.state_dict().items(),
                              runs[1].model.state_dict().items()):
        assert torch.equal(a, b), k
