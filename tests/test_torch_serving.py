"""The port's serving layer: `MicroBatcher`, `make_dlrm_service` against the
JAX package's service on the same weights and requests, and `serve_http`."""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embeddingtables_tpu.models import DLRMConfig as JaxConfig
from embeddingtables_tpu.models import init_dlrm as jax_init_dlrm
from embeddingtables_tpu.serving import make_dlrm_service as jax_service
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.serving import (MicroBatcher, _bucket,
                                               make_dlrm_service, serve_http)
from _torch_threads import _one_torch_thread  # noqa: F401


T, D = 3, 4


def ref_scores(dense, cat):
    # A per-example function: batching must be transparent.
    c = cat.astype(np.float32).reshape(cat.shape[0], cat.shape[1], -1)
    return dense.sum(axis=1) + c.sum(axis=(0, 2)) * 0.1


def make_batcher(**kw):
    sizes = []

    def predict(dense, cat):
        sizes.append(dense.shape[0])
        return ref_scores(dense, cat)

    kw.setdefault("max_latency_ms", 20.0)
    return MicroBatcher(predict, **kw), sizes


def req(rng, b):
    return (rng.normal(size=(b, D)).astype(np.float32),
            rng.integers(0, 50, (T, b)).astype(np.int32))


def test_bucket():
    assert [_bucket(n, 64) for n in (1, 2, 3, 5, 64, 100)] == \
        [1, 2, 4, 8, 64, 64]


def test_coalesces_pads_to_buckets_and_slices():
    mb, sizes = make_batcher(max_batch=64)
    rng = np.random.default_rng(0)
    reqs = [req(rng, b) for b in (1, 3, 2, 5, 1, 4)]
    futs = [mb.submit(d, c) for d, c in reqs]
    outs = [f.result(timeout=10) for f in futs]
    mb.stop()
    for (d, c), out in zip(reqs, outs):
        np.testing.assert_allclose(out, ref_scores(d, c), rtol=1e-6)
    st = mb.stats_snapshot()
    assert st["batches"] < len(reqs) and st["requests"] == len(reqs)
    assert st["examples"] == 16
    assert all(s & (s - 1) == 0 for s in sizes), sizes
    assert st["padded_examples"] == sum(sizes) - 16


def test_single_example_and_bags():
    mb, _ = make_batcher(max_batch=8)
    rng = np.random.default_rng(1)
    d = rng.normal(size=D).astype(np.float32)
    c = rng.integers(0, 50, T).astype(np.int32)
    np.testing.assert_allclose(mb.predict(d, c, timeout=10),
                               ref_scores(d[None], c[:, None]), rtol=1e-6)
    d2 = rng.normal(size=(2, D)).astype(np.float32)
    c2 = rng.integers(0, 50, (T, 2, 2)).astype(np.int32)
    assert mb.predict(d2, c2, timeout=10).shape == (2,)
    mb.stop()


def test_max_batch_carries_over_and_rejects_oversize():
    mb, sizes = make_batcher(max_batch=4)
    rng = np.random.default_rng(2)
    reqs = [req(rng, 3) for _ in range(3)]   # 3 + 3 > 4: carried over
    futs = [mb.submit(d, c) for d, c in reqs]
    for (d, c), f in zip(reqs, futs):
        np.testing.assert_allclose(f.result(timeout=10), ref_scores(d, c),
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        mb.submit(*req(rng, 5))
    with pytest.raises(ValueError):
        mb.submit(np.zeros((2, D), np.float32), np.zeros((T, 3), np.int32))
    mb.stop()
    assert mb.stats.batches == 3


def test_stop_drains_queued_work_then_refuses():
    def slow(dense, cat):
        time.sleep(0.02)
        return ref_scores(dense, cat)

    mb = MicroBatcher(slow, max_batch=2, max_latency_ms=1.0)
    rng = np.random.default_rng(3)
    futs = [mb.submit(*req(rng, 2)) for _ in range(5)]
    mb.stop(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)
    assert not mb._worker.is_alive()
    with pytest.raises(RuntimeError):
        mb.submit(*req(rng, 1))


def test_stop_without_drain_fails_what_is_left():
    gate = threading.Event()

    def blocked(dense, cat):
        gate.wait(10)
        return ref_scores(dense, cat)

    mb = MicroBatcher(blocked, max_batch=1, max_latency_ms=1.0)
    rng = np.random.default_rng(4)
    futs = [mb.submit(*req(rng, 1)) for _ in range(4)]
    time.sleep(0.05)
    stopper = threading.Thread(target=mb.stop, kwargs=dict(drain=False))
    stopper.start()
    gate.set()
    stopper.join(15)
    assert not stopper.is_alive()
    for f in futs:                            # each resolves one way or other
        exc = f.exception(timeout=10)
        assert exc is None or isinstance(exc, RuntimeError)
    assert any(f.exception() is not None for f in futs)


def test_concurrent_clients_all_correct():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        mb, _ = make_batcher(max_batch=128, max_latency_ms=5.0)
        rng = np.random.default_rng(5)
        reqs = [req(rng, int(rng.integers(1, 6))) for _ in range(32)]
        results = {}

        def client(i):
            results[i] = mb.predict(*reqs[i], timeout=30)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        mb.stop()
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 32 and mb.stats.requests == 32
    for i, (d, c) in enumerate(reqs):
        np.testing.assert_allclose(results[i], ref_scores(d, c), rtol=1e-6)


def test_predictor_error_fans_out_to_every_future():
    def boom(dense, cat):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(boom, max_batch=8, max_latency_ms=20.0)
    futs = [mb.submit(np.zeros((1, D), np.float32),
                      np.zeros((T, 1), np.int32)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    mb.stop()


# ---------------------------------------------------------------------------
# The DLRM service against the JAX package's
# ---------------------------------------------------------------------------

def _models(**kw):
    kw = dict(dict(vocab_sizes=(40, 60, 25), num_dense=3, dim=8,
                   bottom_mlp=(16, 8), top_mlp=(16, 1)), **kw)
    jm = jax_init_dlrm(jax.random.key(0),
                       JaxConfig(**kw, compute_dtype=jnp.float32))
    pcfg = ett.DLRMConfig(**kw, compute_dtype=torch.float32)

    def arrays(layers):
        return [(np.asarray(w), np.asarray(b)) for w, b in layers]

    pm = ett.dlrm_from_arrays(pcfg, arrays(jm.bottom), arrays(jm.top),
                              np.asarray(jm.tables.data), jm.tables.offsets,
                              device="cpu")
    return jm, pm


@pytest.mark.parametrize("bag", [None, 2])
def test_dlrm_service_matches_jax_service(bag):
    jm, pm = _models(bag=bag)
    rng = np.random.default_rng(6)
    reqs = []
    for b in (1, 5, 3, 8):
        shape = (b,) if bag is None else (b, bag)
        reqs.append((rng.normal(size=(b, 3)).astype(np.float32),
                     np.stack([rng.integers(0, v, shape).astype(np.int32)
                               for v in pm.config.vocab_sizes])))
    ours = make_dlrm_service(pm, max_batch=8, max_latency_ms=5.0)
    theirs = jax_service(jm, max_batch=8, max_latency_ms=5.0)
    try:
        got = [f.result(timeout=60) for f in
               [ours.submit(d, c) for d, c in reqs]]
        want = [theirs.predict(d, c, timeout=60) for d, c in reqs]
    finally:
        ours.stop()
        theirs.stop()
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw,item", [(dict(mesh=object()), "item I"),
                                     (dict(mesh=object(), quantized=True),
                                      "single-chip")])
def test_service_options_not_ported_yet_raise(kw, item):
    _, pm = _models()
    with pytest.raises(NotImplementedError, match=item):
        make_dlrm_service(pm, **kw)


def test_http_roundtrip_over_the_dlrm_service():
    jm, pm = _models()
    svc = make_dlrm_service(pm, max_batch=16)
    server = serve_http(svc)
    port = server.server_address[1]
    try:
        rng = np.random.default_rng(7)
        d = rng.normal(size=(3, 3)).astype(np.float32)
        c = np.stack([rng.integers(0, v, 3) for v in pm.config.vocab_sizes])
        body = json.dumps({"dense": d.tolist(), "cat": c.tolist()}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"}), timeout=30)
        scores = np.asarray(json.loads(r.read())["scores"], np.float32)
        want = np.asarray(ett.dlrm_forward(pm, d, c.astype(np.int32)).detach())
        np.testing.assert_allclose(scores, want, rtol=1e-6, atol=1e-7)

        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=30).read())
        assert stats["requests"] == 1 and stats["bucket_sizes"] == [4]

        for path, data, code in (("predict", b"{}", 400),
                                 ("nowhere", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/{path}", data=data), timeout=30)
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
