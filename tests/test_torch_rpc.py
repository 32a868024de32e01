"""The port's binary RPC transport against the JAX package's, on the CPU.

  - Frames byte for byte equal to JAX's (`pack_request`, `pack_response`,
    `read_frame`), for every dtype of the wire.
  - A port server answers a JAX client, and a JAX server a port client.
  - Routing by model name, pipelining with responses out of order, a hot
    swap under load, errors returned to the client, and a client that fails
    fast once the server is gone.

Every wait has a timeout of at most 10 s, so a fault fails a test instead of
holding a worker.
"""
import socket
import threading

import numpy as np
import pytest
import torch

from embeddingtables_tpu import rpc as JR
from embeddingtables_tpu import serving as JSERV
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import rpc as PR
from embeddingtables_tpu_torch.serving import MicroBatcher
from _torch_threads import _one_torch_thread  # noqa: F401

WAIT = 10.0


def _arrays():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-5, 5, (2, 3, 2)).astype(np.int32),
            np.arange(5, dtype=np.int64), np.ones(2, np.float16),
            np.frombuffer(b"abc", np.uint8), np.zeros((0, 2), np.float64)]


def test_frames_are_byte_equal_to_jax():
    arrays = _arrays()
    for op in (PR.OP_PREDICT, PR.OP_STATS, PR.OP_LIST, PR.OP_PING):
        assert PR.pack_request(7, op, "dlrm", arrays) == \
            JR.pack_request(7, op, "dlrm", arrays)
    assert PR.pack_response(9, arrays) == JR.pack_response(9, arrays)
    assert PR.pack_response(9, error="KeyError: x") == \
        JR.pack_response(9, error="KeyError: x")
    frame = PR.pack_request(3, PR.OP_PREDICT, "m", arrays)
    a, b = socket.socketpair()
    try:
        a.settimeout(WAIT)
        b.settimeout(WAIT)
        a.sendall(frame + frame)
        got_p, got_j = PR.read_frame(b), JR.read_frame(b)
        assert bytes(got_p) == bytes(got_j) == frame[4:]
        off, out = 4 + 6 + 1 + 1, []        # header, name "m", narr
        for _ in arrays:
            arr, off = PR._unpack_array(memoryview(frame), off)
            out.append(arr)
        for x, y in zip(out, arrays):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    finally:
        a.close()
        b.close()
    with pytest.raises(TypeError):
        PR.pack_response(1, [np.zeros(2, np.int16)])


def _dlrm_service():
    cfg = ett.DLRMConfig(vocab_sizes=(13, 29, 7), num_dense=3, dim=8,
                         bottom_mlp=(16, 8), top_mlp=(16, 1),
                         compute_dtype=torch.float32)
    model = ett.init_dlrm(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    svc = ett.make_dlrm_service(model, max_batch=64, max_latency_ms=2.0)
    return cfg, model, svc


def _request(rng, b, vocabs=(13, 29, 7)):
    return (rng.standard_normal((b, 3)).astype(np.float32),
            np.stack([rng.integers(0, v, b) for v in vocabs]).astype(np.int32))


def test_port_server_answers_a_jax_client():
    cfg, model, svc = _dlrm_service()
    server = PR.serve_rpc({"dlrm": svc})
    client = JR.RPCClient(*server.address, timeout=WAIT)
    try:
        rng = np.random.default_rng(1)
        reqs = [_request(rng, b) for b in (1, 5, 17, 3)]
        futs = [client.submit("dlrm", d, c) for d, c in reqs]
        for (d, c), fut in zip(reqs, futs):
            want = ett.make_eval_step(cfg)(model, d, c).numpy()
            np.testing.assert_allclose(fut.result(WAIT), want, rtol=1e-6,
                                       atol=1e-6)
        assert client.list_models() == ["dlrm"] and client.ping()
        assert client.stats("dlrm")["requests"] == 4
    finally:
        client.close()
        server.stop()
        server.router.stop_all()


def test_jax_server_answers_a_port_client():
    def predict(dense, cat):
        return dense.sum(axis=1), cat[0].astype(np.int32)

    batcher = JSERV.MicroBatcher(predict, max_batch=32, max_latency_ms=1.0)
    server = JR.serve_rpc({"sum": batcher})
    client = PR.RPCClient(*server.address, timeout=WAIT)
    try:
        rng = np.random.default_rng(2)
        d, c = _request(rng, 6)
        scores, ids = client.predict("sum", d, c, timeout=WAIT)
        np.testing.assert_allclose(scores, d.sum(axis=1), rtol=1e-6)
        assert ids.dtype == np.int32 and np.array_equal(ids, c[0])
        assert client.list_models(timeout=WAIT) == ["sum"]
        with pytest.raises(RuntimeError, match="unknown model"):
            client.predict("nope", d, c, timeout=WAIT)
    finally:
        client.close()
        server.stop()
        server.router.stop_all()


def test_routing_pipelining_out_of_order_and_errors():
    gate = threading.Event()

    def slow(dense, cat):
        assert gate.wait(WAIT)
        return dense[:, 0]

    router = PR.ModelRouter()
    router.register("slow", MicroBatcher(slow, max_batch=8,
                                         max_latency_ms=1.0))
    router.register("fast", MicroBatcher(lambda d, c: d[:, 1], max_batch=8,
                                         max_latency_ms=1.0))
    server = PR.serve_rpc(router)
    client = PR.RPCClient(*server.address, timeout=WAIT)
    try:
        rng = np.random.default_rng(3)
        d, c = _request(rng, 2)
        first = client.submit("slow", d, c)
        fast = [client.submit("fast", d, c) for _ in range(5)]
        for f in fast:                         # answered before the first
            np.testing.assert_array_equal(f.result(WAIT), d[:, 1])
        assert not first.done()
        gate.set()
        np.testing.assert_array_equal(first.result(WAIT), d[:, 0])
        assert router.names() == ["fast", "slow"]
        with pytest.raises(RuntimeError, match="KeyError"):
            client.predict("missing", d, c, timeout=WAIT)
        with pytest.raises(RuntimeError, match="ValueError"):
            client.predict("fast", d, c[:, :1], timeout=WAIT)
        with pytest.raises(RuntimeError, match="exceeds max_batch"):
            client.predict("fast", *_request(rng, 9), timeout=WAIT)
    finally:
        gate.set()
        client.close()
        server.stop()
        router.stop_all()


def test_hot_swap_under_load_loses_no_request():
    router = PR.ModelRouter()
    router.register("m", MicroBatcher(lambda d, c: d[:, 0] * 0 + 1.0,
                                      max_batch=16, max_latency_ms=1.0))
    server = PR.serve_rpc(router)
    clients = [PR.RPCClient(*server.address, timeout=WAIT) for _ in range(3)]
    rng = np.random.default_rng(4)
    d, c = _request(rng, 2)
    try:
        futs = []
        for i in range(60):
            if i == 30:
                router.register("m", MicroBatcher(
                    lambda d, c: d[:, 0] * 0 + 2.0, max_batch=16,
                    max_latency_ms=1.0))
            futs.append(clients[i % 3].submit("m", d, c))
        got = [float(f.result(WAIT)[0]) for f in futs]
        assert set(got) <= {1.0, 2.0} and got[-1] == 2.0
        router.unregister("m")
        with pytest.raises(RuntimeError, match="unknown model"):
            clients[0].predict("m", d, c, timeout=WAIT)
    finally:
        for cl in clients:
            cl.close()
        server.stop()
        router.stop_all()


def test_client_fails_fast_after_the_server_stops():
    router = PR.ModelRouter()
    router.register("m", MicroBatcher(lambda d, c: d[:, 0], max_batch=8))
    server = PR.serve_rpc(router)
    client = PR.RPCClient(*server.address, timeout=WAIT)
    try:
        assert client.ping(timeout=WAIT)
        server.stop()
        client._reader.join(WAIT)
        assert not client._reader.is_alive()
        d, c = _request(np.random.default_rng(5), 1)
        with pytest.raises(ConnectionError):
            client.submit("m", d, c)
    finally:
        client.close()
        router.stop_all()
