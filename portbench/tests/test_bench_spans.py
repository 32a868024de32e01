"""The attribution of device time to the program's spans (`spans.py`) on a
hand-made trace: one step of the loop, its kernels launched from the loop's
thread and (the backward) from a second thread, a prefetcher's copy on a
stream of its own, a full launch queue and a synchronize inside "step".
The readers that were there before read the same with the layer spans in
the trace as without them."""
import dataclasses

import pytest

from portbench import spans, spec, trace

iv = trace.Interval
LOOP, AUTOGRAD, PREFETCH = 11, 12, 13        # the runtime's thread ids
IDENT = 1001                                  # the loop's thread, as phases
STREAM, SIDE = 7, 22

LAYERS = [("step.lookup", 110, 200), ("step.forward", 200, 300),
          ("step.backward", 300, 500), ("step.sparse_update", 500, 800),
          ("update.sort", 520, 560), ("update.permute", 560, 600),
          ("update.scatter", 600, 700), ("step.dense_update", 800, 900)]

# (call, thread, call start, call end, device op, stream, duration): the
# device runs each stream's work in call order, from t = 2,000 on.
WORK = [
    ("cudaLaunchKernel", LOOP, 50, 60, "fill_kernel", STREAM, 5),       # data
    ("cudaMemcpyAsync", LOOP, 102, 104, "Memcpy DtoD", STREAM, 3),      # step
    ("cudaLaunchKernel", LOOP, 120, 125, "add_kernel", STREAM, 7),
    ("cudaLaunchKernel", LOOP, 150, 158, "gather_rows_vec_kernel", STREAM,
     40),
    ("cuLaunchKernelEx", LOOP, 210, 215, "sm90_gemm", STREAM, 100),
    ("cudaMemsetAsync", LOOP, 220, 222, "Memset (Device)", STREAM, 2),
    ("cudaLaunchKernel", AUTOGRAD, 310, 315, "sm90_gemm_bwd", STREAM, 200),
    ("cudaMemcpyAsync", PREFETCH, 400, 404, "Memcpy HtoD", SIDE, 30),
    ("cudaLaunchKernel", AUTOGRAD, 350, 356, "mul_kernel", STREAM, 11),
    ("cudaLaunchKernel", LOOP, 510, 516, "copy_kernel", STREAM, 13),
    ("cudaLaunchKernel", LOOP, 530, 534, "radixSort_kernel", STREAM, 17),
    ("cudaLaunchKernel", LOOP, 570, 575, "gather_rows_vec_kernel", STREAM,
     19),
    ("cudaLaunchKernel", LOOP, 610, 660, "runscatter_pieces", STREAM, 23),
    ("cudaLaunchKernel", LOOP, 670, 675, "runscatter_runs", STREAM, 29),
    ("cudaLaunchKernel", LOOP, 810, 815, "sgd_kernel", STREAM, 31),
]
# the driver's launch inside the runtime's (one enqueue), host-only calls,
# waits: a full queue inside the first run-scatter launch, a synchronize
# in the dense update, and the prefetcher's wait for its buffer (not the
# step's: that thread launches no kernel)
EXTRA = [iv("cuLaunchKernel", 151, 157, LOOP),
         iv("cudaStreamWaitEvent", 101, 102, LOOP),
         iv("Command Buffer Full", 620, 650, 0),
         iv("cudaStreamSynchronize", 850, 870, LOOP),
         iv("cudaEventSynchronize", 410, 480, PREFETCH)]


def _trace(layers=True, drop_launch=None, steps=1, drop_first_op=False):
    """`steps` steps of `WORK` 1,000 ns apart; `drop_launch`: the index of
    a call left out of the first step, `drop_first_op`: the first device
    record left out (as the profiler can lose it)."""
    host, device, t = [], [], {STREAM: 2000 * steps, SIDE: 2000 * steps}
    for k in range(steps):
        at = 1000 * k
        for i, (call, th, s, e, op, stream, dur) in enumerate(WORK):
            if not (k == 0 and i == drop_launch):
                host.append(iv(call, at + s, at + e, th))
            device.append(iv(op, t[stream], t[stream] + dur, stream))
            t[stream] += dur + 1
        host += [dataclasses.replace(h, start=at + h.start, end=at + h.end)
                 for h in EXTRA]
        host += [iv("phase.data", at, at + 100, IDENT),
                 iv("phase.step", at + 100, at + 1000, IDENT)]
        if layers:
            host += [iv(f"phase.{n}", at + s, at + e, IDENT)
                     for n, s, e in LAYERS]
    if drop_first_op:
        device = device[1:]
    return trace.Trace((0, 3000 * steps), device, host)


def _facts(tr, steps=1):
    return {"trace": tr, "traced_batches": list(range(steps)),
            "device_kind": "H100",
            "unique": [3], "n_ids": 5, "dim": 2, "adagrad": False,
            "phases": {"data": (4, 0.002), "step": (4, 0.004)},
            "event_s": 0.5, "event_steps": 10, "flops_per_step": 1e9,
            "world": 1}


def test_each_operation_lands_in_the_span_that_enqueued_it():
    got = [(d.name, n) for d, n in spans.attribute(_trace())]
    assert got == [
        ("fill_kernel", "phase.data"), ("Memcpy DtoD", "phase.step"),
        ("add_kernel", "phase.step.lookup"),
        ("gather_rows_vec_kernel", "phase.step.lookup"),
        ("sm90_gemm", "phase.step.forward"),
        ("Memset (Device)", "phase.step.forward"),
        ("sm90_gemm_bwd", "phase.step.backward"),
        ("mul_kernel", "phase.step.backward"),
        ("copy_kernel", "phase.step.sparse_update"),
        ("radixSort_kernel", "phase.update.sort"),
        ("gather_rows_vec_kernel", "phase.update.permute"),
        ("runscatter_pieces", "phase.update.scatter"),
        ("runscatter_runs", "phase.update.scatter"),
        ("sgd_kernel", "phase.step.dense_update")]


def test_self_times_launches_and_the_enqueue_cost():
    facts = _facts(_trace())
    s = spans.summary(facts)
    ms = 1e-6
    assert s["self_ms"] == pytest.approx({
        "step": 3 * ms, "step.lookup": 47 * ms, "step.forward": 102 * ms,
        "step.backward": 211 * ms, "step.sparse_update": 13 * ms,
        "update.sort": 17 * ms, "update.permute": 19 * ms,
        "update.scatter": 52 * ms, "step.dense_update": 31 * ms})
    # the step stream's time: the step's and the data phase's fill
    assert s["stream_ms"] == pytest.approx(sum(s["self_ms"].values())
                                           + 5 * ms)
    assert s["ops"] == 13
    assert s["misplaced"] == {"gather_rows": (2, 0), "run_scatter": (2, 0)}
    assert spans.self_ms(facts, "update.sort") == pytest.approx(17 * ms)
    # 900 ns in "step", less the full queue (30) and the synchronize (20)
    assert spans.enqueue_ms(facts) == pytest.approx(850 * ms)
    readers = {m: spec.load_module("metrics", m).read(facts) for m in (
        "lookup_ms.train", "forward_ms.train", "backward_ms.train",
        "sparse_update_ms.train", "update_sort_ms.train",
        "update_permute_ms.train", "update_scatter_ms.train",
        "dense_update_ms.train", "enqueue_ms.train", "launches.train")}
    assert readers == pytest.approx({
        "lookup_ms.train": 47 * ms, "forward_ms.train": 102 * ms,
        "backward_ms.train": 211 * ms, "sparse_update_ms.train": 13 * ms,
        "update_sort_ms.train": 17 * ms, "update_permute_ms.train": 19 * ms,
        "update_scatter_ms.train": 52 * ms, "dense_update_ms.train": 31 * ms,
        "enqueue_ms.train": 850 * ms, "launches.train": 13})


def test_a_misplaced_launch_is_counted():
    tr = _trace()
    # the lookup's gather enqueued after the lookup closed
    tr.host = [dataclasses.replace(h, start=205, end=207)
               if h.name == "cudaLaunchKernel" and h.start == 150 else h
               for h in tr.host]
    tr.host = [h for h in tr.host if h.name != "cuLaunchKernel"]
    assert spans.summary(_facts(tr))["misplaced"]["gather_rows"] == (2, 1)


def test_a_first_record_lost_pairs_from_the_last():
    # 10 steps, 130 kernels: one missing is under `spans.UNPAIRED`
    whole = spans.attribute(_trace(steps=10))
    lost = spans.attribute(_trace(steps=10, drop_first_op=True))
    assert [(d.name, n) for d, n in lost] == \
        [(d.name, n) for d, n in whole[1:]]
    facts = _facts(_trace(steps=10, drop_first_op=True), steps=10)
    assert spans.summary(facts)["misplaced"] == {"gather_rows": (20, 0),
                                                 "run_scatter": (20, 0)}
    assert spans.self_ms(facts, "step.lookup") == pytest.approx(47e-6)


def test_kernels_that_do_not_pair_with_launches_read_nothing():
    facts = _facts(_trace(drop_launch=4))
    assert spans.attribute(facts["trace"]) is None
    assert spans.summary(facts) is None
    assert spans.self_ms(facts, "step.forward") is None
    assert spans.launches(facts) is None
    # the parent's program: a step without layer spans
    parent = _facts(_trace(layers=False))
    assert spans.self_ms(parent, "step.lookup") is None
    assert spans.self_ms(parent, "step") == pytest.approx(
        sum(d for *_, stream, d in WORK[1:] if stream == STREAM) * 1e-6)
    assert spans.enqueue_ms(_facts(None)) is None


def test_the_readers_there_before_read_the_same():
    names = [m["name"] for m in spec.load_benchmark()["per_layer"]
             if m["source"] != "program_span"
             or m["name"] in ("data_wait_ms.train", "dispatch_ms.train")]
    assert len(names) == 8
    for name in names:
        read = spec.load_module("metrics", name).read
        assert read(_facts(_trace())) == read(_facts(_trace(layers=False)))
    with_layers, without = _trace(), _trace(layers=False)
    assert trace.busy_ns(with_layers) == trace.busy_ns(without)
    assert trace.kernel_time_by_name(with_layers) == \
        trace.kernel_time_by_name(without)
