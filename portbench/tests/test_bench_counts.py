"""The yardstick's arithmetic against hand counts at small shapes: model
FLOPs, the kernels' byte needs, and the reduction of a trace to busy time,
idle gaps and per-layer readings."""
import pytest

from portbench import readings, roofline, trace
from portbench.reference import dcn, dlrm


def test_dlrm_forward_flops_by_hand():
    cfg = {"num_dense": 13, "dim": 8, "bottom_mlp": [16, 8],
           "top_mlp": [32, 1], "vocab_sizes": [5, 5, 5]}
    # bottom 13*16 + 16*8; pairs of 4 vectors: 6, so top in = 8 + 6
    macs = 13 * 16 + 16 * 8 + (8 + 6) * 32 + 32 * 1 + 6 * 8
    assert dlrm.forward_flops(cfg) == 2 * macs


def test_dlrm_mlperf_step_flops():
    cfg = {"num_dense": 13, "dim": 128, "bottom_mlp": [512, 256, 128],
           "top_mlp": [1024, 1024, 512, 256, 1], "vocab_sizes": [1] * 26}
    step = 3 * dlrm.forward_flops(cfg) * 65536
    assert step == pytest.approx(0.95e12, rel=0.01)


def test_dcn_forward_flops_by_hand():
    cfg = {"num_dense": 3, "dim": 4, "vocab_sizes": [7, 7], "num_cross": 2,
           "cross_rank": 5, "deep_mlp": [6, 2]}
    f = 2 * 4 + 3
    macs = 2 * (2 * f * 5) + f * 6 + 6 * 2 + 2 * 1
    assert dcn.forward_flops(cfg) == 2 * macs
    big = {"num_dense": 13, "dim": 128, "vocab_sizes": [1] * 26,
           "num_cross": 3, "cross_rank": 512,
           "deep_mlp": [1024, 1024, 512, 256]}
    assert 3 * dcn.forward_flops(big) * 65536 == pytest.approx(6.05e12,
                                                               rel=0.01)


def test_byte_needs_by_hand():
    assert roofline.gather_rows_bytes(10, 4, 8) == 4 * 8 * 4 + 40 + 10 * 32
    assert roofline.run_scatter_bytes(10, 4, 8, False) == \
        10 * 8 * 4 + 40 + 2 * 4 * 32
    assert roofline.run_scatter_bytes(10, 4, 8, True) == \
        roofline.run_scatter_bytes(10, 4, 8, False) + 32
    assert roofline.train_step_gather_bytes(10, 4, 8) == \
        roofline.gather_rows_bytes(10, 4, 8) + roofline.gather_rows_bytes(
            10, 10, 8)
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes") == 3.35e12
    assert roofline.peak("NVIDIA A100", "hbm_bytes") is None


def _trace():
    iv = trace.Interval
    device = [iv("void gather_rows_vec_kernel<4>", 100, 200, 7),
              iv("sm90_gemm", 150, 300, 7),
              iv("runscatter_pieces_kernel", 400, 450, 9),
              iv("Memcpy HtoD", 460, 500, 11)]
    host = [iv("phase.step", 0, 380, 1), iv("cudaLaunchKernel", 320, 340, 1),
            iv("phase.data", 380, 1000, 1)]
    return trace.Trace((0, 1000), device, host)


def test_union_busy_and_idle_gaps():
    tr = _trace()
    assert trace.union([(1, 3), (2, 5), (7, 8)], 0, 10) == [(1, 5), (7, 8)]
    assert trace.gaps([(1, 5), (7, 8)], 0, 10) == [(0, 1), (5, 7), (8, 10)]
    assert trace.busy_ns(tr) == 200 + 50 + 40
    gaps = dict(trace.idle_by_host(tr))
    # idle [0, 100) and [300, 400) (its middle, 350, is past the launch)
    # under phase.step; [450, 460) and [500, 1000) under phase.data
    assert gaps["phase.step"] == pytest.approx((100 + 100) / 1e9)
    assert gaps["phase.data"] == pytest.approx((10 + 500) / 1e9)
    names = [n for n, _ in trace.kernel_time_by_name(tr)]
    assert "Memcpy HtoD" not in names and names[0] == "sm90_gemm"


def test_readers_on_a_trace():
    facts = {"trace": _trace(), "traced_batches": [0], "device_kind": "H100",
             "unique": [3], "n_ids": 5, "dim": 2, "adagrad": False,
             "phases": {"data": (4, 0.002)}}
    assert readings.idle_share(facts) == pytest.approx(100 * (1 - 0.29))
    assert readings.per_traced_step_ms(facts, hand=True) == \
        pytest.approx((100 + 50) / 1e6)
    assert readings.per_traced_step_ms(facts, hand=False) == \
        pytest.approx(150 / 1e6)
    assert readings.phase_ms(facts, "data") == pytest.approx(0.5)
    assert readings.phase_ms(facts, "step") is None
    ks = readings.kernels(facts, kernel="run_scatter")
    share = readings.bandwidth_share(facts, 3.35e12 * 50e-9, ks)
    assert share == pytest.approx(100.0)
    assert readings.idle_share({"trace": None}) is None
