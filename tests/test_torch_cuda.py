"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here is marked `cuda` and skips without a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from embeddingtables_tpu_torch.ops.cuda import gather as G


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 64, 36])
def test_cuda_gather_rows_bitwise(cuda_device, dtype, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    v = 5000
    tab = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(-v - 3, v + 3, (4099,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    before = G.gather_rows.launches
    got = G.gather_rows(tab, idx)
    assert G.gather_rows.launches == before + 1
    want = G.gather_rows_plain(tab, idx)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bag", [1, 8, 32])
def test_cuda_gather_bags_matches_plain(cuda_device, dtype, bag):
    g = torch.Generator(device=cuda_device).manual_seed(bag)
    v, d = 5000, 128
    tab = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(-v, v + 2, (777, bag), generator=g,
                        device=cuda_device, dtype=torch.int32)
    got = G.gather_bags(tab, idx).float()
    want = G.gather_bags_plain(tab, idx).float()
    # Same f32 additions in the same order: equal up to summation order.
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_wrappers_reject_ids_on_another_device(cuda_device):
    tab = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError):
        G.gather_rows(tab, torch.zeros(3, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bag", [None, 3])
def test_cuda_dlrm_forward_matches_the_cpu_forward(cuda_device, bag):
    import embeddingtables_tpu_torch as ett
    cfg = ett.DLRMConfig(vocab_sizes=(300, 500, 200), num_dense=5, dim=32,
                         bottom_mlp=(64, 32), top_mlp=(64, 1), bag=bag,
                         compute_dtype=torch.float32)
    cpu = ett.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = ett.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = gpu.to(cuda_device)
    g = torch.Generator().manual_seed(1)
    dense = torch.randn((64, 5), generator=g)
    shape = (64,) if bag is None else (64, bag)
    cat = torch.stack([torch.randint(0, v, shape, generator=g, dtype=torch.int32)
                       for v in cfg.vocab_sizes])
    kern = G.gather_rows if bag is None else G.gather_bags
    before = kern.launches
    got = ett.make_eval_step(cfg)(gpu, dense, cat)
    assert kern.launches == before + 1 and got.device.type == "cuda"
    want = ett.make_eval_step(cfg)(cpu, dense, cat)
    # f32 towers on both (TF32 off by default for matmuls): summation order.
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The update kernels: scatter_add_rows_sorted and hot_accumulate
# ---------------------------------------------------------------------------

from embeddingtables_tpu_torch.ops.cuda import _lib  # noqa: E402
from embeddingtables_tpu_torch.ops.cuda import scatter as S  # noqa: E402
from embeddingtables_tpu_torch.ops.cuda import segsum as H  # noqa: E402


def _sorted_rows(g, device, n, v, zipf):
    """Ascending int32 rows with padding (< 0), rows >= V and, under
    `zipf`, long runs on a few hot rows, the hottest spanning many of the
    run-scatter's windows."""
    if zipf:
        hot = torch.randint(0, v, (8,), generator=g, device=device)
        pick = torch.randint(0, 8, (n,), generator=g, device=device)
        pick = torch.where(torch.rand((n,), generator=g, device=device) < 0.4,
                           0, pick)
        cold = torch.randint(0, v, (n,), generator=g, device=device)
        coin = torch.rand((n,), generator=g, device=device) < 0.6
        rows = torch.where(coin, hot[pick], cold)
    else:
        rows = torch.randint(0, v, (n,), generator=g, device=device)
    special = torch.rand((n,), generator=g, device=device)
    rows = torch.where(special < 0.05, -1, rows)
    rows = torch.where(special > 0.97, v + 5, rows)
    return torch.sort(rows.to(torch.int32), stable=True).values


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("d", [128, 36, 7])
@pytest.mark.parametrize("zipf", [False, True])
def test_cuda_scatter_add_rows_sorted_matches_plain(cuda_device, dtype,
                                                    adagrad, d, zipf):
    g = torch.Generator(device=cuda_device).manual_seed(d + 2 * zipf)
    v, n = 3000, 20_000
    rows = _sorted_rows(g, cuda_device, n, v, zipf)
    vals = torch.randn((n, d), generator=g, device=cuda_device)
    table = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    accum = (torch.rand((v,), generator=g, device=cuda_device)
             if adagrad else None)
    t_k, t_p = table.clone(), table.clone()
    a_k = None if accum is None else accum.clone()
    a_p = None if accum is None else accum.clone()
    before = S.scatter_add_rows_sorted.launches
    S.scatter_add_rows_sorted(t_k, rows, vals, -0.05, accum=a_k, eps=1e-8)
    assert S.scatter_add_rows_sorted.launches == before + 1
    S.scatter_add_rows_sorted_plain(t_p, rows, vals, -0.05, accum=a_p, eps=1e-8)
    torch.cuda.synchronize()
    if not adagrad:
        # The same f32 additions in the same order, one rounding: bitwise.
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(t_k.view(bits), t_p.view(bits))
    else:
        # The mean's reduction order and rsqrt's last bits: rtol 1e-6 in
        # f32, which can flip one bf16 rounding (at most 2^-7 relative).
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(t_k.float(), t_p.float(), rtol=tol,
                                   atol=1e-6)
        torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=0)
    untouched = torch.ones(v, dtype=torch.bool, device=cuda_device)
    ok = (rows >= 0) & (rows < v)
    untouched[rows[ok].long()] = False
    assert torch.equal(t_k[untouched], table[untouched])
    if zipf:
        runs = torch.unique_consecutive(rows[ok], return_counts=True)[1]
        assert int(runs.max()) > 16 * S.RUN_WINDOW


def _window_edge_rows(device, v):
    """Runs placed on the window edges (L = RUN_WINDOW), three times over:
    runs of L and L + 1, one starting at L - 1 (mod L) over five windows, one
    filling a window; padding before the first edge, rows >= V at the end."""
    w = S.RUN_WINDOW
    lengths = [w // 4, w, w + 1, w - 2 - w // 4, 3 * w + 5, w - 4, w, 1, 2, 3,
               w + 1, 7, w - 14]
    ids = torch.arange(3 * len(lengths), dtype=torch.int32) * 7
    ids[0] = -1
    rows = torch.repeat_interleave(ids, torch.tensor(lengths * 3))
    return torch.cat([rows, torch.full((5,), v, dtype=torch.int32)]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adagrad", [False, True])
def test_cuda_scatter_window_edges_match_plain(cuda_device, dtype, adagrad):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    v, d = 300, 128
    rows = _window_edge_rows(cuda_device, v)
    vals = torch.randn((rows.numel(), d), generator=g, device=cuda_device)
    table = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    accum = (torch.rand((v,), generator=g, device=cuda_device)
             if adagrad else None)
    t_k, t_p = table.clone(), table.clone()
    a_k = None if accum is None else accum.clone()
    a_p = None if accum is None else accum.clone()
    S.scatter_add_rows_sorted(t_k, rows, vals, -0.05, accum=a_k, eps=1e-8)
    S.scatter_add_rows_sorted_plain(t_p, rows, vals, -0.05, accum=a_p, eps=1e-8)
    torch.cuda.synchronize()
    if not adagrad:
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(t_k.view(bits), t_p.view(bits))
    else:
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(t_k.float(), t_p.float(), rtol=tol,
                                   atol=1e-6)
        torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_scatter_empty_stream_launches_nothing(cuda_device):
    table = torch.ones((10, 128), device=cuda_device)
    before = S.scatter_add_rows_sorted.launches
    S.scatter_add_rows_sorted(table, torch.zeros(0, dtype=torch.int32,
                                                 device=cuda_device),
                              torch.zeros((0, 128), device=cuda_device))
    assert S.scatter_add_rows_sorted.launches == before
    assert torch.equal(table, torch.ones_like(table))


@pytest.mark.cuda
# 1024 and 2048 segments take 16- and 8-column slices: the cluster
# reduction's four-word and one-word paths.
@pytest.mark.parametrize("segments", [128, 384, 512, 1024, 2048])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_cuda_hot_accumulate_matches_plain(cuda_device, segments, compute):
    g = torch.Generator(device=cuda_device).manual_seed(segments)
    n, d = 50_000, 256
    rows = torch.randint(-10, segments + 50, (n,), generator=g,
                         device=cuda_device, dtype=torch.int32)
    vals = torch.randn((n, d), generator=g, device=cuda_device)
    before = H.hot_accumulate.launches
    got = H.hot_accumulate(rows, vals, segments, compute_dtype=compute)
    assert H.hot_accumulate.launches == before + 1
    want = H.hot_accumulate_plain(rows, vals, segments, compute)
    mag = H.hot_accumulate_plain(rows, vals.abs(), segments, compute)
    # Atomics add in a varying order: f32 rounding of the summed magnitude.
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())
    if segments == 128:
        # Zipf ids into a 3-row table padded to 128 segments: long stretches
        # of equal ids pile onto three rows.
        p = torch.tensor([0.57, 0.26, 0.17], device=cuda_device)
        rows = torch.multinomial(p, n, replacement=True, generator=g)
        rows = rows.to(torch.int32)
        got = H.hot_accumulate(rows, vals, segments, compute_dtype=compute)
        want = H.hot_accumulate_plain(rows, vals, segments, compute)
        mag = H.hot_accumulate_plain(rows, vals.abs(), segments, compute)
        assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())
        assert bool((got[3:] == 0).all())


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda_device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(S, "scatter_add_rows_sorted_plain", refuse)
    monkeypatch.setattr(H, "hot_accumulate_plain", refuse)
    table = torch.zeros((64, 128), device=cuda_device)
    rows = torch.tensor([3, 1, 3, 70, -1], dtype=torch.int32,
                        device=cuda_device)
    vals = torch.ones((5, 128), device=cuda_device)
    S.scatter_update(table, rows, vals, 2.0)
    assert float(table[3, 0]) == 4.0 and float(table[1, 0]) == 2.0
    out = H.hot_accumulate(rows, vals, 128, compute_dtype=torch.float32)
    assert float(out[3, 0]) == 2.0 and float(out.sum()) == 4 * 128


@pytest.mark.cuda
def test_cuda_a_failed_library_load_raises(cuda_device, monkeypatch, tmp_path):
    broken = tmp_path / "broken.so"
    broken.write_bytes(b"not a shared library")
    monkeypatch.setattr(_lib, "_libs", {})
    monkeypatch.setattr(_lib, "build", lambda names=None: {"scatter": broken})
    with pytest.raises(OSError):
        S.scatter_add_rows_sorted(
            torch.zeros((4, 128), device=cuda_device),
            torch.zeros(2, dtype=torch.int32, device=cuda_device),
            torch.zeros((2, 128), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adagrad_indexer", "adagrad_dense"])
def test_cuda_train_step_matches_the_cpu_step(cuda_device, opt):
    import embeddingtables_tpu_torch as ett
    cfg = ett.DLRMConfig(vocab_sizes=(300, 5000, 200), num_dense=5, dim=128,
                         bottom_mlp=(64, 128), top_mlp=(64, 1),
                         compute_dtype=torch.float32)
    make = {"sgd": lambda: ett.SparseSGD(0.1),
            "adagrad_indexer": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="indexer"),
            "adagrad_dense": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="dense")}[opt]
    cpu = ett.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        sparse_opt=make())
    gpu = ett.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu",
                        sparse_opt=make()).to(cuda_device)
    g = torch.Generator().manual_seed(1)
    dense = torch.randn((256, 5), generator=g)
    cat = torch.stack([torch.randint(0, v, (256,), generator=g,
                                     dtype=torch.int32)
                       for v in cfg.vocab_sizes])
    label = torch.randint(0, 2, (256,), generator=g).float()
    before = S.scatter_add_rows_sorted.launches
    loss_g = ett.make_train_step(cfg, sparse_opt=make())(gpu, dense, cat, label)
    assert S.scatter_add_rows_sorted.launches == before + (opt != "adagrad_dense")
    loss_c = ett.make_train_step(cfg, sparse_opt=make())(cpu, dense, cat, label)
    # f32 towers on both: summation order only.
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gpu.tables.data.cpu(), cpu.tables.data,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gpu.emb_state.accum.cpu(), cpu.emb_state.accum,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_cuda_ensemble_update_takes_hot_accumulate_on_tiny_tables(cuda_device):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tables = [ett.SimpleEmbedding(torch.randn((v, 128), generator=g,
                                              device=cuda_device))
              for v in (10, 400, 3000)]
    upds = [ett.SparseEmbeddingUpdate(
        delta=torch.randn((512, 128), generator=g, device=cuda_device),
        indices=torch.randint(0, t.spec.vocab, (512,), generator=g,
                              device=cuda_device)) for t in tables]
    cpu = [ett.SimpleEmbedding(t.data.cpu()) for t in tables]
    cpu_upds = [ett.SparseEmbeddingUpdate(u.delta.cpu(), u.indices.cpu())
                for u in upds]
    hot, run = H.hot_accumulate.launches, S.scatter_add_rows_sorted.launches
    ett.ensemble_update(ett.SparseSGD(0.1), tables, upds)
    assert H.hot_accumulate.launches == hot + 2
    assert S.scatter_add_rows_sorted.launches == run + 1
    ett.ensemble_update(ett.SparseSGD(0.1), cpu, cpu_upds)
    for t, c in zip(tables, cpu):
        torch.testing.assert_close(t.data.cpu(), c.data, rtol=1e-5, atol=1e-5)
