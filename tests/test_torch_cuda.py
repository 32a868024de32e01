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
@pytest.mark.parametrize("d", [128, 36, 7, 1, 32, 64, 129, 258, 4096,
                               2, 4, 8, 12, 16])
@pytest.mark.parametrize("zipf", [False, True])
def test_cuda_scatter_add_rows_sorted_matches_plain(cuda_device, dtype,
                                                    adagrad, d, zipf):
    # Every width class: narrow (1, 2, 4, 7, 8, 12, 16, 32, 36, 64; at 4 and
    # 8 one and two 16-byte units, P = 1 and 2), 32-128 units (128) and wide
    # (129, 258, 4096).
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
@pytest.mark.parametrize("d", [128, 1, 64, 258])
def test_cuda_scatter_window_edges_match_plain(cuda_device, dtype, adagrad,
                                               d):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    v = 300
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
@pytest.mark.parametrize("d, width_class", [(1, "narrow"), (64, "narrow"),
                                            (128, "mid"), (129, "wide"),
                                            (4096, "wide")])
def test_cuda_scatter_counts_one_launch_by_width_class(cuda_device, d,
                                                       width_class):
    # One wrapper call, AdaGrad epilogue: one count, under its width class,
    # two device kernels, and the plain version's result (a 4,096-wide row
    # in one pass).
    g = torch.Generator(device=cuda_device).manual_seed(d)
    v = 500
    rows = _sorted_rows(g, cuda_device, 6000, v, True)
    vals = torch.randn((rows.numel(), d), generator=g, device=cuda_device)
    table = torch.randn((v, d), generator=g, device=cuda_device)
    accum = torch.rand((v,), generator=g, device=cuda_device)
    t_k, t_p, a_k, a_p = table.clone(), table.clone(), accum.clone(), accum.clone()
    before = S.scatter_add_rows_sorted.launches
    classes = dict(S.scatter_add_rows_sorted.classes)
    S.scatter_add_rows_sorted(t_k, rows, vals, -0.05, accum=a_k, eps=1e-8)
    assert S.scatter_add_rows_sorted.launches == before + 1
    after = dict(S.scatter_add_rows_sorted.classes)
    assert after.pop(width_class) == classes.pop(width_class, 0) + 1
    assert after == classes
    assert S.scatter_add_rows_sorted.kernels == 2
    S.scatter_add_rows_sorted_plain(t_p, rows, vals, -0.05, accum=a_p, eps=1e-8)
    torch.cuda.synchronize()
    torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=1e-6)
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
@pytest.mark.parametrize("opt", ["sgd", "adagrad_indexer", "adagrad_dense",
                                 "lazy_adam", "ftrl"])
def test_cuda_train_step_matches_the_cpu_step(cuda_device, opt):
    import embeddingtables_tpu_torch as ett
    cfg = ett.DLRMConfig(vocab_sizes=(300, 5000, 200), num_dense=5, dim=128,
                         bottom_mlp=(64, 128), top_mlp=(64, 1),
                         compute_dtype=torch.float32)
    make = {"sgd": lambda: ett.SparseSGD(0.1),
            "adagrad_indexer": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="indexer"),
            "adagrad_dense": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="dense"),
            "lazy_adam": lambda: ett.SparseLazyAdam(0.01),
            "ftrl": lambda: ett.SparseFTRL(0.1, l1=0.01)}[opt]
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
    assert S.scatter_add_rows_sorted.launches == before + (
        opt in ("sgd", "adagrad_indexer"))
    loss_c = ett.make_train_step(cfg, sparse_opt=make())(cpu, dense, cat, label)
    # f32 towers on both: summation order only.
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gpu.tables.data.cpu(), cpu.tables.data,
                               rtol=1e-5, atol=1e-5)
    for g_leaf, c_leaf in zip(gpu.emb_state, cpu.emb_state):
        torch.testing.assert_close(g_leaf.cpu(), c_leaf, rtol=1e-5, atol=1e-7)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65_536,), (4096, 8)], ids=["rows", "bags"])
def test_cuda_indexer_equals_the_cpu_indexer(cuda_device, shape):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator(device=cuda_device).manual_seed(5)
    v = 50_000
    ids = torch.randint(-3, v + 3, shape, generator=g, device=cuda_device,
                        dtype=torch.int32)
    for ix in (ett.SparseIndexer(), ett.DenseIndexer()):
        got = ett.index(ids, vocab=v, indexer=ix)
        want = ett.index(ids.cpu(), vocab=v, indexer=ix)
        for f in ("unique", "num_unique", "offsets", "map", "group_of"):
            assert getattr(got, f).device.type == "cuda"
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


class _plain_update_path:
    """Route the run-scatter path to the plain versions, on the card."""

    def __enter__(self):
        self.saved = (S.scatter_add_rows_sorted, S.gather_rows)
        S.scatter_add_rows_sorted = S.scatter_add_rows_sorted_plain
        S.gather_rows = G.gather_rows_plain

    def __exit__(self, *exc):
        S.scatter_add_rows_sorted, S.gather_rows = self.saved


@pytest.mark.cuda
@pytest.mark.parametrize("num_splits", [1, 4])
def test_cuda_sgd_update_views_are_bitwise_the_plain_version(cuda_device,
                                                             num_splits):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator(device=cuda_device).manual_seed(num_splits)
    v, n, d = 20_000, 30_000, 128
    data = torch.randn((v, d), generator=g, device=cuda_device)
    upd = ett.SparseEmbeddingUpdate(
        delta=torch.randn((n, d), generator=g, device=cuda_device),
        indices=torch.randint(0, v, (n,), generator=g, device=cuda_device))
    ir = ett.index(upd.indices)
    kern, plain = data.clone(), data.clone()
    before = S.scatter_add_rows_sorted.launches
    for j in range(num_splits):
        view = ett.indexer_view(ir, num_splits, j)
        ett.sgd_update(kern, upd, 0.1, view=view, method="dedup")
        with _plain_update_path():
            ett.sgd_update(plain, upd, 0.1, view=view, method="dedup")
        assert torch.equal(kern.view(torch.int32), plain.view(torch.int32))
    assert S.scatter_add_rows_sorted.launches == before + num_splits
    whole = data.clone()
    ett.sgd_update(whole, upd, 0.1, idx_result=ir)
    torch.testing.assert_close(kern, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["lazy_adam", "ftrl"])
def test_cuda_adam_and_ftrl_take_hot_accumulate_on_a_tiny_table(cuda_device,
                                                                opt):
    import embeddingtables_tpu_torch as ett
    make = {"lazy_adam": lambda: ett.SparseLazyAdam(0.01),
            "ftrl": lambda: ett.SparseFTRL(0.1, l1=0.01)}[opt]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    data = 0.1 * torch.randn((300, 128), generator=g, device=cuda_device)
    cpu = data.cpu()
    upd = ett.SparseEmbeddingUpdate(
        delta=torch.randn((4096, 128), generator=g, device=cuda_device),
        indices=torch.randint(-5, 310, (4096,), generator=g,
                              device=cuda_device))
    cpu_upd = ett.SparseEmbeddingUpdate(upd.delta.cpu(), upd.indices.cpu())
    o = make()
    state, cstate = o.init(data), o.init(cpu)
    hot, run = H.hot_accumulate.launches, S.scatter_add_rows_sorted.launches
    for _ in range(2):
        _, state = o.apply(data, upd, state)
        _, cstate = o.apply(cpu, cpu_upd, cstate)
    assert H.hot_accumulate.launches == hot + 2
    assert S.scatter_add_rows_sorted.launches == run
    # hot_accumulate adds within a block in a varying order: the dense
    # gradient differs from the CPU's in its last bits, and the optimizer
    # carries that through.
    torch.testing.assert_close(data.cpu(), cpu, rtol=1e-4, atol=1e-5)
    for a, b in zip(state, cstate):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_split_adagrad_runs_one_run_scatter_per_shard(cuda_device):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator(device=cuda_device).manual_seed(9)
    v, n = 10_000, 8192
    data = torch.randn((v, 128), generator=g, device=cuda_device)
    upd = ett.SparseEmbeddingUpdate(
        delta=torch.randn((n, 128), generator=g, device=cuda_device),
        indices=torch.randint(0, v, (n,), generator=g, device=cuda_device))
    opt = ett.SparseRowWiseAdaGrad(0.1, method="indexer")
    split = ett.SplitEmbedding(data.clone(), 3000)          # 4 shards
    simple = ett.SimpleEmbedding(data.clone())
    before = S.scatter_add_rows_sorted.launches
    [split], [ps] = ett.ensemble_update(opt, [split], [upd])
    assert S.scatter_add_rows_sorted.launches == before + 4
    [simple], [ss] = ett.ensemble_update(opt, [simple], [upd])
    torch.testing.assert_close(split.materialize(), simple.data, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(ps.accum, ss.accum, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# The model families' widths: DeepFM's fused stack (D + 1 = 129) and its
# unfolded first-order stack (D = 1), and one train step of each family
# ---------------------------------------------------------------------------

def _table_at(g, device, v, d, dtype, offset):
    """A contiguous (v, d) table whose base lies `offset` elements into its
    buffer: offset 1 leaves a f32 base 4-byte and a bf16 base 2-byte
    aligned, offset 2 a bf16 base 4-byte aligned."""
    buf = torch.randn((v * d + offset,), generator=g, device=device)
    return buf.to(dtype)[offset:].view(v, d)


def _ids_with_specials(g, device, n, v):
    idx = torch.randint(-v - 3, v + 3, (n,), generator=g, device=device,
                        dtype=torch.int32)
    special = torch.tensor([-v, v, 2**31 - 1, -2**31], dtype=torch.int32,
                           device=device)
    idx[:min(n, 4)] = special[:min(n, 4)]
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 5, 36, 127, 129, 130, 257])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 37, 40_001])
def test_cuda_family_widths_gather_bitwise(cuda_device, dtype, d, offset, n):
    # Widths on and off the 16-byte grid (DeepFM's fused 129 and its
    # first-order 1 among them), tables whose base is only 4- or 2-byte
    # aligned, one row, a count that no rows-in-flight divides, and the
    # special ids (wrapped, out of range, the int32 extremes).
    g = torch.Generator(device=cuda_device).manual_seed(1000 * d + n + offset)
    v = 5000
    tab = _table_at(g, cuda_device, v, d, dtype, offset)
    assert tab.is_contiguous()
    idx = _ids_with_specials(g, cuda_device, n, v)
    before = G.gather_rows.launches
    got = G.gather_rows(tab, idx)
    assert G.gather_rows.launches == before + 1
    want = G.gather_rows_plain(tab, idx)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 129, 130, 257])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("bag", [1, 3, 8])
def test_cuda_family_widths_gather_bags_matches_plain(cuda_device, dtype, d,
                                                       offset, bag):
    # Off-grid widths take the realigning bag kernel: f32 sums in bag order
    # and one rounding, as the plain version makes them, so bitwise outside
    # the NaN rows. Those carry the canonical NaN (0x7fc00000, bf16 0x7fc0)
    # as on the CPU; torch's f32 -> bf16 cast on the card gives 0x7fff.
    g = torch.Generator(device=cuda_device).manual_seed(100 * d + bag + offset)
    v, n = 3000, 2051
    tab = _table_at(g, cuda_device, v, d, dtype, offset)
    idx = torch.randint(-v, v, (n, bag), generator=g, device=cuda_device,
                        dtype=torch.int32)
    idx[:4, 0] = torch.tensor([v, -v - 1, 2**31 - 1, -2**31],
                              dtype=torch.int32, device=cuda_device)
    before = G.gather_bags.launches
    got = G.gather_bags(tab, idx)
    assert G.gather_bags.launches == before + 1
    want = G.gather_bags_plain(tab, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=0,
                               equal_nan=True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    nan = want.isnan()
    assert torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])
    canonical = 0x7FC00000 if dtype == torch.float32 else 0x7FC0
    assert nan.any() and (got.view(bits)[nan] == canonical).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("d", [129, 1])
def test_cuda_family_widths_scatter_matches_plain(cuda_device, dtype,
                                                  adagrad, d):
    # Zipf runs over many windows, padding and rows >= V, at the two widths
    # that leave the kernel's vector path: every column of a 129-wide row
    # (the tail lane) and the one column of a 1-wide row.
    g = torch.Generator(device=cuda_device).manual_seed(3 * d + adagrad)
    v, n = 3000, 20_000
    rows = _sorted_rows(g, cuda_device, n, v, True)
    vals = torch.randn((n, d), generator=g, device=cuda_device)
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


class _plain_forward_gathers:
    """Route the forward lookups (`ops.lookup` and `SimpleEmbedding.rows`)
    to the plain gathers, on the card."""

    def __enter__(self):
        import sys
        self.mods = [sys.modules["embeddingtables_tpu_torch.ops.lookup"],
                     sys.modules["embeddingtables_tpu_torch.tables"]]
        self.saved = [(m, n, getattr(m, n)) for m in self.mods
                      for n in ("gather_rows", "gather_bags") if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, getattr(G, n + "_plain"))

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _family_case(ett, family, device):
    """(model on the card, its train step, one batch, stacks a step)."""
    g = torch.Generator().manual_seed(1)
    vocabs, b = (300, 500, 200), 256
    dense = torch.randn((b, 5), generator=g)
    cat = torch.stack([torch.randint(0, v, (b,), generator=g,
                                     dtype=torch.int32) for v in vocabs])
    if family == "two_tower":
        cfg = ett.TwoTowerConfig(query_vocab_sizes=vocabs, item_vocab=5000,
                                 num_dense=5, dim=64, embed_dim=32,
                                 query_mlp=(64, 32), item_mlp=(64, 32))
        model = ett.init_two_tower(cfg, g, device="cpu").to(device)
        items = torch.randperm(5000, generator=g)[:b].to(torch.int32)
        step = ett.models.two_tower.make_train_step(cfg)
        return model, step, (dense, cat, items), 2
    kw = dict(vocab_sizes=vocabs, num_dense=5, dim=128,
              compute_dtype=torch.float32)
    label = (torch.rand((b,), generator=g) < 0.5).float()
    if family == "dcn":
        cfg = ett.DCNConfig(**kw, deep_mlp=(64, 32), cross_rank=16)
        model = ett.init_dcn(cfg, g, device="cpu")
        step = ett.models.dcn.make_train_step(cfg)
    else:
        cfg = ett.DeepFMConfig(**kw, deep_mlp=(64, 32),
                               fold_fm_w=family == "deepfm_folded")
        model = ett.init_deepfm(cfg, g, device="cpu")
        step = ett.models.deepfm.make_train_step(cfg)
    stacks = 2 if family == "deepfm_unfolded" else 1
    return model.to(device), step, (dense, cat, label), stacks


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dcn", "deepfm_folded",
                                    "deepfm_unfolded", "two_tower"])
def test_cuda_family_train_step_is_bitwise_the_plain_step(cuda_device,
                                                          family):
    # SparseSGD through the run-scatter on every stack (none is a tiny
    # table), the towers in f32: the kernels' step equals the plain
    # versions' step bit for bit.
    import copy
    import embeddingtables_tpu_torch as ett
    model, step, batch, stacks = _family_case(ett, family, cuda_device)
    plain = copy.deepcopy(model)
    before = S.scatter_add_rows_sorted.launches
    out = step(model, *batch)
    assert S.scatter_add_rows_sorted.launches == before + stacks
    with _plain_update_path(), _plain_forward_gathers():
        out_p = step(plain, *batch)
    torch.cuda.synchronize()
    assert S.scatter_add_rows_sorted.launches == before + stacks
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    out_p if isinstance(out_p, tuple) else (out_p,)):
        assert torch.equal(a, b)
    for (name, a), (_, b) in zip(model.named_buffers(),
                                 plain.named_buffers()):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def one_rank_nccl_mesh(tmp_path_factory):
    """A one-rank NCCL group over a file store, and its mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import torch.distributed as dist
    from embeddingtables_tpu_torch.parallel import mesh as pmesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    pmesh.init_process(f"file://{store}", 1, 0, device="cuda")
    yield pmesh.local_mesh(1)
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dcn", "deepfm_folded",
                                    "deepfm_unfolded", "two_tower"])
def test_cuda_sharded_family_step_on_one_rank_is_bitwise_the_single_step(
        one_rank_nccl_mesh, family):
    # One SGD step of the family's sharded step on a one-rank NCCL group
    # (the gather exchange, the run-scatter on the shard) against the
    # single-device step from the same weights: bit for bit.
    import copy
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import parallel as P
    mesh = one_rank_nccl_mesh
    model, step1, batch, stacks = _family_case(ett, family,
                                               torch.device("cuda"))
    shard, make, unshard = {
        "dcn": (P.shard_dcn, P.make_sharded_dcn_train_step, P.unshard_dcn),
        "deepfm": (P.shard_deepfm, P.make_sharded_deepfm_train_step,
                   P.unshard_deepfm),
        "two_tower": (P.shard_two_tower, P.make_sharded_tt_train_step,
                      P.unshard_two_tower)}[
        "two_tower" if family == "two_tower" else family.split("_")[0]]
    sm = shard(copy.deepcopy(model), mesh, "data")
    batch = tuple(x.cuda() for x in batch)
    before = S.scatter_add_rows_sorted.launches
    out = make(model.config, mesh, "data")(sm, *batch)
    assert S.scatter_add_rows_sorted.launches == before + stacks
    out1 = step1(model, *batch)
    torch.cuda.synchronize()
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    out1 if isinstance(out1, tuple) else (out1,)):
        assert torch.equal(a, b)
    back = unshard(sm)
    for (name, a), (_, b) in zip(back.named_buffers(),
                                 model.named_buffers()):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(back.named_parameters(),
                                 model.named_parameters()):
        assert torch.equal(a, b), name


class _plain_planner_path:
    """Route every kernel of a planned step to its plain version, on the
    card: the lookups of the three groups, the run-scatter and its value
    permute, and `hot_accumulate`."""

    def __enter__(self):
        import sys
        names = ("gather_rows", "gather_bags", "scatter_add_rows_sorted",
                 "hot_accumulate")
        plain = {"gather_rows": G.gather_rows_plain,
                 "gather_bags": G.gather_bags_plain,
                 "scatter_add_rows_sorted": S.scatter_add_rows_sorted_plain,
                 "hot_accumulate": H.hot_accumulate_plain}
        self.saved = [(m, n, getattr(m, n))
                      for k, m in list(sys.modules.items())
                      if k.startswith("embeddingtables_tpu_torch")
                      and m is not None
                      for n in names if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, plain[n])

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adagrad_indexer"])
def test_cuda_planned_step_on_one_rank_matches_the_plain_planned_step(
        one_rank_nccl_mesh, opt):
    # A three-way plan made by hand on a one-rank NCCL group (one rank's
    # plan_sharding replicates everything): one planned DLRM step through
    # the kernels against the same step on the plain versions. Launches a
    # step: a gather_rows per group's lookup, the replicated and row groups'
    # value permutes and run-scatters; the column group (2,000 rows) sums
    # with index_add_, whose atomics add in a varying order, so the tables
    # are held to rtol 1e-6 (the AdaGrad epilogue's rsqrt as on the card).
    import copy
    import dataclasses
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import parallel as P
    mesh = one_rank_nccl_mesh
    vocabs = (300, 5000, 2000)
    cfg = ett.DLRMConfig(vocab_sizes=vocabs, num_dense=5, dim=128,
                         bottom_mlp=(64, 128), top_mlp=(64, 1),
                         compute_dtype=torch.float32)
    sparse = (ett.SparseSGD(0.1) if opt == "sgd" else
              ett.SparseRowWiseAdaGrad(0.1, method="indexer"))
    plan = P.plan_sharding(vocabs, 128, mesh)
    plan = dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, placement=p) for d, p in zip(
            plan.decisions, (P.REPLICATE, P.ROW_SHARD, P.COL_SHARD))))
    g = torch.Generator().manual_seed(4)
    single = ett.init_dlrm(cfg, g, device="cpu", sparse_opt=sparse).to("cuda")
    model = P.plan_model(single, plan, mesh, sparse)
    plain = P.plan_model(copy.deepcopy(single), plan, mesh, sparse)
    b = 512
    batch = (torch.randn((b, 5), generator=g).cuda(),
             torch.stack([torch.randint(0, v, (b,), generator=g,
                                        dtype=torch.int32)
                          for v in vocabs]).cuda(),
             (torch.rand((b,), generator=g) < 0.5).float().cuda())
    step = P.make_planned_train_step(cfg, mesh, sparse_opt=sparse)
    before = (G.gather_rows.launches, S.scatter_add_rows_sorted.launches,
              H.hot_accumulate.launches)
    loss = step(model, *batch)
    torch.cuda.synchronize()
    assert (G.gather_rows.launches - before[0],
            S.scatter_add_rows_sorted.launches - before[1],
            H.hot_accumulate.launches - before[2]) == (5, 2, 0)
    with _plain_planner_path():
        loss_p = step(plain, *batch)
    torch.cuda.synchronize()
    assert G.gather_rows.launches - before[0] == 5
    torch.testing.assert_close(loss, loss_p, rtol=1e-6, atol=0.0)
    for (name, a), (_, b) in zip(model.named_buffers(),
                                 plain.named_buffers()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 plain.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


# ---------------------------------------------------------------------------
# The table variants: quantized, compositional, offloaded and tiered tables
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quantized_rows_match_the_cpu_rows(cuda_device, bits):
    # The quantized gather is torch ops on both devices: the same q, scales
    # and products, bitwise, with NaN rows in the same places.
    import embeddingtables_tpu_torch as ett
    g = torch.Generator().manual_seed(bits)
    v = 5000
    data = torch.randn((v, 128), generator=g)
    data[7] = 0.0
    cls = ett.QuantizedEmbedding if bits == 8 else ett.Int4QuantizedEmbedding
    cpu = cls.quantize(data)
    gpu = cls.quantize(data.to(cuda_device))
    stored = "q" if bits == 8 else "packed"
    assert torch.equal(getattr(gpu, stored).cpu(), getattr(cpu, stored))
    assert torch.equal(gpu.scale.cpu().view(torch.int32),
                       cpu.scale.view(torch.int32))
    idx = torch.randint(-v - 3, v + 3, (4099,), generator=g,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([7, -v, v, 2**31 - 1])
    got, want = gpu.rows(idx.to(cuda_device)).cpu(), cpu.rows(idx)
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()
    assert torch.equal(got.nan_to_num().view(torch.int32),
                       want.nan_to_num().view(torch.int32))


def _compositional(ett, kind, device):
    # 1M rows: QR's two tables of 1,000 rows are past the tiny-table branch
    # (<= 512 padded rows), so every sub-table takes the run-scatter.
    g = torch.Generator().manual_seed(3)
    v, d = 1_000_000, 128
    if kind == "qr":
        t = ett.QREmbedding.create(g, v, d, device="cpu")
        t.q_data, t.r_data = t.q_data.to(device), t.r_data.to(device)
        return t, [t.q_data, t.r_data], ett.qr_lookup_vjp
    if kind == "md":
        t = ett.MDEmbedding.create(g, v, d, 32, device="cpu")
        t.data, t.proj = t.data.to(device), t.proj.to(device)
        return t, [t.data], ett.md_lookup_vjp
    # Rank 4 keeps every core off the tiny-table branch (D % 128 != 0).
    t = ett.TTEmbedding.create(g, v, d, rank=4, device="cpu")
    t.cores = tuple(c.to(device) for c in t.cores)
    return t, list(t.core_tables()), ett.tt_lookup_vjp


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["qr", "md", "tt"])
def test_cuda_compositional_rows_and_sgd_step_are_bitwise_the_plain_path(
        cuda_device, kind):
    import copy
    import embeddingtables_tpu_torch as ett
    table, subs, vjp = _compositional(ett, kind, cuda_device)
    plain = copy.deepcopy(table)
    psubs = ([plain.q_data, plain.r_data] if kind == "qr" else
             [plain.data] if kind == "md" else list(plain.core_tables()))
    g = torch.Generator(device=cuda_device).manual_seed(4)
    ids = torch.randint(0, 1_000_000, (8192,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    target = torch.randn((8192, 128), generator=g, device=cuda_device)
    opt = ett.SparseSGD(0.5)

    def step(t, tables):
        out, pull = vjp(t, ids)
        upds = pull((out - target) / ids.numel())
        for data, upd in zip(tables, upds[:len(tables)]):
            opt.apply(data, upd, opt.init(data))
        return out

    before = (G.gather_rows.launches, S.scatter_add_rows_sorted.launches)
    out = step(table, subs)
    assert G.gather_rows.launches > before[0]
    assert S.scatter_add_rows_sorted.launches == before[1] + len(subs)
    with _plain_update_path(), _plain_forward_gathers():
        out_p = step(plain, psubs)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p)
    for a, b in zip(subs, psubs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["offload", "tiered"])
def test_cuda_host_tables_match_a_simple_embedding(cuda_device, kind):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator().manual_seed(5)
    v, d = 200_000, 128
    data = torch.randn((v, d), generator=g)
    ref = ett.SimpleEmbedding(data.to(cuda_device))
    if kind == "offload":
        t = ett.HostOffloadEmbedding(data, device=cuda_device)
        assert t.data.is_pinned()
    else:
        t = ett.TieredEmbedding.from_array(data, 4096, device=cuda_device)
        assert t.cold.is_pinned() and t.hot.device.type == "cuda"
    ids = torch.randint(0, v, (65_536,), generator=g, dtype=torch.int32)
    ids[:64] = torch.arange(64) * 3     # hot rows for the tiered table
    got = t.rows(ids.to(cuda_device))
    assert got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32),
                       ref.rows(ids.to(cuda_device)).view(torch.int32))
    delta = torch.randn((65_536, d), generator=g).to(cuda_device)
    t.scatter_apply(ids.to(cuda_device), delta)
    ref.scatter_apply(ids.to(cuda_device), delta)
    torch.testing.assert_close(t.materialize(), ref.data, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Rows wider than the run-scatter's registers, and persistence on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("adagrad", [False, True])
@pytest.mark.parametrize("d", [258, 1025, 2048, 4096, 4097, 4100])
@pytest.mark.parametrize("zipf", [False, True], ids=["edges", "zipf"])
def test_cuda_wide_rows_scatter_matches_plain(cuda_device, dtype, adagrad, d,
                                              zipf):
    # Wider than 128 units: the wide class, a block a window; past 4,096
    # columns, AdaGrad's two sweeps over column chunks.
    g = torch.Generator(device=cuda_device).manual_seed(d + zipf)
    v, n = 3000, 20_000
    rows = (_sorted_rows(g, cuda_device, n, v, True) if zipf
            else _window_edge_rows(cuda_device, v))
    vals = torch.randn((rows.numel(), d), generator=g, device=cuda_device)
    table = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    accum = (torch.rand((v,), generator=g, device=cuda_device)
             if adagrad else None)
    t_k, t_p = table.clone(), table.clone()
    a_k = None if accum is None else accum.clone()
    a_p = None if accum is None else accum.clone()
    before = S.scatter_add_rows_sorted.launches
    S.scatter_add_rows_sorted(t_k, rows, vals, -0.05, accum=a_k, eps=1e-8)
    assert S.scatter_add_rows_sorted.launches == before + 1
    S.scatter_add_rows_sorted_plain(t_p, rows, vals, -0.05, accum=a_p,
                                    eps=1e-8)
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
def test_cuda_simple_embedding_sgd_at_d_2048_takes_the_run_scatter(
        cuda_device):
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    g = torch.Generator(device=cuda_device).manual_seed(11)
    v, d = 5000, 2048
    data = torch.randn((v, d), generator=g, device=cuda_device)
    ids = torch.randint(0, v, (4096,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    delta = torch.randn((4096, d), generator=g, device=cuda_device)
    opt = ett.SparseSGD(0.1)
    kernel, plain = data.clone(), data.clone()
    before = S.scatter_add_rows_sorted.launches
    opt.apply(kernel, SparseEmbeddingUpdate(delta, ids), opt.init(kernel))
    assert S.scatter_add_rows_sorted.launches == before + 1
    with _plain_update_path():
        opt.apply(plain, SparseEmbeddingUpdate(delta, ids), opt.init(plain))
    torch.cuda.synchronize()
    assert torch.equal(kernel.view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
def test_cuda_delta_chain_restores_bitwise_and_refreshes_a_service(
        cuda_device, tmp_path):
    import numpy as np
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import utils
    cfg = ett.DLRMConfig(vocab_sizes=(3000, 500, 20_000), num_dense=5,
                         dim=64, bottom_mlp=(32, 64), top_mlp=(32, 1))
    data = ett.SyntheticCriteo(vocab_sizes=cfg.vocab_sizes, num_dense=5,
                               batch_size=1024, seed=3)
    opt = ett.SparseRowWiseAdaGrad(0.05, method="indexer")
    mgr = utils.DeltaCheckpointManager(str(tmp_path / "delta"), base_every=3)
    ckpt = utils.CheckpointManager(str(tmp_path / "ckpt"))
    before = G.gather_rows.launches
    res = ett.train_dlrm(cfg, data.batches(), 6, sparse_opt=opt,
                         device=cuda_device, delta_ckpt=mgr, delta_every=2,
                         ckpt_manager=ckpt, ckpt_every=3,
                         guard=utils.DivergenceGuard(ckpt), log_every=1,
                         verbose=False)
    # Each step gathers twice (forward, permute); each delta once a leaf.
    assert G.gather_rows.launches == before + 6 * 2 + 2 * 2
    fresh = ett.init_dlrm(cfg, device=cuda_device, sparse_opt=opt)
    ett.restore_delta(mgr, fresh)
    assert torch.equal(fresh.tables.data.view(torch.int32),
                       res.model.tables.data.view(torch.int32))
    assert torch.equal(fresh.emb_accum, res.model.emb_accum)
    whole = ett.init_dlrm(cfg, device=cuda_device, sparse_opt=opt)
    ckpt.restore_latest(whole)
    for (name, a), b in zip(whole.state_dict().items(),
                            res.model.state_dict().values()):
        assert torch.equal(a, b), name
    # The chain holds the tables; the service serves the trained towers.
    svc, _ = ett.make_refreshable_dlrm_service(res.model, max_batch=256)
    try:
        follower = utils.DeltaFollower(str(tmp_path / "delta"),
                                       fresh.tables.data)
        assert follower.poll() == 3
        svc.swap_tables(follower.data)
        batch = next(data.batches())
        dense, cat = batch["dense"][:256], batch["cat"][:, :256]
        got = svc.predict(dense, cat, timeout=60)
        want = ett.make_eval_step(cfg)(res.model, dense, cat)
        assert np.array_equal(got, want.cpu().numpy())
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# Microbatching, the towers' torch.optim state and the device prefetcher
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm_folded"])
def test_cuda_microbatch_step_is_bitwise_the_plain_step(cuda_device, family):
    # k = 4 slices: four lookups (one gather_rows launch each) and one
    # run-scatter per stack; the kernels' step equals the plain versions'
    # k = 4 step bit for bit (f32 towers, SparseSGD).
    import copy
    import embeddingtables_tpu_torch as ett
    if family == "dlrm":
        g = torch.Generator().manual_seed(1)
        cfg = ett.DLRMConfig(vocab_sizes=(300, 500, 200), num_dense=5,
                             dim=128, bottom_mlp=(64, 128), top_mlp=(64, 1),
                             compute_dtype=torch.float32)
        model = ett.init_dlrm(cfg, g, device="cpu").to(cuda_device)
        step = ett.make_train_step(cfg, microbatch=4)
        b = 256
        batch = (torch.randn((b, 5), generator=g),
                 torch.stack([torch.randint(0, v, (b,), generator=g,
                                            dtype=torch.int32)
                              for v in cfg.vocab_sizes]),
                 (torch.rand((b,), generator=g) < 0.5).float())
    else:
        model, _, batch, _ = _family_case(ett, family, cuda_device)
        mod = ett.models.dcn if family == "dcn" else ett.models.deepfm
        step = mod.make_train_step(model.config, microbatch=4)
    plain = copy.deepcopy(model)
    rows, scat = G.gather_rows.launches, S.scatter_add_rows_sorted.launches
    loss = step(model, *batch)
    torch.cuda.synchronize()
    # Four lookups, and the run-scatter's value permute.
    assert G.gather_rows.launches == rows + 4 + 1
    assert S.scatter_add_rows_sorted.launches == scat + 1
    with _plain_update_path(), _plain_forward_gathers():
        loss_p = step(plain, *batch)
    assert torch.equal(loss, loss_p)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 plain.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_adam_tower_step_is_bitwise_the_plain_step(cuda_device):
    # torch.optim.Adam on the towers, its state in the model's buffers:
    # `step` stays a CPU scalar (torch's own choice without capturable),
    # the moments lie beside the parameters on the card.
    import copy
    import functools
    import embeddingtables_tpu_torch as ett
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    cfg = ett.DLRMConfig(vocab_sizes=(300, 500, 200), num_dense=5, dim=128,
                         bottom_mlp=(64, 128), top_mlp=(64, 1),
                         compute_dtype=torch.float32)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    model = ett.init_dlrm(cfg, g, device=cuda_device, dense_tx=adam)
    state = model.dense_opt_state.state_dict()
    assert state["bottom_params_0__step"].device.type == "cpu"
    assert state["bottom_params_0__exp_avg"].device == model.tables.data.device
    plain = copy.deepcopy(model)
    gh = torch.Generator().manual_seed(3)
    b = 512
    batch = (torch.randn((b, 5), generator=gh),
             torch.stack([torch.randint(0, v, (b,), generator=gh,
                                        dtype=torch.int32)
                          for v in cfg.vocab_sizes]),
             (torch.rand((b,), generator=gh) < 0.5).float())
    step = ett.make_train_step(cfg, dense_tx=adam)
    for _ in range(2):
        loss = step(model, *batch)
        with _plain_update_path(), _plain_forward_gathers():
            loss_p = step(plain, *batch)
        assert torch.equal(loss, loss_p)
    assert float(model.dense_opt_state.bottom_params_0__step) == 2.0
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 plain.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_device_prefetcher_copies_on_a_side_stream(cuda_device):
    import numpy as np
    from embeddingtables_tpu_torch.io import DevicePrefetcher
    rng = np.random.default_rng(0)
    host = [dict(dense=rng.standard_normal((4096, 13)).astype(np.float32),
                 cat=rng.integers(0, 100, (26, 4096)).astype(np.int32),
                 step=i) for i in range(9)]
    streams = []

    def put(b):
        streams.append(torch.cuda.current_stream(cuda_device))
        assert b["dense"].is_pinned() and b["step"] == len(streams) - 1
        return tuple(b[k].to(cuda_device, non_blocking=True)
                     for k in ("dense", "cat"))

    pf = DevicePrefetcher(iter(host), put, depth=2, device=cuda_device)
    main = torch.cuda.current_stream(cuda_device)
    got = []
    for want in host:
        batch, (dense, cat) = next(pf)
        assert batch is want and dense.device.type == "cuda"
        got.append((dense * 2, cat + 1))          # work on the main stream
    with pytest.raises(StopIteration):
        next(pf)
    torch.cuda.synchronize()
    assert all(s != main for s in streams)
    for want, (dense, cat) in zip(host, got):
        assert torch.equal(dense.cpu(), torch.from_numpy(want["dense"]) * 2)
        assert torch.equal(cat.cpu(), torch.from_numpy(want["cat"]) + 1)


def _dcn_plain(model, dense, emb_t, dtype):
    """The DCN forward at the logical width F, written out: x0, the
    weights and every product in `dtype`, as the port casts them."""
    b = emb_t.shape[1]
    x0 = torch.cat([emb_t.permute(1, 0, 2).reshape(b, -1), dense],
                   dim=-1).to(dtype)
    x = x0
    for u, v, bias in model.cross:
        x = x0 * ((x @ v.to(dtype)) @ u.to(dtype).T + bias.to(dtype)) + x
    for w, bias in model.deep:
        x = torch.relu(x @ w.to(dtype) + bias.to(dtype))
    w, bias = model.head
    return (x @ w.to(dtype) + bias.to(dtype))[:, 0].float()


@pytest.mark.cuda
def test_cuda_dcn_towers_run_on_the_16_byte_grid(cuda_device):
    # DCN-v2 at the MLPerf widths (x0 = 26 x 128 + 13 = 3,341 columns,
    # rank 512) in bf16: the towers run 3,344 wide, so none of the 21
    # GEMMs of width F in the forward and backward is one of cuBLAS's
    # alignment-1, -2 or -4 kernels. Against the same network written out at width 3,341 in
    # bf16 and in f32: the logits within 2^-5 of the largest (0.5-0.84 %
    # on the H100). A bf16 backward of this network sits about 11 % from
    # f32's in every leaf, the unpadded computation's as much as the
    # padded one's: a bf16 forward flips ReLU masks and the rounding runs
    # through the cross layers' products, so two bf16 summation orders
    # differ by about 5 % (two seeds, H100). Each gradient is held to
    # about twice that: 2^-2 of f32's, 2^-3 of the unpadded bf16 one's.
    import re
    from torch.profiler import ProfilerActivity, profile
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.models import dcn as PD
    cfg = ett.DCNConfig(vocab_sizes=(10,) * 26, num_dense=13, dim=128,
                        num_cross=3, cross_rank=512,
                        deep_mlp=(1024, 1024, 512, 256),
                        compute_dtype=torch.bfloat16)
    assert cfg.input_features == 3341
    assert PD.grid_width(3341, torch.bfloat16) == 3344
    g = torch.Generator(device=cuda_device).manual_seed(0)
    model = ett.init_dcn(cfg, g, device=cuda_device)
    b = 4096
    dense = torch.randn((b, 13), generator=g, device=cuda_device)
    emb_t = torch.randn((26, b, 128), generator=g, device=cuda_device) * 0.1
    label = (torch.rand((b,), generator=g, device=cuda_device) < 0.5).float()
    leaves = [p for _, p in model.tower_params()] + [emb_t.requires_grad_()]

    def grads(forward):
        logits = forward(model.cross, model.deep, model.head, cfg, dense,
                         emb_t)
        return logits, torch.autograd.grad(PD.bce_loss(logits, label), leaves)

    grads(PD.forward_from_embeddings)               # cuBLAS's heuristics
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        logits, got = grads(PD.forward_from_embeddings)
        torch.cuda.synchronize()
    # The towers' GEMMs: those with F' = 3,344 among their operands' sizes
    # (per cross layer two in the forward and four in the backward, and
    # three of the deep tower's first layer); the kernels launched by each.
    tower = [k.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and any(3344 in s for s in e.input_shapes if isinstance(s, list))
             for k in e.kernels]
    gemms = [k for k in tower
             if re.search("gemm|nvjet|xmma|cutlass", k, re.I)]
    assert len(gemms) >= 21, tower
    misaligned = [k for k in gemms if re.search("align[124](?![0-9])", k)]
    assert not misaligned, misaligned
    plain = {dt: grads(lambda *a: _dcn_plain(model, dense, emb_t, dt))
             for dt in (torch.bfloat16, torch.float32)}
    for dt in plain:
        assert (logits - plain[dt][0]).abs().max() <= \
            2 ** -5 * plain[dt][0].abs().max()
    for dt, tol in ((torch.bfloat16, 2 ** -3), (torch.float32, 2 ** -2)):
        for leaf, a, w in zip(leaves, got, plain[dt][1]):
            assert a.shape == w.shape == leaf.shape
            assert (a - w).norm() <= tol * w.norm()


# The multi-hot path (MLPerf DLRM-DCNv2): bags of one width a table.
MLPERF_BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
               100, 27, 10, 3, 1, 1)


def _ragged_ids(g, device, vocab, widths, b):
    """(S, b) int32 stacked ids, table t's bag in its widths[t] slot rows
    drawn over its own rows; with the stack's first and last rows, the
    wrapped id -1 (the last row), an out-of-range id (a NaN bag) and a bag
    of 100 repeats of one row placed in example 0 ... 3."""
    offs = [0]
    for _ in widths:
        offs.append(offs[-1] + vocab)
    ids = torch.cat([torch.randint(offs[t], offs[t + 1], (w, b), generator=g,
                                   device=device)
                     for t, w in enumerate(widths)]).to(torch.int32)
    starts = [sum(widths[:t]) for t in range(len(widths))]
    wide = max(range(len(widths)), key=lambda t: widths[t])
    ids[starts[wide]:starts[wide] + widths[wide], 0] = offs[wide] + 17
    ids[0, 1], ids[1, 1] = 0, offs[-1] - 1
    ids[starts[wide] + 5, 2] = -1
    ids[starts[wide] + 50, 3] = offs[-1]
    return ids, offs[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 129])
def test_cuda_gather_bags_ragged_matches_plain(cuda_device, dtype, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    ids, v = _ragged_ids(g, cuda_device, 4000, MLPERF_BAGS, 3000)
    tab = torch.randn((v, d), generator=g, device=cuda_device).to(dtype)
    before = G.gather_bags_ragged.launches
    layout = G.BagLayout(MLPERF_BAGS, cuda_device)
    got = G.gather_bags_ragged(tab, ids, layout)
    assert G.gather_bags_ragged.launches == before + 1
    want = G.gather_bags_ragged_plain(tab, ids, layout)
    assert got.shape == (len(MLPERF_BAGS), 3000, d)
    # The same f32 additions in bag order, one rounding: equal, NaN bags
    # included (torch writes bf16 NaN as 0x7fff, the kernel 0x7fc0).
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    wide = MLPERF_BAGS.index(100)
    row = tab[ids[sum(MLPERF_BAGS[:wide]), 0].long()].float()
    acc = torch.zeros_like(row)
    for _ in range(100):
        acc += row
    assert torch.equal(got[wide, 0].float(), acc.to(dtype).float())
    assert torch.isnan(got[wide, 3]).all() and not torch.isnan(got[wide, 2]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adagrad_indexer"])
def test_cuda_bag_indexed_update_is_the_expanded_update(cuda_device, opt):
    import embeddingtables_tpu_torch as ett
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, d = 2048, 128
    ids, v = _ragged_ids(g, cuda_device, 3000, MLPERF_BAGS, b)
    ids = ids.clamp(0, v - 1)
    bags = G.BagLayout(MLPERF_BAGS, cuda_device).bags(b)
    delta = torch.randn((len(MLPERF_BAGS) * b, d), generator=g,
                        device=cuda_device)
    make = {"sgd": lambda: ett.SparseSGD(0.1),
            "adagrad_indexer": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="indexer")}[opt]
    table = torch.randn((v, d), generator=g, device=cuda_device)
    lazy = ett.SparseEmbeddingUpdate(delta=delta, indices=ids.reshape(-1),
                                     bags=bags)
    expanded = ett.SparseEmbeddingUpdate(delta=delta[bags.long()],
                                         indices=ids.reshape(-1))
    out = []
    for upd in (lazy, expanded):
        t = table.clone()
        state = make().init(t)
        make().apply(t, upd, state)
        out.append((t, state))
    # The same values reach the run-scatter in the same sorted order.
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, c) for a, c in zip(out[0][1], out[1][1]))


@pytest.mark.cuda
def test_cuda_bag_indexed_update_past_2_31_elements(cuda_device):
    # n * D = 2^31 + 2^27 elements of sorted values (8.6 GB in f32): the
    # permute's output and the run-scatter's reads past 2^31 elements. The
    # last 2^20 ids touch rows no earlier id touches, so a wrapped offset
    # shows in them.
    if torch.cuda.get_device_properties(cuda_device).total_memory < 40e9:
        pytest.skip("needs 40 GB of device memory")
    d, v, m, tail = 128, 200_000, 65_536, 1 << 20
    n = (1 << 31) // d + tail
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rows = torch.cat([
        torch.randint(0, v - 1000, (n - tail,), generator=g,
                      device=cuda_device),
        torch.randint(v - 1000, v, (tail,), generator=g, device=cuda_device),
    ]).to(torch.int32)
    bags = torch.randint(0, m, (n,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    delta = torch.randn((m, d), generator=g, device=cuda_device)
    table = torch.zeros((v, d), device=cuda_device)
    S.scatter_update(table, rows, delta, 1.0, bags=bags)
    want = torch.zeros((v, d), dtype=torch.float64, device=cuda_device)
    for lo in range(0, n, 1 << 22):
        hi = min(n, lo + (1 << 22))
        want.index_add_(0, rows[lo:hi].long(),
                        delta[bags[lo:hi].long()].double())
    # f32 run sums of about 10,000 N(0, 1) terms a row against f64 sums
    torch.testing.assert_close(table.double(), want, rtol=1e-4, atol=1e-3)
    assert table[v - 1000:].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adagrad_indexer"])
def test_cuda_multihot_dcn_step_matches_the_cpu_step(cuda_device, opt):
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.models import make_dcn_train_step
    widths = (1, 3, 7, 100, 2)
    cfg = ett.DCNConfig(vocab_sizes=(300, 5000, 200, 4000, 50), num_dense=5,
                        dim=128, num_cross=2, cross_rank=64, deep_mlp=(64, 32),
                        compute_dtype=torch.float32, bag_sizes=widths,
                        dense_mlp=(64, 128))
    make = {"sgd": lambda: ett.SparseSGD(0.1),
            "adagrad_indexer": lambda: ett.SparseRowWiseAdaGrad(
                0.1, method="indexer")}[opt]
    cpu = ett.init_dcn(cfg, torch.Generator().manual_seed(0), device="cpu",
                       sparse_opt=make())
    gpu = ett.init_dcn(cfg, torch.Generator().manual_seed(0), device="cpu",
                       sparse_opt=make()).to(cuda_device)
    g = torch.Generator().manual_seed(1)
    dense = torch.randn((256, 5), generator=g)
    cat = torch.cat([torch.randint(0, v, (w, 256), generator=g,
                                   dtype=torch.int32)
                     for v, w in zip(cfg.vocab_sizes, widths)])
    label = torch.randint(0, 2, (256,), generator=g).float()
    before = (G.gather_bags_ragged.launches, S.scatter_add_rows_sorted.launches)
    loss_g = make_dcn_train_step(cfg, sparse_opt=make())(gpu, dense, cat, label)
    assert (G.gather_bags_ragged.launches,
            S.scatter_add_rows_sorted.launches) == (before[0] + 1,
                                                    before[1] + 1)
    loss_c = make_dcn_train_step(cfg, sparse_opt=make())(cpu, dense, cat, label)
    # f32 towers on both: summation order only.
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gpu.tables.data.cpu(), cpu.tables.data,
                               rtol=1e-5, atol=1e-5)
    for (_, a), (_, c) in zip(gpu.tower_params(), cpu.tower_params()):
        torch.testing.assert_close(a.detach().cpu(), c.detach(), rtol=1e-5,
                                   atol=1e-6)
