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
