"""The traffic generator: the same seed gives the same inputs; ids follow
the Zipf rule over each table."""
import numpy as np
import torch

from portbench import generate

TRAFFIC = {"kind": "train", "batch": 512, "zipf_a": 1.1, "batches": 3}
VOCAB = [5000, 3, 70, 1200]


def _batches(seed):
    return generate.train_batches(VOCAB, 13, TRAFFIC, seed,
                                  torch.device("cpu"))


def test_same_seed_same_batches_other_seed_other_batches():
    a, b, c = _batches(2**31 + 11), _batches(2**31 + 11), _batches(12)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["cat"], c[0]["cat"])


def test_batches_have_the_port_layout_and_range():
    for b in _batches(5):
        assert b["dense"].shape == (512, 13) and b["dense"].dtype == np.float32
        assert b["cat"].shape == (4, 512) and b["cat"].dtype == np.int32
        assert b["label"].shape == (512,)
        assert set(np.unique(b["label"])) <= {0.0, 1.0}
        for t, v in enumerate(VOCAB):
            assert 0 <= b["cat"][t].min() and b["cat"][t].max() < v


def test_ids_follow_zipf_by_rank():
    g = generate.generator("cpu", 3, 1)
    ids = generate.zipf_ids(g, 1000, 200_000, 1.1, "cpu").numpy()
    counts = np.sort(np.bincount(ids, minlength=1000))[::-1]
    p = np.arange(1, 1001, dtype=np.float64) ** -1.1
    p /= p.sum()
    # the hottest ranks' shares within a few percent of r^-a
    np.testing.assert_allclose(counts[:5] / ids.size, p[:5], rtol=0.05)
