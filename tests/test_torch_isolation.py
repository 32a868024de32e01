"""The port stands alone: it imports neither JAX nor the JAX package, builds
nothing at import time, and never falls back to the CPU on its own."""
import functools
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


NEW_MODULES = ("quant", "qr", "md", "tt", "offload", "tiered",
               "utils.rowstats", "utils.checkpoint", "utils.deltackpt",
               "utils.resilience", "utils.telemetry", "rpc", "io.loader",
               "io.synth", "io.criteo_file", "models.microbatch",
               "parallel", "parallel.mesh", "parallel.sharded",
               "parallel.alltoall", "parallel.dlrm", "parallel.dcn",
               "parallel.deepfm", "parallel.two_tower", "parallel.colshard",
               "parallel.planner", "compat", "nn")
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, embeddingtables_tpu_torch, "
            + "".join(f"embeddingtables_tpu_torch.{m}, " for m in NEW_MODULES)
            + "embeddingtables_tpu_torch.ops.cuda._lib as lib;"
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


def _no_device_calls():
    """Each entry point that creates state, called without `device=`."""
    dlrm = ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                          bottom_mlp=(4,), top_mlp=(3, 1))
    dcn = ett.DCNConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                        deep_mlp=(3,), cross_rank=2)
    dfm = ett.DeepFMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                           deep_mlp=(3,), fold_fm_w=False)
    tt = ett.TwoTowerConfig(query_vocab_sizes=(5, 6), item_vocab=7,
                            num_dense=1, dim=4, embed_dim=2,
                            query_mlp=(2,), item_mlp=(2,))

    def arrays(layers):
        return [tuple(t.detach().numpy() for t in layer) for layer in layers]

    def from_cpu(name, cfg):
        return getattr(ett, "init_" + name)(cfg, device="cpu")

    def dlrm_arrays():
        m = from_cpu("dlrm", dlrm)
        ett.dlrm_from_arrays(dlrm, arrays(m.bottom), arrays(m.top),
                             np.zeros((11, 4), np.float32),
                             m.tables.offsets)

    def dcn_arrays():
        m = from_cpu("dcn", dcn)
        ett.dcn_from_arrays(dcn, arrays(m.cross), arrays(m.deep),
                            arrays([m.head])[0], np.zeros((11, 4), np.float32),
                            m.tables.offsets)

    def deepfm_arrays():
        m = from_cpu("deepfm", dfm)
        ett.deepfm_from_arrays(dfm, arrays(m.deep), arrays([m.head])[0],
                               np.zeros(2, np.float32), np.float32(0),
                               np.zeros((11, 4), np.float32),
                               m.tables.offsets,
                               fm_w_data=np.zeros((11, 1), np.float32))

    def two_tower_arrays():
        m = from_cpu("two_tower", tt)
        ett.two_tower_from_arrays(tt, arrays(m.query_mlp),
                                  arrays(m.item_mlp),
                                  np.zeros((11, 4), np.float32),
                                  m.query_tables.offsets,
                                  np.zeros((7, 4), np.float32))

    def quantized_service():
        # The model cannot reach the quantized service without a device.
        ett.make_dlrm_service(ett.init_dlrm(dlrm), quantized=True)

    g = torch.Generator()
    table = np.zeros((11, 4), np.float32)
    return {
        "QREmbedding.create": lambda: ett.QREmbedding.create(g, 11, 4),
        "MDEmbedding.create": lambda: ett.MDEmbedding.create(g, 11, 4, 2),
        "TTEmbedding.create": lambda: ett.TTEmbedding.create(g, 11, 4),
        "TieredEmbedding.create": lambda: ett.TieredEmbedding.create(
            g, 11, 4, 3),
        "TieredEmbedding.from_array": lambda: ett.TieredEmbedding.from_array(
            table, 3),
        "HostOffloadEmbedding": lambda: ett.HostOffloadEmbedding(table),
        "quantize_dlrm": quantized_service,
        "quantized_from_arrays": lambda: ett.quantized_from_arrays(
            np.ones(11, np.float32), q=table.astype(np.int8)),
        "qr_from_arrays": lambda: ett.qr_from_arrays(table[:3], table[:4], 11),
        "md_from_arrays": lambda: ett.md_from_arrays(table[:, :2], table[:2]),
        "tt_from_arrays": lambda: ett.tt_from_arrays(
            [np.zeros((4, 1, 2, 2), np.float32),
             np.zeros((3, 2, 2, 1), np.float32)], 11),
        "tiered_from_arrays": lambda: ett.tiered_from_arrays(table[:3],
                                                             table[3:]),
        "init_dlrm": lambda: ett.init_dlrm(dlrm),
        "init_dcn": lambda: ett.init_dcn(dcn),
        "init_deepfm": lambda: ett.init_deepfm(dfm),
        "init_two_tower": lambda: ett.init_two_tower(tt),
        "dlrm_from_arrays": dlrm_arrays,
        "dcn_from_arrays": dcn_arrays,
        "deepfm_from_arrays": deepfm_arrays,
        "two_tower_from_arrays": two_tower_arrays,
        "train_dlrm": lambda: ett.train_dlrm(dlrm, iter(()), 0),
        "train_dcn": lambda: ett.train_dcn(dcn, iter(()), 0),
        "train_deepfm": lambda: ett.train_deepfm(dfm, iter(()), 0),
        "train_two_tower": lambda: ett.train_two_tower(tt, iter(()), 0),
        "train_dlrm_persistent": lambda: ett.train_dlrm(
            dlrm, iter(()), 0, ckpt_manager=object(), ckpt_every=1,
            guard=object(), delta_ckpt=object(), delta_every=1),
        "make_refreshable_service": lambda: ett.make_refreshable_service(
            ett.init_dlrm(dlrm)),
        "init_dlrm_dense_tx": lambda: ett.init_dlrm(dlrm, dense_tx=ADAM),
        "train_dlrm_input_options": lambda: ett.train_dlrm(
            dlrm, iter(()), 0, dense_tx=ADAM, microbatch=2,
            device_prefetch=2),
        "nn.Embed": lambda: ett.nn.Embed(5, 4),
        "nn.SparseEmbed": lambda: ett.nn.SparseEmbed(5, 4),
        "from_torch(array)": lambda: ett.from_torch(table),
        "local_mesh": lambda: ett.parallel.local_mesh(1),
        "default_mesh(devices=)": lambda: ett.parallel.default_mesh(
            ("data",), devices=[0]),
        "train_dcn_persistent": lambda: ett.train_dcn(
            dcn, iter(()), 0, ckpt_manager=object(), ckpt_every=1,
            guard=object(), delta_ckpt=object(), delta_every=1,
            evict_every=2),
    }


@pytest.mark.parametrize("entry", ["init_dlrm", "dlrm_from_arrays",
                                   "init_dcn", "dcn_from_arrays",
                                   "init_deepfm", "deepfm_from_arrays",
                                   "init_two_tower", "two_tower_from_arrays",
                                   "train_dlrm", "train_dcn", "train_deepfm",
                                   "train_two_tower", "QREmbedding.create",
                                   "MDEmbedding.create", "TTEmbedding.create",
                                   "TieredEmbedding.create",
                                   "TieredEmbedding.from_array",
                                   "HostOffloadEmbedding", "quantize_dlrm",
                                   "quantized_from_arrays", "qr_from_arrays",
                                   "md_from_arrays", "tt_from_arrays",
                                   "tiered_from_arrays",
                                   "train_dlrm_persistent",
                                   "make_refreshable_service",
                                   "init_dlrm_dense_tx",
                                   "train_dlrm_input_options", "nn.Embed",
                                   "nn.SparseEmbed", "from_torch(array)",
                                   "local_mesh", "default_mesh(devices=)",
                                   "train_dcn_persistent"])
def test_entry_points_without_a_device_raise_when_there_is_no_card(
        entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _no_device_calls()[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert ett.config.resolve_device("cpu") == torch.device("cpu")


def test_quantization_runs_where_the_model_lies_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                         bottom_mlp=(4,), top_mlp=(3, 1))
    model = ett.init_dlrm(cfg, device="cpu")
    qt, eval_fn = ett.quant.quantize_dlrm(model, bits=4)
    assert qt.packed.device.type == "cpu"
    out = eval_fn(np.zeros((3, 2), np.float32), np.zeros((2, 3), np.int32))
    assert out.device.type == "cpu" and out.shape == (3,)


def test_persistence_runs_where_its_templates_lie_without_a_card(
        monkeypatch, tmp_path):
    from embeddingtables_tpu_torch import utils
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                         bottom_mlp=(4,), top_mlp=(3, 1))
    model = ett.init_dlrm(cfg, device="cpu")
    ckpt = utils.CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, model)
    assert ckpt.restore_latest(ett.init_dlrm(cfg, device="cpu")) is not None
    mgr = utils.DeltaCheckpointManager(str(tmp_path / "delta"))
    tracker = utils.TouchedRowTracker(11)
    tracker.observe([2, 7])
    mgr.save(1, model.tables.data, model.emb_state, tracker)
    follower = utils.DeltaFollower(str(tmp_path / "delta"),
                                   model.tables.data)
    assert follower.poll() == 1 and follower.data.device.type == "cpu"
    with utils.phase("sync_without_a_card", sync=True):
        pass


def test_input_options_run_where_the_model_lies_without_a_card(monkeypatch):
    # dense_tx, microbatch and device_prefetch on the CPU: the prefetcher is
    # a host thread there, and nothing asks for a card.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                         bottom_mlp=(4,), top_mlp=(3, 1))
    data = ett.SyntheticCriteo(vocab_sizes=(5, 6), num_dense=2, batch_size=8)
    res = ett.train_dlrm(cfg, data.batches(), 2, dense_tx=ADAM, microbatch=2,
                         device_prefetch=2, device="cpu", verbose=False,
                         log_every=1)
    assert len(res.losses) == 2 and res.model.tables.data.device.type == "cpu"
    st = res.model.dense_opt_state
    assert float(st.bottom_params_0__step) == 2.0
    pf = ett.io.DevicePrefetcher(iter([{"x": np.ones(3)}]),
                                 lambda b: torch.as_tensor(b["x"]),
                                 device="cpu")
    batch, arg = next(pf)
    assert arg.device.type == "cpu" and torch.equal(arg, torch.ones(3,
                                                     dtype=torch.float64))


def test_a_mesh_forms_no_group_of_its_own():
    # No fallback: without a process group a mesh refuses, on the card's
    # backend or the CPU's, and forms no group itself.
    import torch.distributed as dist
    assert not dist.is_initialized()
    for device in ("cpu", None):
        with pytest.raises(RuntimeError, match="process group|device='cpu'"):
            ett.parallel.default_mesh(("data",), device=device)
    assert not dist.is_initialized()
    assert ett.parallel.mesh.backend_for(torch.device("cuda")) == "nccl"
    assert ett.parallel.mesh.backend_for(torch.device("cpu")) == "gloo"


def test_every_family_on_a_mesh_runs_where_its_model_lies(tmp_path):
    # A one-rank gloo group with no card visible: the sharded steps, evals
    # and mesh services of every family run on the CPU and ask for no card.
    from _torch_mesh import MeshPool
    pool = MeshPool(1, str(tmp_path))
    try:
        seen, = pool.run("families_where_they_lie")
    finally:
        pool.close()
    assert seen == ["cpu", "cpu", "numpy"] * 3 + ["cpu"] * 3 + ["numpy"]


def test_a_planned_model_runs_where_its_tables_lie(tmp_path):
    # A one-rank gloo group with no card visible: a planned DLRM and DCN
    # (replicated, row- and column-sharded tables) make their tables, step,
    # evaluate and serve on the CPU and ask for no card.
    from _torch_mesh import MeshPool
    pool = MeshPool(1, str(tmp_path))
    try:
        seen, = pool.run("planned_where_they_lie")
    finally:
        pool.close()
    assert seen == ["cpu", "cpu", "cpu", "numpy"] * 2
