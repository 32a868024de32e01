"""Every loop and service of the port takes every parameter of its JAX
counterpart (`embeddingtables_tpu_torch/unported.py`).

Each entry point is called with every keyword parameter of the JAX
function, read by `inspect.signature`, at JAX's default, on a 2-table
configuration on the CPU for one step: it must run. Then: values JAX
ignores are ignored, JAX's `ValueError`s on invalid combinations are raised,
no option is unported (the two-tower loop's `plan` trains the planned model
on a one-rank gloo group in this process), and an unknown name raises
`TypeError` as Python does.
"""
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

import embeddingtables_tpu.models.train as jax_train
import embeddingtables_tpu.serving as jax_serving
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch.data import SyntheticCriteo, SyntheticRetrieval
from embeddingtables_tpu_torch.models import train as port_train
from _torch_threads import _one_torch_thread  # noqa: F401

VOCABS = (13, 29)
B = 8
CTR = {
    "dlrm": lambda: ett.DLRMConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                                   bottom_mlp=(16, 8), top_mlp=(16, 1)),
    "dcn": lambda: ett.DCNConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                                 deep_mlp=(16, 8), num_cross=1),
    "deepfm": lambda: ett.DeepFMConfig(vocab_sizes=VOCABS, num_dense=3, dim=8,
                                       deep_mlp=(16, 8)),
}
INIT = {"dlrm": ett.init_dlrm, "dcn": ett.init_dcn, "deepfm": ett.init_deepfm}


def _two_tower_cfg():
    return ett.TwoTowerConfig(query_vocab_sizes=VOCABS, item_vocab=40,
                              num_dense=3, dim=8, embed_dim=8,
                              query_mlp=(16, 8), item_mlp=(16, 8))


def _jax_defaults(fn):
    """{name: default} of `fn`'s keyword parameters."""
    return {name: p.default for name, p in inspect.signature(fn).parameters.items()
            if p.kind is p.KEYWORD_ONLY}


def _ctr_batches(cfg):
    return SyntheticCriteo(vocab_sizes=cfg.vocab_sizes, num_dense=3,
                           batch_size=B, seed=1).batches()


def _tt_batches():
    return SyntheticRetrieval(query_vocab_sizes=VOCABS, item_vocab=40,
                              num_dense=3, batch_size=B, seed=1).batches()


def _tt_plans(mesh):
    """The planned two-tower model's `(q_plan, i_plan)`: the query tables
    replicated, the corpus row-sharded (by hand on one rank)."""
    import dataclasses
    from embeddingtables_tpu_torch.parallel import ROW_SHARD, plan_sharding
    cfg = _two_tower_cfg()
    ip = plan_sharding([cfg.item_vocab], cfg.dim, mesh)
    ip = dataclasses.replace(ip, decisions=(dataclasses.replace(
        ip.decisions[0], placement=ROW_SHARD),))
    return plan_sharding(cfg.query_vocab_sizes, cfg.dim, mesh), ip


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group in this process and its mesh (left after the
    module's tests)."""
    from embeddingtables_tpu_torch.parallel import init_process, local_mesh
    store = tmp_path_factory.mktemp("options_group") / "store"
    init_process(f"file://{store}", 1, 0, device="cpu")
    try:
        yield local_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _planned_tt(mesh, **kw):
    """`train_two_tower(mesh=, plan=)` for one step on the one-rank group:
    the planned loop."""
    res = port_train.train_two_tower(_two_tower_cfg(), _tt_batches(), 1,
                                     device="cpu", mesh=mesh,
                                     plan=_tt_plans(mesh), **kw)
    assert type(res.model).__name__ == "PlannedTwoTower"
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()
    return res


def _run_ctr(family, **kw):
    cfg = CTR[family]()
    loop = getattr(port_train, f"train_{family}")
    return loop(cfg, _ctr_batches(cfg), 1, device="cpu", **kw)


@pytest.mark.parametrize("family", sorted(CTR))
def test_ctr_loop_takes_every_jax_parameter_at_its_default(family):
    kw = _jax_defaults(getattr(jax_train, f"train_{family}"))
    kw["verbose"] = False
    res = _run_ctr(family, **kw)
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()


def test_two_tower_loop_takes_every_jax_parameter_at_its_default():
    kw = _jax_defaults(jax_train.train_two_tower)
    kw["verbose"] = False
    res = port_train.train_two_tower(_two_tower_cfg(), _tt_batches(), 1,
                                     device="cpu", **kw)
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()


@pytest.mark.parametrize("name", ["evaluate_auc", "evaluate_metrics"])
def test_evaluate_takes_every_jax_parameter_at_its_default(name):
    cfg = CTR["dlrm"]()
    model = ett.init_dlrm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batches = list(SyntheticCriteo(vocab_sizes=VOCABS, num_dense=3,
                                   batch_size=64, seed=2).batches(1))
    kw = _jax_defaults(getattr(jax_train, name))
    out = getattr(port_train, name)(ett.make_eval_step(cfg), model, batches,
                                    **kw)
    value = out if name == "evaluate_auc" else out["auc"]
    assert 0.0 <= value <= 1.0


def _service_model(family):
    if family == "retrieval":
        return ett.init_two_tower(_two_tower_cfg(),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    return INIT[family](CTR[family](), torch.Generator().manual_seed(0),
                        device="cpu")


def _serve_once(svc, family):
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((2, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, 2) for v in VOCABS]).astype(np.int32)
    try:
        out = svc.predict(dense, cat, timeout=30)
    finally:
        svc.stop()
    scores = out[0] if family == "retrieval" else out
    assert np.isfinite(scores).all()


@pytest.mark.parametrize("family", ["dlrm", "dcn", "deepfm", "retrieval"])
def test_service_takes_every_jax_parameter_at_its_default(family):
    fn = f"make_{family}_service"
    kw = _jax_defaults(getattr(jax_serving, fn))
    _serve_once(getattr(ett, fn)(_service_model(family), **kw), family)


# What JAX ignores: each option whose meaning needs another option that is
# not set (mesh, exchange="a2a", ckpt_manager, evict_every, delta_ckpt).
IGNORED = {"axis": "model", "exchange": "a2a", "capacity_factor": 4.0,
           "auto_capacity": True, "ckpt_every": 5, "evict_threshold": 0.5,
           "freq_decay": 0.5, "delta_every": 3, "microbatch": 1}


@pytest.mark.parametrize("family", sorted(CTR) + ["two_tower"])
def test_values_jax_ignores_are_ignored(family):
    jax_loop = getattr(jax_train, f"train_{family}")
    kw = {k: v for k, v in IGNORED.items()
          if k in inspect.signature(jax_loop).parameters}
    if family == "two_tower":
        res = port_train.train_two_tower(_two_tower_cfg(), _tt_batches(), 1,
                                         device="cpu", verbose=False, **kw)
    else:
        res = _run_ctr(family, verbose=False, **kw)
    assert np.isfinite(res.losses).all()


@pytest.mark.parametrize("family", ["dlrm", "retrieval"])
def test_service_values_jax_ignores_are_ignored(family):
    kw = {"axis": "model"}
    if family != "retrieval":
        kw["quantize_bits"] = 4
    fn = f"make_{family}_service"
    _serve_once(getattr(ett, fn)(_service_model(family), **kw), family)


@pytest.mark.parametrize("kw", [
    dict(wire_dtype=torch.bfloat16),
    dict(wire_dtype=torch.bfloat16, exchange="a2a"),
    dict(plan=object()),
    dict(delta_ckpt=object()),
], ids=["wire_dtype", "wire_dtype_a2a_without_mesh", "plan_without_mesh",
        "delta_ckpt_without_delta_every"])
def test_invalid_combinations_raise_what_jax_raises(kw):
    # JAX's own checks (embeddingtables_tpu/models/train.py): ValueError.
    with pytest.raises(ValueError):
        _run_ctr("dlrm", **kw)


def test_planner_with_another_exchange_raises_as_jax_does():
    with pytest.raises(NotImplementedError, match="gather exchange"):
        _run_ctr("dlrm", plan=object(), mesh=object(), exchange="a2a")


CTR_LOOPS = ("train_dlrm", "train_dcn", "train_deepfm")


@pytest.mark.parametrize("entry,kw", [
    ("train_dlrm", dict(mesh=object(), ckpt_manager=object(), plan=object())),
    ("train_dcn", dict(mesh=object(), plan=object())),
    ("train_deepfm", dict(mesh=object(), plan=object())),
    ("train_two_tower", dict(mesh=object(), plan=object())),
    ("make_deepfm_service", dict(mesh=object())),
    ("make_retrieval_service", dict(mesh=object())),
])
def test_an_unported_value_raises_not_implemented(request, entry, kw):
    """No option is unported. The two-tower loop's `plan` trains the
    planned model (one step on a one-rank group); a mesh service of a model
    no sharded placement made names the planner (item I-3), as JAX has no
    such service. The CTR loops take a plan: they reach the fake mesh, as
    the retrieval service, which takes the single-device model, does."""
    name = "plan" if "plan" in kw else "mesh"
    if entry == "train_two_tower":
        _planned_tt(request.getfixturevalue("mesh1"), verbose=False)
        return

    def call():
        if entry.startswith("train_"):
            _run_ctr(entry[len("train_"):], **kw)
        else:
            family = entry[len("make_"):-len("_service")]
            getattr(ett, entry)(_service_model(family), **kw)

    if entry == "make_retrieval_service" or entry in CTR_LOOPS:
        with pytest.raises(AttributeError):
            call()
        return
    with pytest.raises(NotImplementedError,
                       match=f"{entry}\\({name}=.*I-3"):
        call()


def test_an_unknown_name_raises_type_error():
    with pytest.raises(TypeError, match="no_such_option"):
        _run_ctr("dcn", no_such_option=1)
    with pytest.raises(TypeError, match="guard"):
        port_train.train_two_tower(_two_tower_cfg(), _tt_batches(), 1,
                                   device="cpu", guard=object())


@pytest.mark.parametrize("kw", [
    dict(ckpt_manager=object(), ckpt_every=1), dict(guard=object()),
    dict(delta_ckpt=object(), delta_every=1), dict(evict_every=2),
], ids=["ckpt_manager", "guard", "delta_ckpt", "evict_every"])
def test_train_dlrm_on_a_mesh_refuses_what_waits_for_item_i2(kw):
    # Sharded persistence and eviction (item I-2b) are ported, and the
    # planner for the CTR loops (items I-2c and I-3a): beside a (here fake)
    # mesh, with or without a plan, the option is accepted and the loop
    # reaches the mesh; only delta checkpoints under a plan raise JAX's
    # NotImplementedError, before anything touches the mesh.
    with pytest.raises(AttributeError):
        _run_ctr("dlrm", mesh=object(), **kw)
    if "delta_ckpt" in kw:
        with pytest.raises(NotImplementedError, match="delta checkpointing"):
            _run_ctr("dlrm", mesh=object(), plan=object(), **kw)
    else:
        with pytest.raises(AttributeError):
            _run_ctr("dlrm", mesh=object(), plan=object(), **kw)


@pytest.mark.parametrize("entry", ["train_dcn", "train_deepfm",
                                   "train_two_tower", "make_dcn_service",
                                   "make_deepfm_service",
                                   "make_retrieval_service"])
def test_the_other_families_mesh_waits_for_item_i2(request, entry):
    # Every family's mesh is ported (item I-2a): the loops and the
    # retrieval service reach the (here fake) mesh; a CTR mesh service
    # takes the family's sharded model (or the DLRM's and DCN's planned
    # one) and names the planner (item I-3) for any other; the CTR loops
    # take a plan and reach the mesh, and the two-tower loop's plan trains
    # the planned model on a real (one-rank) mesh (item I-3b).
    if entry.startswith("make_"):
        family = entry[len("make_"):-len("_service")]
        if family == "retrieval":
            with pytest.raises(AttributeError):
                ett.make_retrieval_service(_service_model(family),
                                           mesh=object())
        else:
            with pytest.raises(NotImplementedError, match=r"mesh=.*I-3"):
                getattr(ett, entry)(_service_model(family), mesh=object())
        return
    if entry == "train_two_tower":
        with pytest.raises(AttributeError):
            port_train.train_two_tower(_two_tower_cfg(), _tt_batches(), 1,
                                       device="cpu", mesh=object())
        _planned_tt(request.getfixturevalue("mesh1"), verbose=False,
                    log_every=1, eval_every=1,
                    eval_batches=list(SyntheticRetrieval(
                        query_vocab_sizes=VOCABS, item_vocab=40,
                        num_dense=3, batch_size=B, seed=2).batches(1)))
        return
    for kw in (dict(mesh=object()), dict(mesh=object(), plan=object())):
        with pytest.raises(AttributeError):
            _run_ctr(entry[len("train_"):], **kw)


def test_the_unported_table_names_each_option_and_its_item(mesh1):
    """Every option is ported: the table is empty, and the two-tower loop
    takes every JAX parameter at its default beside a mesh and a plan."""
    from embeddingtables_tpu_torch.unported import UNPORTED
    assert UNPORTED == {}
    kw = _jax_defaults(jax_train.train_two_tower)
    kw.update(verbose=False, mesh=mesh1)
    del kw["plan"]
    _planned_tt(**kw)
