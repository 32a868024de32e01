"""JAX's public names in the port (fault F3, closed).

The walk: for every module of the JAX package that has a port counterpart
(`embeddingtables_tpu.X` -> `embeddingtables_tpu_torch.X`; the Pallas
kernels' `ops.pallas` -> `ops.cuda`), each public name the module defines
(a package: each name it exports from the package) is a name of the port's
module, or an entry of `PINNED`, whose reason is a line of ROADMAP.md: a
deliberate divergence of queue 3. No module is skipped (`SKIPPED` is
empty): the CLIs are ported too (`embeddingtables_tpu_torch/scripts/`).

Not part of F3, and not names of a module: the framework's own swaps of
parameters, `FRAMEWORK_SWAPS` (JAX's `key` is the port's `generator`; JAX's
`jit=` and flax's `table_init`, `parent` and `name` have no torch meaning).

Then the wrappers F3 added are held against JAX's functions on a 4-rank
gloo group: the sharded Adam and FTRL applies, the four butterfly updates
(rtol 1e-5 / atol 1e-6, as `test_torch_mesh.py`), `default_mesh(devices=)`,
`batch_shardings` and `shard_table`, the models' aliases and `auc_jax`
(rtol 1e-6).
"""
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import embeddingtables_tpu as J
from embeddingtables_tpu import metrics as JMET
from embeddingtables_tpu import optim as JO
from embeddingtables_tpu.ops.sparse_update import SparseEmbeddingUpdate
from embeddingtables_tpu.parallel import alltoall as JA
from embeddingtables_tpu.parallel import sharded as JS
from embeddingtables_tpu.parallel.mesh import local_mesh
import embeddingtables_tpu_torch as ett
from embeddingtables_tpu_torch import optim as PO
from _torch_mesh import MeshPool
from _torch_threads import _one_torch_thread  # noqa: F401

ROADMAP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ROADMAP.md")

SKIPPED = {}

_NO_SWITCH = "**No kernel switch.**"
PINNED = {
    ("embeddingtables_tpu.config", name): _NO_SWITCH
    for name in ("lookup_impl", "update_impl", "set_lookup_impl",
                 "set_update_impl", "on_tpu", "pallas_interpret",
                 "set_pallas_interpret", "use_impl")}

FRAMEWORK_SWAPS = {"key": "generator", "jit": None, "table_init": None,
                   "parent": None, "name": None}


def port_module(name: str) -> str:
    return name.replace("embeddingtables_tpu", "embeddingtables_tpu_torch",
                        1).replace(".ops.pallas", ".ops.cuda")


def jax_modules():
    yield "embeddingtables_tpu", True
    for info in pkgutil.walk_packages(J.__path__, "embeddingtables_tpu."):
        yield info.name, info.ispkg


def public_names(module, is_pkg: bool) -> list:
    """The public names `module` defines, or (a package) exports."""
    out = []
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        home = getattr(value, "__module__", None) or ""
        if (is_pkg and home.startswith("embeddingtables_tpu.")) or \
                home == module.__name__:
            out.append(name)
    return out


def test_every_public_jax_name_has_a_port_name_or_a_roadmap_entry():
    roadmap = open(ROADMAP).read()
    for reason in set(PINNED.values()) | set(SKIPPED.values()):
        assert reason in roadmap, reason
    missing, walked = [], 0
    for name, is_pkg in jax_modules():
        if any(name == s or name.startswith(s + ".") for s in SKIPPED):
            continue
        port = importlib.import_module(port_module(name))
        module = importlib.import_module(name)
        for attr in public_names(module, is_pkg):
            walked += 1
            if not hasattr(port, attr) and (name, attr) not in PINNED:
                missing.append(f"{name}.{attr}")
    assert walked > 300
    assert missing == []


def test_the_pinned_names_are_absent_from_the_port():
    # A pinned name that the port gains must leave the table.
    for module, attr in PINNED:
        assert not hasattr(importlib.import_module(port_module(module)), attr)


def test_framework_swaps_are_parameters_not_names():
    """`key` -> `generator` where the port's wrappers take JAX's key."""
    for fn in ("sharded_sgd_update_a2a", "sharded_adagrad_update_a2a",
               "sharded_adam_update_a2a"):
        jp = inspect.signature(getattr(JA, fn)).parameters
        pp = inspect.signature(getattr(ett.parallel.alltoall, fn)).parameters
        assert "key" in jp and FRAMEWORK_SWAPS["key"] in pp
        assert {n for n in jp if n not in pp} == {"key"}
    assert "generator" in inspect.signature(
        ett.parallel.sharded.sharded_adam_apply).parameters


def test_the_models_aliases_are_the_family_steps():
    from embeddingtables_tpu_torch.models import dcn, deepfm
    assert ett.models.make_dcn_train_step is dcn.make_train_step
    assert ett.models.make_dcn_eval_step is dcn.make_eval_step
    assert ett.models.make_deepfm_train_step is deepfm.make_train_step
    assert ett.models.make_deepfm_eval_step is deepfm.make_eval_step


@pytest.mark.parametrize("ties", [False, True])
def test_auc_jax_matches_jax(ties):
    rng = np.random.default_rng(3)
    y = (rng.random(501) < 0.3).astype(np.float32)
    s = rng.standard_normal(501).astype(np.float32)
    if ties:
        s = np.round(s, 1)
    got = ett.metrics.auc_jax(torch.from_numpy(y), torch.from_numpy(s))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(JMET.auc_jax(y, s)),
                               rtol=1e-6)
    assert float(ett.metrics.auc_jax(torch.ones(4), torch.arange(4.0))) == 0


def test_a_mesh_covers_the_group():
    """Divergence pin (ROADMAP.md queue 3, "A mesh covers the group"):
    JAX's `local_mesh(n)` takes the first n devices of its one process;
    here ranks outside a mesh would miss its collectives."""
    from embeddingtables_tpu_torch.parallel.mesh import _mesh_ranks
    assert _mesh_ranks([2, 0, 3, 1], 4).tolist() == [2, 0, 3, 1]
    with pytest.raises(ValueError, match="ROADMAP.md queue 3"):
        _mesh_ranks([0, 1], 4)


def test_batch_shardings_are_block_callables():
    """Divergence pin (ROADMAP.md queue 3, "Block shardings"): a sharding
    is a callable that takes this rank's block of a global array."""
    from embeddingtables_tpu_torch.parallel.dlrm import BlockSharding

    class Ex:
        n_data, data_index = 4, 2
    x = np.arange(24).reshape(8, 3)
    np.testing.assert_array_equal(BlockSharding(Ex, 0)(x), x[4:6])
    np.testing.assert_array_equal(BlockSharding(Ex, 1)(x.T), x.T[:, 4:6])


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = MeshPool(4, str(tmp_path_factory.mktemp("mesh")))
    yield p
    p.close()


def put(mesh, x, spec=P("data")):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


V, D, B, T = 37, 8, 16, 2
OPTS = {"sgd": (JO.SparseSGD(0.5), PO.SparseSGD(0.5)),
        "adagrad": (JO.SparseRowWiseAdaGrad(0.5, eps=1e-6),
                    PO.SparseRowWiseAdaGrad(0.5, eps=1e-6)),
        "adam": (JO.SparseLazyAdam(0.05), PO.SparseLazyAdam(0.05)),
        "ftrl": (JO.SparseFTRL(0.1, l1=0.01), PO.SparseFTRL(0.1, l1=0.01))}


@pytest.mark.parametrize("name", ["adam", "ftrl"])
def test_sharded_adam_and_ftrl_apply_match_jax(pool, name):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((V, D)).astype(np.float32)
    shifted = rng.integers(0, V, (T, B)).astype(np.int32)
    delta = rng.standard_normal((T, B, D)).astype(np.float32)
    jopt, popt = OPTS[name]
    mesh = local_mesh(4)
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    sidx, sdelta = put(mesh, shifted, P(None, "data")), put(
        mesh, delta, P(None, "data"))
    if name == "adam":
        m, v, c = JS.init_sharded_adam_state(mesh, st)
        st, m, v, c = jax.jit(lambda s, m, v, c, i, d: JS.sharded_adam_apply(
            mesh, s, m, v, c, i, d, jopt))(st, m, v, c, sidx, sdelta)
        want_state = JS.unshard_adam_state(st, m, v, c)
    else:
        z, n = JS.init_sharded_ftrl_state(mesh, st, jopt)
        st, z, n = jax.jit(lambda s, z, n, i, d: JS.sharded_ftrl_apply(
            mesh, s, z, n, i, d, jopt))(st, z, n, sidx, sdelta)
        want_state = JS.unshard_row_state(st, (z, n))
    for got, state in pool.run("f3_gather_apply", table, shifted, delta,
                               popt, name):
        np.testing.assert_allclose(got, np.asarray(st.unshard()), rtol=1e-5,
                                   atol=1e-6)
        for g, w in zip(state, want_state):
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam", "ftrl"])
def test_butterfly_updates_match_jax(pool, name):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((V, D)).astype(np.float32)
    upd = dict(delta=rng.standard_normal((B, D)).astype(np.float32),
               indices=rng.integers(0, V, B).astype(np.int32))
    jopt, popt = OPTS[name]
    mesh = local_mesh(4)
    st = JS.ShardedStackedTables.shard(mesh, "data", jnp.asarray(table))
    u = SparseEmbeddingUpdate(delta=put(mesh, upd["delta"]),
                              indices=put(mesh, upd["indices"]))
    kw = dict(capacity_factor=4.0)
    if name == "sgd":
        st, ovf = jax.jit(lambda s, u: JA.sharded_sgd_update_a2a(
            mesh, s, u, 0.5, **kw))(st, u)
        want_state = []
    else:
        acc = JS.init_sharded_row_state(mesh, st, jopt)
        if name == "adagrad":
            st, acc, ovf = jax.jit(lambda s, a, u: JA.sharded_adagrad_update_a2a(
                mesh, s, a, u, jopt, **kw))(st, acc, u)
        elif name == "adam":
            st, m, v, c, ovf = jax.jit(lambda s, a, u: JA.sharded_adam_update_a2a(
                mesh, s, *a, u, jopt, **kw))(st, acc, u)
            acc = (m, v, c)
        else:
            st, z, n, ovf = jax.jit(lambda s, a, u: JA.sharded_ftrl_update_a2a(
                mesh, s, *a, u, jopt, **kw))(st, acc, u)
            acc = (z, n)
        want_state = list(JS.unshard_row_state(st, acc))
    for got, state, got_ovf in pool.run("f3_a2a", table, upd, popt, name):
        assert got_ovf == int(ovf) == 0
        np.testing.assert_allclose(got, np.asarray(st.unshard()), rtol=1e-5,
                                   atol=1e-6)
        for g, w in zip(state, want_state):
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=1e-5, atol=1e-6)


def test_default_mesh_batch_shardings_and_shard_table(pool):
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((8, 3)).astype(np.float32)
    cat = rng.integers(0, 9, (2, 8)).astype(np.int32)
    want = JS.shard_table(local_mesh(4), "data", jnp.asarray(dense)).data
    for r, (grid, d_ok, c_ok, shard) in enumerate(pool.run(
            "f3_meshes", dense, cat)):
        assert grid == [0, 1, 2, 3] and d_ok and c_ok
        np.testing.assert_array_equal(shard, np.asarray(want)[r])
