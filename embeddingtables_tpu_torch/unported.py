"""The JAX package's options that the port does not have yet: one table for
every training loop, train step and service.

Each loop and service accepts every parameter of its JAX counterpart. An
option of `UNPORTED` at one of its off values does nothing; any other value
raises `NotImplementedError` naming what it waits for. An entry
`"mesh+<option>"` is refused only beside a `mesh` (`train_dlrm`'s mesh is
ported; its sharded persistence and eviction are not); `"mesh"` itself is
refused by the entry points whose sharded family waits (DCN, DeepFM, the
two-tower retriever and their services). Options that JAX reads only
together with another one are accepted and ignored as JAX ignores them,
since the one that gives them a meaning is unported or unset:

  - `axis`, `exchange`, `capacity_factor`, `auto_capacity` without `mesh`
    (the last three mean something only with `exchange="a2a"` on a mesh).

The loops' `evict_every` (with `evict_threshold` and `freq_decay`),
`ckpt_manager` (with `ckpt_every`), `guard`, `delta_ckpt` (with
`delta_every`) and `device_prefetch`, the CTR loops' and train steps'
`dense_tx` and `microbatch`, the services' `quantized` (with
`quantize_bits`), and `train_dlrm`'s and `make_dlrm_service`'s `mesh` (with
`axis`, `exchange`, `capacity_factor`, `auto_capacity`, `wire_dtype`) are
ported and read; as in JAX, `evict_threshold` and `freq_decay` mean nothing
without `evict_every`, `ckpt_every` nothing without `ckpt_manager`,
`delta_every` nothing without `delta_ckpt`, nor `quantize_bits` without
`quantized`.

Where JAX raises on a combination, the callers raise the same exception
class first (`plan` without `mesh`, `wire_dtype` without an `a2a` mesh,
`delta_ckpt` without `delta_every`: `ValueError`; `plan` with another
exchange than "gather", a quantized service on a `mesh`, and `microbatch`
with the `a2a` exchange: `NotImplementedError`).
"""
from __future__ import annotations

# option: (the values at which it is off, what it waits for)
_PERSIST = ("sharded persistence: ModRowLayout and the sharded checkpoint "
            "restores (ROADMAP.md queue 1, item I-2)")
UNPORTED = {
    "mesh": ((None,), "the sharded DCN, DeepFM and two-tower placements "
                      "(ROADMAP.md queue 1, item I-2)"),
    "plan": ((None,), "the planner (ROADMAP.md queue 1, item I-3)"),
    "mesh+ckpt_manager": ((None,), _PERSIST),
    "mesh+guard": ((None,), _PERSIST),
    "mesh+delta_ckpt": ((None,), _PERSIST),
    "mesh+evict_every": ((0,), "evict_rows_sharded (ROADMAP.md queue 1, "
                               "item I-2)"),
}


def _is_off(value, off) -> bool:
    return any(value is o or (o is not None and value == o) for o in off)


def refuse_unported(entry: str, **options) -> None:
    """Raise `NotImplementedError`, naming each of `options` (names of
    `UNPORTED`) that is set to a value that needs its unported feature."""
    on = {name: value for name, value in options.items()
          if not _is_off(value, UNPORTED[name][0])}
    if on:
        raise NotImplementedError(
            f"{entry}({', '.join(f'{k}={v!r}' for k, v in on.items())}) "
            f"waits for {', '.join(UNPORTED[k][1] for k in on)}")


def refuse_beside_mesh(entry: str, mesh, **options) -> None:
    """With a `mesh`, raise `NotImplementedError` naming each of `options`
    whose `"mesh+<option>"` entry of `UNPORTED` it sets."""
    if mesh is None:
        return
    on = {name: value for name, value in options.items()
          if not _is_off(value, UNPORTED[f"mesh+{name}"][0])}
    if on:
        raise NotImplementedError(
            f"{entry}(mesh={mesh!r}, "
            f"{', '.join(f'{k}={v!r}' for k, v in on.items())}) waits for "
            f"{', '.join(sorted({UNPORTED['mesh+' + k][1] for k in on}))}")


def check_jax_combinations(*, mesh=None, plan=None, delta_ckpt=None,
                           delta_every=0, wire_dtype=None,
                           exchange="gather") -> None:
    """What JAX's loops raise on an invalid combination of options, in
    JAX's order, before any unported option is refused."""
    if plan is not None and exchange != "gather":
        raise NotImplementedError(
            "planner-placed training supports the gather exchange only")
    if wire_dtype is not None and (mesh is None or exchange != "a2a"):
        raise ValueError(
            "wire_dtype requires mesh= with exchange='a2a' (it compresses "
            "the butterfly's row payloads; other paths would silently "
            "ignore it)")
    if plan is not None and mesh is None:
        raise ValueError("plan= requires mesh=")
    if delta_ckpt is not None and not delta_every:
        raise ValueError("delta_ckpt requires delta_every > 0")
