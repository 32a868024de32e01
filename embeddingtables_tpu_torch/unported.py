"""The JAX package's options that the port does not have yet: one table for
every training loop, train step and service.

Each loop and service accepts every parameter of its JAX counterpart. An
option of `UNPORTED` at one of its off values does nothing; any other value
raises `NotImplementedError` naming what it waits for. Only the planner's
two-tower model waits now: `train_two_tower` refuses a `plan` (the CTR loops
take one). Options that JAX reads only together with another one
are accepted and ignored as JAX ignores them, since the one that gives them
a meaning is unset:

  - `axis`, `exchange`, `capacity_factor`, `auto_capacity` without `mesh`
    (the last three mean something only with `exchange="a2a"` on a mesh);
  - as in JAX, `evict_threshold` and `freq_decay` mean nothing without
    `evict_every`, `ckpt_every` nothing without `ckpt_manager`,
    `delta_every` nothing without `delta_ckpt`, nor `quantize_bits` without
    `quantized`.

Every other option is ported and read, beside a `mesh` too: the loops'
eviction, checkpoints, guard, delta checkpoints and `device_prefetch`, the
CTR loops' and train steps' `dense_tx` and `microbatch`, the services'
`quantized`, every family's `mesh` (with `axis`; `train_dlrm` and
`make_dlrm_service` also with `exchange`, `capacity_factor`,
`auto_capacity`, `wire_dtype`), and the CTR loops' `plan` with a `mesh`.

Where JAX raises on a combination, the callers raise the same exception
class first (`plan` without `mesh`, `wire_dtype` without an `a2a` mesh,
`delta_ckpt` without `delta_every`: `ValueError`; `plan` with another
exchange than "gather", `delta_ckpt` with a `plan`, a quantized service on a
`mesh`, and `microbatch` with the `a2a` exchange: `NotImplementedError`).
"""
from __future__ import annotations

# option: (the values at which it is off, what it waits for)
UNPORTED = {
    "plan": ((None,), "the planner's two-tower model (ROADMAP.md queue 1, "
                      "item I-3b)"),
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
    if delta_ckpt is not None and plan is not None:
        raise NotImplementedError(
            "delta checkpointing covers single-chip and uniform sharded "
            "placements (a planner placement has no single global row space)")
