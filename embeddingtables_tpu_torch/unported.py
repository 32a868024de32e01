"""The JAX package's options that the port does not have yet, and JAX's own
errors on invalid combinations of options.

Each loop and service accepts every parameter of its JAX counterpart, and
every option is ported: `UNPORTED` (option -> (the values at which it is
off, what it waits for)) is empty. Options that JAX reads only together
with another one are accepted and ignored as JAX ignores them, since the
one that gives them a meaning is unset:

  - `axis`, `exchange`, `capacity_factor`, `auto_capacity` without `mesh`
    (the last three mean something only with `exchange="a2a"` on a mesh);
  - as in JAX, `evict_threshold` and `freq_decay` mean nothing without
    `evict_every`, `ckpt_every` nothing without `ckpt_manager`,
    `delta_every` nothing without `delta_ckpt`, nor `quantize_bits` without
    `quantized`.

Where JAX raises on a combination, the callers raise the same exception
class first (`plan` without `mesh`, `wire_dtype` without an `a2a` mesh,
`delta_ckpt` without `delta_every`: `ValueError`; `plan` with another
exchange than "gather", `delta_ckpt` with a `plan`, a quantized service on a
`mesh`, and `microbatch` with the `a2a` exchange: `NotImplementedError`).
"""
from __future__ import annotations

# option: (the values at which it is off, what it waits for)
UNPORTED = {}


def check_jax_combinations(*, mesh=None, plan=None, delta_ckpt=None,
                           delta_every=0, wire_dtype=None,
                           exchange="gather") -> None:
    """What JAX's loops raise on an invalid combination of options, in
    JAX's order."""
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
