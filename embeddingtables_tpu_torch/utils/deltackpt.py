"""Incremental (delta) checkpoints: save only the rows touched since the last
checkpoint (counterpart of `embeddingtables_tpu/utils/deltackpt.py`).

The tables are most of a recommendation model's bytes, and a training
interval touches a small, skewed share of their rows. So a
`DeltaCheckpointManager` writes:

  - a full base (`base_<step>/`, `utils.checkpoint.save_checkpoint` of
    `(data, state)`, one file per tensor) every `base_every` saves, with a
    `rowlayout_<step>.json` naming the row layout it was saved in;
  - in between, a delta (`delta_<step>.npz`): the touched global row ids,
    their current values, and the same rows of every row-wise optimizer
    state leaf, gathered on the card with one `gather_rows` launch per leaf
    and copied to the host, O(touched rows), never O(vocab).

Restore = the base, then each delta's rows set (`index_copy_`, whole rows:
bit-preserving) in step order, so a restored state is bitwise the live one.

The delta files are the JAX package's format: a delta written by either
package applies in the other. A bfloat16 array is stored as its `uint16`
view with a `<key>__mldt` entry naming `bfloat16` (numpy has no bfloat16 of
its own; the conversion goes through `tensor.view(torch.int16)`). The bases
are torch-native files, not orbax's: JAX and the port cannot read each
other's bases.

Which rows were touched is known on the host for free: the loops hold each
batch's ids before they move it to the card, and the lazy sparse update
touches exactly the looked-up rows. `TouchedRowTracker.observe` is a numpy
mask write.

Optimizer-state convention (as `optim.py`): a state leaf whose leading
dimension is the vocab (AdaGrad's `(V,)` accumulator, Adam's `(V, D)`
moments, FTRL's `(V, D)` z and n) is row-sliced (`srow_<i>`); any other
(Adam's step count, SGD's zero-size placeholder) is saved whole in every
delta (`sfull_<i>`), `i` counting the state's leaves in JAX's order.

Layouts: `FlatRowLayout`, the `(V, ...)` tensors of one device, and
`ModRowLayout`, a mod-row-sharded table (`parallel.ShardedStackedTables`):
global row r on the rank of flattened index `r % n`, at slot `r // n` of
its `(rows_per_shard, ...)` shard. JAX's mod layout is one global
`(n, rows_per_shard, ...)` array whose collectives XLA inserts; here each
rank holds its shard, so under a `ModRowLayout` every rank of the
placement joins each save and restore:

  - a delta's rows are gathered by their owners and all-gathered (one
    `gather_rows` a leaf on each rank), and the rank of index 0 writes the
    one `delta_<step>.npz`, keyed by global row as JAX's: a delta written
    by either package, from either layout, applies in the other;
  - a base is written as one part per rank (`utils.checkpoint`'s sharded
    checkpoints) with `rowlayout_<step>.json` naming `{"kind": "mod", "n",
    "rps"}`;
  - a restore reads the base in its own layout, or re-lays it by global
    row (`_restore_base_converted`: a flat base into a sharded model, a
    sharded base into a flat one or onto another rank count), then sets
    each delta's rows on their owners.

Every rank must hold the same touched rows (the loops feed each rank's
tracker the same global batches).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.cuda.gather import gather_rows
from .checkpoint import (barrier, load_leaf, named_leaves, read_index,
                         restore_checkpoint, save_checkpoint)


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TouchedRowTracker:
    """Host-side record of which global rows were touched since `clear()`.

    Feed it the host-side id batches the input pipeline already holds. For
    a `StackedTables` ensemble pass the per-table `(T, B[, bag])` batch and
    the stacked `offsets`; the tracker shifts to global stacked row ids."""

    def __init__(self, vocab: int):
        self.vocab = int(vocab)
        self._mask = np.zeros(self.vocab, dtype=bool)

    def observe(self, indices) -> None:
        """Mark global row ids (any shape) as touched."""
        idx = _host(indices).ravel()
        if idx.size:
            self._mask[idx] = True

    def observe_batch(self, cat, offsets: Sequence[int],
                      pad_idx: Optional[int] = None) -> None:
        """Mark a `(T, B[, bag])` per-table batch, shifting table t's ids by
        `offsets[t]`. `pad_idx` entries (variable-length bag sentinels) are
        not rows."""
        cat = _host(cat)
        offs = np.asarray(offsets[:cat.shape[0]], dtype=cat.dtype)
        flat = (cat + offs.reshape((-1,) + (1,) * (cat.ndim - 1))).ravel()
        if pad_idx is not None:
            flat = flat[cat.ravel() != pad_idx]
        if flat.size:
            self._mask[flat] = True

    def rows(self) -> np.ndarray:
        """Touched global row ids, ascending, int32."""
        return np.nonzero(self._mask)[0].astype(np.int32)

    def count(self) -> int:
        return int(self._mask.sum())

    def clear(self) -> None:
        self._mask[:] = False


class FlatRowLayout:
    """The `(V, ...)` global-row layout: global row r is leaf[r]."""

    def __init__(self, vocab: int):
        self.vocab = int(vocab)

    def is_rowwise(self, leaf) -> bool:
        shape = tuple(getattr(leaf, "shape", ()))
        return len(shape) >= 1 and shape[0] == self.vocab and self.vocab > 0

    def take(self, leaf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """The rows of `leaf` at the int32 `rows`, one `gather_rows` (the
        kernel on the card); a `(V,)` leaf is gathered as `(V, 1)`."""
        flat = leaf.detach().reshape(leaf.shape[0], -1)
        return gather_rows(flat, rows).reshape(
            (rows.shape[0],) + tuple(leaf.shape[1:]))

    def set(self, leaf: torch.Tensor, rows: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
        """Set whole rows of `leaf` in place; returns `leaf`."""
        with torch.no_grad():
            return leaf.index_copy_(0, rows.to(leaf.device).long(),
                                    vals.to(leaf.device, leaf.dtype))


class ModRowLayout:
    """The mod-row-sharded layout of a `parallel.ShardedStackedTables`:
    global row r at slot `r // n` of the `(rows_per_shard, ...)` shard of
    the rank of flattened index `r % n` (`exchange`, the placement's
    `parallel.sharded.Exchange`). `take` is a collective; `set` writes this
    rank's rows only."""

    def __init__(self, n_shards: int, rows_per_shard: int, exchange=None):
        self.n = int(n_shards)
        self.rps = int(rows_per_shard)
        self.exchange = exchange

    @classmethod
    def for_tables(cls, sharded_tables) -> "ModRowLayout":
        ex = sharded_tables.exchange
        return cls(ex.n, sharded_tables.rows_local, ex)

    def is_rowwise(self, leaf) -> bool:
        shape = tuple(getattr(leaf, "shape", ()))
        return len(shape) >= 1 and shape[0] == self.rps and self.rps > 0

    def take(self, leaf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """The global `rows` of the sharded `leaf` on every rank (a
        collective): each rank gathers the rows it owns (`gather_rows`),
        then the owners' rows are all-gathered and put in `rows`' order."""
        ex = self.exchange
        rest = tuple(leaf.shape[1:])
        flat = leaf.detach().reshape(leaf.shape[0], -1)
        rows = rows.to(leaf.device)
        if not rows.numel():
            return flat[:0].reshape((0,) + rest)
        owner = torch.remainder(rows, self.n).long()
        mine = (owner == ex.me).nonzero().squeeze(1)
        vals = gather_rows(flat, torch.div(rows[mine], self.n,
                                           rounding_mode="floor")
                           .to(torch.int32).contiguous())
        counts = torch.bincount(owner, minlength=self.n)
        cmax = int(counts.max())
        padded = flat.new_zeros((cmax, flat.shape[1]))
        padded[:vals.shape[0]] = vals
        got = ex.gather_flat(padded)                  # (n, cmax, width)
        valid = torch.arange(cmax, device=leaf.device)[None, :] < \
            counts[:, None]
        out = flat.new_empty((rows.numel(), flat.shape[1]))
        out[torch.argsort(owner, stable=True)] = got[valid]
        return out.reshape((rows.numel(),) + rest)

    def set(self, leaf: torch.Tensor, rows: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
        """Set this rank's rows of the global `rows` in place; returns
        `leaf`."""
        rows = rows.to(leaf.device).long()
        mine = (torch.remainder(rows, self.n) == self.exchange.me) & \
            (rows >= 0)
        with torch.no_grad():
            return leaf.index_copy_(
                0, torch.div(rows[mine], self.n, rounding_mode="floor"),
                vals.to(leaf.device, leaf.dtype)[mine])


def snapshot_delta(data: torch.Tensor, state, rows, layout=None) -> dict:
    """The touched `rows` of `data` and of every row-wise leaf of `state`,
    on the host: one gather per leaf on the leaf's device, O(rows), never
    O(vocab). Keys: `rows`, `vals`, `srow_<i>` / `sfull_<i>` by the
    state's leaf position; values are CPU tensors."""
    layout = layout or FlatRowLayout(data.shape[0])
    rows = np.ascontiguousarray(_host(rows), dtype=np.int32)
    idx = torch.from_numpy(rows).to(data.device)
    out = {"rows": torch.from_numpy(rows),
           "vals": layout.take(data, idx).cpu()}
    for i, (_, leaf) in enumerate(named_leaves(state)):
        if layout.is_rowwise(leaf):
            out[f"srow_{i}"] = layout.take(leaf, idx).cpu()
        else:
            out[f"sfull_{i}"] = leaf.detach().to("cpu", copy=True)
    return out


def apply_delta(data: torch.Tensor, state, delta: dict, layout=None):
    """Set a `snapshot_delta` dict's rows into `(data, state)`, in place,
    whole rows (not added: the delta holds the rows' values after the
    update); returns `(data, state)`."""
    layout = layout or FlatRowLayout(data.shape[0])
    rows = torch.as_tensor(delta["rows"])
    layout.set(data, rows, torch.as_tensor(delta["vals"]))
    for i, (_, leaf) in enumerate(named_leaves(state)):
        if layout.is_rowwise(leaf):
            layout.set(leaf, rows, torch.as_tensor(delta[f"srow_{i}"]))
        elif f"sfull_{i}" in delta:
            full = torch.as_tensor(delta[f"sfull_{i}"])
            with torch.no_grad():
                leaf.copy_(full.reshape(leaf.shape))
    return data, state


def _layout_meta(layout, data) -> dict:
    """Serializable description of the row layout a base was saved in."""
    if isinstance(layout, ModRowLayout):
        return {"kind": "mod", "n": layout.n, "rps": layout.rps}
    return {"kind": "flat", "vocab": int(data.shape[0])}


def _rows_to_flat(arr: torch.Tensor, meta: dict) -> torch.Tensor:
    """A row-wise leaf from its saved layout (mod: the `(n, rps, ...)`
    stack of the parts) into flat global-row order (mod capacity
    `n * rps >= vocab`)."""
    if meta["kind"] == "mod":
        n, rps = meta["n"], meta["rps"]
        return arr.transpose(0, 1).reshape((n * rps,) + tuple(arr.shape[2:]))
    return arr


def _rows_from_flat(flat: torch.Tensor, target_layout,
                    target_shape) -> torch.Tensor:
    """Flat global rows into the target: for a `ModRowLayout` this rank's
    `(rps, ...)` shard (rows past the saved capacity are padding, zero),
    else the first `target_shape[0]` rows."""
    if isinstance(target_layout, ModRowLayout):
        n, rps = target_layout.n, target_layout.rps
        mine = flat[target_layout.exchange.me::n][:rps]
        if mine.shape[0] < rps:
            mine = torch.cat([mine, mine.new_zeros(
                (rps - mine.shape[0],) + tuple(flat.shape[1:]))])
        return mine
    return flat[:target_shape[0]]


def _saved_leaf(path: str, meta: dict, i: int) -> torch.Tensor:
    """Leaf `i` of the base at `path` in its saved layout: a flat base's
    tensor, or the `(n, rps, ...)` stack of a mod base's parts."""
    if meta["kind"] == "mod":
        return torch.stack([load_leaf(os.path.join(path, f"part_{r}"), i)
                            for r in range(meta["n"])])
    return load_leaf(path, i)


def _atomic_savez(path: str, payload: dict) -> None:
    """`np.savez` to `path` through a temporary file and a rename. A
    bfloat16 tensor is written as its uint16 view plus a `<key>__mldt`
    entry naming its dtype (the JAX package's encoding of ml_dtypes
    arrays)."""
    enc = {}
    for k, v in payload.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                enc[k] = v.view(torch.int16).numpy().view(np.uint16)
                enc[k + "__mldt"] = np.str_("bfloat16")
                continue
            v = v.numpy()
        enc[k] = np.asarray(v)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **enc)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_npz(path: str) -> dict:
    """An `_atomic_savez` file (the port's or the JAX package's) as CPU
    tensors, the `__mldt` views turned back into their dtype."""
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    out = {}
    for k, v in raw.items():
        if k.endswith("__mldt"):
            continue
        dt = raw.get(k + "__mldt")
        if dt is None:
            out[k] = torch.from_numpy(v)
            continue
        dtype = getattr(torch, str(dt), None)
        if not isinstance(dtype, torch.dtype) or \
                dtype.itemsize != v.dtype.itemsize:
            raise TypeError(f"{path}: {k} is stored as {dt}, which has no "
                            f"torch dtype of {v.dtype.itemsize} bytes")
        signed = {1: np.int8, 2: np.int16, 4: np.int32}[v.dtype.itemsize]
        out[k] = torch.from_numpy(v.view(signed)).view(dtype)
    return out


class DeltaCheckpointManager:
    """Base + delta checkpoint rotation for one table tensor and its
    (row-wise) optimizer state.

        mgr = DeltaCheckpointManager(dir, base_every=8)
        tracker = TouchedRowTracker(stacked.data.shape[0])
        ... per step: tracker.observe_batch(cat_host, stacked.offsets) ...
        mgr.save(step, stacked.data, opt_state, tracker)   # clears tracker
        mgr.restore_latest(data, opt_state)   # into the templates, in place

    Every `base_every`-th save is a full base; a committed base prunes the
    previous bases and every delta. Bases and deltas are written under
    temporary names and renamed, so a crash mid-save leaves the previous
    chain restorable and a follower never reads half a file.
    """

    def __init__(self, directory: str, base_every: int = 8, layout=None):
        if base_every < 1:
            raise ValueError("base_every must be >= 1")
        self.directory = os.path.abspath(directory)
        self.base_every = base_every
        self.layout = layout   # None: flat (V, ...); ModRowLayout: sharded
        os.makedirs(self.directory, exist_ok=True)
        self._since_base = self._count_since_latest_base()

    @property
    def _exchange(self):
        """The placement whose ranks save together (None: one process)."""
        return getattr(self.layout, "exchange", None)

    def _writes(self) -> bool:
        """Whether this process writes the shared files."""
        ex = self._exchange
        return ex is None or ex.me == 0

    def force_base(self) -> None:
        """Make the next save a full base: after any event that breaks the
        chain's premise that the live state = last save + touched rows,
        such as a `DivergenceGuard` rollback."""
        self._since_base = self.base_every

    # -- directory scan helpers -------------------------------------------
    def _bases(self):
        return sorted(int(name[5:]) for name in os.listdir(self.directory)
                      if name.startswith("base_") and name[5:].isdigit())

    def _deltas(self):
        return sorted(int(name[6:-4]) for name in os.listdir(self.directory)
                      if name.startswith("delta_") and name.endswith(".npz")
                      and name[6:-4].isdigit())

    def _count_since_latest_base(self) -> int:
        bases = self._bases()
        if not bases:
            return 0
        return sum(1 for d in self._deltas() if d > bases[-1])

    def latest_step(self) -> Optional[int]:
        bases, deltas = self._bases(), self._deltas()
        steps = bases + [d for d in deltas if bases and d > bases[-1]]
        return max(steps) if steps else None

    # -- save / restore ----------------------------------------------------
    def save(self, step: int, data: torch.Tensor, state,
             tracker: TouchedRowTracker) -> str:
        """Save a checkpoint at `step`; consumes (clears) the tracker.
        Under a `ModRowLayout` every rank calls it (a collective)."""
        ex = self._exchange
        bases = self._bases()
        if not bases or self._since_base >= self.base_every - 1:
            path = save_checkpoint(
                os.path.join(self.directory, f"base_{step}"), (data, state),
                parts=ex or False)
            if self._writes():
                self._commit_base(step, bases, _layout_meta(self.layout,
                                                            data))
            self._since_base = 0
        else:
            payload = snapshot_delta(data, state, tracker.rows(),
                                     layout=self.layout)
            path = os.path.join(self.directory, f"delta_{step}.npz")
            if self._writes():
                _atomic_savez(path, payload)
            self._since_base += 1
        if ex is not None:
            barrier(ex)
        tracker.clear()
        return path

    def _commit_base(self, step: int, bases, meta: dict) -> None:
        """Name the layout of the committed `base_<step>`, then delete every
        other base and ALL deltas, those past `step` too (a directory reused
        by a run whose step count restarted would otherwise replay a stale
        delta onto the new base)."""
        path = os.path.join(self.directory, f"rowlayout_{step}.json")
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)
        for b in bases:
            if b == step:
                continue
            shutil.rmtree(os.path.join(self.directory, f"base_{b}"),
                          ignore_errors=True)
            try:
                os.unlink(os.path.join(self.directory, f"rowlayout_{b}.json"))
            except FileNotFoundError:
                pass
        for d in self._deltas():
            os.unlink(os.path.join(self.directory, f"delta_{d}.npz"))

    def _saved_meta(self, base: int) -> Optional[dict]:
        p = os.path.join(self.directory, f"rowlayout_{base}.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def restore_latest(self, data_like: torch.Tensor, state_like):
        """Restore the newest `(data, state)` into the templates, in place:
        the base (re-laid by global row when it was saved in another
        layout), then every later delta in step order. Returns
        `(data_like, state_like)`, or None when the directory holds no
        committed base. Under a `ModRowLayout` every rank calls it."""
        bases = self._bases()
        if not bases:
            return None
        base = bases[-1]
        saved = self._saved_meta(base)
        target = _layout_meta(self.layout, data_like)
        keys = ("kind", "n", "rps")
        if saved is None or {k: saved[k] for k in keys if k in saved} == \
                {k: target[k] for k in keys if k in target}:
            restore_checkpoint(os.path.join(self.directory, f"base_{base}"),
                               (data_like, state_like),
                               parts=self._exchange or False)
        else:
            self._restore_base_converted(base, saved, data_like, state_like)
        for d in self._deltas():
            if d > base:
                delta = _load_npz(os.path.join(self.directory,
                                               f"delta_{d}.npz"))
                apply_delta(data_like, state_like, delta, layout=self.layout)
        return data_like, state_like

    def _restore_base_converted(self, base: int, saved: dict, data_like,
                                state_like) -> None:
        """A base saved in another layout, in place: each row-wise leaf is
        read in the saved layout (every part of a sharded base), put in
        flat global-row order and re-laid into the target's; the other
        leaves are read whole."""
        path = os.path.join(self.directory, f"base_{base}")
        target = self.layout or FlatRowLayout(data_like.shape[0])
        first = os.path.join(path, "part_0") if saved["kind"] == "mod" \
            else path
        index = {e["leaf"]: e for e in read_index(first)["leaves"]}
        with torch.no_grad():
            for i, (_, like) in enumerate(named_leaves((data_like,
                                                        state_like))):
                if i not in index:
                    continue                  # zero-size: the template's own
                if target.is_rowwise(like):
                    flat = _rows_to_flat(_saved_leaf(path, saved, i), saved)
                    like.copy_(_rows_from_flat(flat, target, like.shape))
                else:
                    like.copy_(load_leaf(first, i).reshape(like.shape))


def load_base_data(directory: str, base: int,
                   like: torch.Tensor) -> torch.Tensor:
    """Read ONLY the table tensor of a base checkpoint (leaf 0 of its
    `(data, state)`, a file of its own), as a new tensor on `like`'s device
    in `like`'s dtype; the optimizer state is not read. The serving side's
    primitive."""
    meta_p = os.path.join(directory, f"rowlayout_{base}.json")
    meta = {"kind": "flat"}
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
    path = os.path.join(directory, f"base_{base}")
    first = os.path.join(path, "part_0") if meta["kind"] == "mod" else path
    entry = next(e for e in read_index(first)["leaves"] if e["leaf"] == 0)
    if tuple(entry["shape"][1:]) != tuple(like.shape[1:]):
        raise ValueError(f"{path} holds rows of shape {entry['shape'][1:]}, "
                         f"the template {list(like.shape[1:])}")
    raw = _rows_to_flat(_saved_leaf(path, meta, 0), meta)
    return raw[:like.shape[0]].to(device=like.device, dtype=like.dtype,
                                  copy=True)


class DeltaFollower:
    """Online model refresh: follow a trainer's delta-checkpoint chain and
    keep a serving table in sync. Each `poll()`:

      - a new base -> one read of the table leaf (`load_base_data`);
      - new deltas -> their rows set, O(touched rows).

    A tensor the follower has handed out is never written: the first delta
    of a poll is applied out of place (`index_copy`, a new table tensor,
    one table-sized copy on the device), later ones of the same poll in
    place on that new tensor; a service swaps the new `data` in when it
    likes. Optimizer state in the chain is ignored; the dense towers are
    not in the chain. Robust to the trainer pruning mid-poll: a missing file
    is skipped and the next poll resyncs."""

    def __init__(self, directory: str, data: torch.Tensor):
        self.directory = os.path.abspath(directory)
        self.data = data
        self._base: Optional[int] = None
        self._last: int = -1

    def _scan(self):
        bases, deltas = [], []
        try:
            for name in os.listdir(self.directory):
                if name.startswith("base_") and name[5:].isdigit():
                    bases.append(int(name[5:]))
                elif name.startswith("delta_") and name.endswith(".npz") \
                        and name[6:-4].isdigit():
                    deltas.append(int(name[6:-4]))
        except FileNotFoundError:
            pass
        return sorted(bases), sorted(deltas)

    def poll(self) -> int:
        """Apply anything new; returns the number of snapshots applied."""
        bases, deltas = self._scan()
        applied = 0
        fresh = False          # self.data is a tensor no one else holds
        if bases and bases[-1] != self._base:
            try:
                self.data = load_base_data(self.directory, bases[-1],
                                           self.data)
            except FileNotFoundError:
                return applied          # pruned mid-poll; next poll resyncs
            fresh = True
            self._base = bases[-1]
            self._last = bases[-1]
            applied += 1
        if self._base is None:
            return applied
        for d in deltas:
            if d <= self._last:
                continue
            try:
                z = _load_npz(os.path.join(self.directory,
                                           f"delta_{d}.npz"))
            except FileNotFoundError:
                continue                # pruned by a concurrent base commit
            rows = z["rows"].to(self.data.device).long()
            vals = z["vals"].to(self.data.device, self.data.dtype)
            if fresh:
                self.data.index_copy_(0, rows, vals)
            else:
                self.data = self.data.index_copy(0, rows, vals)
                fresh = True
            self._last = d
            applied += 1
        return applied
