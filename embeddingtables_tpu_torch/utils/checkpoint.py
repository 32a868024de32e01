"""Checkpoint and resume (counterpart of
`embeddingtables_tpu/utils/checkpoint.py`), in torch-native files.

A checkpoint is a directory with one file per tensor (`leaf_<i>.pt`,
written by `torch.save`) and an `index.json` naming each leaf's path in the
tree, its shape and its dtype. The tree is an `nn.Module` (the leaves of its
`state_dict()`: the models hold their towers as parameters and their tables
and sparse optimizer states as buffers) or nested tuples, lists, dicts and
`NamedTuple`s of tensors and modules, such as `(data, SparseOptState)`;
`named_leaves` flattens both. Zero-size leaves (SGD's placeholder state) are
not written: the template recreates them, as in JAX.

The torch reading of JAX's "code owns structure, checkpoints own data":
`restore_checkpoint` copies each saved leaf into the template's own tensor,
in place, on the template's device and in its dtype, and returns the
template; a leaf whose path, shape or dtype differs is refused. The train
steps update their model in place, so a rollback lands in the object the
loop holds.

Writes are atomic: a checkpoint is written under a temporary name that no
reader lists (`.tmp-...`, not all digits and not `base_<digits>`), then
renamed into place, so a reader polling during a save never sees a
half-written step. Files load with `torch.load(weights_only=True)`: no
pickled code runs.

These files are not orbax's: the JAX package and the port cannot read each
other's checkpoints (delta files, `utils.deltackpt`, are shared).

A sharded model (one holding a `parallel.ShardedStackedTables`: one
process per card, each holding its own shard) is saved by every rank of
its placement together: each rank writes its tree as `part_<i>/`, i its
flattened mesh index, into one temporary directory, which the rank of
index 0 renames into place between two barriers; `parts.json` records the
number of parts. It restores into the same placement, each rank reading
its own part (JAX's orbax restores a sharded array into another placement;
the port's full checkpoints do not: ROADMAP.md queue 3, "Checkpoint
bases").
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

INDEX = "index.json"


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """The tensors of `tree` in order, each with its path: a module's
    `state_dict()` entries (parameters and persistent buffers), the
    elements of tuples and lists (by position), of `NamedTuple`s (by field)
    and of dicts (in sorted key order, as JAX flattens them). None is an
    empty subtree, as in JAX."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [(prefix.rstrip("."), tree)]
    if isinstance(tree, nn.Module):
        return [(prefix + k, v)
                for k, v in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        raise TypeError(f"checkpoint leaves must be tensors or modules, got "
                        f"{type(tree).__name__} at '{prefix.rstrip('.')}'")
    return [leaf for k, sub in items
            for leaf in named_leaves(sub, f"{prefix}{k}.")]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host holding exactly its own elements (`torch.save`
    writes a tensor's whole storage, so a view is copied out first)."""
    t = t.detach()
    if t.device.type != "cpu":
        return t.cpu()
    exact = t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if exact and t.is_contiguous() else t.clone()


def _replace_dir(tmp: str, path: str) -> None:
    """Rename the finished directory `tmp` to `path`, replacing any old
    one (moved aside first: a rename cannot replace a non-empty
    directory)."""
    if os.path.exists(path):
        trash = tempfile.mkdtemp(prefix=".old-", dir=os.path.dirname(path))
        os.replace(path, os.path.join(trash, "ckpt"))
        os.replace(tmp, path)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, path)


PARTS = "parts.json"


def placement_of(tree):
    """The `parallel.sharded.Exchange` of a sharded model (a module that
    holds a `ShardedStackedTables`), else None."""
    if isinstance(tree, nn.Module):
        for m in tree.modules():
            ex = getattr(m, "exchange", None)
            if ex is not None:
                return ex
    return None


def barrier(ex) -> None:
    """Wait for every rank of the placement `ex`."""
    import torch.distributed as dist
    dist.barrier(group=ex.group)


def part_path(path: str, ex) -> str:
    """This rank's part of the sharded checkpoint at `path`."""
    with open(os.path.join(path, PARTS)) as f:
        n = json.load(f)["parts"]
    if n != ex.n:
        raise ValueError(f"{path} holds {n} parts; the placement has "
                         f"{ex.n} ranks (a sharded checkpoint restores into "
                         "its own placement)")
    return os.path.join(path, f"part_{ex.me}")


def _save_parts(path: str, tree, ex, force: bool) -> str:
    """Every rank of `ex` writes its part; index 0 commits the directory."""
    parent = os.path.dirname(path)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-parts")
    if ex.me == 0:
        if os.path.exists(path) and not force:
            raise FileExistsError(path)
        os.makedirs(parent, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, PARTS), "w") as f:
            json.dump({"parts": ex.n}, f)
    barrier(ex)
    save_checkpoint(os.path.join(tmp, f"part_{ex.me}"), tree, parts=False)
    barrier(ex)
    if ex.me == 0:
        _replace_dir(tmp, path)
    barrier(ex)
    return path


def save_checkpoint(path: str, tree, *, step: Optional[int] = None,
                    force: bool = True, parts=None) -> str:
    """Save `tree` (a model, or a tuple of state) to the directory `path`
    (`path/<step>` with `step`); returns the directory. An existing
    checkpoint there is replaced, or with `force=False` refused. `parts`:
    the placement (`Exchange`) whose ranks save their parts together (a
    collective); by default a sharded model's own (`placement_of`), False
    for none."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, str(step))
    ex = placement_of(tree) if parts is None else parts
    if ex:
        return _save_parts(path, tree, ex, force)
    if os.path.exists(path) and not force:
        raise FileExistsError(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    leaves = named_leaves(tree)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{os.path.basename(path)}-",
                           dir=parent)
    try:
        index = []
        for i, (name, t) in enumerate(leaves):
            if t.numel() == 0:
                continue
            torch.save(_host_copy(t), os.path.join(tmp, f"leaf_{i}.pt"))
            index.append({"leaf": i, "name": name, "shape": list(t.shape),
                          "dtype": str(t.dtype).replace("torch.", "")})
        with open(os.path.join(tmp, INDEX), "w") as f:
            json.dump({"count": len(leaves), "leaves": index}, f)
        _replace_dir(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def read_index(path: str) -> dict:
    """A checkpoint's `index.json`: `count` leaves, and for each saved one
    its `leaf` position, `name`, `shape` and `dtype`."""
    with open(os.path.join(path, INDEX)) as f:
        return json.load(f)


def load_leaf(path: str, i: int) -> torch.Tensor:
    """Leaf `i` of the checkpoint at `path`, on the host, memory-mapped."""
    return torch.load(os.path.join(path, f"leaf_{i}.pt"), weights_only=True,
                      map_location="cpu", mmap=True)


def restore_checkpoint(path: str, restore_like, *, parts=None) -> Any:
    """Copy the checkpoint at `path` into `restore_like`'s tensors, in place
    (on their devices, in their dtypes), and return `restore_like`. It must
    have the saved structure: the same leaves by path, shape and dtype. A
    sharded checkpoint (`parts`, by default `placement_of(restore_like)`)
    gives each rank its own part."""
    path = os.path.abspath(path)
    ex = placement_of(restore_like) if parts is None else parts
    if ex:
        path = part_path(path, ex)
    index = read_index(path)
    leaves = named_leaves(restore_like)
    saved = {e["leaf"]: e for e in index["leaves"]}
    if index["count"] != len(leaves):
        raise ValueError(f"{path} holds a tree of {index['count']} leaves; "
                         f"the template has {len(leaves)}")
    for i, (name, t) in enumerate(leaves):
        e = saved.get(i)
        if t.numel() == 0 and e is None:
            continue                    # zero-size: the template's own
        want = {"name": name, "shape": list(t.shape),
                "dtype": str(t.dtype).replace("torch.", "")}
        got = None if e is None else {k: e[k] for k in want}
        if got != want:
            raise ValueError(f"leaf {i} of {path}: saved {got}, template "
                             f"{want}")
    with torch.no_grad():
        for i, (_, t) in enumerate(leaves):
            if i in saved:
                t.copy_(load_leaf(path, i))
    return restore_like


class CheckpointManager:
    """Step-numbered checkpoint rotation (keeps the latest `max_to_keep`):

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, model)
        mgr.restore_latest(model)      # in place; returns model
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit())

    def save(self, step: int, tree) -> str:
        """Save `tree` at `step` (with a sharded model, every rank of its
        placement together) and prune the oldest beyond `max_to_keep`."""
        p = save_checkpoint(self.directory, tree, step=step)
        ex = placement_of(tree)
        if ex is None or ex.me == 0:
            steps = self._steps()
            while len(steps) > self.max_to_keep:
                shutil.rmtree(os.path.join(self.directory,
                                           str(steps.pop(0))),
                              ignore_errors=True)
        if ex is not None:
            barrier(ex)
        return p

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, restore_like):
        return restore_checkpoint(os.path.join(self.directory, str(step)),
                                  restore_like)

    def restore_latest(self, restore_like):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, restore_like)
