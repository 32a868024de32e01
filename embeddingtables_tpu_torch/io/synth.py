"""Native synthetic batches (counterpart of
`embeddingtables_tpu/io/synth.py`): `native/synth_gen.cpp`, shared with the
JAX package and unchanged, built by `io.loader` and bound with ctypes.

The port's `data.SyntheticCriteo` owns the distribution: its Walker alias
tables (the Zipf skew) and its hidden label model, which are bitwise the JAX
package's. This module hands those arrays to the threaded C++ sampler, so
the per-example loop (lognormal dense features, T alias draws, the label's
Bernoulli) runs outside the interpreter; for the same arguments its batches
are bitwise the JAX package's native batches.

The native stream is deterministic in (seed, stream_seed, batch_index) and
does not depend on the thread count (a counter-based RNG per example), but
it is not numpy's `Generator` stream: it draws from the same alias tables
and label model, a stream of the same distribution.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

from ..data import SyntheticCriteo
from .loader import NATIVE_DIR, _compile_and_load

_SRC = NATIVE_DIR / "synth_gen.cpp"

_lib = None
_lib_err: Optional[str] = None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = _compile_and_load(_SRC, "synth_gen")
        lib.synth_generate.restype = None
        lib.synth_generate.argtypes = [
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_void_p,  # packed AliasCell[] (12-byte records)
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        # No g++, or a build that failed: the numpy generator takes over.
        _lib_err = str(e)
    return _lib


def native_synth_available() -> bool:
    return _load() is not None


class NativeSyntheticCriteo:
    """Drop-in for `data.SyntheticCriteo` backed by the C++ sampler.

    Same constructor surface (it owns a SyntheticCriteo for the alias
    tables + label model); `batches()` yields the same dict layout. Falls
    back to the Python generator when the native library can't build.
    """

    def __init__(self, *args, nthreads: Optional[int] = None, **kwargs):
        self.py = SyntheticCriteo(*args, **kwargs)
        self.nthreads = nthreads or min(8, os.cpu_count() or 1)
        p = self.py
        self._vocabs = np.asarray(p.vocab_sizes, np.int64)
        self._offs = np.zeros(len(p.vocab_sizes) + 1, np.int64)
        np.cumsum(self._vocabs, out=self._offs[1:])
        # Pack each table's (prob, perm[k], perm[alias[k]]) into one 12-byte
        # record so a native draw costs ONE random access, not three gathers
        # (at V=100k the tables blow L2 — this is the cat-draw bottleneck).
        cell_dt = np.dtype([("prob", np.float32), ("keep", np.int32),
                            ("alias", np.int32)])
        cells = []
        for v in p.vocab_sizes:
            prob, alias, perm = p._zipf_tables(int(v))
            c = np.empty(int(v), cell_dt)
            c["prob"] = prob.astype(np.float32)
            c["keep"] = perm
            c["alias"] = perm[alias]
            cells.append(c)
        self._cells = np.concatenate(cells)
        self._row_logit = np.concatenate(
            [np.asarray(r, np.float32) for r in p._row_logit])
        self._w_dense = np.asarray(p._w_dense, np.float32)

    def _generate(self, batch_index: int) -> dict:
        lib = _load()
        p = self.py
        b, nd, t = p.batch_size, p.num_dense, len(p.vocab_sizes)
        bag = p.bag or 0
        dense = np.empty((b, nd), np.float32)
        cat = np.empty((t, b) if not bag else (t, b, bag), np.int32)
        label = np.empty((b,), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_long)
        stream = p.seed if p.stream_seed is None else p.stream_seed
        lib.synth_generate(
            b, nd, t, bag,
            self._vocabs.ctypes.data_as(i64p),
            self._offs.ctypes.data_as(i64p),
            self._cells.ctypes.data_as(ctypes.c_void_p),
            self._row_logit.ctypes.data_as(f32p),
            self._w_dense.ctypes.data_as(f32p),
            float(p._bias), 1.0 / np.sqrt(nd), 1.0 / np.sqrt(t),
            ctypes.c_uint64(stream & 0xFFFFFFFFFFFFFFFF),
            ctypes.c_uint64(batch_index), self.nthreads,
            dense.ctypes.data_as(f32p), cat.ctypes.data_as(i32p),
            label.ctypes.data_as(f32p))
        return dict(dense=dense, cat=cat, label=label)

    def batches(self, num_batches: Optional[int] = None) -> Iterator[dict]:
        if _load() is None:
            yield from self.py.batches(num_batches)
            return
        i = 0
        while num_batches is None or i < num_batches:
            yield self._generate(i)
            i += 1
