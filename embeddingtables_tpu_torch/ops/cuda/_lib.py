"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes one shared library
`<KERNEL_BUILD_DIR>/<name>-<hash>.so`, built at first use on the machine with
the card (nothing is compiled at import time: the CPU tests import every
module). The sources share the `csrc/*.cuh` headers. The hash covers the
source, the headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Every pointer and the stream
cross as `ctypes.c_void_p`; every entry returns `cudaGetLastError()`, which
`check` turns into an exception with the text of the library's own
`et_cuda_error_string`, which every source exports.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ... import config

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` (and the shared
    `csrc/*.cuh` headers it may include) lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return config.KERNEL_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Build the named sources (default: all of `csrc/*.cu`) that are not
    built yet, one nvcc process per source, all started together. Returns
    {name: path}; the compiler's output (ptxas register and spill counts)
    is kept beside each library as `<lib>.log`."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    config.KERNEL_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output from building `csrc/<name>.cu`."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed.
    signatures: {function: [argtypes]}; every function returns a C int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.et_cuda_error_string.argtypes = [ctypes.c_int]
            lib.et_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.et_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on `t`'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count
