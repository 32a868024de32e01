"""Device selection and the kernel build directory.

There is no implementation switch: every op dispatches on the device of the
tensor it is given. A CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.
"""
from __future__ import annotations

from pathlib import Path

import torch

# Where `ops/cuda/_lib.py` puts the shared libraries it builds from `csrc/`.
KERNEL_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Raises when no device is given and no CUDA card is present, so nothing
    silently runs on the CPU; pass `device="cpu"` to run there on purpose.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
