"""Telemetry: phase hooks, step timing, bandwidth accounting, profiler traces
(counterpart of `embeddingtables_tpu/utils/telemetry.py`).

  - `Telemetry`: counters, per-phase wall timings and effective-bandwidth
    records, cheap enough to leave on;
  - `phase(name)`: a context manager that times a phase and fires the
    registered callbacks (`cb(name, "start" | "end")`);
  - `trace_profile(dir)`: `torch.profiler` around a block, exported as a
    Chrome trace into `dir`.

Wall timings include host and launch time. `phase(..., sync=True)` waits for
the card's queued work (`torch.cuda.synchronize()`) before it stops the
clock; the default adds no synchronisation, so a phase around a loop's step
does not slow the step. For kernel time, read a `trace_profile` trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class PhaseStat:
    count: int = 0
    total_s: float = 0.0
    bytes: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def gbps(self) -> float:
        return self.bytes / max(self.total_s, 1e-12) / 1e9


class Telemetry:
    """Phase timings, counters, and effective-bandwidth accounting."""

    def __init__(self):
        self.phases: Dict[str, PhaseStat] = defaultdict(PhaseStat)
        self.counters: Dict[str, float] = defaultdict(float)
        self.callbacks: List[Callable[[str, str], None]] = []

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def record_bytes(self, phase_name: str, nbytes: int) -> None:
        self.phases[phase_name].bytes += nbytes

    def on_phase(self, cb: Callable[[str, str], None]) -> None:
        """Register `cb(phase_name, event)`, event "start" or "end"."""
        self.callbacks.append(cb)

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0, sync: bool = False):
        for cb in self.callbacks:
            cb(name, "start")
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync and torch.cuda.is_available():
                # Wait for the queued device work, so the time is honest.
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            st = self.phases[name]
            st.count += 1
            st.total_s += dt
            if nbytes:
                st.bytes += nbytes
            for cb in self.callbacks:
                cb(name, "end")

    def summary(self) -> str:
        lines = []
        for name in sorted(self.phases):
            st = self.phases[name]
            bw = f" {st.gbps:8.1f} GB/s" if st.bytes else ""
            lines.append(f"{name:28s} n={st.count:<6d} "
                         f"mean={st.mean_s*1e3:8.3f} ms{bw}")
        for name in sorted(self.counters):
            lines.append(f"{name:28s} {self.counters[name]:g}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.phases.clear()
        self.counters.clear()


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(t: Telemetry) -> Telemetry:
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, t
    return old


def phase(name: str, nbytes: int = 0, sync: bool = False):
    """Module-level shortcut: `with telemetry.phase("update"): ...`."""
    return _GLOBAL.phase(name, nbytes=nbytes, sync=sync)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """`torch.profiler` (CPU, and CUDA where there is a card) around a
    block; the trace is written to `log_dir/trace.json` (Chrome trace
    format). Where the profiler cannot start, the block runs untraced and
    the counter `trace_profile.unsupported` records it; a failed stop or
    export counts `trace_profile.stop_failed`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
        _GLOBAL.count("trace_profile.unsupported")
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except Exception:
                _GLOBAL.count("trace_profile.stop_failed")
