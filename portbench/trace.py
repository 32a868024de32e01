"""The traced stretch of a `--trace 1` run, and its reduction.

`Tracer` runs `torch.profiler` around one stretch of the window; the
device work queued before it has finished when it opens, and the stretch
ends in a synchronize. `from_kineto` and the functions below turn the
profiler's events into:

  - device intervals: every kernel, copy and set on every stream,
  - busy: the length of their union inside the stretch,
  - idle gaps: the stretch minus that union, each named by the innermost
    host operation that covers its middle (on the thread that launched most
    kernels where it has one),
  - kernel time by name.

A stretch in which the profiler recorded no device operation is an error:
the run fails rather than report an idle share or a kernel time of 0.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time


@dataclasses.dataclass
class Interval:
    name: str
    start: int      # ns on the profiler's clock
    end: int
    thread: int = 0


@dataclasses.dataclass
class Trace:
    window: tuple           # (start_ns, end_ns) of the traced stretch
    device: list            # [Interval] kernels, copies, sets
    host: list              # [Interval] host operations

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        return [e for e in self.device if not is_copy(e.name)]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union(intervals, lo: int, hi: int) -> list:
    """The union of `intervals` ((start, end) pairs) clipped to [lo, hi],
    as sorted disjoint pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def gaps(busy: list, lo: int, hi: int) -> list:
    """[lo, hi] minus the sorted disjoint `busy` pairs."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def busy_ns(trace: Trace) -> int:
    lo, hi = trace.window
    return sum(e - s for s, e in union(
        [(i.start, i.end) for i in trace.device], lo, hi))


def idle_by_host(trace: Trace, top: int = 10) -> list:
    """[(host operation, idle seconds)] of the longest idle totals."""
    lo, hi = trace.window
    busy = union([(i.start, i.end) for i in trace.device], lo, hi)
    launches = collections.Counter(h.thread for h in trace.host
                                   if "LaunchKernel" in h.name)
    main = launches.most_common(1)[0][0] if launches else None
    host = sorted(trace.host, key=lambda h: h.start)
    total = collections.Counter()
    active, i = [], 0          # a heap by end of the operations begun
    for s, e in gaps(busy, lo, hi):
        mid = (s + e) // 2
        while i < len(host) and host[i].start <= mid:
            heapq.heappush(active, (host[i].end, i))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        best = max(((host[j].thread == main, host[j].start), host[j].name)
                   for _, j in active) if active else None
        total[best[1] if best else "no traced host span"] += (e - s) / 1e9
    return [[n, v] for n, v in total.most_common(top)]


def kernel_time_by_name(trace: Trace, top: int = 10) -> list:
    """[(kernel, seconds)] of the kernels that took most device time."""
    total = collections.Counter()
    for k in trace.kernels():
        total[k.name[:120]] += (k.end - k.start) / 1e9
    return [[n, v] for n, v in total.most_common(top)]


def from_kineto(events, window: tuple, spans=()) -> Trace:
    """A `Trace` of the stretch `window` ((start, end) ns on the host's
    wall clock, which the profiler's timestamps share) from
    `prof.profiler.kineto_results.events()`, with the host `spans` the
    harness recorded itself."""
    from torch.autograd import DeviceType
    device, host = [], list(spans)
    for e in events:
        iv = Interval(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.device_resource_id())
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue        # a host span's shadow on the device timeline
        (device if on_device else host).append(iv)
    if not device:
        raise RuntimeError("the profiler recorded no device operation in the "
                           "traced stretch")
    return Trace(window, device, host)


class Tracer:
    """`with tracer: ...` profiles the block once; `trace` holds it.

    The profiler records device activity only, which costs the host next
    to nothing (recording host operations cost up to 4 ms a step). The
    stretch's bounds and the port's telemetry phases ("data", "step";
    `phase_callback`) are taken on the host's wall clock, so idle gaps
    can be named by them."""

    def __init__(self):
        self.trace = None
        self._spans, self._open, self._on = [], {}, False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self):
        """Start and stop the profiler once, so that its first start (the
        CUPTI set-up, seconds) falls in set-up and not in the window."""
        import torch
        with self._profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def phase_callback(self, name: str, event: str) -> None:
        """A telemetry callback: the phase as a host span while tracing."""
        key = (name, threading.get_ident())
        if event == "start":
            self._open[key] = time.time_ns()
        elif key in self._open:
            start = self._open.pop(key)
            if self._on:
                self._spans.append(Interval(f"phase.{name}", start,
                                            time.time_ns(), key[1]))

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self._on, self._t0 = True, time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        t1, self._on = time.time_ns(), False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = from_kineto(
                self._prof.profiler.kineto_results.events(), (self._t0, t1),
                self._spans)
        self._prof = None
        return False
