"""Device time of a traced call by the program's own spans.

The port opens a telemetry phase at each layer of its train step
("step.lookup", "step.forward", "step.backward", "step.sparse_update",
"step.dense_update"; inside the update "update.sort", "update.permute",
"update.scatter"), and `trace.Tracer` keeps every phase of the traced call
as a host span `phase.<name>` on the loop's thread, on the profiler's clock.
This module gives each device operation of the step's stream the innermost
span that was open on the loop's thread when the host enqueued it:

  - the step's stream is the stream that ran most kernels; operations on
    other streams (the prefetcher's copies) belong to no span;
  - the enqueue calls are the runtime's kernel launches, memsets and copies
    (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemsetAsync`,
    `cudaMemcpyAsync`, ...) made by a thread that launches kernels; a call
    that lies inside another call of its kind on its thread (the driver's
    call inside the runtime's) is the same enqueue;
  - a stream runs its work in the order it was enqueued, so operations of
    a kind on the step's stream pair off with the enqueue calls of that
    kind in order, from the last back: the profiler can miss the first
    device records of a traced stretch (one kernel and three copies of a
    DLRM call on the H100), never its last. Where a kind's operations and
    calls differ in number by more than `UNPAIRED` of the operations,
    nothing is attributed (kernels) or the operations take the span of the
    operation before them on the stream (memsets and copies);
  - containment is by time on the loop's thread, whatever thread made the
    call: autograd launches the backward's kernels from its own thread
    while the loop's thread sits in "step.backward".

A span's self time is the summed duration of the operations attributed to
it and not to a span inside it. The trace keeps no correlation id of a
launch, so the pairing is by order; `summary` logs how many hand kernels
landed outside the spans that call them, which a wrong pairing or two
clocks would show.

The host's own enqueue cost of a step is the time inside "step" less the
part covered by calls that wait on the device or on a full launch queue
(`Command Buffer Full`, `cuda*Synchronize`, blocking copies) on a thread
that launches kernels.
"""
from __future__ import annotations

import collections
import sys

from portbench import port, trace

STEP = "phase.step"
# The most operations of a kind, as a share of them, whose records or calls
# may be missing before the pairing is refused.
UNPAIRED = 0.01
# The spans that call each hand kernel on the training path.
HAND_SPANS = {"gather_rows": ("phase.step.lookup", "phase.update.permute"),
              "run_scatter": ("phase.update.scatter",)}


def op_kind(name: str) -> str:
    """"memcpy", "memset" or "kernel": the kind of a device operation."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def call_kind(name: str):
    """The kind of device operation a runtime or driver call enqueues, or
    None for a call that enqueues none."""
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    return None


def is_queue_full(name: str) -> bool:
    """The profiler's record of a launch that waited for room in the
    queue."""
    return name.replace("_", " ").lower() == "command buffer full"


def is_wait(name: str) -> bool:
    """A call that waits on the device: a synchronize or a blocking
    copy."""
    if name.startswith("cu") and name.endswith("Synchronize"):
        return True
    return call_kind(name) == "memcpy" and "Async" not in name


def _launch_threads(tr) -> set:
    return {h.thread for h in tr.host if call_kind(h.name) == "kernel"}


def _calls(tr, kind: str, threads: set) -> list:
    """The enqueue calls of `kind` by `threads`, in time order, each nested
    call folded into the call around it."""
    out, last = [], {}
    for h in sorted((h for h in tr.host if h.thread in threads
                     and call_kind(h.name) == kind),
                    key=lambda h: (h.start, -h.end)):
        outer = last.get(h.thread)
        if outer is not None and h.end <= outer.end:
            continue
        last[h.thread] = h
        out.append(h)
    return out


def step_stream(tr):
    """The stream that ran most kernels, or None."""
    n = collections.Counter(d.thread for d in tr.kernels())
    return n.most_common(1)[0][0] if n else None


def loop_spans(tr) -> list:
    """The phase spans of the thread that opened "step", by start."""
    n = collections.Counter(h.thread for h in tr.host if h.name == STEP)
    if not n:
        return []
    loop = n.most_common(1)[0][0]
    return sorted((h for h in tr.host if h.thread == loop
                   and h.name.startswith("phase.")),
                  key=lambda h: (h.start, -h.end))


def innermost(spans: list, times: list) -> list:
    """For each time of `times` (ascending), the name of the innermost of
    the nested `spans` (by start) open then, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def attribute(tr):
    """[(device operation, span name or None)] of the step's stream in
    stream order, or None where its kernels and their launches do not pair
    off (or the trace has no "step" span)."""
    spans = loop_spans(tr)
    stream = step_stream(tr)
    if not spans or stream is None:
        return None
    threads = _launch_threads(tr)
    ops = sorted((d for d in tr.device if d.thread == stream),
                 key=lambda d: d.start)
    span_of = {}
    for kind in ("kernel", "memset", "memcpy"):
        mine = [d for d in ops if op_kind(d.name) == kind]
        calls = _calls(tr, kind, threads)
        if abs(len(calls) - len(mine)) > UNPAIRED * len(mine):
            if kind == "kernel":
                return None
            continue
        n = min(len(calls), len(mine))
        names = innermost(spans, [c.start for c in calls[len(calls) - n:]])
        for d, name in zip(mine[len(mine) - n:], names):
            span_of[id(d)] = name
    out, prev = [], None
    for d in ops:
        if id(d) in span_of:
            prev = span_of[id(d)]
        out.append((d, span_of.get(id(d), prev)))
    return out


def in_step(name) -> bool:
    return name is not None and (name == STEP or name.startswith(
        ("phase.step.", "phase.update.", "phase.exchange.")))


def summary(facts: dict):
    """The traced call's attribution, once per run (kept in `facts`):
    {"self_ms": {span: device ms a step}, "ops": step-stream operations a
    step launched in "step", "stream_ms": the stream's device ms a step,
    "misplaced": {hand kernel: (count, outside its spans)}}; None without
    a trace, traced steps or a pairing. Logged to standard error."""
    if "spans" in facts:
        return facts["spans"]
    tr, steps = facts.get("trace"), len(facts.get("traced_batches", []))
    pairs = attribute(tr) if tr is not None and steps else None
    facts["spans"] = None
    if pairs is None:
        if tr is not None:
            print("spans: no attribution (no step span, or the step "
                  "stream's kernels and their launches differ in number "
                  f"by more than {100 * UNPAIRED:g} %)",
                  file=sys.stderr, flush=True)
        return None
    self_ns = collections.Counter()
    hand = collections.defaultdict(lambda: [0, 0])
    n_step, stream_ns = 0, 0
    for d, name in pairs:
        dur = d.end - d.start
        stream_ns += dur
        if in_step(name):
            self_ns[name] += dur
            n_step += 1
        k = port.hand_kernel(d.name)
        if k in HAND_SPANS:
            hand[k][0] += 1
            hand[k][1] += name not in HAND_SPANS[k]
    out = {"self_ms": {n[len("phase."):]: v / 1e6 / steps
                       for n, v in self_ns.items()},
           "ops": n_step / steps, "stream_ms": stream_ns / 1e6 / steps,
           "misplaced": {k: tuple(v) for k, v in hand.items()}}
    facts["spans"] = out
    attributed = sum(out["self_ms"].values())
    print(f"spans: step tree {attributed:.4f} of {out['stream_ms']:.4f} "
          f"step-stream device ms a step "
          f"({100 * attributed / max(out['stream_ms'], 1e-12):.2f} %); "
          + "; ".join(f"{n} {v:.4f}" for n, v in
                      sorted(out["self_ms"].items()))
          + "; hand kernels (launched, outside their spans): "
          + ", ".join(f"{k} {v}" for k, v in
                      sorted(out["misplaced"].items())),
          file=sys.stderr, flush=True)
    return out


def self_ms(facts: dict, span: str):
    """Device ms a traced step of the operations attributed to `span`
    itself; None where the program has no such span or nothing ran in
    it."""
    s = summary(facts)
    if s is None:
        return None
    return s["self_ms"].get(span)


def launches(facts: dict):
    """Operations a traced step launched on the step's stream inside
    "step"."""
    s = summary(facts)
    return None if s is None or not s["ops"] else s["ops"]


def enqueue_ms(facts: dict):
    """Host ms a traced step spends in "step" less the time its launching
    threads wait on the device or the launch queue (module docstring)."""
    tr = facts.get("trace")
    if tr is None:
        return None
    step_spans = [h for h in loop_spans(tr) if h.name == STEP]
    if not step_spans:
        return None
    threads = _launch_threads(tr)
    waits = [(h.start, h.end) for h in tr.host if is_queue_full(h.name)
             or (is_wait(h.name) and h.thread in threads)]
    total = 0
    for s in step_spans:
        covered = sum(e - b for b, e in trace.union(waits, s.start, s.end))
        total += (s.end - s.start) - covered
    return total / 1e6 / len(step_spans)
