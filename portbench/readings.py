"""What the per-layer readers in `metrics/` share. Each reader is
`read(facts) -> float | None`: None where its run has nothing to read
(no trace, no card in the peak table, no launch of its kernel), and then
the harness leaves the metric out of the line rather than report 0."""
from __future__ import annotations

from portbench import port, roofline, trace


def idle_share(facts: dict):
    """% of the traced stretch in which no operation ran on the device."""
    tr = facts.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - trace.busy_ns(tr) / (tr.window[1] - tr.window[0]))


def kernels(facts: dict, kernel=None, hand=None) -> list:
    """The traced kernels of hand kernel `kernel`; or with `hand` True /
    False every hand kernel / every other kernel but NCCL's (which
    `collective_ms` reads)."""
    tr = facts.get("trace")
    if tr is None:
        return []
    out = []
    for k in tr.kernels():
        h = port.hand_kernel(k.name)
        if kernel is not None:
            keep = h == kernel
        elif hand:
            keep = h is not None
        else:
            keep = h is None and "nccl" not in k.name.lower()
        if keep:
            out.append(k)
    return out


def seconds(ks: list) -> float:
    return sum(k.end - k.start for k in ks) / 1e9


def per_traced_step_ms(facts: dict, hand: bool):
    steps = len(facts.get("traced_batches", []))
    ks = kernels(facts, hand=hand)
    if not steps or not ks:
        return None
    return 1e3 * seconds(ks) / steps


def bandwidth_share(facts: dict, nbytes: float, ks: list):
    """% of the card's byte rate that `nbytes` over the time of `ks` is."""
    bw = roofline.peak(facts["device_kind"], "hbm_bytes")
    if bw is None or not ks:
        return None
    return 100.0 * nbytes / bw / seconds(ks)


def phase_ms(facts: dict, name: str):
    """Mean host ms of the port's telemetry phase `name` over the
    untraced calls of the window."""
    n, total = facts.get("phases", {}).get(name, (0, 0.0))
    return 1e3 * total / n if n else None


def step_mfu(facts: dict):
    """% of the cards' bf16 peak: the model's FLOPs a step (3 x the
    forward's, global batch) times the steps of the untraced calls, over
    their CUDA-event time on rank 0 and the peak of every card used."""
    peak = roofline.peak(facts["device_kind"], "bf16_flops")
    if peak is None or not facts.get("event_s"):
        return None
    return (100.0 * facts["flops_per_step"] * facts["event_steps"]
            / facts["event_s"] / (peak * facts.get("world", 1)))
