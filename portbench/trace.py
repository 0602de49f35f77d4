"""Reduce a ``torch.profiler`` trace to device events, busy time, kernel
time by name and idle gaps by what the host was doing.

The busy arithmetic is ``chip_smoke._report_profile``'s (frozen copy): the
device rows are the kernels, copies and sets the card ran, and their
durations add up to its busy time; here they are read from the raw
Kineto events rather than ``key_averages()``, and overlapping rows are
counted once.  Host annotations the harness opens are named ``pb:...``; an
idle gap of the device is charged to the innermost one that was open at
the gap's midpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

HOST_PREFIX = "pb:"


@dataclass
class Event:
    name: str
    start: float     # seconds since the trace began
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host annotations ``pb:*``) of a finished profile,
    each sorted by start."""
    res = prof.profiler.kineto_results
    evs = res.events()
    t0 = min((e.start_ns() for e in evs), default=0)
    dev, host = [], []
    for e in evs:
        kind = str(e.device_type())
        name = e.name()
        ev = Event(name, (e.start_ns() - t0) * 1e-9,
                   (e.start_ns() + e.duration_ns() - t0) * 1e-9)
        if kind.endswith("CUDA"):
            # the profiler mirrors each host annotation on the device
            # timeline over the kernels it launched: not a device row
            if not (name.startswith(HOST_PREFIX) or e.is_user_annotation()):
                dev.append(ev)
        elif name.startswith(HOST_PREFIX):
            host.append(ev)
    dev.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return dev, host


def busy_s(dev: Sequence[Event]) -> float:
    """Seconds in which some device row ran (the union of their spans)."""
    total, cur_s, cur_e = 0.0, None, None
    for e in dev:
        if cur_e is None or e.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = e.start, e.end
        else:
            cur_e = max(cur_e, e.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_time(dev: Sequence[Event], part: str) -> float:
    """Summed seconds of the device rows whose name holds ``part``."""
    return sum(e.dur for e in dev if part in e.name)


def kernel_count(dev: Sequence[Event]) -> int:
    """Kernel launches among the device rows (copies and sets left out)."""
    return sum(1 for e in dev if not is_copy(e.name))


def top_ops(dev: Sequence[Event], k: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for e in dev:
        by[e.name] = by.get(e.name, 0.0) + e.dur
    return [[n[:120], s] for n, s in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:k]]


def idle_gaps(dev: Sequence[Event], host: Sequence[Event], t_from: float,
              t_to: float, k: int = 10) -> List[List]:
    """Idle seconds of the device between ``t_from`` and ``t_to``, summed
    by the innermost host annotation open at each gap's midpoint, the
    largest ``k``."""
    gaps = []
    cur = t_from
    for e in dev:
        if e.start > cur:
            gaps.append((cur, min(e.start, t_to)))
        cur = max(cur, e.end)
        if cur >= t_to:
            break
    if cur < t_to:
        gaps.append((cur, t_to))
    by: Dict[str, float] = {}
    nxt, open_ = 0, []
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt].start <= mid:
            open_.append(host[nxt])
            nxt += 1
        open_ = [h for h in open_ if h.end >= mid]
        name = (max(open_, key=lambda h: h.start).name if open_
                else "pb:outside")
        by[name] = by.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
