"""Spans and counters of the bank's ask path: one record per ask.

``StudyBank.ask_all`` opens a root span ``ask`` (``StudyBank.ask_view`` a
root ``ask_view``) and a span for each stage inside it.  A record holds
the ask's number (one process-wide sequence), its bank's id
(``new_bank_id``), the root and stage spans as host-clock
(``time.perf_counter_ns``) start / end pairs with their parent, the ask's
counters, and whether a torch profiler was recording during the ask.  A
stage that waits on the device ends at a designed exit
(``sanitizers.to_host``) and its span closes after that exit, so the
span's host-clock time is the stage's real time and costs no sync.

Records go into ``RING``, the last ``RING_SIZE`` asks of the process.  It
lives at module level, as ``kernels.build.MISSES`` does, so that records
outlive the bank that wrote them; ``records`` and ``summary`` read it.

The recorder is on by default: it is the operator's always-available
view of the ask (``TuningService.health`` serves its ``summary``).
``set_enabled(False)`` leaves every span and counter a single flag test.
While a torch profiler records, each span also opens
``torch.profiler.record_function`` under the span's name, so a Kineto
trace shows the stages on one timeline with the kernels they launched;
with no profiler running none is entered.

Counters of an ask, by name: ``na`` (the bucket), ``fit_rows`` and
``due_rows`` (rows in the fit's batch and rows written back),
``fit_steps`` (the fit's Adam steps, each a closed-form gradient) and
``fit_nonfinite`` (rows of the fit whose returned hyperparameters are
not finite: their kernel matrix failed its factorization),
``obs_cache_hits``; from the ``sanitizers.Tally`` that counts the asking
thread's crossings while the ask runs: ``exits`` and ``d2h_bytes`` (``to_host``), ``uploads`` and
``h2d_bytes`` (``to_device``), ``entry_calls`` and ``new_signatures``
(the ``gp.BANK_ENTRY_POINTS`` entries); and ``builds``, the kernel suites
built or loaded during the ask (``kernels.build.MISSES``, process-wide).

The stage spans of a ``StudyBank`` ask (the root's children, then theirs):

  * ``ask.random``: studies asked through their own view;
  * ``ask.draw``: the columnar candidate draw and its encoding;
  * ``ask.obs``: the shared observation stage (a cache hit still records
    it), with ``ask.obs.gather``, ``ask.obs.fit`` (the fit schedule, the
    hyperparameter fit, its exit and the ledger write), ``ask.obs.factors``
    (the Cholesky factors and the prescale) and ``ask.obs.copy`` (the
    factors' copy to the host and their write into the ledger);
  * ``ask.pick``: one per family, carrying the family's name, up to and
    including that family's exit of the picks;
  * ``ask.register``: the picked configurations, their encoded rows, the
    ledger write and the ``Trial`` objects.

The factors' compute and their copy end at one exit.  On the card a CUDA
event pair splits them: one event recorded just before the exit
(``device_mark``), one just after (``span(..., since=mark)``).  The copy
span then starts, and the factors span ends, that interval before the
exit returned.  The pair is read when the ask's root closes: the pick's
exit has waited on the stream past both events by then, so the read
waits on nothing.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.analysis import sanitizers
from repro_torch.kernels import build

RING_SIZE = 4096
# counts every record carries, 0 where the ask did none of it
COUNTS = ("fit_rows", "due_rows", "fit_steps", "fit_nonfinite",
          "obs_cache_hits")
RING: "collections.deque[Record]" = collections.deque(maxlen=RING_SIZE)

_ENABLED = True
_ASK_NUMBERS = itertools.count(1)
_BANK_NUMBERS = itertools.count(1)
_LOCAL = threading.local()      # the asking thread's open record
_clock = time.perf_counter_ns


def set_enabled(on: bool) -> bool:
    """Turn the recorder on or off; returns the previous setting."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


def new_bank_id() -> int:
    """A fresh id for a bank's records (ids are never reused)."""
    return next(_BANK_NUMBERS)


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _builds() -> int:
    return sum(build.MISSES.values())


def _event(device: torch.device) -> torch.Event:
    """A timing event recorded on ``device``'s current stream."""
    e = torch.Event(device, enable_timing=True)
    e.record()
    return e


class Record:
    """One ask.  ``spans`` are ``(name, parent, start_ns, end_ns, family)``
    tuples, the root first with parent -1, a parent being an index into
    ``spans``; ``counters`` maps a counter's name to its value.  While the
    ask runs the record is also the context manager of its stage spans,
    whose ``with`` block closes the innermost open span."""

    __slots__ = ("ask", "bank", "spans", "counters", "profiled", "_open",
                 "_annotations", "_tally", "_builds", "_splits")

    def __init__(self, ask: int, bank: int):
        self.ask, self.bank = ask, bank
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = dict.fromkeys(COUNTS, 0)
        self.profiled = False
        self._open: List[int] = []
        self._annotations: Optional[Dict[int, object]] = None
        self._tally: Optional[sanitizers.Tally] = None
        self._builds = 0
        self._splits: Optional[List[tuple]] = None

    @property
    def root(self) -> str:
        return self.spans[0][0]

    def span_ms(self, name: str) -> float:
        """Milliseconds of every span named ``name``, summed."""
        return sum(s[3] - s[2] for s in self.spans if s[0] == name) * 1e-6

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        self._end(self._open[-1])
        return False

    def _begin(self, name: str, family: Optional[str]) -> int:
        spans, opened = self.spans, self._open
        i = len(spans)
        if self.profiled:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            if self._annotations is None:
                self._annotations = {}
            self._annotations[i] = rf
        spans.append((name, opened[-1] if opened else -1, _clock(), 0,
                      family))
        opened.append(i)
        return i

    def _end(self, i: int) -> None:
        """Close span ``i`` and any span opened inside it still open."""
        t = _clock()
        spans, opened = self.spans, self._open
        while opened:
            j = opened.pop()
            name, parent, t0, _, family = spans[j]
            spans[j] = (name, parent, t0, t, family)
            if self._annotations:
                rf = self._annotations.pop(j, None)
                if rf is not None:
                    rf.__exit__(None, None, None)
            if j == i:
                break

    def _split(self) -> None:
        """Move the factors / copy boundaries to where the device reached
        the copy's first event."""
        spans = self.spans
        for before, after, e0, e1 in self._splits:
            e1.synchronize()        # complete: the pick's exit came after
            b, a = spans[before], spans[after]
            split = max(a[2] - int(e0.elapsed_time(e1) * 1e6), b[2])
            spans[before] = b[:3] + (split,) + b[4:]
            spans[after] = a[:2] + (split,) + a[3:]
        self._splits = None


# the span of a recorder that is off, or of code outside an ask
_NULL = contextlib.nullcontext()


class _Root:
    __slots__ = ("bank", "name", "rec")

    def __init__(self, bank: int, name: str):
        self.bank, self.name = bank, name

    def __enter__(self):
        rec = self.rec = Record(next(_ASK_NUMBERS), self.bank)
        rec.profiled = _profiling()
        rec._builds = _builds()
        rec._tally = sanitizers.start_tally()
        _LOCAL.rec = rec
        rec._begin(self.name, None)
        return rec

    def __exit__(self, exc_type, *exc):
        rec = self.rec
        _LOCAL.rec = None
        sanitizers.stop_tally()
        rec._end(0)
        if exc_type is not None:
            return False        # a failed ask leaves no record
        if rec._splits:
            rec._split()
        rec.profiled = rec.profiled or _profiling()
        t, counters = rec._tally, rec.counters
        counters.update(exits=t.exits, d2h_bytes=t.d2h_bytes,
                        uploads=t.uploads, h2d_bytes=t.h2d_bytes,
                        entry_calls=t.entry_calls,
                        new_signatures=t.new_signatures,
                        builds=_builds() - rec._builds)
        RING.append(rec)
        return False


def root(bank: int, name: str):
    """The root span of one ask of bank ``bank``; a root opened inside an
    open ask of the same thread is a stage of that ask."""
    if not _ENABLED:
        return _NULL
    if getattr(_LOCAL, "rec", None) is not None:
        return span(name)
    return _Root(bank, name)


def span(name: str, family: Optional[str] = None, since=None):
    """A stage span of the open ask (nothing outside one), open from this
    call to the end of the ``with`` block it heads.  ``since`` is a
    ``device_mark`` taken before the exit that ended the previous stage:
    this span then starts, and that stage ends, when the device reached
    the mark's event."""
    if not _ENABLED:
        return _NULL
    rec = getattr(_LOCAL, "rec", None)
    if rec is None:
        return _NULL
    i = rec._begin(name, family)
    if since is not None:
        before, e0, device = since
        if rec._splits is None:
            rec._splits = []
        rec._splits.append((before, i, e0, _event(device)))
    return rec


def device_mark(device: torch.device):
    """Before a device->host exit that ends the open stage, on the card: a
    CUDA event recorded on the current stream, for ``span(...,
    since=...)``.  None off the card, outside an ask or when off."""
    if not _ENABLED or device.type != "cuda":
        return None
    rec = getattr(_LOCAL, "rec", None)
    if rec is None or not rec._open:
        return None
    return rec._open[-1], _event(device), device


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open ask's counter ``name``."""
    if not _ENABLED:
        return
    rec = getattr(_LOCAL, "rec", None)
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def records(bank: Optional[int] = None) -> List[Record]:
    """The ring's records, oldest first (of bank ``bank`` alone when
    given)."""
    return [r for r in list(RING) if bank is None or r.bank == bank]


def summary(bank: Optional[int] = None, last: int = 64) -> dict:
    """The last ``last`` asks (of bank ``bank`` when given): ``asks``;
    each span name's ``median_ms`` and ``p90_ms`` over the asks that
    record it (a name's spans summed within an ask) and ``n``, those
    asks' count; each counter's ``mean`` over the asks that record it
    (``na`` is recorded where the ask had a bucket)."""
    recs = records(bank)[-last:] if last > 0 else []
    per: Dict[str, List[float]] = {}
    for r in recs:
        for name in dict.fromkeys(s[0] for s in r.spans):
            per.setdefault(name, []).append(r.span_ms(name))
    spans = {name: {"n": len(v), "median_ms": float(np.median(v)),
                    "p90_ms": float(np.percentile(v, 90))}
             for name, v in per.items()}
    names: Iterable[str] = dict.fromkeys(k for r in recs for k in r.counters)
    counters = {k: float(np.mean([r.counters[k] for r in recs
                                  if k in r.counters]))
                for k in names}
    return {"asks": len(recs), "spans": spans, "counters": counters}
