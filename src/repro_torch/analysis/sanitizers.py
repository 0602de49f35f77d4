"""Runtime sanitizers: enforce device-hygiene invariants while code runs.

The port's counterpart of ``repro.analysis.sanitizers``, with the
reference's names:

  * ``no_retrace()`` — the zero-retrace audit of the bank's steady state.
    Eager PyTorch has no jit cache; its counterpart is the registry
    ``repro_torch.core.gp.BANK_ENTRY_POINTS`` of ``EntryPoint`` wrappers,
    each recording the distinct dispatch signatures it has been called
    with (what a jit cache keys on: each tensor's shape, dtype and device,
    each host array's shape and dtype, the value of every other argument).
    A new signature is a new shape bucket, the port's "compile".  A kernel
    suite built or loaded inside the block counts too, under
    ``build:<suite>`` (a miss of ``kernels.build.load``).
  * ``no_transfer()`` — the block runs under
    ``torch.cuda.set_sync_debug_mode``: every synchronizing CUDA call (an
    ``.item()``, ``.cpu()``, ``torch.nonzero``, ``if t.any():``, a
    synchronous upload) raises.  ``to_host`` is the sanctioned exit (the
    reference's ``jax.device_get``) and ``to_device`` the sanctioned
    upload; each lifts the guard for its own call only.
  * ``start_tally()`` / ``stop_tally()`` — count the calling thread's
    ``to_host`` / ``to_device`` calls and bytes and its ``EntryPoint``
    calls and new signatures into a fresh ``Tally``, as ``core.telemetry``
    does over each ask; with no tally running nothing is counted.
  * ``assert_holds(lock)`` — debug-mode lock-ownership assertion for
    caller-must-hold functions.  Free when disabled; enable with
    ``REPRO_DEBUG_LOCKS=1`` or ``set_debug_locks``.

Imports torch, numpy and the standard library only.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class RetraceError(AssertionError):
    """A bank entry point met more new signatures than its budget."""


class RetraceReport:
    """Mutable report yielded by ``no_retrace``.

    ``expected`` maps entry-point name -> compiles the audited region is
    *allowed* (default 0 for every name: pure steady state).  Callers
    that legitimately cross shape buckets (the multi-study growth sweep)
    fill it in before the block exits.  After exit, ``deltas`` holds the
    per-entry-point new-cache-entry counts and ``violations`` the summed
    excess ``max(0, delta - expected)``.
    """

    def __init__(self, jits: Mapping[str, object],
                 expected: Optional[Mapping[str, int]] = None):
        self.jits = dict(jits)
        self.expected: Dict[str, int] = dict(expected or {})
        self.base: Dict[str, int] = {}
        self.deltas: Dict[str, int] = {}
        self.violations: int = 0
        self._finished = False

    def _snapshot(self) -> Dict[str, int]:
        return {name: int(f._cache_size())
                for name, f in self.jits.items()}

    def finish(self) -> None:
        now = self._snapshot()
        self.deltas = {k: now[k] - self.base[k] for k in self.jits}
        self.violations = sum(
            max(0, self.deltas[k] - int(self.expected.get(k, 0)))
            for k in self.jits)
        self._finished = True

    def detail(self) -> str:
        """`name=delta/expected` for every mismatching entry point."""
        return ",".join(
            f"{k}={self.deltas[k]}/{int(self.expected.get(k, 0))}"
            for k in sorted(self.jits)
            if self.deltas.get(k, 0) != int(self.expected.get(k, 0)))


def signature(args, kwargs) -> tuple:
    """What a jit cache would key a call on: a tensor by (shape, dtype,
    device), a host array or numpy scalar by (shape, dtype), anything else
    by its value, as a static argument."""
    def key(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype), str(v.device))
        if isinstance(v, (np.ndarray, np.generic)):
            return ("array", np.shape(v), str(v.dtype))
        return ("value", type(v).__name__, v)

    return (tuple(key(a) for a in args),
            tuple(sorted((k, key(v)) for k, v in kwargs.items())))


class Tally:
    """One thread's totals, since ``start_tally``, of the designed crossings
    and the entry points' calls: ``to_host`` calls (``exits``) and the
    bytes of the tensors they return (``d2h_bytes``), ``to_device`` calls
    (``uploads``) and the bytes they move (``h2d_bytes``), ``EntryPoint``
    calls (``entry_calls``) and the new signatures among them
    (``new_signatures``)."""

    __slots__ = ("exits", "d2h_bytes", "uploads", "h2d_bytes",
                 "entry_calls", "new_signatures")

    def __init__(self):
        self.exits = self.d2h_bytes = self.uploads = self.h2d_bytes = 0
        self.entry_calls = self.new_signatures = 0


_TALLY = threading.local()


def start_tally() -> Tally:
    """A fresh ``Tally`` that counts the calling thread's crossings and
    entry calls from now to ``stop_tally``."""
    t = _TALLY.t = Tally()
    return t


def stop_tally() -> None:
    """Stop the calling thread's tally."""
    _TALLY.t = None


class EntryPoint:
    """A bank entry point that records every distinct dispatch signature
    it is called with (``signature``); ``_cache_size()`` counts them, as a
    jitted function's does its compiles, so ``RetraceReport`` audits both
    alike.  Calls pass straight through."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._signatures: set = set()

    def __call__(self, *args, **kwargs):
        sigs = self._signatures
        seen = len(sigs)
        sigs.add(signature(args, kwargs))
        t = getattr(_TALLY, "t", None)
        if t is not None:
            t.entry_calls += 1
            t.new_signatures += len(sigs) - seen
        return self.__wrapped__(*args, **kwargs)

    def _cache_size(self) -> int:
        return len(self._signatures)


class _BuildMisses:
    """``build.load`` misses of one kernel suite, as a cache size: a suite
    built or loaded inside an audited block is a compile."""

    def __init__(self, suite: str):
        self.suite = suite

    def _cache_size(self) -> int:
        from repro_torch.kernels import build
        return build.MISSES.get(self.suite, 0)


def build_entries() -> Dict[str, object]:
    """``build:<suite>`` -> its load misses, for every kernel suite."""
    from repro_torch.kernels import build
    return {f"build:{s}": _BuildMisses(s) for s in build.suite_names()}


@contextlib.contextmanager
def no_retrace(jits: Optional[Mapping[str, object]] = None,
               expected: Optional[Mapping[str, int]] = None,
               raise_on_violation: bool = True):
    """Audit the signature caches of ``jits`` (name -> ``EntryPoint`` or
    anything with ``_cache_size()``) across the block: every entry point
    may add at most ``expected[name]`` (default 0) new signatures, i.e.
    meet at most that many new shape buckets.

    ``jits=None`` audits the bank serving pipeline
    (``gp.BANK_ENTRY_POINTS``) and every kernel suite's builds
    (``build_entries``): the zero-retrace contract.  Yields a
    ``RetraceReport``; with ``raise_on_violation=False`` the caller
    inspects ``report.violations`` itself.
    """
    if jits is None:
        from repro_torch.core import gp as gp_lib
        jits = {**gp_lib.BANK_ENTRY_POINTS, **build_entries()}
    rep = RetraceReport(jits, expected)
    rep.base = rep._snapshot()
    try:
        yield rep
    finally:
        rep.finish()
    if raise_on_violation and rep.violations:
        raise RetraceError(
            f"{rep.violations} unexpected new signature(s) in audited "
            f"region: {rep.detail()} (name=new_entries/expected) — a "
            "new shape bucket or build leaked into the steady state")


# ----------------------------------------------------------------- syncs
# The guard's process-wide state: whether a ``no_transfer`` block is
# active on a card, and whether ``to_host`` / ``to_device`` may lift it.
_GUARD = {"active": False, "explicit_ok": True}
_MODES = {"allow": 0, "log": 1, "log_explicit": 1, "disallow": 2,
          "disallow_explicit": 2}


@contextlib.contextmanager
def no_transfer(device_to_host: Optional[str] = "disallow",
                host_to_device: Optional[str] = None,
                device_to_device: Optional[str] = None,
                device: DeviceLike = None):
    """Sync-guard the block on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``).  Levels per direction, as the reference's: None
    (leave that direction out), "allow", "log", "disallow",
    "log_explicit", "disallow_explicit".

    PyTorch guards synchronizing calls, not directions, with one
    process-wide mode (``torch.cuda.set_sync_debug_mode``), so the levels
    map onto it as follows.  The block runs at the strictest level given:
    "allow" is mode "default", "log" / "log_explicit" mode "warn" (a
    warning at each sync), "disallow" / "disallow_explicit" mode "error"
    (each sync raises).  A synchronous upload (``torch.as_tensor`` of a
    host array onto the card, a Python scalar written into a card tensor)
    is such a sync whatever ``host_to_device`` says, so the reference's
    default, which allows uploads, becomes "allowed through
    ``to_device``".  ``to_host`` and ``to_device`` lift the mode for their
    own call unless a level ends in ``_explicit``, which, as in JAX,
    guards explicit crossings too.

    The mode is process-wide, not per thread: work other threads enqueue
    while the block runs is guarded too, and a ``to_host`` in one thread
    lifts the guard for all of them while it copies.  On ``device="cpu"``
    there is no CUDA sync to guard and the block leaves ``torch.cuda``
    alone, so it is not load-bearing there (as the reference's guard on
    the CPU backend).  On a card a failure to set the mode raises, and
    with ``device=None`` and no card the guard raises.
    """
    levels = [lv for lv in (device_to_host, host_to_device,
                            device_to_device) if lv is not None]
    for lv in levels:
        if lv not in _MODES:
            raise ValueError(f"unknown transfer-guard level {lv!r}")
    dev = resolve_device(device)
    if dev.type != "cuda" or not levels:
        yield
        return
    prev_mode = torch.cuda.get_sync_debug_mode()
    prev = dict(_GUARD)
    torch.cuda.set_sync_debug_mode(max(_MODES[lv] for lv in levels))
    _GUARD.update(active=True, explicit_ok=not any(
        lv.endswith("_explicit") for lv in levels))
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev_mode)
        _GUARD.update(prev)


@contextlib.contextmanager
def _sanctioned():
    """Lift an active guard for one designed crossing."""
    if not (_GUARD["active"] and _GUARD["explicit_ok"]):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def to_host(*tensors):
    """The designed device->host exit (the reference's
    ``jax.device_get``): each tensor as a numpy array, one for one
    argument, a tuple for several.  Host arrays pass through.  The call
    and the returned tensors' bytes go into the thread's running tally
    (``start_tally``)."""
    with _sanctioned():
        out = tuple(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t) for t in tensors)
    tl = getattr(_TALLY, "t", None)
    if tl is not None:
        tl.exits += 1
        for a, src in zip(out, tensors):
            if isinstance(src, torch.Tensor):
                tl.d2h_bytes += a.nbytes
    return out[0] if len(out) == 1 else out


def to_device(array, device, dtype=None) -> torch.Tensor:
    """The designed host->device upload: ``array`` (a host array, a
    scalar or a tensor) as a contiguous tensor on ``device``; a host array
    is cast to the numpy ``dtype`` first when one is given.  The call and
    the bytes it moves go into the thread's running tally
    (``start_tally``)."""
    with _sanctioned():
        if isinstance(array, torch.Tensor):
            out = array.to(device).contiguous()
        else:
            a = np.asarray(array, dtype=dtype)
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            out = torch.as_tensor(a, device=device)
    tl = getattr(_TALLY, "t", None)
    if tl is not None:
        tl.uploads += 1
        if not isinstance(array, torch.Tensor) or out.device != array.device:
            tl.h2d_bytes += out.nbytes
    return out


# --------------------------------------------------------------------- locks
_DEBUG_LOCKS = os.environ.get("REPRO_DEBUG_LOCKS", "") not in ("", "0")


def set_debug_locks(enabled: bool) -> bool:
    """Toggle ``assert_holds`` enforcement; returns the previous value."""
    global _DEBUG_LOCKS
    prev, _DEBUG_LOCKS = _DEBUG_LOCKS, bool(enabled)
    return prev


def debug_locks_enabled() -> bool:
    return _DEBUG_LOCKS


def assert_holds(lock) -> None:
    """Assert the calling thread holds ``lock``.

    A no-op unless debug mode is on (``REPRO_DEBUG_LOCKS=1`` or
    ``set_debug_locks(True)``), so caller-must-hold contracts — the
    commit path of the service, the drain predicates of the schedulers —
    can declare themselves at zero steady-state cost.  RLock/Condition
    check true ownership (``_is_owned``); a plain ``threading.Lock``
    has no owner, so only held-by-someone (``locked()``) is checkable.
    The lint rule REPRO-C201 treats a declared ``assert_holds(self.X)``
    as lock-held evidence for the whole function.
    """
    if not _DEBUG_LOCKS:
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        if not owned():
            raise AssertionError(
                f"assert_holds: {lock!r} is not held by "
                f"{threading.current_thread().name}")
        return
    locked = getattr(lock, "locked", None)
    if locked is not None and not locked():
        raise AssertionError(
            f"assert_holds: {lock!r} is not held (plain Lock: ownership "
            "is unverifiable, only held-by-someone)")
