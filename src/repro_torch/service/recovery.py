"""Crash recovery: latest snapshot + WAL suffix replay.

The recovery contract (proved end-to-end by the chaos harness in
``repro_torch.service.chaos``):

  * the snapshot (``StudyBank.save``'s atomic ``.npz``) stores ``op_seq``,
    the sequence number of the last journal op it contains;
  * the WAL holds every op since *some* earlier point — possibly
    overlapping the snapshot (compaction truncates the log *after* the
    snapshot replace, so a crash between the two leaves both);
  * replay truncates the torn tail, then applies every record with
    ``seq > op_seq`` in order.  Asks re-execute ``view.ask(n)`` against
    bit-identical RNG/GP state, so they mint the *same* trial ids and
    configurations the pre-crash service handed out; tells go through the
    idempotent ``tell_once`` path, so an at-least-once journal can't
    double-apply an observation.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List

from repro_torch.service.wal import read_records, truncate_to

SNAPSHOT = "snapshot.npz"
WAL_FILE = "wal.log"
CONFIG = "service.json"


@dataclasses.dataclass
class RecoveryReport:
    snapshot_loaded: bool = False
    snapshot_iteration: int = 0
    wal_records: int = 0          # valid frames found in the log
    replayed: int = 0             # applied (seq > snapshot op_seq)
    skipped: int = 0              # already contained in the snapshot
    truncated_bytes: int = 0      # torn tail cut off the log
    poisoned: int = 0             # consumed their seq but failed to apply


def recover(data_dir, bank,
            apply_record: Callable[[Dict[str, Any]], Any],
            on_snapshot: Callable[[], None] = None) -> RecoveryReport:
    """Restore ``bank`` (and the caller's side tables, via
    ``apply_record``) from ``data_dir``.  ``apply_record`` must route each
    journal op through ``bank.apply_op`` — the service passes its own
    wrapper so name tables and ask-dedup caches are rebuilt by the same
    code path that maintains them live.  ``on_snapshot`` fires after the
    snapshot load (before replay) so the caller can restore side tables
    from ``bank.extra`` first."""
    rep = RecoveryReport()
    snap = os.path.join(data_dir, SNAPSHOT)
    if os.path.exists(snap):
        rep.snapshot_iteration = bank.load(snap)
        rep.snapshot_loaded = True
        if on_snapshot is not None:
            on_snapshot()
    wal_path = os.path.join(data_dir, WAL_FILE)
    records, good, total = read_records(wal_path)
    rep.wal_records = len(records)
    if good < total:
        rep.truncated_bytes = total - good
        truncate_to(wal_path, good)
    for rec in records:
        if int(rec["seq"]) <= bank.op_seq:
            rep.skipped += 1
            continue
        prev = bank.op_seq
        try:
            apply_record(rec)
        except Exception:
            # ops are validated before journaling, so this is defense in
            # depth.  apply_op consumes the seq even when the apply raises;
            # if op_seq advanced, the record is a poison frame — live
            # serving skipped it the same way, so skipping here preserves
            # bit-exact replay.  op_seq NOT advancing means a structural
            # journal error (seq gap/reorder): abort rather than silently
            # drop the whole suffix.
            if bank.op_seq == prev:
                raise
            rep.poisoned += 1
        else:
            rep.replayed += 1
    return rep


def wal_suffix(data_dir) -> List[Dict[str, Any]]:
    """The valid records currently in the log (diagnostics / tests)."""
    return read_records(os.path.join(data_dir, WAL_FILE))[0]
