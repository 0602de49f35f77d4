"""Durable ask/tell tuning service: WAL + exact-replay crash recovery.

See ``repro_torch.service.server`` for the write path (journal-then-apply),
``repro_torch.service.recovery`` for the restart path (snapshot + WAL suffix
replay), ``repro_torch.service.client`` for the driver-facing client, and
``repro_torch.service.chaos`` for the SIGKILL harness that proves the
bit-equal recovery contract.  The port's copy of ``repro.service``, over
the port's ``StudyBank``.
"""
from repro_torch.service.client import (RemoteOptimizer, RemoteTrial,
                                        ServiceClient, ServiceDown)
from repro_torch.service.recovery import RecoveryReport, recover
from repro_torch.service.server import (CrashPoints, ServiceError,
                                        TuningService, serve,
                                        space_from_spec)
from repro_torch.service.wal import (WriteAheadLog, read_records,
                                     truncate_to)

__all__ = [
    "RemoteOptimizer", "RemoteTrial", "ServiceClient", "ServiceDown",
    "RecoveryReport", "recover", "CrashPoints", "ServiceError",
    "TuningService", "serve", "space_from_spec", "WriteAheadLog",
    "read_records", "truncate_to",
]
