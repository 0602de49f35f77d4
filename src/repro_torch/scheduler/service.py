"""ServiceScheduler: run the existing tuner drivers against a remote
durable tuning service.

The scheduler protocols in this package answer "who *executes* trials";
the durable service answers "who *owns* ask/tell state".  This scheduler
composes the two: trial execution delegates to any inner scheduler
(serial, threads, task queue — whatever the deployment already uses),
while ``make_engine`` hands the driver a ``RemoteOptimizer`` bound to one
named study on the service.  ``Tuner``/``AsyncTuner`` detect the hook and
use the remote engine instead of constructing a local
``AskTellOptimizer`` — the driver loops are unchanged, but every ask and
tell is journaled server-side, so a crashed driver (or service) resumes
from the WAL with bit-identical proposals.

Strategy configuration (optimizer type, seed, fit schedule) lives in the
service's ``service.json``, not the driver config: N drivers against one
study must agree on it, and the journal replays against exactly one
strategy state.  The service, not this scheduler, holds the bank, so it
takes no device.  The port's copy of ``repro.scheduler.service``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.service.client import RemoteOptimizer, ServiceClient


class ServiceScheduler:
    """Scheduler view of one study on a remote tuning service.

    ``inner`` executes trials (defaults to ``SerialScheduler``) and this
    object transparently exposes whichever scheduler protocol the inner
    one implements; ``make_engine`` supplies the remote ask/tell core.
    """

    def __init__(self, base_url: str, study: str, inner=None,
                 client: Optional[ServiceClient] = None,
                 timeout: float = 30.0, retries: int = 3):
        from repro_torch.scheduler.local import SerialScheduler
        self.client = client or ServiceClient(base_url, timeout=timeout,
                                              retries=retries)
        self.study = study
        self.inner = inner if inner is not None else SerialScheduler()

    def make_engine(self, param_space,
                    conf: Optional[Dict[str, Any]] = None
                    ) -> RemoteOptimizer:
        """The driver's ask/tell core: a client for this study.  ``conf``
        is accepted for signature uniformity; strategy settings are
        server-side (see module docstring)."""
        return RemoteOptimizer(self.client, self.study,
                               param_space=param_space)

    # Expose exactly the protocol surface the inner scheduler has:
    # hasattr-based dispatch (``as_async``, the tuners) then sees a batch
    # scheduler, an async one, or both — matching the inner's nature.
    def __getattr__(self, item):
        if item in ("make_objective", "submit", "wait_any", "gather",
                    "as_async", "shutdown", "start", "stats"):
            return getattr(self.inner, item)
        raise AttributeError(item)
