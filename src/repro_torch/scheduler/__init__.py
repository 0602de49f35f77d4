from repro_torch.scheduler.base import (AsyncScheduler, BatchToAsyncAdapter,
                                        Scheduler, TaskHandle, as_async,
                                        assert_holds)
from repro_torch.scheduler.distributed import (FaultInjection,
                                               TaskQueueScheduler)
from repro_torch.scheduler.local import (ProcessScheduler, SerialScheduler,
                                         ThreadScheduler)
from repro_torch.scheduler.service import ServiceScheduler

__all__ = ["Scheduler", "AsyncScheduler", "TaskHandle",
           "BatchToAsyncAdapter", "as_async", "assert_holds",
           "FaultInjection", "TaskQueueScheduler", "ProcessScheduler",
           "SerialScheduler", "ThreadScheduler", "ServiceScheduler"]
