from repro_torch.scheduler.base import (AsyncScheduler, BatchToAsyncAdapter,
                                        Scheduler, TaskHandle, as_async,
                                        assert_holds)
from repro_torch.scheduler.local import SerialScheduler, ThreadScheduler

__all__ = ["Scheduler", "AsyncScheduler", "TaskHandle",
           "BatchToAsyncAdapter", "as_async", "assert_holds",
           "SerialScheduler", "ThreadScheduler"]
