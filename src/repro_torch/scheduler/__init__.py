from repro_torch.scheduler.base import Scheduler, assert_holds
from repro_torch.scheduler.local import SerialScheduler, ThreadScheduler

__all__ = ["Scheduler", "assert_holds", "SerialScheduler", "ThreadScheduler"]
