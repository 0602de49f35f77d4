from repro_torch.core.spaces import (ParamSpace, loguniform, Int, LogInt,
                                     Choice, CHOICE_KEY)
from repro_torch.core.optimizer import AskTellOptimizer, Trial
from repro_torch.core.studybank import StudyBank, StudyLedger
from repro_torch.core.tuner import Tuner, TunerResults
from repro_torch.core.async_tuner import AsyncTuner

__all__ = ["ParamSpace", "loguniform", "Int", "LogInt", "Choice",
           "CHOICE_KEY", "AskTellOptimizer", "Trial",
           "StudyBank", "StudyLedger", "Tuner", "TunerResults",
           "AsyncTuner"]
from repro_torch.core import tpe as _tpe  # registers optimizer="tpe"
