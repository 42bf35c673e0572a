from .supervisor import Supervisor, TrainerCrash, FailureInjector
from .straggler import StragglerMonitor

__all__ = ["Supervisor", "TrainerCrash", "FailureInjector", "StragglerMonitor"]
