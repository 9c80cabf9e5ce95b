"""Fault tolerance: failure injection, checkpoint/restart supervision,
elastic resharding, straggler detection (training side; the serving side's
retry/hedging lives in repro_torch.core.runtime)."""

from repro_torch.ft.faults import (FailureInjector, InjectedFailure, RestartStats,
                                   StragglerMonitor, reshard_state, run_with_restarts)

__all__ = ["FailureInjector", "InjectedFailure", "RestartStats",
           "StragglerMonitor", "reshard_state", "run_with_restarts"]
