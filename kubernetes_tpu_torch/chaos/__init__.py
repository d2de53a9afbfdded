"""Chaos / failure-domain tooling: the deterministic fault-injection harness
(faultinject.py) behind the chaos tests."""

from .faultinject import (FaultInjected, FaultKill, FaultPlan, Injector,
                          arm, disarm, enabled)

__all__ = ["FaultInjected", "FaultKill", "FaultPlan", "Injector", "arm",
           "disarm", "enabled"]
