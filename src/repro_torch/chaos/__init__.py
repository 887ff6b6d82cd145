"""Chaos tier (DESIGN.md §15): seeded fault injection, agent-swarm
stress, and the linearizability checker that audits what survived.

The layering contract: core code never imports this package — it only
announces named :func:`repro_torch.core.hooks.fault_point` seams, and
:func:`fault_injection` installs a :class:`FaultPlan` to act on them.
"""
from repro_torch.chaos.check import check_history, check_swarm
from repro_torch.chaos.clock import FakeClock
from repro_torch.chaos.faults import (FaultPlan, FaultRule, FaultyStore,
                                      fault_injection)
from repro_torch.chaos.swarm import (AgentRecord, SwarmConfig, SwarmResult,
                                     run_swarm)
from repro_torch.core.hooks import (InjectedCrash, InjectedFault,
                                    install_fault_hook)

__all__ = [
    "AgentRecord", "FakeClock", "FaultPlan", "FaultRule", "FaultyStore",
    "InjectedCrash", "InjectedFault", "SwarmConfig", "SwarmResult",
    "check_history", "check_swarm", "fault_injection",
    "install_fault_hook", "run_swarm",
]
