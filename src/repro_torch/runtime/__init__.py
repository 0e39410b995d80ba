"""The steal runtime (port of ``repro.runtime``): the executor over
stacked lanes, the adaptive proportion, telemetry, the failure detector
and the resilience layer (fault plans, recovery supersteps, snapshots)."""

from repro_torch.core.ops import item_nbytes
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.runtime.detector import DetectorPolicy, FailureDetector
from repro_torch.runtime.executor import StealRuntime
from repro_torch.runtime.resilience import FaultPlan, FaultState
from repro_torch.runtime.telemetry import RoundRecord, Telemetry, WaveRecord

__all__ = [
    "AdaptiveConfig",
    "AdaptiveController",
    "DetectorPolicy",
    "FailureDetector",
    "FaultPlan",
    "FaultState",
    "StealRuntime",
    "RoundRecord",
    "WaveRecord",
    "Telemetry",
    "item_nbytes",
]
