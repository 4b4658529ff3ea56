from tony_tpu_torch.coordinator.coordinator import (
    ClientRpcHandler,
    Coordinator,
)
from tony_tpu_torch.coordinator.launcher import (
    Launcher,
    LocalProcessLauncher,
    SshLauncher,
)
from tony_tpu_torch.coordinator.liveness import LivenessMonitor

__all__ = [
    "ClientRpcHandler",
    "Coordinator",
    "Launcher",
    "LivenessMonitor",
    "LocalProcessLauncher",
    "SshLauncher",
]
