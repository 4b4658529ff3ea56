from tony_tpu_torch.coordinator.liveness import LivenessMonitor

__all__ = ["LivenessMonitor"]
