"""Host-side runtime of the port: the single-stream monitor state machine."""

from respmon_tpu_torch.runtime.monitor import RespiratoryMonitor

__all__ = ["RespiratoryMonitor"]
