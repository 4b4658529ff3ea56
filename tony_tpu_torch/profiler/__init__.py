from tony_tpu_torch.profiler.chrome_trace import (
    device_busy_ms,
    op_totals_ms,
    per_plane_op_totals_ms,
)
from tony_tpu_torch.profiler.profiler import (
    ServeProfiler,
    StepProfiler,
    maybe_start_server,
    trace,
    trigger_path,
    write_trigger,
)

__all__ = [
    "ServeProfiler",
    "StepProfiler",
    "device_busy_ms",
    "maybe_start_server",
    "op_totals_ms",
    "per_plane_op_totals_ms",
    "trace",
    "trigger_path",
    "write_trigger",
]
