from tony_tpu_torch.metrics.sampler import (
    AVG_MEMORY_RSS,
    MAX_MEMORY_RSS,
    MetricsStore,
    TaskMetricsMonitor,
    process_tree_rss_bytes,
)

__all__ = [
    "AVG_MEMORY_RSS",
    "MAX_MEMORY_RSS",
    "MetricsStore",
    "TaskMetricsMonitor",
    "process_tree_rss_bytes",
]
