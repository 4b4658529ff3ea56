from tony_tpu_torch.mini.cluster import MiniTonyCluster, script_conf

__all__ = ["MiniTonyCluster", "script_conf"]
