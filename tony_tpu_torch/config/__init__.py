from tony_tpu_torch.config.config import ConfError, TonyConf, build_conf, role_key
from tony_tpu_torch.config import keys

__all__ = ["TonyConf", "ConfError", "build_conf", "role_key", "keys"]
