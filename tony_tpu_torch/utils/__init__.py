"""Host utilities of the port (copies of the JAX package's)."""

from tony_tpu_torch.utils.fs import (
    LocalizableResource,
    app_staging_dir,
    new_app_id,
    parse_resources,
    staging_root,
    unzip,
    zip_dir,
)
from tony_tpu_torch.utils.net import ServerPort, local_host_name, reserve_port
from tony_tpu_torch.utils.shell import execute_shell, python_interpreter

__all__ = [
    "LocalizableResource",
    "ServerPort",
    "app_staging_dir",
    "execute_shell",
    "local_host_name",
    "new_app_id",
    "parse_resources",
    "python_interpreter",
    "reserve_port",
    "staging_root",
    "unzip",
    "zip_dir",
]
