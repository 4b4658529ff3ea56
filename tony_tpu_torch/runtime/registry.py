"""Runtime registry — ServiceLoader equivalent.

The PyTorch port's copy of ``tony_tpu/runtime/registry.py``.

Reference: FrameworkRuntimeProvider.java:29-61 resolves the configured
framework type to a runtime via Java ServiceLoader
(META-INF/services/...AbstractFrameworkRuntime). Here it's an explicit
registry plus ``register()`` for out-of-tree runtimes.

The port registers every runtime of the JAX package's but ``horovod``,
whose rendezvous driver is not ported yet: asking for it raises a
``ConfError`` at submit.
"""

from __future__ import annotations

from tony_tpu_torch.config import ConfError
from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter
from tony_tpu_torch.runtime.jax_runtime import JaxRuntime
from tony_tpu_torch.runtime.mxnet_runtime import MXNetRuntime
from tony_tpu_torch.runtime.pytorch_runtime import PyTorchRuntime
from tony_tpu_torch.runtime.ray_runtime import RayRuntime
from tony_tpu_torch.runtime.standalone import StandaloneRuntime
from tony_tpu_torch.runtime.tf_runtime import TFRuntime

_REGISTRY: dict[str, type[Runtime]] = {}


def register(runtime_cls: type[Runtime]) -> type[Runtime]:
    _REGISTRY[runtime_cls.name] = runtime_cls
    return runtime_cls


for _rt in (JaxRuntime, TFRuntime, PyTorchRuntime, MXNetRuntime,
            StandaloneRuntime, RayRuntime):
    register(_rt)

NOT_PORTED = {"horovod": "ROADMAP.md queue 1 item 7"}


def get_runtime(framework: str) -> type[Runtime]:
    if framework.lower() in NOT_PORTED:
        raise ConfError(
            f"the {framework.lower()} runtime is not ported to "
            f"tony_tpu_torch yet ({NOT_PORTED[framework.lower()]})")
    try:
        return _REGISTRY[framework.lower()]
    except KeyError:
        raise ValueError(
            f"unknown framework {framework!r}; known: {sorted(_REGISTRY)}"
        ) from None


def get_am_adapter(framework: str) -> AMAdapter:
    """Ref: FrameworkRuntimeProvider.getAMAdapter :53."""
    return get_runtime(framework).get_am_adapter()


def get_task_adapter(framework: str) -> TaskAdapter:
    """Ref: FrameworkRuntimeProvider.getTaskAdapter :61."""
    return get_runtime(framework).get_task_adapter()
