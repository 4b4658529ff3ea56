"""TensorFlow runtime: TF_CONFIG injection.

The PyTorch port's copy of ``tony_tpu/runtime/tf_runtime.py``.

Reference: runtime/TFRuntime.java:45-59 + Utils.constructTFConfig
(util/Utils.java:503-520): gang mode only; the spec strips the
``tensorboard`` role always, and strips ``evaluator`` for non-evaluator
tasks (estimator semantics).
"""

from __future__ import annotations

import json

from tony_tpu_torch import constants as C
from tony_tpu_torch.runtime.base import Runtime, TaskAdapter, TaskContext


def construct_tf_config(cluster_spec: dict[str, list[str]], role: str,
                        index: int) -> str:
    cluster = {
        r: list(slots)
        for r, slots in cluster_spec.items()
        if r != C.TENSORBOARD_JOB_NAME
        and not (r == C.EVALUATOR_JOB_NAME and role != C.EVALUATOR_JOB_NAME)
    }
    return json.dumps(
        {
            "cluster": cluster,
            "task": {"type": role, "index": index},
            "environment": "cloud",
        }
    )


class TFTaskAdapter(TaskAdapter):
    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_task_env(ctx)
        mode = str(ctx.conf.get("tony.application.distributed-mode"))
        if mode == C.GANG:  # TF_CONFIG only meaningful with the full gang
            env[C.TF_CONFIG] = construct_tf_config(ctx.cluster_spec, ctx.role, ctx.index)
        return env


class TFRuntime(Runtime):
    name = "tensorflow"
    task_adapter_cls = TFTaskAdapter
