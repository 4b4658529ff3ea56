"""Continuous-batching serving over a paged KV cache or fixed-shape
cache rows (``engine``), the page pool and slots (``slots``), the radix
prefix store of pages or rows (``prefix``) and deterministic fault
injection (``faults``)."""

from tony_tpu_torch.serve.engine import (PoolExhausted, QueueFull,
                                         Request, Result, Server,
                                         bucket_len)
from tony_tpu_torch.serve.faults import Fault, FaultPlan, InjectedFault
from tony_tpu_torch.serve.prefix import PrefixStore
from tony_tpu_torch.serve.slots import PagePool, SlotCache

__all__ = ["Fault", "FaultPlan", "InjectedFault", "PagePool",
           "PoolExhausted", "PrefixStore", "QueueFull", "Request",
           "Result", "Server", "SlotCache", "bucket_len"]
