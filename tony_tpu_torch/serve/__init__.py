"""Continuous-batching serving over a paged KV cache or fixed-shape
cache rows (``engine``), the page pool and slots (``slots``), the radix
prefix store of pages or rows (``prefix``), deterministic fault
injection (``faults``), the host-RAM page tier and the page wire codec
(``tier``), live session migration (``migrate``) and the replica agent
behind HTTP (``agent``)."""

from tony_tpu_torch.serve.engine import (PoolExhausted, QueueFull,
                                         Request, Result, Server,
                                         bucket_len)
from tony_tpu_torch.serve.faults import Fault, FaultPlan, InjectedFault
from tony_tpu_torch.serve.prefix import PrefixStore
from tony_tpu_torch.serve.slots import (PagePool, SlotCache, gather_pages,
                                        scatter_pages)
from tony_tpu_torch.serve.tier import HostPageTier

__all__ = ["Fault", "FaultPlan", "HostPageTier", "InjectedFault",
           "PagePool", "PoolExhausted", "PrefixStore", "QueueFull",
           "Request", "Result", "Server", "SlotCache", "bucket_len",
           "gather_pages", "scatter_pages"]
