"""Serving front door over N in-process ``serve.Server`` replicas: the
PyTorch port's copy of ``tony_tpu/gateway``.

``core`` is the admission/routing/drain machinery (pure Python, no
sockets — unit-testable); ``admission`` the weighted-fair-queuing
tiers + tenant quotas; ``journal`` the write-ahead ticket journal a
restarted gateway recovers from; ``http`` the stdlib
thread-per-connection network face; ``edge`` the event-driven selector
front end. The CLI entrypoint is ``python -m
tony_tpu_torch.cli.gateway``; ``python -m tony_tpu_torch.cli.generate
--serve`` drives the same core over stdin/stdout JSONL. The JAX
package's ``autoscale``, ``rebalance`` and ``remote`` are not ported
yet (ROADMAP.md queue 3).
"""

from tony_tpu_torch.gateway.admission import (DEFAULT_TIER,
                                              DEFAULT_TIER_WEIGHTS,
                                              TenantQuotas, WFQueue,
                                              parse_tier_weights)
from tony_tpu_torch.gateway.core import (BadRequest, DeadlineExceeded,
                                         Gateway, GatewayClosed,
                                         GatewayHistory, GatewayQueueFull,
                                         GenRequest, NoHealthyReplicas,
                                         QuotaExceeded,
                                         RetryBudgetExhausted, Shed, Ticket)
from tony_tpu_torch.gateway.edge import GatewayEdge
from tony_tpu_torch.gateway.http import GatewayHTTP

__all__ = [
    "BadRequest",
    "DEFAULT_TIER",
    "DEFAULT_TIER_WEIGHTS",
    "DeadlineExceeded",
    "Gateway",
    "GatewayClosed",
    "GatewayEdge",
    "GatewayHTTP",
    "GatewayHistory",
    "GatewayQueueFull",
    "GenRequest",
    "NoHealthyReplicas",
    "QuotaExceeded",
    "RetryBudgetExhausted",
    "Shed",
    "TenantQuotas",
    "Ticket",
    "WFQueue",
    "parse_tier_weights",
]
