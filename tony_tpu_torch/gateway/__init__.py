"""Serving front door over N ``serve.Server`` replicas: the PyTorch
port's copy of ``tony_tpu/gateway``.

``core`` is the admission/routing/drain machinery (pure Python, no
sockets — unit-testable); ``admission`` the weighted-fair-queuing
tiers + tenant quotas; ``autoscale`` the elastic control loop driving
``Gateway.add_replica``/``remove_replica``; ``rebalance`` the
pressure-driven live migration loop; ``remote`` the remote-replica stub
(a replica agent a host, lease heartbeats, epoch fencing, resumable
streams); ``journal`` the write-ahead ticket journal a restarted gateway
recovers from; ``http`` the stdlib
thread-per-connection network face; ``edge`` the event-driven selector
front end. The CLI entrypoint is ``python -m
tony_tpu_torch.cli.gateway``; ``python -m tony_tpu_torch.cli.generate
--serve`` drives the same core over stdin/stdout JSONL; ``python -m
tony_tpu_torch.cli.replica`` is the agent a host.
"""

from tony_tpu_torch.gateway.admission import (DEFAULT_TIER,
                                              DEFAULT_TIER_WEIGHTS,
                                              TenantQuotas, WFQueue,
                                              parse_tier_weights)
from tony_tpu_torch.gateway.autoscale import (AutoScaler,
                                              ProvisionerBackend,
                                              ScaleError, ThreadBackend)
from tony_tpu_torch.gateway.core import (BadRequest, DeadlineExceeded,
                                         Gateway, GatewayClosed,
                                         GatewayHistory, GatewayQueueFull,
                                         GenRequest, NoHealthyReplicas,
                                         QuotaExceeded,
                                         RetryBudgetExhausted, Shed, Ticket)
from tony_tpu_torch.gateway.edge import GatewayEdge
from tony_tpu_torch.gateway.http import GatewayHTTP
from tony_tpu_torch.gateway.rebalance import Rebalancer
from tony_tpu_torch.gateway.remote import (AgentHTTPError, AgentTransport,
                                           RemoteServer,
                                           launch_local_agent)

__all__ = [
    "AgentHTTPError",
    "AgentTransport",
    "AutoScaler",
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
    "ProvisionerBackend",
    "QuotaExceeded",
    "Rebalancer",
    "RemoteServer",
    "RetryBudgetExhausted",
    "ScaleError",
    "Shed",
    "TenantQuotas",
    "ThreadBackend",
    "Ticket",
    "WFQueue",
    "launch_local_agent",
    "parse_tier_weights",
]
