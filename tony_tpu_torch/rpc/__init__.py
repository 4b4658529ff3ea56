from tony_tpu_torch.rpc.client import RpcClient, RpcError
from tony_tpu_torch.rpc.server import RpcServer

__all__ = ["RpcClient", "RpcError", "RpcServer"]
