"""Package rules of the PyTorch port: it imports nothing of JAX, Flax or
the JAX package (an AST scan of every module, and a fresh interpreter
that imports them all and inspects ``sys.modules``); every import of a
``tony_tpu_torch`` module in its source resolves, the lazy ones inside
functions included; it passes the repository's lint (``tools/lint.py``)
with ``chip_smoke.py``; its entry points raise without a CUDA device
unless asked for the CPU; the gateway CLI refuses only what is not
ported (``--mesh``); work on CPU tensors never launches the CUDA
kernel; and the job control plane (client, coordinator, agent, RPC,
session, config, runtimes, mini cluster) imports no ``torch`` at module
level, so that a coordinator or an agent process never loads it."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import QWEN_TINY, tokens
from tony_tpu_torch.cli import gateway as torch_gateway_cli
from tony_tpu_torch.cli import generate as torch_cli
from tony_tpu_torch.cli import replica as torch_replica_cli
from tony_tpu_torch.cli import score as torch_score
from tony_tpu_torch.examples import sft_lora
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.resnet import ResNet50
from tony_tpu_torch.models.transformer import Transformer, TransformerConfig
from tony_tpu_torch.models.quantize import quantize_for_serving
from tony_tpu_torch.ops import add_rmsnorm, q8_matmul, rmsnorm
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.serve import Request, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tony_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "tony_tpu")


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                yield path, rel.removesuffix(".__init__")


def _roots(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module.split(".")[0]]
    return []


def test_no_jax_imports_in_source():
    bad = []
    for path, _ in _modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += [(path, r) for node in ast.walk(tree) for r in _roots(node)
                if r in FORBIDDEN]
    assert not bad


def test_every_port_import_resolves():
    """Each ``tony_tpu_torch.*`` module an ``import`` or ``from ...
    import`` names, at any depth of the AST, exists (a name imported
    from a module may be an attribute instead)."""
    bad = []
    for path, _ in _modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(path, node.lineno, n) for n in names
                    if n.split(".")[0] == "tony_tpu_torch"
                    and importlib.util.find_spec(n) is None]
    assert not bad


def test_port_passes_the_lint():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "lint.py"),
                          "tony_tpu_torch", "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_port_loads_no_jax():
    mods = [m for _, m in _modules()]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


CONTROL_PLANE = ("client", "coordinator", "agent", "rpc", "session",
                 "config", "runtime", "mini")


def _module_level_imports(tree):
    """Imports outside any function or class body."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def test_control_plane_imports_no_torch_at_module_level():
    bad, seen = [], []
    for path, mod in _modules():
        if mod.split(".")[1:2] and mod.split(".")[1] in CONTROL_PLANE:
            seen.append(mod)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            bad += [(mod, n.lineno) for n in _module_level_imports(tree)
                    if "torch" in _roots(n)]
    assert not bad
    assert {m.split(".")[1] for m in seen} == set(CONTROL_PLANE)


def test_control_plane_processes_load_no_torch():
    """What ``python -m tony_tpu_torch.coordinator`` and ``.agent`` and the
    client import, transitively, leaves ``torch`` unloaded."""
    mods = ["tony_tpu_torch.coordinator.coordinator",
            "tony_tpu_torch.agent.executor", "tony_tpu_torch.client",
            "tony_tpu_torch.mini", "tony_tpu_torch.cli.local",
            "tony_tpu_torch.distributed"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(dtype=torch.float32, **QWEN_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(model)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "vocab_size": 96, "hidden_size": 48,
        "intermediate_size": 96, "num_hidden_layers": 1,
        "num_attention_heads": 6, "num_key_value_heads": 1,
        "max_position_embeddings": 64, "rms_norm_eps": 1e-6}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["--model", str(tmp_path), "--token-ids", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_score.main(["--model", str(tmp_path), "--token-ids", "1,2",
                          "--int8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["--model", str(tmp_path), "--serve",
                        "--serve-replicas", "2"])
    for argv in (["--demo-model"], ["--model", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_gateway_cli.main([*argv, "--replicas", "2", "--port", "0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_replica_cli.main([*argv, "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50(num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sft_lora.main(["--steps", "1"])


class _Built(Exception):
    """Raised in place of building the gateway: the CLI got past its
    flag checks."""


@pytest.mark.parametrize("flags", [
    ["--agents", "127.0.0.1:1"], ["--remote-replica", "--demo-model"],
    ["--roles", "prefill=1,decode=1", "--demo-model"],
    ["--autoscale-max", "4", "--demo-model"],
    ["--rebalance", "--demo-model"],
    ["--kv-host-mb", "64", "--demo-model"]],
    ids=lambda v: v[0])
def test_gateway_cli_takes_the_fabric_flags(flags, monkeypatch, capsys):
    """The flags of remote replicas and the KV fabric no longer exit 2:
    the CLI goes on to build its gateway (stopped there)."""
    def build(*a, **kw):
        raise _Built

    monkeypatch.setattr(torch_gateway_cli, "build_gateway", build)
    with pytest.raises(_Built):
        torch_gateway_cli.main([*flags, "--device", "cpu", "--port", "0"])
    assert "not ported" not in capsys.readouterr().err
    assert torch_gateway_cli.main(["--demo-model", "--device", "cpu",
                                   "--mesh", "4"]) == 2
    assert torch_replica_cli.main(["--demo-model", "--device", "cpu",
                                   "--mesh", "4"]) == 2


def test_cpu_work_never_launches_the_kernel():
    cfg = TransformerConfig(dtype=torch.float32, decode_attention="flash",
                            **QWEN_TINY)
    model = Transformer(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    flash_decode.launches = 0
    generate(model, tokens(0, (2, 5)), max_new_tokens=4)
    srv = Server(model, batch_size=2, device="cpu", prefix_cache_mb=1.0)
    list(srv.run([Request([1, 2, 3], 5), Request([4, 5], 3)]))
    assert srv.counters()["decode_steps"] > 0
    assert flash_decode.launches == 0


def test_cpu_int8_and_norm_work_never_launches_the_kernels():
    cfg = TransformerConfig(dtype=torch.float32, **QWEN_TINY)
    model = quantize_for_serving(Transformer(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0)))
    counters = (q8_matmul, rmsnorm, add_rmsnorm)
    for c in counters:
        c.launches = 0
    generate(model, tokens(0, (2, 5)), max_new_tokens=4)
    x = torch.randn(3, QWEN_TINY["d_model"])
    scale = torch.ones(QWEN_TINY["d_model"])
    rmsnorm(x, scale)
    add_rmsnorm(x, x.bfloat16(), scale)
    assert [c.launches for c in counters] == [0, 0, 0]
