"""Package rules of the PyTorch port: it imports nothing of JAX, Flax or
the JAX package (an AST scan of every module, and a fresh interpreter
that imports them all and inspects ``sys.modules``); its entry points
raise without a CUDA device unless asked for the CPU; and work on CPU
tensors never launches the CUDA kernel."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import QWEN_TINY, tokens
from tony_tpu_torch.cli import generate as torch_cli
from tony_tpu_torch.cli import score as torch_score
from tony_tpu_torch.models.generate import generate
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
