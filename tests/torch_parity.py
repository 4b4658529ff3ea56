"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: a tiny Qwen2-style configuration built in both packages on the
same weights, drawn from a seeded numpy generator and carried across by
``tony_tpu_torch.models.convert.from_jax_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tony_tpu.models.transformer import RopeScaling as JaxRopeScaling
from tony_tpu.models.transformer import Transformer as JaxTransformer
from tony_tpu.models.transformer import TransformerConfig as JaxConfig
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.transformer import RopeScaling, Transformer
from tony_tpu_torch.models.transformer import TransformerConfig

# Qwen2 family at test size: q/k/v biases, gated SiLU, GQA 6:1, tied
# embeddings, rope_theta 1e6
QWEN_TINY = dict(vocab_size=96, d_model=48, n_heads=6, n_kv_heads=1,
                 n_layers=2, d_ff=96, max_seq_len=64,
                 attention_backend="reference", qkv_bias=True,
                 gated_mlp=True, activation="silu", norm="rms",
                 norm_eps=1e-6, rope_theta=1e6, tied_embeddings=True)

LLAMA3_SCALING = dict(kind="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0, original_max_len=16)


def _leaf(rng, path: str, shape) -> np.ndarray:
    name = path.rsplit("/", 1)[-1]
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "bias":
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "embedding" or name == "lm_head":
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = shape[0] if "/o/" not in path else shape[0] * shape[1]
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def build_pair(seed: int = 0, jax_dtype=jnp.float32,
               torch_dtype=torch.float32, rope_scaling: dict | None = None,
               **overrides):
    """(jax model, jax params, torch model on the CPU) on the same
    seeded weights."""
    kw = {**QWEN_TINY, **overrides}
    jcfg = JaxConfig(dtype=jax_dtype, rope_scaling=JaxRopeScaling(
        **rope_scaling) if rope_scaling else None, **kw)
    tcfg = TransformerConfig(dtype=torch_dtype, rope_scaling=RopeScaling(
        **rope_scaling) if rope_scaling else None, **kw)
    jm = JaxTransformer(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        joined = "/".join(str(getattr(p, "key", p)) for p in path)
        leaves.append(_leaf(rng, "/" + joined, s.shape))
    params_np = jax.tree_util.tree_unflatten(treedef, leaves)
    tm = Transformer(tcfg, device="cpu")
    tm.load_state_dict(from_jax_params(params_np, tcfg))
    jparams = jax.tree.map(jnp.asarray, params_np)
    return jm, jparams, tm


def tokens(seed: int, shape, vocab: int = QWEN_TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int64)


def wait_for(cond, timeout: float = 120.0, what: str = "condition"):
    """Poll ``cond()`` until it holds; a long deadline, not a timing."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class Gate:
    """Holds a server's stepping at a step boundary once ``rows`` of its
    live requests each have ``after`` tokens, until ``open()``: the
    mid-stream window a migration test needs, made by an event and not
    by a sleep. A test that then waits on several streams of one server
    passes their number as ``rows``: with the default of one, the gate
    could freeze a stream admitted a step after the first below
    ``after`` tokens, and that wait could only time out. The hold sits
    outside the engine's locks (it wraps ``step``), so an
    ``extract_session`` from another thread goes through while it
    holds. Works on a JAX and a port ``Server`` alike."""

    def __init__(self, server, after: int, rows: int = 1):
        import threading

        self.held = threading.Event()
        self._go = threading.Event()
        real = server.step

        def step():
            if not self._go.is_set() and sum(
                    len(t) >= after
                    for t in server.live_progress().values()) >= rows:
                self.held.set()
                self._go.wait(300)
            return real()

        server.step = step

    def open(self) -> None:
        self._go.set()
