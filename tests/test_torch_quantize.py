"""int8 weight-only models of the port (``models.quantize`` and
``QuantDense``) against the JAX package on the same numpy-seeded
weights, over four families: Qwen2-style GQA with q/k/v biases (the
path chip_smoke.py runs at full width), Llama GQA, GPT-NeoX and Phi
(layer norm, biases, partial rotary, parallel residual, an untied head
with a bias).

- The int8 values and scales equal ``tony_tpu.models.quantize.
  quantize_transformer_params``'s bit for bit, from the port's own
  fp32 ``state_dict`` and from the JAX tree.
- The quantized forward equals the JAX quantized forward on the
  converted tree to 1e-4 absolute (logits of magnitude ~7; the same
  fp32 math over 2 layers, summed in another order: the JAX Pallas
  kernel runs in interpret mode here, the port's plain version).
- Cached decode equals the port's quantized full forward to 1e-4, and
  greedy ``generate`` gives the JAX package's tokens.
- bf16 activations over the same int8 weights stay within 0.1 of the
  JAX bf16 quantized forward (each side rounds activations to bf16 at
  2^-8 relative, at different places, through 2 layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.quantize import quantize_for_serving as jax_qfs
from tony_tpu.models.quantize import (
    quantize_transformer_params as jax_quantize_params,
)
from tony_tpu.models.transformer import Transformer as JaxTransformer
from tony_tpu_torch.models import quantize_for_serving
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.generate import (generate, init_cache,
                                            single_decode_step)
from tony_tpu_torch.models.quantize import quantize_transformer_params
from tony_tpu_torch.models.transformer import QuantDense, Transformer
from tony_tpu_torch.ops.quant import q8_matmul

ATOL = 1e-4
_NEOX = dict(norm="layer", use_bias=True, qkv_bias=False, gated_mlp=False,
             activation="gelu", parallel_residual=True, rotary_dims=4,
             n_kv_heads=None)
FAMILIES = {
    "qwen2": {},
    "llama_gqa": dict(qkv_bias=False, n_kv_heads=2),
    "neox": _NEOX,
    "phi": dict(_NEOX, tied_embeddings=False, lm_head_bias=True),
}


def _quantized_pair(family, seed=0, **kw):
    """(JAX quantized model, its params, the port's quantized model
    loaded from the JAX tree, the port's float model, the numpy tree)."""
    jm, jp, tm = build_pair(seed, **FAMILIES[family], **kw)
    tree = jax.tree.map(np.asarray, jp)
    jqm, jqp = jax_qfs(jm, {"params": jp})
    qcfg = dataclasses.replace(tm.cfg, quantized=True)
    tqm = Transformer(qcfg, device="cpu")
    tqm.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jqp), qcfg))
    return jqm, jqp, tqm, tm, tree


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_int8_weights_bit_equal_to_jax(family):
    _, _, tqm, tm, tree = _quantized_pair(family)
    mine = quantize_for_serving(tm).state_dict()
    want = tqm.state_dict()  # the JAX tree's int8 and scales, mapped
    qkeys = [k for k in want if k.endswith((".kernel_q8", ".scale"))
             and k.split(".")[-2] in ("q", "k", "v", "o", "wg", "wi", "wo")]
    n_dense = 4 + (3 if tm.cfg.gated_mlp else 2)
    assert len(qkeys) == 2 * n_dense * tm.cfg.n_layers
    for key in want:
        assert mine[key].dtype == want[key].dtype, key
        assert torch.equal(mine[key], want[key]), key
    assert all(mine[k].dtype == torch.int8 for k in qkeys
               if k.endswith("kernel_q8"))
    # the JAX-layout route gives the JAX tree itself
    ours = jax.tree_util.tree_leaves_with_path(
        quantize_transformer_params(tree))
    theirs = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_quantize_params(tree))))
    assert len(ours) == len(theirs)
    for path, leaf in ours:
        np.testing.assert_array_equal(np.asarray(leaf), theirs[path])
        assert np.asarray(leaf).dtype == theirs[path].dtype


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_forward_matches_jax(family):
    jqm, jqp, tqm, tm, _ = _quantized_pair(family)
    toks = tokens(1, (2, 20))
    want = np.asarray(jqm.apply(jqp, jnp.asarray(toks)))
    q8_matmul.launches = 0
    with torch.no_grad():
        got = tqm(torch.as_tensor(toks)).numpy()
        fp = tm(torch.as_tensor(toks)).numpy()
    assert q8_matmul.launches == 0  # CPU tensors never launch
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # and close to the float model: the int8 error alone
    assert np.abs(got - fp).mean() / np.abs(fp).mean() < 0.05


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_decode_matches_quantized_forward(family):
    _, _, tqm, _, _ = _quantized_pair(family)
    seq = torch.as_tensor(tokens(4, (2, 10)))
    with torch.no_grad():
        full = tqm(seq)
        cache = init_cache(tqm, 2)
        steps = [tqm(seq[:, :4], decode=True, cache=cache)]
    for t in range(4, 10):
        cache, last = single_decode_step(tqm, cache, seq[:, t])
        steps.append(last[:, None])
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_greedy_generate_matches_jax(family):
    jqm, jqp, tqm, _, _ = _quantized_pair(family)
    prompt = tokens(5, (2, 7))
    eos = (7, 11)
    want = np.asarray(jax_generate(jqm, jqp["params"], jnp.asarray(prompt),
                                   max_new_tokens=12, eos_id=eos))
    got = generate(tqm, prompt, max_new_tokens=12, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_activations_over_int8_weights():
    """The smoke's bf16 route: quantize at fp32, load the same int8
    state_dict into a bf16 config."""
    jqm, jqp, tqm, _, _ = _quantized_pair("qwen2")
    bf16 = Transformer(dataclasses.replace(tqm.cfg, dtype=torch.bfloat16),
                       device="cpu")
    bf16.load_state_dict(tqm.state_dict())
    dense = [m for m in bf16.modules() if isinstance(m, QuantDense)]
    assert dense and all(m.kernel_q8.dtype == torch.int8
                         and m.scale.dtype == torch.float32 for m in dense)
    jbf16 = JaxTransformer(dataclasses.replace(jqm.cfg, dtype=jnp.bfloat16))
    toks = tokens(1, (2, 20))
    want = np.asarray(jbf16.apply(jqp, jnp.asarray(toks)))
    with torch.no_grad():
        got = bf16(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


def test_quantize_refuses_what_it_cannot_convert():
    _, _, tm = build_pair(0)
    bf16 = Transformer(dataclasses.replace(tm.cfg, dtype=torch.bfloat16),
                       device="cpu")
    bf16.load_state_dict(tm.state_dict())
    with pytest.raises(ValueError, match="fp32"):
        quantize_for_serving(bf16)
    # MoE experts convert (int8 [E, in, out], fp32 scales [E, out]); an
    # expert block with a leaf the conversion does not know is refused
    moe = {"block_0": {"moe": {"router": np.zeros((4, 2), np.float32),
                               "wi": np.zeros((2, 4, 8), np.float32)}}}
    out = quantize_transformer_params(moe)["block_0"]["moe"]
    assert out["wi_q8"].shape == (2, 4, 8) and out["wi_scale"].shape == (2, 8)
    moe["block_0"]["moe"]["w9"] = np.zeros((2, 8, 4), np.float32)
    with pytest.raises(ValueError, match="MoE"):
        quantize_transformer_params(moe)


def test_trainer_refuses_a_quantized_model():
    from tony_tpu_torch.train import FusedAdamW, Trainer

    _, _, tqm, _, _ = _quantized_pair("qwen2")
    with pytest.raises(ValueError, match="quantize_for_serving"):
        Trainer(tqm, lambda m, b: m(b).sum(), FusedAdamW(1e-3))


def test_quantized_weights_are_a_quarter_of_the_bytes():
    _, _, tqm, tm, _ = _quantized_pair("llama_gqa")

    def dense_bytes(model):
        return sum(t.numel() * t.element_size()
                   for k, t in model.state_dict().items()
                   if k.rsplit(".", 1)[-1] in ("weight", "kernel_q8"))

    assert dense_bytes(tqm) * 4 == dense_bytes(tm)
    assert not any(p.dtype == torch.int8 for p in tqm.parameters())
