"""The port's mixture of experts (``tony_tpu_torch.parallel.moe``) against
``tony_tpu.parallel.moe`` on the same inputs, made from a numpy seed:
the layer's output, aux loss and gradients (input and every parameter)
routed and dropless, gated or not, renormalized or not, over each
activation and a capacity small enough to drop tokens; the gating's
dispatch bit for bit and its combine to the last bits of a softmax; a tie between two experts; the int8
expert conversion bit for bit; the expert-batched q8 matmul's plain
version against ``jax.vmap(q8_matmul)`` (the Pallas kernel in interpret
mode); the int8 layer against the JAX quantized layer; and the MoE
leaves carried both ways between the JAX tree and the port's
``state_dict`` (``from_jax_params``, ``to_jax_params``).

Tolerances: fp32 values hold to 1e-5 relative, to each element and to
the array's largest (``_close``: a gradient element that is a sum of
many cancelling terms carries the rounding of its largest terms); both
sides sum in fp32 in their own order. bf16 results of the q8 matmul
hold to one bf16 step (2^-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_pair
from tony_tpu.models.quantize import quantize_transformer_params as jax_qtp
from tony_tpu.ops.quant import q8_matmul as jax_q8
from tony_tpu.parallel import moe as jmoe
from tony_tpu_torch.models.convert import from_jax_params, to_jax_params
from tony_tpu_torch.models.quantize import (quantize_expert,
                                            quantize_for_serving)
from tony_tpu_torch.ops import quant as q8
from tony_tpu_torch.parallel import moe as tmoe

E, D, F, B, L = 4, 16, 24, 2, 6
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(),
                               err_msg=err_msg)


def _params(seed, gated, router_scale=1.0):
    rng = np.random.default_rng(seed)
    p = {"router": router_scale * rng.standard_normal((D, E)) / np.sqrt(D),
         "wi": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "wo": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if gated:
        p["wg"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _cfgs(**kw):
    return (jmoe.MoEConfig(num_experts=E, d_model=D, d_ff=F, **kw),
            tmoe.MoEConfig(num_experts=E, d_model=D, d_ff=F, **kw))


CASES = {
    "routed-gelu": dict(),
    "routed-gated-silu-renorm": dict(gated=True, activation="silu",
                                     renormalize_top_k=True),
    "routed-drops-gelu_tanh": dict(capacity_factor=0.5,
                                   activation="gelu_tanh"),
    "dropless-gated-silu-renorm": dict(dropless=True, gated=True,
                                       activation="silu",
                                       renormalize_top_k=True),
    "dropless-gelu_tanh": dict(dropless=True, activation="gelu_tanh"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_jax(case):
    """Forward, aux and the gradients of sum(out * r) + aux with respect
    to x and every parameter."""
    kw = CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    p_np = _params(1, kw.get("gated", False))
    rng = np.random.default_rng(2)
    x_np = rng.standard_normal((B, L, D)).astype(np.float32)
    r_np = rng.standard_normal((B, L, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_layer(p, x, jcfg)
        return jnp.sum(out * r_np) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    tx = torch.tensor(x_np, requires_grad=True)
    tout, taux = tmoe.moe_layer(tp, tx, tcfg)
    (torch.sum(tout * torch.from_numpy(r_np)) + taux).backward()

    _close(tout.detach().numpy(), jout)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=RTOL)
    _close(tx.grad.numpy(), jgx)
    for k in p_np:
        _close(tp[k].grad.numpy(), jgp[k], err_msg=k)


@pytest.mark.parametrize("capacity,renorm", [(2, False), (5, True),
                                             (12, False)])
def test_top_k_gating_matches_jax(capacity, renorm):
    """The dispatch bit for bit, and the combine where it is 0 (every
    token, expert and slot the same); the combine's gate weights to 2^-21
    relative: they are softmax probabilities, and ``torch.exp`` and
    XLA's exp differ in the last bit of about one value in four, so no
    fp32 softmax of the port gives XLA's bits."""
    logits = np.random.default_rng(3).standard_normal(
        (B * L, E)).astype(np.float32)
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(logits), 2, capacity,
                                   renormalize=renorm)
    td, tc, ta = tmoe.top_k_gating(torch.from_numpy(logits), 2, capacity,
                                   renormalize=renorm)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tc.numpy() == 0, np.asarray(jc) == 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2.0 ** -21,
                               atol=0)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=RTOL)


def test_top_k_tie_takes_the_lower_expert():
    """Two equal router columns give every token equal probabilities for
    experts 1 and 2: like ``jax.lax.top_k``, the port picks expert 1
    first, in the gates, the dispatch and the output."""
    jcfg, tcfg = _cfgs(top_k=1, capacity_factor=4.0)
    p_np = _params(4, False)
    p_np["router"][:, 2] = p_np["router"][:, 1]
    p_np["router"][:, 0] = p_np["router"][:, 3] = -3.0  # 1 and 2 win
    x_np = np.abs(np.random.default_rng(5).standard_normal(
        (B, L, D))).astype(np.float32)
    logits = x_np.reshape(-1, D) @ p_np["router"]
    _, _, idx, _ = tmoe._gates(torch.from_numpy(logits), 1, False)
    assert (idx[:, 0] == 1).all()
    jd, _, _ = jmoe.top_k_gating(jnp.asarray(logits), 1, 8)
    td, _, _ = tmoe.top_k_gating(torch.from_numpy(logits), 1, 8)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    jout, _ = jmoe.moe_layer(jax.tree.map(jnp.asarray, p_np),
                             jnp.asarray(x_np), jcfg)
    tout, _ = tmoe.moe_layer({k: torch.from_numpy(v)
                              for k, v in p_np.items()},
                             torch.from_numpy(x_np), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_quantize_expert_bit_equal():
    p_np = _params(6, True)
    p_np["wi"][1, :, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    jq = jax_qtp({"moe": p_np})["moe"]
    for nm in ("wi", "wg", "wo"):
        q, sc = quantize_expert(torch.from_numpy(p_np[nm]))
        assert q.dtype == torch.int8 and sc.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(jq[nm + "_q8"]))
        assert np.array_equal(sc.numpy(), np.asarray(jq[nm + "_scale"]))


@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_matmul_experts_reference_matches_vmapped_pallas(broadcast,
                                                            dtype):
    """``jax.vmap(q8_matmul, in_axes=(None or 0, 0, 0))``, the Pallas
    kernel run in interpret mode, against the plain version."""
    rng = np.random.default_rng(7)
    m, k, n = 5, 64, 128
    x_np = rng.standard_normal((m, k) if broadcast else (E, m, k))
    w_q, scale = quantize_expert(torch.from_numpy(
        rng.standard_normal((E, k, n)).astype(np.float32)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x_np, jdt)
    want = jax.vmap(jax_q8, in_axes=(None if broadcast else 0, 0, 0))(
        jx, jnp.asarray(w_q.numpy()), jnp.asarray(scale.numpy()))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    got = q8.q8_matmul_experts(tx, w_q, scale)
    assert got.dtype == tdt and tuple(got.shape) == (E, m, n)
    rtol = RTOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("dropless", [True, False])
def test_int8_moe_layer_matches_jax_quantized_layer(dropless):
    """The quantized layer (int8 experts by ``quantize_expert``, the
    router fp32) through both packages: the JAX one runs the vmapped
    Pallas kernel in interpret mode."""
    jcfg, tcfg = _cfgs(gated=True, activation="silu",
                       renormalize_top_k=True, dropless=dropless)
    p_np = _params(8, True)
    qp = {"router": p_np["router"]}
    for nm in ("wi", "wg", "wo"):
        q, sc = quantize_expert(torch.from_numpy(p_np[nm]))
        qp[nm + "_q8"], qp[nm + "_scale"] = q.numpy(), sc.numpy()
    x_np = np.random.default_rng(9).standard_normal(
        (B, L, D)).astype(np.float32)
    jout, jaux = jmoe.moe_layer(jax.tree.map(jnp.asarray, qp),
                                jnp.asarray(x_np), jcfg)
    tout, taux = tmoe.moe_layer({k: torch.from_numpy(v)
                                 for k, v in qp.items()},
                                torch.from_numpy(x_np), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=RTOL)


def test_mesh_is_refused():
    class Mesh:
        shape = {"expert": 2}

    _, tcfg = _cfgs(mesh=Mesh())
    with pytest.raises(NotImplementedError, match="item 5"):
        tmoe.moe_layer(_params(0, False), torch.zeros(1, 2, D), tcfg)


@pytest.mark.parametrize("kind", ["dense", "moe", "int8-moe"])
def test_params_carry_both_ways(kind):
    """``to_jax_params`` of the port's ``state_dict`` is the JAX tree
    ``from_jax_params`` read, leaf for leaf (the MoE block's router and
    experts, and the int8 experts with their scales), and reads back to
    the same ``state_dict``."""
    kw = {} if kind == "dense" else dict(
        gated_mlp=False, moe_every=2, moe_num_experts=4, moe_gated=True)
    _, jp, tm = build_pair(5, **kw)
    if kind == "int8-moe":
        tm = quantize_for_serving(tm)
        jp = jax_qtp({"params": jax.tree.map(np.asarray, jp)})["params"]
    sd = tm.state_dict()
    back = to_jax_params(sd, tm.cfg)["params"]
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(got[path], leaf), jax.tree_util.keystr(path)
    again = from_jax_params(back, tm.cfg)
    assert again.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(again[k].to(v.dtype), v), k
