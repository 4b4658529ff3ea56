"""Mixture-of-Experts on one card: the counterpart of
``tony_tpu/parallel/moe.py``.

Plain functions on tensors. Routing is the reference's: an fp32 router,
softmax probabilities, top-k gates (optionally renormalized to sum to 1,
Mixtral's rule) and the Switch/GShard load-balancing loss. Two ways to
evaluate the experts:

- routed (``dropless=False``, the training path): each expert takes at
  most ``capacity = max(1, int(capacity_factor * T / E))`` tokens of the
  dispatch's ``T`` rows, in token order choice by choice; dispatch and
  combine are one-hot ``[T, E, C]`` products, and a token past its
  expert's capacity is dropped from that expert;
- dropless (Mixtral's exact evaluation): every expert runs on every
  token, and the outputs combine by gate weight.

Points kept exact against the reference:
- ``jax.lax.top_k`` takes the lower index on a tie; ``torch.topk``
  promises no order, so the gates come from a stable descending sort;
- the router logits take the promoted dtype of the tokens and the
  router, as ``tokens @ router`` does in JAX: fp32 for the fp32 router
  parameter over ``cfg.dtype`` tokens, computed with TF32 off (routing
  in bf16 or TF32 flips top-k choices); a trainer's bf16 compute copy
  of the router routes in bf16, as the reference's ``Trainer`` does;
- dtypes promote as ``jnp.einsum`` promotes them: the routed dispatch of
  bf16 tokens by the fp32 one-hot gives fp32 expert inputs, and both
  combines sum in fp32 (the gate weights are fp32).

int8 experts (``wi_q8`` [E, D, F] with ``wi_scale`` [E, F], and so on)
run through ``ops.quant.q8_matmul_experts``, one launch for all experts
(the CUDA kernel on the card), as the reference runs ``q8_matmul`` under
``jax.vmap``. Expert parallelism over a mesh is not ported yet: a config
with ``mesh`` set raises (ROADMAP item 5).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch.ops.quant import q8_matmul_experts


@dataclass
class MoEConfig:
    """Field for field the reference's ``MoEConfig``."""

    num_experts: int = 8
    capacity_factor: float = 1.25
    top_k: int = 2
    d_model: int = 512
    d_ff: int = 2048
    gated: bool = False
    activation: str = "gelu"  # gelu | gelu_tanh | silu
    renormalize_top_k: bool = False
    dropless: bool = False
    mesh: Any = None
    expert_axis: str = "expert"


def _act(name: str):
    """'gelu' is the erf form, 'gelu_tanh' the approximation."""
    table = {
        "gelu": F.gelu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
    }
    if name not in table:
        raise ValueError(f"unsupported MoE activation {name!r} "
                         f"(supported: {sorted(table)})")
    return table[name]


def _refuse_mesh(cfg: MoEConfig) -> None:
    if cfg.mesh is not None:
        raise NotImplementedError(
            "MoE over a mesh (expert parallelism) is not ported to "
            "PyTorch yet (ROADMAP.md, item 5)")


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``, by comparison (no host read of the indices)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest per row, of equal values the
    lower index first (a stable descending sort)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return torch.gather(probs, -1, idx), idx


def _aux_loss(probs, gate_idx, e: int, k: int) -> torch.Tensor:
    """Switch/GShard load-balancing loss from the routing decisions."""
    me = probs.mean(dim=0)
    ce = _one_hot(gate_idx, e, probs.dtype).sum(dim=1).mean(dim=0)
    return e * (me * ce).sum() / k


def _gates(logits: torch.Tensor, k: int, renormalize: bool):
    """Softmax probabilities, the top-k gates (values, indices), the
    values renormalized to sum to 1 per token if asked, and the aux
    loss."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx, _aux_loss(probs, gate_idx, e, k)


def top_k_gating(logits: torch.Tensor, k: int, capacity: int,
                 renormalize: bool = False):
    """Top-k token -> expert routing with per-expert capacity.

    logits [T, E] -> (dispatch [T, E, C] one-hot, combine [T, E, C] gate
    weights, aux loss), in logits' dtype. A token's position in its
    expert's buffer counts the tokens before it, in token order, choice
    by choice; positions at or past ``capacity`` are dropped."""
    t, e = logits.shape
    probs, gate_vals, gate_idx, aux_loss = _gates(logits, k, renormalize)
    dt = logits.dtype
    dispatch = torch.zeros(t, e, capacity, dtype=dt, device=logits.device)
    combine = torch.zeros_like(dispatch)
    taken = torch.zeros(e, dtype=torch.int64, device=logits.device)
    for choice in range(k):
        idx = gate_idx[:, choice]
        one_hot = _one_hot(idx, e, torch.int64)  # [T, E]
        pos_within = torch.cumsum(one_hot, dim=0) - 1 + taken[None, :]
        taken = taken + one_hot.sum(dim=0)
        pos = (pos_within * one_hot).sum(dim=1)
        keep = pos < capacity
        w = gate_vals[:, choice] * keep
        slot = (_one_hot(idx, e, dt)[:, :, None]
                * _one_hot(torch.where(keep, pos, 0), capacity,
                           dt)[:, None, :])
        dispatch = dispatch + slot * keep[:, None, None].to(dt)
        combine = combine + slot * w[:, None, None]
    return dispatch, combine, aux_loss


def _promoted(x: torch.Tensor, w: torch.Tensor):
    """Both operands in ``jnp.einsum``'s promoted dtype (bf16 with fp32
    gives fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _mm(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` with its dtype promotion."""
    return torch.einsum(spec, *_promoted(x, w))


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [T, D] (every expert's) or [E, C, D] times w [E, D, F] -> [E, T
    or C, F], promoted: a batched product over the experts that reads
    each expert's weight where it lies (an einsum of ``td,edf`` would
    lay the weights out anew on every call)."""
    return torch.matmul(*_promoted(x, w))


def _q8_expert_ffn(params: dict, x: torch.Tensor, act, gated: bool):
    """The int8 expert FFN: x [T, D] (every expert's) or [E, C, D], each
    product one ``q8_matmul_experts`` launch over all experts."""
    up = q8_matmul_experts(x, params["wi_q8"], params["wi_scale"])
    if gated:
        h = act(q8_matmul_experts(x, params["wg_q8"],
                                  params["wg_scale"])) * up
    else:
        h = act(up)
    return q8_matmul_experts(h.contiguous(), params["wo_q8"],
                             params["wo_scale"])


def _expert_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """Per-expert FFN of both paths: act(x wi) or act(x wg) * (x wi),
    then wo; x is [E, C, D] (routed) or [T, D] (dropless, every expert
    on every token), the result [E, C or T, D]."""
    act = _act(cfg.activation)
    if "wi_q8" in params:
        return _q8_expert_ffn(params, x.contiguous(), act, cfg.gated)
    up = _expert_mm(x, params["wi"])
    if cfg.gated:
        h = act(_expert_mm(x, params["wg"])) * up
    else:
        h = act(up)
    return _expert_mm(h, params["wo"])


def _dropless_moe(params: dict, tokens: torch.Tensor, logits: torch.Tensor,
                  cfg: MoEConfig):
    """Every expert on every token, combined by (renormalized) gate
    weight: exact, no capacity and no dropping."""
    e = logits.shape[-1]
    _, gate_vals, gate_idx, aux = _gates(logits, cfg.top_k,
                                         cfg.renormalize_top_k)
    weights = (_one_hot(gate_idx, e, gate_vals.dtype)
               * gate_vals[..., None]).sum(dim=1)  # [T, E]
    expert_out = _expert_ffn(params, tokens, cfg)
    return _mm("etd,te->td", expert_out, weights), aux


@contextlib.contextmanager
def _full_fp32():
    """fp32 matrix products without TF32 for the router."""
    mm = torch.backends.cuda.matmul
    if not mm.allow_tf32:
        yield
        return
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = True


def router_logits(tokens: torch.Tensor, router: torch.Tensor):
    """Router logits [T, E] of ``tokens`` [T, D] in the promoted dtype
    (fp32 for an fp32 router), fp32 products without TF32."""
    dt = torch.promote_types(tokens.dtype, router.dtype)
    with _full_fp32():
        return tokens.to(dt) @ router.to(dt)


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x [B, L, D] -> (out [B, L, D] in the promoted dtype, fp32 aux
    loss). The dispatch's ``T`` is ``B * L``: every row takes part,
    padding included, as in the reference."""
    _refuse_mesh(cfg)
    b, l, d = x.shape
    tokens = x.reshape(b * l, d)
    logits = router_logits(tokens, params["router"])
    if cfg.dropless:
        out, aux = _dropless_moe(params, tokens, logits, cfg)
        return out.reshape(b, l, d), aux
    capacity = max(1, int(cfg.capacity_factor * (b * l) / cfg.num_experts))
    dispatch, combine, aux = top_k_gating(logits, cfg.top_k, capacity,
                                          renormalize=cfg.renormalize_top_k)
    expert_in = _mm("td,tec->ecd", tokens, dispatch)  # [E, C, D]
    expert_out = _expert_ffn(params, expert_in, cfg)
    out = _mm("ecd,tec->td", expert_out, combine)
    return out.reshape(b, l, d), aux


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    dtype=torch.float32, device=None) -> dict:
    """Random expert parameters from ``generator`` (on ``device``):
    router [D, E] and wi [E, D, F] at ``d_model ** -0.5``, wo [E, F, D]
    at ``d_ff ** -0.5``, wg like wi when gated."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(*shape, std):
        return torch.randn(*shape, generator=generator, dtype=dtype,
                           device=device) * std

    params = {"router": normal(d, e, std=d ** -0.5),
              "wi": normal(e, d, f, std=d ** -0.5),
              "wo": normal(e, f, d, std=f ** -0.5)}
    if cfg.gated:
        params["wg"] = normal(e, d, f, std=d ** -0.5)
    return params


def moe_logical_axes() -> dict:
    """Logical sharding names of the expert leaves (the reference's
    ``RULES['ep']``), for the parallelism slice."""
    return {
        "router": (None, None),
        "wi": ("expert", None, "mlp"),
        "wg": ("expert", None, "mlp"),
        "wo": ("expert", "mlp", None),
    }
