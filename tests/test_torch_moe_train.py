"""Training a routed mixture of experts through the port's ``Trainer``
against the JAX ``Trainer``, the load-balancing loss added in
``apply_fn`` as ``examples/lm-pretrain/pretrain.py`` adds it
(``moe_aux_loss`` over the ``losses`` a forward collects; flax's
``mutable=["losses"]`` in the JAX package): the tiny Qwen2-style model
with every second block a routed MoE (4 experts, top-2, capacity 1.25),
fp32, ``FusedAdamW``, three steps, remat off and ``attn_saved`` (the
policy that checkpoints the expert FFN alone). The losses, the final aux
loss and the parameters hold to the dense
trainer's tolerances (``tests/test_torch_train.py``: 1e-5 on losses, 2e-5
on parameters). The step captured whole (the graph cache's stand-in
capture) gives the eager step's bits, and remat (``nothing``, the whole
block recomputed) changes no bit. Then
the port's ``examples/lm_pretrain.py --moe`` trains at its toy size with
falling losses.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graphs import StandIn
from torch_parity import build_pair, tokens
from tony_tpu.models.transformer import moe_aux_loss as jax_aux
from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu_torch.examples import lm_pretrain
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.models.transformer import moe_aux_loss
from tony_tpu_torch.ops.adamw import FusedAdamW
from tony_tpu_torch.ops.xent import chunked_cross_entropy
from tony_tpu_torch.train import Trainer

SEQ, LR = 17, 1e-3
MOE = dict(gated_mlp=False, moe_every=2, moe_num_experts=4, moe_top_k=2,
           moe_capacity_factor=1.25)


def _pair(**kw):
    return build_pair(3, **MOE, **kw)


def _batches(n, b=4):
    return [tokens(200 + i, (b, SEQ)) for i in range(n)]


def _jax_run(jm, jparams, batches):
    def apply_fn(p, batch):
        hidden, mut = jm.apply(p, batch["tokens"], return_hidden=True,
                               mutable=["losses"])
        ce = jax_xent(hidden[:, :-1], p["params"]["embedding"],
                      batch["tokens"][:, 1:], chunk_size=40)
        return ce + jax_aux(mut["losses"])

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    tr = JaxTrainer(mesh=mesh, apply_fn=apply_fn,
                    optimizer=JaxFusedAdamW(LR), donate=False)
    step_fn, state = tr.build_step(tr.init_state({"params": jparams}))
    losses = []
    for x in batches:
        state, m = step_fn(state, {"tokens": jnp.asarray(x, jnp.int32)})
        losses.append(float(m["loss"]))
    _, mut = jm.apply({"params": state.params["params"]},
                      jnp.asarray(batches[0], jnp.int32),
                      mutable=["losses"])
    return state.params["params"], losses, float(jax_aux(mut["losses"]))


def _apply_fn(model, batch):
    losses = []
    hidden = model(batch["tokens"], return_hidden=True, losses=losses)
    ce = chunked_cross_entropy(hidden[:, :-1], model.embedding,
                               batch["tokens"][:, 1:], chunk_size=40)
    return ce + moe_aux_loss(losses)


def _torch_run(tm, batches, captured=False):
    tr = Trainer(tm, _apply_fn, FusedAdamW(LR))
    if captured:
        tr.graphs = GraphCache("cpu", StandIn())
    state = tr.init_state()
    losses = []
    for x in batches:
        state, m = tr.step(state, {"tokens": torch.from_numpy(x)})
        losses.append(float(m["loss"]))
    aux = []
    with torch.no_grad():
        tm(torch.from_numpy(batches[0]), losses=aux)
    return state.params, losses, float(moe_aux_loss(aux)), tr


@pytest.mark.parametrize("remat", ["off", "attn_saved"])
def test_routed_moe_trainer_matches_jax(remat):
    kw = {} if remat == "off" else dict(remat=True, remat_policy=remat)
    jm, jparams, tm = _pair(**kw)
    batches = _batches(3)
    jp, jl, jaux = _jax_run(jm, jparams, batches)
    tp, tl, taux, _ = _torch_run(tm, batches)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg)
    for name, w in want.items():
        np.testing.assert_allclose(tp[name].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=name)


def test_captured_step_and_remat_change_no_bit():
    """The step captured whole (one aux loss a MoE block, appended once
    under remat's recomputation) against the eager step, with and
    without remat: the same bits."""
    batches = _batches(3)
    runs = []
    for remat, captured in ((False, False), (False, True), (True, True)):
        _, _, tm = _pair(remat=remat, remat_policy="nothing")
        params, losses, aux, tr = _torch_run(tm, batches, captured)
        if captured:
            c = tr.graphs.counters(("train_step",))
            assert c["train_step_captures"] == 1
            assert c["train_step_replays"] == 2
        runs.append((losses, aux, params))
    for losses, aux, params in runs[1:]:
        assert losses == runs[0][0] and aux == runs[0][1]
        for name, p in params.items():
            assert torch.equal(p, runs[0][2][name]), name


def test_lm_pretrain_moe_trains(tmp_path):
    cfg = {"model_type": "qwen2", "hidden_size": 48,
           "num_hidden_layers": 2, "num_attention_heads": 6,
           "num_key_value_heads": 1, "intermediate_size": 96,
           "vocab_size": 96, "hidden_act": "silu", "rope_theta": 1e6,
           "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
           "max_position_embeddings": 64}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "r.json"
    rc = lm_pretrain.main(["--config-json", str(path), "--moe", "--steps",
                           "8", "--micro", "2", "--accum", "1", "--seq-len",
                           "16", "--max-seq-len", "64", "--lr", "3e-3",
                           "--device", "cpu", "--result", str(out)])
    assert rc == 0
    losses = json.loads(out.read_text())["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1
