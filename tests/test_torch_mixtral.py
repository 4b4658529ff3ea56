"""Mixtral through the port against the JAX package and ``transformers``:
a tiny ``MixtralForCausalLM`` (vocab 96, d 48, ff 64, 2 layers, 4/2
heads, 4 experts, top-2) with seeded weights, saved as one
``model.safetensors`` and as two shards with an index. The port's
reader (``models.hf.load_hf_dir``) reads both to the same model, whose
logits match the JAX ``from_hf_mixtral`` model's and transformers' own;
greedy and sampled ``Server`` streams (paged and unpaged), ``generate``
in fp32 and int8, and the CLIs (``--serve``, ``--int8``, ``score
--int8``) are token-exact to the JAX package's. A routed MoE
(``moe_dropless=False``, capacity 1.25), whose outputs depend on every
row of a dispatch, serves token-exact through both ``Server``s, paged
and unpaged: the port dispatches the same rows with the same padding.

Tolerances: logits to 1e-5 relative of the largest against the JAX
model (both fp32), 3e-4 against transformers (the JAX package's own
test's); token streams exact; ``score`` to its printed precision.
"""

import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from torch_parity import build_pair, tokens
from tony_tpu.cli import generate as jax_cli
from tony_tpu.cli import score as jax_score
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.hf import from_hf_mixtral
from tony_tpu.models.quantize import quantize_for_serving as jax_quantize
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.cli import generate as torch_cli
from tony_tpu_torch.cli import score as torch_score
from tony_tpu_torch.models import generate
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.hf import (convert_mixtral_state_dict,
                                      load_hf_dir, mixtral_config,
                                      write_safetensors)
from tony_tpu_torch.serve import Request, Server

EOS = (9, 33, 71)


def _mixtral():
    config = transformers.MixtralConfig(
        vocab_size=96, hidden_size=48, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, num_local_experts=4,
        num_experts_per_tok=2, tie_word_embeddings=False,
        sliding_window=None, attention_dropout=0.0, eos_token_id=95,
        attn_implementation="eager")
    model = transformers.MixtralForCausalLM(config).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                x = 1.0 + 0.1 * rng.standard_normal(p.shape)
            elif name.endswith("embed_tokens.weight") \
                    or name.startswith("lm_head"):
                x = 0.3 * rng.standard_normal(p.shape)
            else:
                x = rng.standard_normal(p.shape) / np.sqrt(p.shape[-1])
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """(HF model, JAX model, JAX params, single-file dir, sharded dir)."""
    hf = _mixtral()
    single = tmp_path_factory.mktemp("mixtral_single")
    hf.save_pretrained(single)
    sharded = tmp_path_factory.mktemp("mixtral_sharded")
    hf.config.to_json_file(os.path.join(sharded, "config.json"))
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    names = sorted(sd)
    parts = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
             "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    weight_map = {}
    for fname, keys in parts.items():
        write_safetensors({k: sd[k] for k in keys},
                          os.path.join(sharded, fname))
        weight_map.update(dict.fromkeys(keys, fname))
    with open(os.path.join(sharded, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    jm, jp = from_hf_mixtral(hf)
    return hf, jm, jp["params"], str(single), str(sharded)


@pytest.fixture(scope="module")
def port(mixtral):
    return load_hf_dir(mixtral[3], device="cpu")[0]


@pytest.mark.parametrize("form", ["single", "sharded"])
def test_reader_matches_jax_and_transformers(mixtral, port, form):
    hf, jm, jp, single, sharded = mixtral
    tm, hfcfg = load_hf_dir(single if form == "single" else sharded,
                            device="cpu")
    assert hfcfg["model_type"] == "mixtral"
    cfg = tm.cfg
    assert cfg.moe_every == 1 and cfg.moe_num_experts == 4
    assert cfg.moe_gated and cfg.moe_renormalize and cfg.moe_dropless
    assert not cfg.gated_mlp and cfg.moe_d_ff == 64
    for k, v in port.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k
    toks = tokens(5, (2, 13))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-4)


def test_converter_matches_jax_tree_and_refuses_unmapped(mixtral, port):
    """``convert_mixtral_state_dict`` gives what ``from_jax_params``
    makes of the JAX importer's tree, and refuses an unmapped tensor."""
    hf, _, jp, _, _ = mixtral
    cfg = mixtral_config(hf.config.to_dict())
    sd = convert_mixtral_state_dict(dict(hf.state_dict()), cfg)
    via_jax = from_jax_params(jax_tree(jp), cfg)
    assert sd.keys() == via_jax.keys() == port.state_dict().keys()
    for k in sd:
        assert torch.equal(sd[k].float(), via_jax[k]), k
    bad = dict(hf.state_dict())
    bad["model.layers.0.block_sparse_moe.experts.0.w9.weight"] = \
        torch.zeros(2, 2)
    with pytest.raises(ValueError, match="does not map"):
        convert_mixtral_state_dict(bad, cfg)


def jax_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


MIX = [(tokens(10, 12).tolist() + tokens(11, 3).tolist(), 10),
       (tokens(12, 7).tolist(), 6), (tokens(13, 5).tolist(), 14),
       (tokens(14, 9).tolist(), 8), (tokens(15, 4).tolist(), 12)]


def _serve(srv, cls, sampled):
    for i, (p, n) in enumerate(MIX):
        kw = dict(temperature=0.8, top_k=5 if i % 4 == 2 else 0,
                  seed=100 + i) if sampled and i % 2 == 0 else {}
        srv.submit(cls(list(p), n, id=i, **kw))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


SERVE = dict(batch_size=2, eos_id=EOS, chunk_steps=4, min_bucket=8)


def _paging(paged):
    return dict(paged=True, kv_page_size=8) if paged else dict(paged=False)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_server_matches_jax(mixtral, port, paged):
    """Greedy and sampled requests in one run (every second one sampled,
    with its own seed)."""
    _, jm, jp, _, _ = mixtral
    want = _serve(JaxServer(jm, jp, **SERVE, **_paging(paged)), JaxRequest,
                  True)
    got = _serve(Server(port, device="cpu", **SERVE, **_paging(paged)),
                 Request, True)
    assert got == want
    assert any(r[1] == "eos" for r in got.values())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_generate_matches_jax(mixtral, port, int8):
    from tony_tpu_torch.models import quantize_for_serving

    _, jm, jp, _, _ = mixtral
    tm = port
    if int8:
        jm, jp = jax_quantize(jm, jp)
        tm = quantize_for_serving(port)
        for k, v in from_jax_params(jax_tree(jp), tm.cfg).items():
            assert torch.equal(tm.state_dict()[k].to(v.dtype), v), k
    prompt = tokens(21, (3, 7))
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt),
                                   max_new_tokens=12, eos_id=EOS))
    got = generate(tm, torch.from_numpy(prompt), max_new_tokens=12,
                   eos_id=EOS).numpy()
    assert np.array_equal(got, want)


def _run(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


LINES = [{"id": "a", "token_ids": [1, 2, 3], "max_new_tokens": 9},
         {"id": "b", "token_ids": [40, 41, 42, 43, 44], "max_new_tokens": 5},
         {"id": "c", "token_ids": [7], "max_new_tokens": 6}]
GROUPED = ["--token-ids", "5,6,7", "--token-ids", "9,1,4", "--token-ids",
           "2"]


@pytest.mark.parametrize("which", ["serve", "int8", "score-int8"])
def test_cli_matches_jax(mixtral, which, monkeypatch, capsys):
    """Over the sharded directory: the JAX CLI reads it through
    transformers, the port through its own reader."""
    ckpt = mixtral[4]
    if which == "serve":
        mains = (jax_cli.main, torch_cli.main)
        argv = ["--model", ckpt, "--serve", "--serve-batch", "2",
                "--eos-id", "17"]
        stdin = "\n".join(json.dumps(x) for x in LINES) + "\n"
    elif which == "int8":
        mains = (jax_cli.main, torch_cli.main)
        argv = ["--model", ckpt, *GROUPED, "--max-new-tokens", "6",
                "--int8"]
        stdin = ""
    else:
        mains = (jax_score.main, torch_score.main)
        argv = ["--model", ckpt, "--token-ids", "5,6,7,8,9,10",
                "--token-ids", "1,2,3,4", "--int8"]
        stdin = ""
    extra = [] if which == "score-int8" else ["--compile-cache", ""]
    rc_j, out_j = _run(mains[0], argv + extra, stdin, monkeypatch, capsys)
    rc_t, out_t = _run(mains[1], argv + ["--device", "cpu"], stdin,
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0 and out_t
    if which == "serve":  # finish order depends on the JAX CLI's threads
        out_j, out_t = sorted(out_j), sorted(out_t)
    assert out_t == out_j


@pytest.fixture(scope="module")
def routed():
    """A routed MoE (every second block, capacity 1.25, SwiGLU experts)
    built in both packages on the same weights."""
    return build_pair(17, gated_mlp=False, moe_every=2, moe_num_experts=4,
                      moe_top_k=2, moe_gated=True, moe_activation="silu",
                      moe_capacity_factor=1.25, moe_dropless=False)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_routed_moe_server_matches_jax(routed, paged):
    jm, jp, tm = routed
    want = _serve(JaxServer(jm, jp, **SERVE, **_paging(paged)), JaxRequest,
                  False)
    got = _serve(Server(tm, device="cpu", **SERVE, **_paging(paged)),
                 Request, False)
    assert got == want
