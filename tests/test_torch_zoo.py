"""The model zoo through the port against the JAX package and
``transformers``: GPT-2, GPT-NeoX (parallel and sequential residual),
Phi and Gemma, each a tiny model built by ``transformers`` from a seeded
config that turns on the family's own knobs, its weights drawn from a
seeded numpy generator:

- GPT-2: learned positions (32 of them, so a request reaches the clip)
  and Conv1D ``[in, out]`` weights with the fused ``c_attn``;
- GPT-NeoX: ``rotary_pct`` 0.25 of a 16-wide head, the fused per-head
  ``query_key_value``, ``use_parallel_residual`` on and off, an untied
  head;
- Phi: ``partial_rotary_factor`` 0.4, one shared input LayerNorm and a
  biased untied head;
- Gemma: one KV head, ``head_dim`` 16 against d / h = 12, the embedding
  scale, the (1 + weight) RMSNorm, and ``hidden_act`` read before
  ``hidden_activation`` (``gelu`` against ``gelu_pytorch_tanh``).

Each is saved as ``config.json`` (``to_json_file``) and one
``model.safetensors`` written by the port's ``write_safetensors``, then
read by ``models.hf.load_hf_dir``. Held: logits within 1e-5 of the
largest against the JAX ``from_hf_*`` model (both fp32) and within 3e-4
against ``transformers`` (the tolerances of ``tests/test_hf.py`` and
``tests/test_torch_mixtral.py``); the converted ``state_dict`` carried to
the JAX tree and back (``models.convert``) leaf for leaf; greedy
``Server`` streams token-exact to the JAX ``Server``'s, paged for every
family and unpaged for GPT-2; ``generate`` token-exact; the CLIs'
output equal to the JAX CLIs' (``--serve``, one-shot, ``--int8``,
``score``), each CLI case on one family; and the refusals made as the
reference makes them: ``gemma2``, a bias-free NeoX, a tied Phi and a
tensor no importer maps.
"""

import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from torch_parity import tokens
from tony_tpu.cli import generate as jax_cli
from tony_tpu.cli import score as jax_score
from tony_tpu.models import hf as jax_hf
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.cli import generate as torch_cli
from tony_tpu_torch.cli import score as torch_score
from tony_tpu_torch.models import generate
from tony_tpu_torch.models import hf
from tony_tpu_torch.models.convert import from_jax_params, to_jax_params
from tony_tpu_torch.serve import Request, Server

VOCAB = 96
EOS = (9, 33, 71)

# name -> (transformers config, model class, JAX importer, the port's
# converter)
SPECS = {
    "gpt2": (lambda: transformers.GPT2Config(
        vocab_size=VOCAB, n_embd=48, n_head=4, n_layer=2, n_positions=32,
        activation_function="gelu_new", eos_token_id=95, bos_token_id=95),
        transformers.GPT2LMHeadModel, jax_hf.from_hf_gpt2,
        hf.convert_gpt2_state_dict),
    "neox": (lambda: transformers.GPTNeoXConfig(
        vocab_size=VOCAB, hidden_size=64, num_attention_heads=4,
        num_hidden_layers=2, intermediate_size=128,
        max_position_embeddings=32, rotary_pct=0.25,
        use_parallel_residual=True, tie_word_embeddings=False,
        eos_token_id=95), transformers.GPTNeoXForCausalLM,
        jax_hf.from_hf_neox, hf.convert_neox_state_dict),
    "neox_seq": (lambda: transformers.GPTNeoXConfig(
        vocab_size=VOCAB, hidden_size=64, num_attention_heads=4,
        num_hidden_layers=2, intermediate_size=128,
        max_position_embeddings=32, rotary_pct=0.25,
        use_parallel_residual=False, tie_word_embeddings=False,
        eos_token_id=95), transformers.GPTNeoXForCausalLM,
        jax_hf.from_hf_neox, hf.convert_neox_state_dict),
    "phi": (lambda: transformers.PhiConfig(
        vocab_size=VOCAB, hidden_size=64, num_attention_heads=4,
        num_hidden_layers=2, intermediate_size=128,
        max_position_embeddings=32, partial_rotary_factor=0.4,
        hidden_act="gelu_new", eos_token_id=95),
        transformers.PhiForCausalLM, jax_hf.from_hf_phi,
        hf.convert_phi_state_dict),
    "gemma": (lambda: transformers.GemmaConfig(
        vocab_size=VOCAB, hidden_size=48, num_attention_heads=4,
        num_key_value_heads=1, head_dim=16, num_hidden_layers=2,
        intermediate_size=96, max_position_embeddings=32,
        hidden_act="gelu", hidden_activation="gelu_pytorch_tanh",
        eos_token_id=95, pad_token_id=0, bos_token_id=2),
        transformers.GemmaForCausalLM, jax_hf.from_hf_gemma,
        hf.convert_llama_state_dict),
}
FAMILIES = list(SPECS)


def _draw(name: str, p: torch.Tensor, rng, unit_offset: bool) -> np.ndarray:
    """Seeded weights: norm scales near 1 (near 0 for Gemma's offset
    form), small biases, larger embeddings, other matrices scaled by
    their fan-in (a Conv1D's is its first axis)."""
    leaf = name.rsplit(".", 1)[-1]
    norm = "ln" in name or "norm" in name
    if p.dim() == 1 and norm and leaf == "weight":
        base = 0.0 if unit_offset else 1.0
        return base + 0.1 * rng.standard_normal(p.shape)
    if leaf == "bias":
        return 0.1 * rng.standard_normal(p.shape)
    if any(k in name for k in ("wte", "wpe", "embed", "lm_head")):
        return 0.3 * rng.standard_normal(p.shape)
    fan_in = p.shape[0] if name.startswith("transformer.") else p.shape[-1]
    return rng.standard_normal(p.shape) / np.sqrt(fan_in)


def _hf_model(family: str):
    make, cls, _, _ = SPECS[family]
    config = make()
    config._attn_implementation = "eager"
    model = cls(config).eval()
    rng = np.random.default_rng(sum(map(ord, family)))
    seen = set()
    with torch.no_grad():
        for name, p in model.named_parameters():  # tied once
            if id(p) in seen:
                continue
            seen.add(id(p))
            x = _draw(name, p, rng, family == "gemma")
            p.copy_(torch.from_numpy(np.asarray(x, dtype=np.float32)))
    return model


def _save(model, path) -> str:
    os.makedirs(path, exist_ok=True)
    model.config.to_json_file(os.path.join(path, "config.json"))
    hf.write_safetensors({k: v.contiguous() for k, v in
                          model.state_dict().items()},
                         os.path.join(path, "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """Built on first use: {family: (HF model, JAX model, JAX params,
    checkpoint dir, the port's model read from it)}."""
    cache = {}

    def get(family):
        if family not in cache:
            model = _hf_model(family)
            ckpt = _save(model, tmp_path_factory.mktemp(family))
            jm, jp = SPECS[family][2](model)
            tm, _ = hf.load_hf_dir(ckpt, device="cpu")
            cache[family] = (model, jm, jp["params"], ckpt, tm)
        return cache[family]

    return get


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _config_matches(cfg, jcfg) -> None:
    """Every field the two configs share, but the dtype, is equal."""
    import dataclasses

    for f in dataclasses.fields(cfg):
        if f.name in ("dtype", "rope_scaling") \
                or not hasattr(jcfg, f.name):
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.rope_scaling is None) == (jcfg.rope_scaling is None)


@pytest.mark.parametrize("family", FAMILIES)
def test_reader_matches_jax_and_transformers(zoo, family):
    model, jm, jp, ckpt, tm = zoo(family)
    _config_matches(tm.cfg, jm.cfg)
    toks = tokens(5, (2, 13), VOCAB)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
        ref = model(torch.from_numpy(toks)).logits.numpy()
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=3e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_converter_carries_every_leaf_both_ways(zoo, family):
    """The port's converter over the in-memory state_dict gives what the
    reader gave; ``from_jax_params`` of the JAX importer's tree gives it
    too, and ``to_jax_params`` gives that tree back, leaf for leaf
    (learned positions, every projection's and norm's bias, the head's
    bias)."""
    model, _, jp, _, tm = zoo(family)
    sd = tm.state_dict()
    conv = SPECS[family][3](dict(model.state_dict()), tm.cfg)
    assert conv.keys() == sd.keys()
    for k, v in conv.items():
        assert torch.equal(v, sd[k]), k
    via_jax = from_jax_params(_np(jp), tm.cfg)
    assert via_jax.keys() == sd.keys()
    for k, v in via_jax.items():
        assert torch.equal(v, sd[k]), k
    back = _flat(to_jax_params(sd, tm.cfg)["params"])
    want = _flat(_np(jp))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    leaves = {"gpt2": "pos_embedding", "phi": "lm_head_bias"}
    if family in leaves:
        assert leaves[family] in want
    if tm.cfg.use_bias:
        assert "block_0/attn/o/bias" in want and "ln_f/bias" in want


def _clip_request(cfg):
    """A prompt and budget whose last position is ``max_seq_len - 1``:
    the learned positions' clip."""
    n = cfg.max_seq_len - 10
    return tokens(30, n, VOCAB).tolist(), 10


MIX = [(tokens(10, 12, VOCAB).tolist() + tokens(11, 3, VOCAB).tolist(), 10),
       (tokens(12, 7, VOCAB).tolist(), 6), (tokens(13, 5, VOCAB).tolist(), 14),
       (tokens(14, 9, VOCAB).tolist(), 8)]


def _serve(srv, cls, mix):
    for i, (p, n) in enumerate(mix):
        srv.submit(cls(list(p), n, id=i))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


SERVE = dict(batch_size=2, eos_id=EOS, chunk_steps=4, min_bucket=8)


@pytest.mark.parametrize("family,paged", [
    (f, True) for f in FAMILIES if f != "neox_seq"] + [("gpt2", False)],
    ids=lambda x: {True: "paged", False: "unpaged"}.get(x, x))
def test_server_matches_jax(zoo, family, paged):
    """Greedy streams, with a request whose positions reach
    ``max_seq_len - 1`` (GPT-2: the last learned position)."""
    _, jm, jp, _, tm = zoo(family)
    mix = MIX + [_clip_request(tm.cfg)]
    kw = dict(paged=True, kv_page_size=8) if paged else dict(paged=False)
    want = _serve(JaxServer(jm, jp, **SERVE, **kw), JaxRequest, mix)
    got = _serve(Server(tm, device="cpu", **SERVE, **kw), Request, mix)
    assert got == want
    assert len(got[len(mix) - 1][0]) == 10


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_matches_jax(zoo, family):
    _, jm, jp, _, tm = zoo(family)
    prompt = tokens(21, (3, 7), VOCAB)
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
SCORED = ["--token-ids", "5,6,7,8,9,10", "--token-ids", "1,2,3,4"]


@pytest.mark.parametrize("family,which", [
    ("gpt2", "serve"), ("gemma", "serve"), ("phi", "one-shot"),
    ("neox", "int8"), ("gemma", "score"), ("gpt2", "score-int8")])
def test_cli_matches_jax(zoo, family, which, monkeypatch, capsys):
    """The JAX CLI reads the directory through transformers, the port
    through its own reader; the outputs are equal."""
    ckpt = zoo(family)[3]
    stdin = ""
    mains = (jax_cli.main, torch_cli.main)
    if which == "serve":
        argv = ["--model", ckpt, "--serve", "--serve-batch", "2",
                "--eos-id", "17"]
        stdin = "\n".join(json.dumps(x) for x in LINES) + "\n"
    elif which in ("one-shot", "int8"):
        argv = ["--model", ckpt, *GROUPED, "--max-new-tokens", "6"] + (
            ["--int8"] if which == "int8" else [])
    else:
        mains = (jax_score.main, torch_score.main)
        argv = ["--model", ckpt, *SCORED] + (
            ["--int8"] if which == "score-int8" else [])
    extra = [] if mains[0] is jax_score.main else ["--compile-cache", ""]
    rc_j, out_j = _run(mains[0], argv + extra, stdin, monkeypatch, capsys)
    rc_t, out_t = _run(mains[1], argv + ["--device", "cpu"], stdin,
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0 and out_t
    if which == "serve":  # finish order depends on the JAX CLI's threads
        out_j, out_t = sorted(out_j), sorted(out_t)
    if mains[0] is jax_score.main:
        out_j, out_t = _ppl_apart(out_j, out_t)
    assert out_t == out_j


def _ppl_apart(out_j, out_t):
    """Score lines with their ``ppl=`` fields taken out, once those are
    held to what fp32 allows: the packages sum the per-token nlls in
    different orders, so the totals may differ by a few units in the
    last place (u = 2^-24 relative), and k of them move ``exp(total /
    n)`` by up to 2 k u (total / n) relative, past the eight significant
    digits the field prints; and two values either side of a rounding
    boundary print one step (0.01) apart. k = 4; ``nll/token`` stays in
    the lines, exact to its 4 places."""
    def split(lines):
        rest, ppl, nll = [], [], []
        for line in lines:
            fields = dict(f.split("=") for f in line.split()[1:])
            ppl.append(float(fields.pop("ppl")))
            nll.append(float(fields["nll/token"]))
            rest.append(line.rsplit(" ppl=", 1)[0])
        return rest, np.array(ppl), np.array(nll)

    (rj, pj, nj), (rt, pt, _) = split(out_j), split(out_t)
    assert np.all(np.abs(pt - pj) <= 8 * 2.0 ** -24 * nj * pj + 0.01), \
        (pt, pj)
    return rj, rt


def test_refusals_match_the_reference(zoo, tmp_path):
    """``gemma2``, a bias-free NeoX, a tied Phi and an unmapped tensor are
    refused with the reference's words."""
    def both(jax_fn, port_fn):
        with pytest.raises(ValueError) as je:
            jax_fn()
        with pytest.raises(ValueError) as te:
            port_fn()
        return str(je.value), str(te.value)

    neox = transformers.GPTNeoXConfig(attention_bias=False)
    j, t = both(lambda: jax_hf.neox_config(neox),
                lambda: hf.neox_config(neox.to_dict()))
    assert t == j
    phi = transformers.PhiConfig(tie_word_embeddings=True)
    j, t = both(lambda: jax_hf.phi_config(phi),
                lambda: hf.phi_config(phi.to_dict()))
    assert t == j
    gemma2 = transformers.Gemma2Config(
        vocab_size=VOCAB, hidden_size=48, num_attention_heads=4,
        num_key_value_heads=1, head_dim=16, num_hidden_layers=2,
        intermediate_size=96, max_position_embeddings=32)
    g2 = transformers.Gemma2ForCausalLM(gemma2)
    j, t = both(lambda: jax_hf.from_hf_gemma(g2),
                lambda: hf.gemma_config(gemma2.to_dict()))
    assert t.split(" got ")[1] == j.split(" got ")[1]
    # the CLIs: the same refusal of the model_type
    ckpt = _save(g2, tmp_path / "gemma2")
    with pytest.raises(SystemExit) as je:
        jax_cli.main(["--model", ckpt, "--token-ids", "1,2",
                      "--compile-cache", ""])
    with pytest.raises(SystemExit) as te:
        torch_cli.main(["--model", ckpt, "--token-ids", "1,2",
                        "--device", "cpu"])
    assert str(te.value) == str(je.value) and "gemma2" in str(je.value)
    # a tensor no importer maps: refused by the reference's importers
    # (NeoX, Phi, Gemma through Llama's) and by every one of the port's
    for family in ("neox", "phi", "gemma", "gpt2"):
        model, *_, tm = zoo(family)
        bad = dict(model.state_dict())
        name = next(k for k in bad if ".0." in k).split(".0.")[0] \
            + ".0.extra.weight"
        bad[name] = torch.zeros(2, 2)
        with pytest.raises(ValueError, match="does not map") as te:
            SPECS[family][3](bad, tm.cfg)
        if family == "gpt2":
            continue  # the reference's GPT-2 importer ignores it
        convert = {"neox": jax_hf.convert_neox_state_dict,
                   "phi": jax_hf.convert_phi_state_dict,
                   "gemma": jax_hf.convert_llama_state_dict}[family]
        with pytest.raises(ValueError, match="does not map") as je:
            convert(bad, SPECS[family][2](model)[0].cfg)
        assert str(te.value) == str(je.value)


def _published():
    """``chip_smoke.ZOO``: the four published configs phase 21 serves."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ZOO


JAX_CONFIGS = {"gpt2": jax_hf.gpt2_config, "gpt_neox": jax_hf.neox_config,
               "phi": jax_hf.phi_config, "gemma": jax_hf.gemma_config}


@pytest.mark.parametrize("i", range(4), ids=["gpt2_xl", "pythia_1_4b",
                                             "phi_2", "gemma_2b"])
def test_published_configs_names_and_pages_match(i):
    """At each published config the smoke serves (GPT-2 XL, Pythia-1.4B,
    Phi-2, Gemma-2B; built on the meta device): the port's config equals
    the JAX reader's, ``hf_shapes`` lists exactly the tensors (names and
    shapes) a transformers model of that config holds, and the page
    geometry (``default_page_size``, ``kv_page_nbytes``, bf16 and int8
    caches, at head dims 64, 128, 80 and 256 and one KV head) equals the
    JAX package's and the bytes a built page pool holds."""
    from tony_tpu.serve import slots as jax_slots
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import slots

    name, _, conf = _published()[i]
    kind = conf["model_type"]
    hf_config = transformers.AutoConfig.for_model(**conf)
    make, family = hf.FAMILIES[kind]
    cfg = make(conf)
    jcfg = JAX_CONFIGS[kind](hf_config)
    _config_matches(cfg, jcfg)
    with torch.device("meta"):
        model = transformers.AutoModelForCausalLM.from_config(hf_config)
    held = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    family.check_names({family.strip(k) for k in held}, cfg)
    want = hf.hf_shapes(kind, cfg)
    assert {k: v for k, v in held.items() if k in want} == want
    assert set(held) - set(want) <= {"lm_head.weight"}  # the tied head
    for quant in (False, True):
        c = cfg.__class__(**{**cfg.__dict__, "kv_cache_quant": quant,
                             "dtype": torch.bfloat16, "max_seq_len": 4096})
        jc = jcfg.__class__(**{**jcfg.__dict__, "kv_cache_quant": quant,
                               "dtype": jnp.bfloat16, "max_seq_len": 4096})
        ps = slots.default_page_size(c)
        assert ps == jax_slots.default_page_size(jc) == 64
        nbytes = slots.kv_page_nbytes(c, ps)
        assert nbytes == jax_slots.kv_page_nbytes(jc, ps)
        pool = slots.paged_cache(Transformer(c, device="meta"), 2, ps)
        assert nbytes == slots.page_nbytes(pool), name
