"""The port's CLIs against the JAX package's on one tiny random Qwen2
checkpoint saved by ``transformers``: the ``--serve`` JSONL loop (also
with ``--speculate-k`` and with ``--no-paged-kv``) and the one-shot
``--token-ids`` path (float and ``--int8``, greedy prompts of one length
batched, ``--num-beams``, ``--repetition-penalty``) print the same
token ids; over a tiny sliding-window Mistral checkpoint ``--serve``
turns the paged cache and the prefix store off with the same notes and
prints the same ids (``--serve`` responses
arrive in finish order, which depends on threading in the JAX CLI, so
lines are compared as a set), and ``score`` (full forward, ``--int8``,
``--kv-int8``) prints the same nll/token: to 1e-4 absolute, its printed
precision, the same fp32 math summed in another order. Weights are
drawn from a seeded numpy generator; the port reads the checkpoint with
its own safetensors reader."""

import io
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch
import transformers

from tony_tpu.cli import generate as jax_cli
from tony_tpu.cli import score as jax_score
from tony_tpu_torch.cli import gateway as torch_gateway_cli
from tony_tpu_torch.cli import generate as torch_cli
from tony_tpu_torch.cli import score as torch_score
from tony_tpu_torch.models.hf import read_safetensors, write_safetensors


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = transformers.Qwen2Config(
        vocab_size=96, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=1,
        max_position_embeddings=64, rope_theta=1e6, rms_norm_eps=1e-6,
        tie_word_embeddings=True, eos_token_id=95)
    model = transformers.Qwen2ForCausalLM(cfg)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                x = 1.0 + 0.1 * rng.standard_normal(p.shape)
            else:
                x = 0.3 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    d = tmp_path_factory.mktemp("qwen2_tiny")
    model.save_pretrained(d)
    return str(d)


LINES = [{"id": "a", "token_ids": [1, 2, 3], "max_new_tokens": 9},
         {"id": "b", "token_ids": [40, 41, 42, 43, 44, 45, 46],
          "max_new_tokens": 5},
         {"id": "c", "token_ids": [1, 2, 3, 4], "max_new_tokens": 12},
         {"id": "d", "token_ids": [7], "max_new_tokens": 1}]
FLAGS = ["--serve", "--serve-batch", "2", "--eos-id", "17",
         "--flash-decode"]


def _run(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


def test_serve_jsonl_matches_jax(ckpt, monkeypatch, capsys):
    stdin = "\n".join(json.dumps(x) for x in LINES) + "\n"
    rc_j, out_j = _run(jax_cli.main, ["--model", ckpt, *FLAGS,
                                      "--compile-cache", ""], stdin,
                       monkeypatch, capsys)
    rc_t, out_t = _run(torch_cli.main, ["--model", ckpt, *FLAGS,
                                        "--device", "cpu"], stdin,
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0
    assert len(out_t) == len(LINES)
    assert sorted(out_t) == sorted(out_j)


def test_serve_speculate_k_matches_jax(ckpt, monkeypatch, capsys):
    """``--serve --speculate-k 4``: the same lines as the JAX CLI with the
    flag, and as the port without it (greedy outputs unchanged)."""
    stdin = "\n".join(json.dumps(x) for x in LINES) + "\n"
    spec = [*FLAGS, "--speculate-k", "4"]
    rc_j, out_j = _run(jax_cli.main, ["--model", ckpt, *spec,
                                      "--compile-cache", ""], stdin,
                       monkeypatch, capsys)
    outs = []
    for flags in (spec, FLAGS):
        rc, out = _run(torch_cli.main, ["--model", ckpt, *flags,
                                        "--device", "cpu"], stdin,
                       monkeypatch, capsys)
        assert rc == 0 and len(out) == len(LINES)
        outs.append(sorted(out))
    assert rc_j == 0
    assert outs[0] == outs[1] == sorted(out_j)


def test_serve_replicas_match_jax(ckpt, monkeypatch, capsys):
    """``--serve --serve-replicas 2``: the gateway core over two
    replicas prints the JAX CLI's lines (with the flag), and the port's
    one-replica lines."""
    stdin = "\n".join(json.dumps(x) for x in LINES * 2) + "\n"
    two = [*FLAGS, "--serve-replicas", "2"]
    rc_j, out_j = _run(jax_cli.main, ["--model", ckpt, *two,
                                      "--compile-cache", ""], stdin,
                       monkeypatch, capsys)
    outs = []
    for flags in (two, FLAGS):
        rc, out = _run(torch_cli.main, ["--model", ckpt, *flags,
                                        "--device", "cpu"], stdin,
                       monkeypatch, capsys)
        assert rc == 0 and len(out) == 2 * len(LINES)
        outs.append(sorted(out))
    assert rc_j == 0
    assert outs[0] == outs[1] == sorted(out_j)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gateway_cli_boots_serves_and_drains():
    """``cli.gateway --demo-model --replicas 2 --port 0 --device cpu``
    boots, answers a ``token_ids`` request (unary and streamed alike),
    and exits 0 on SIGTERM after a drain."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.cli.gateway", "--demo-model",
         "--replicas", "2", "--port", "0", "--device", "cpu", "--eos-id",
         "63"], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "gateway at http://" in line, proc.stderr.read()
        url = line.split(" at ")[1].split()[0]
        got = []
        for stream in (False, True):
            body = json.dumps({"token_ids": [1, 2, 3], "max_new_tokens": 4,
                               "stream": stream}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/v1/generate", data=body), timeout=60) as r:
                last = json.loads(r.read().decode().splitlines()[-1])
            got.append((last["token_ids"], last["finish_reason"]))
        assert got[0] == got[1] and got[0][0][:3] == [1, 2, 3]
        with urllib.request.urlopen(url + "/readyz", timeout=10) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "drained clean" in err and "token_ids requests only" in err


@pytest.mark.parametrize("flags,queue", [(["--mesh", "4"], 5)],
                         ids=lambda v: v[0] if isinstance(v, list)
                         else str(v))
def test_gateway_cli_refuses_what_is_not_ported(flags, queue, capsys):
    rc = torch_gateway_cli.main(["--demo-model", "--device", "cpu", *flags])
    assert rc == 2
    assert f"{flags[0]} is not ported to PyTorch yet (ROADMAP.md queue " \
        f"{queue})" in capsys.readouterr().err


def test_one_shot_token_ids_match_jax(ckpt, monkeypatch, capsys):
    argv = ["--model", ckpt, "--token-ids", "5,6,7", "--token-ids", "9,1",
            "--max-new-tokens", "8"]
    rc_j, out_j = _run(jax_cli.main, argv + ["--compile-cache", ""], "",
                       monkeypatch, capsys)
    rc_t, out_t = _run(torch_cli.main, argv + ["--device", "cpu"], "",
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0
    assert out_t == out_j


def test_text_prompt_is_rejected_clearly(ckpt, monkeypatch, capsys):
    stdin = json.dumps({"id": "x", "prompt": "hello"}) + "\n" \
        + json.dumps(LINES[0]) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = torch_cli.main(["--model", ckpt, "--serve", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 1
    assert "tokenizer" in captured.err
    assert json.loads(captured.out.strip())["id"] == "a"


def test_safetensors_round_trip(ckpt, tmp_path):
    sd = read_safetensors(f"{ckpt}/model.safetensors")
    path = tmp_path / "copy.safetensors"
    write_safetensors({**sd, "scalar": torch.tensor(3.0)}, str(path))
    back = read_safetensors(str(path))
    assert back.keys() == {*sd, "scalar"}
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)


# three greedy prompts of one length decode as one batch in both CLIs
GROUPED = ["--token-ids", "5,6,7", "--token-ids", "9,1", "--token-ids",
           "1,2,3", "--token-ids", "8,8,8", "--token-ids", "4"]


@pytest.mark.parametrize("flags", [[], ["--int8"],
                                   ["--int8", "--dtype", "bf16"]])
def test_one_shot_grouped_prompts_match_jax(ckpt, flags, monkeypatch,
                                            capsys):
    argv = ["--model", ckpt, *GROUPED, "--max-new-tokens", "6", *flags]
    rc_j, out_j = _run(jax_cli.main, argv + ["--compile-cache", ""], "",
                       monkeypatch, capsys)
    rc_t, out_t = _run(torch_cli.main, argv + ["--device", "cpu"], "",
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0
    assert len(out_t) == 5
    assert out_t == out_j


def test_serve_refuses_int8(ckpt, monkeypatch, capsys):
    argv = ["--model", ckpt, "--serve", "--int8"]
    rc_j, _ = _run(jax_cli.main, argv + ["--compile-cache", ""], "",
                   monkeypatch, capsys)
    rc_t = torch_cli.main(argv + ["--device", "cpu"])
    assert rc_j == rc_t == 2
    assert "--int8" in capsys.readouterr().err


def _seeded(model):
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                x = 1.0 + 0.1 * rng.standard_normal(p.shape)
            else:
                x = 0.3 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def mistral_ckpt(tmp_path_factory):
    cfg = transformers.MistralConfig(
        vocab_size=96, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=1e4, rms_norm_eps=1e-5,
        sliding_window=8, tie_word_embeddings=False, eos_token_id=95)
    d = tmp_path_factory.mktemp("mistral_tiny")
    _seeded(transformers.MistralForCausalLM(cfg)).save_pretrained(d)
    return str(d)


def test_mistral_checkpoint_loads(mistral_ckpt):
    from tony_tpu_torch.models.hf import load_hf_dir

    model, hf = load_hf_dir(mistral_ckpt, device="cpu")
    cfg = model.cfg
    assert hf["model_type"] == "mistral"
    assert cfg.sliding_window == 8 and not cfg.tied_embeddings
    assert not cfg.qkv_bias and not cfg.use_bias
    assert cfg.kv_heads == 2 and cfg.n_heads == 6
    assert model.lm_head.shape == (96, 48)


WINDOW_LINES = [{"id": "a", "token_ids": list(range(1, 15)),
                 "max_new_tokens": 9},
                {"id": "b", "token_ids": [40, 41, 42], "max_new_tokens": 12},
                {"id": "c", "token_ids": [7] * 11, "max_new_tokens": 6}]


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_serve_sliding_window_matches_jax(mistral_ckpt, flash, monkeypatch,
                                          capsys):
    """A sliding-window checkpoint serves unpaged, with no prefix store,
    each turned off with the JAX CLI's note; the same responses."""
    stdin = "\n".join(json.dumps(x) for x in WINDOW_LINES) + "\n"
    flags = ["--serve", "--serve-batch", "2", "--eos-id", "17"] \
        + (["--flash-decode"] if flash else [])
    errs, outs = [], []
    for main, extra in ((jax_cli.main, ["--compile-cache", ""]),
                        (torch_cli.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        rc = main(["--model", mistral_ckpt, *flags, *extra])
        cap = capsys.readouterr()
        assert rc == 0
        outs.append(sorted(cap.out.strip().splitlines()))
        errs.append(cap.err)
    assert outs[1] == outs[0] and len(outs[1]) == len(WINDOW_LINES)
    for note in ("note: paged KV cache disabled (untested over "
                 "sliding-window attention)",
                 "note: prefix cache disabled (untested over "
                 "sliding-window attention)"):
        assert note in errs[0] and note in errs[1]


def test_serve_no_paged_kv_matches_jax(ckpt, monkeypatch, capsys):
    """``--serve --no-paged-kv``: the JAX CLI's lines with the flag, and
    the port's paged run's."""
    stdin = "\n".join(json.dumps(x) for x in LINES) + "\n"
    rows = [*FLAGS, "--no-paged-kv"]
    rc_j, out_j = _run(jax_cli.main, ["--model", ckpt, *rows,
                                      "--compile-cache", ""], stdin,
                       monkeypatch, capsys)
    outs = []
    for flags in (rows, FLAGS):
        rc, out = _run(torch_cli.main, ["--model", ckpt, *flags,
                                        "--device", "cpu"], stdin,
                       monkeypatch, capsys)
        assert rc == 0 and len(out) == len(LINES)
        outs.append(sorted(out))
    assert rc_j == 0
    assert outs[0] == outs[1] == sorted(out_j)


@pytest.mark.parametrize("flags", [
    ["--num-beams", "3"], ["--repetition-penalty", "1.3"],
    ["--repetition-penalty", "1.3", "--eos-id", "17"]],
    ids=["beams", "penalty", "penalty-eos"])
def test_one_shot_options_match_jax(ckpt, flags, monkeypatch, capsys):
    argv = ["--model", ckpt, *GROUPED, "--max-new-tokens", "10", *flags]
    rc_j, out_j = _run(jax_cli.main, argv + ["--compile-cache", ""], "",
                       monkeypatch, capsys)
    rc_t, out_t = _run(torch_cli.main, argv + ["--device", "cpu"], "",
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0
    assert len(out_t) == 5
    assert out_t == out_j


def test_beams_ignore_the_penalty_with_a_warning(ckpt, monkeypatch, capsys):
    argv = ["--model", ckpt, "--token-ids", "5,6,7", "--max-new-tokens", "6",
            "--num-beams", "2"]
    _, plain = _run(torch_cli.main, argv + ["--device", "cpu"], "",
                    monkeypatch, capsys)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    rc = torch_cli.main(argv + ["--repetition-penalty", "1.5", "--device",
                                "cpu"])
    cap = capsys.readouterr()
    assert rc == 0 and cap.out.strip().splitlines() == plain
    assert "--repetition-penalty is not applied under beam search" in cap.err


def _scores(lines):
    out = []
    for line in lines:
        fields = dict(f.split("=") for f in line.split() if "=" in f)
        out.append((line.split()[0] == "TOTAL", int(fields["tokens"]),
                    float(fields["nll/token"])))
    return out


@pytest.mark.parametrize("flags", [[], ["--int8"], ["--kv-int8"]])
def test_score_matches_jax(ckpt, flags, monkeypatch, capsys):
    argv = ["--model", ckpt, "--token-ids", "5,6,7,8,9,10,11",
            "--token-ids", ",".join(str(i % 96) for i in range(40)),
            "--token-ids", "3", *flags]
    rc_j, out_j = _run(jax_score.main, argv, "", monkeypatch, capsys)
    rc_t, out_t = _run(torch_score.main, argv + ["--device", "cpu"], "",
                       monkeypatch, capsys)
    assert rc_j == rc_t == 0
    got, want = _scores(out_t), _scores(out_j)
    assert len(got) == len(want) == 3  # two inputs and the total
    for (tg, ng, vg), (tw, nw, vw) in zip(got, want):
        assert (tg, ng) == (tw, nw)
        assert abs(vg - vw) <= 1e-4


def test_score_int8_costs_little_over_fp32(ckpt, monkeypatch, capsys):
    argv = ["--model", ckpt, "--token-ids",
            ",".join(str(i * 7 % 96) for i in range(60)), "--device", "cpu"]
    _, fp = _run(torch_score.main, argv, "", monkeypatch, capsys)
    _, q8 = _run(torch_score.main, argv + ["--int8"], "", monkeypatch,
                 capsys)
    nll_fp, nll_q8 = _scores(fp)[-1][2], _scores(q8)[-1][2]
    assert nll_q8 != nll_fp and abs(nll_q8 - nll_fp) <= 0.05 * nll_fp


def test_score_rejects_text_clearly(ckpt, capsys):
    rc = torch_score.main(["--model", ckpt, "--text", "hello", "--device",
                           "cpu"])
    assert rc == 2 and "tokenizer" in capsys.readouterr().err
