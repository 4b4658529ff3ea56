"""Training as a job on the port (``tony_tpu_torch/examples/
lm_pretrain.py`` through ``python -m tony_tpu_torch.cli.local --device
cpu``) against the port's in-process ``fit`` on the same seed: a tiny
Qwen2-style model (2 layers, width 48) gives bit-equal losses, and a job
whose attempt 0 fails after the checkpoint at step 4 is retried, resumes
there, and ends with the uninterrupted run's parameters, bit for bit.
The resume helpers choose the same checkpoint step as the JAX package's
over the same step directories."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tony_tpu.train import checkpoint as jax_ckpt
from tony_tpu_torch.examples import lm_pretrain
from tony_tpu_torch.train import TrainState, checkpoint as port_ckpt, fit
from tony_tpu_torch.utils.fs import scan_latest_step
from torch_jobs import ROOT

TINY = {"model_type": "qwen2", "hidden_size": 48, "num_hidden_layers": 2,
        "num_attention_heads": 6, "num_key_value_heads": 1,
        "intermediate_size": 96, "vocab_size": 96, "hidden_act": "silu",
        "rope_theta": 1e6, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "max_position_embeddings": 64}
SIZE = ["--micro", "2", "--accum", "2", "--seq-len", "16",
        "--max-seq-len", "64", "--seed", "3", "--device", "cpu"]


def _job(tmp_path, task: list, *confs) -> subprocess.CompletedProcess:
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(TINY))
    argv = [sys.executable, "-m", "tony_tpu_torch.cli.local", "--device",
            "cpu", "--root", str(tmp_path / "cluster"), "--executes",
            os.path.join(ROOT, "tony_tpu_torch", "examples",
                         "lm_pretrain.py"),
            "--task_params", " ".join(["--config-json", str(cfg), *SIZE,
                                       *task]),
            "--conf", "tony.worker.instances=1"]
    for c in confs:
        argv += ["--conf", c]
    return subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "PYTHONPATH": ROOT})


def _in_process(steps: int):
    args = lm_pretrain.parse_args(["--config-json", "unused", *SIZE])
    cfg = lm_pretrain.train_config(TINY, args.max_seq_len,
                                   dtype=torch.bfloat16)
    _, trainer, loader = lm_pretrain.build(
        cfg, seed=args.seed, micro=args.micro, accum=args.accum,
        seq_len=args.seq_len, lr=args.lr, warmup=args.warmup,
        device="cpu")
    return fit(trainer, None, loader, total_steps=steps, log_every=1)


def test_job_losses_equal_in_process_fit(tmp_path):
    out = _job(tmp_path, ["--steps", "6", "--result",
                          str(tmp_path / "r.json")])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads((tmp_path / "r.json").read_text())
    want = [h["loss"] for h in _in_process(6).history if "loss" in h]
    assert res["losses"] == want  # bit-equal
    assert res["steps"] == list(range(1, 7)) and res["resumed_from"] is None
    assert res["cuda_visible_devices"] == "" and res["device"] == "cpu"
    assert np.all(np.isfinite(want)) and want[-1] < want[0]


def test_retried_job_resumes_to_the_uninterrupted_params(tmp_path):
    params = tmp_path / "params.pt"
    out = _job(tmp_path, ["--steps", "8", "--fail-after-checkpoint", "4",
                          "--result", str(tmp_path / "r{attempt}.json"),
                          "--save-params", str(params)],
               "tony.coordinator.retry-count=1",
               "tony.application.checkpoint-dir=ckpt")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    first, second = (json.loads((tmp_path / f"r{a}.json").read_text())
                     for a in (0, 1))
    assert first["attempt"] == 0 and first["steps"] == [1, 2, 3, 4]
    assert second["attempt"] == 1 and second["resumed_from"] == 4
    assert second["steps"] == [5, 6, 7, 8]
    assert second["checkpoint"]["restores"][0]["step"] == 4
    ref = _in_process(8)
    want = [h["loss"] for h in ref.history if "loss" in h]
    assert first["losses"] + second["losses"] == want
    got = torch.load(params, weights_only=True)
    assert got.keys() == ref.state.params.keys()
    for name, t in ref.state.params.items():
        assert torch.equal(got[name], t), name


def _step_dirs(d, complete=(1, 3, 7, 12), junk=True):
    os.makedirs(d, exist_ok=True)
    for s in complete:
        os.makedirs(os.path.join(d, f"{s:03d}" if s == 7 else str(s)))
        open(os.path.join(d, f"{s:03d}" if s == 7 else str(s),
                          "state.pt"), "w").close()
    if junk:
        # an in-flight save of each kind, a file, a non-numeric dir
        os.makedirs(os.path.join(d, "20"))
        open(os.path.join(d, "20", "x.orbax-checkpoint-tmp-1"), "w").close()
        os.makedirs(os.path.join(d, "15.tmp-99"))
        open(os.path.join(d, "30"), "w").close()
        os.makedirs(os.path.join(d, "abc"))


@pytest.mark.parametrize("layout", ["mixed", "empty", "missing", "only-junk"])
def test_scan_latest_step_matches_jax(tmp_path, layout):
    d = str(tmp_path / "ckpt")
    if layout == "mixed":
        _step_dirs(d)
    elif layout == "empty":
        os.makedirs(d)
    elif layout == "only-junk":
        _step_dirs(d, complete=())
    assert scan_latest_step(d) == jax_ckpt.scan_latest_step(d)
    assert port_ckpt.scan_latest_step is scan_latest_step


def test_restore_or_init_chooses_the_jax_step(tmp_path):
    """Both packages' managers save steps 2, 5 and 9 (keeping all);
    ``restore_or_init`` restores 9 through each, and inits fresh over an
    empty dir."""
    steps = (2, 5, 9)
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=5)
    pm = port_ckpt.CheckpointManager(str(tmp_path / "port"), max_to_keep=5)
    for s in steps:
        jm.save(s, {"step": np.full(1, s, np.int32),
                    "w": np.full(3, s, np.float32)})
        pm.save(s, TrainState(step=s, params={"w": torch.full((3,), s)},
                              opt_state=None))
    jm.wait()
    jm.close()
    template = {"step": np.zeros(1, np.int32), "w": np.zeros(3, np.float32)}
    js, jman, jres = jax_ckpt.restore_or_init(str(tmp_path / "jax"),
                                              lambda: template)
    ps, pman, pres = port_ckpt.restore_or_init(
        str(tmp_path / "port"), lambda: pytest.fail("init on a resume"))
    assert jres and pres and int(js["step"][0]) == ps.step == 9
    assert torch.equal(ps.params["w"], torch.full((3,), 9))
    assert jman.latest_step() == pman.latest_step() == 9
    jman.close()
    fresh = TrainState(step=0, params={}, opt_state=None)
    state, man, resumed = port_ckpt.restore_or_init(
        str(tmp_path / "empty"), lambda: fresh)
    assert state is fresh and not resumed and man.latest_step() is None


def test_auto_resume_reads_the_job_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("TONY_CHECKPOINT_DIR", raising=False)
    fresh = TrainState(step=0, params={}, opt_state=None)
    assert port_ckpt.auto_resume(lambda: fresh) == (fresh, None, False)
    pm = port_ckpt.CheckpointManager(str(tmp_path))
    pm.save(4, TrainState(step=4, params={"w": torch.ones(2)},
                          opt_state=None))
    monkeypatch.setenv("TONY_CHECKPOINT_DIR", str(tmp_path))
    state, man, resumed = port_ckpt.auto_resume(lambda: fresh)
    assert resumed and state.step == 4 and man.directory == str(tmp_path)
