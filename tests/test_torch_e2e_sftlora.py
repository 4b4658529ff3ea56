"""The LoRA fine-tuning payload as a job through both packages' control
planes on the CPU: ``examples/sft-lora/finetune.py`` through the JAX
package's mini cluster and ``tony_tpu_torch/examples/sft_lora.py``
through the port's (``device="cpu"``), each on one worker at 40 steps of
the reference example's toy model and pairs. Both jobs must SUCCEED,
which is each payload's own self-check (a greedy decode of at least 3 of
the 4 completions from the materialized model), and the two payloads
must report the same adapter and base parameter counts."""

import os
import re

from tony_tpu import mini as jax_mini
from tony_tpu_torch import mini as port_mini
from torch_jobs import ROOT

PAYLOADS = {
    "jax": (jax_mini, {}, os.path.join(ROOT, "examples", "sft-lora",
                                       "finetune.py"),
            # one host device: the payload's CPU collectives need none
            {"tony.application.shell-env":
             "XLA_FLAGS=--xla_force_host_platform_device_count=1"}),
    "port": (port_mini, {"device": "cpu"},
             os.path.join(ROOT, "tony_tpu_torch", "examples", "sft_lora.py"),
             {}),
}
COUNTS = re.compile(r"LoRA adapters: (\d+) params \(base frozen: (\d+)\)")


def _run(pkg: str) -> dict:
    mini, kw, script, extra = PAYLOADS[pkg]
    task = "--steps 40 --global-batch 8" + (
        " --device cpu" if pkg == "port" else "")
    with mini.MiniTonyCluster(**kw) as cluster:
        conf = mini.script_conf(cluster, script, {"worker": 1},
                                **{"tony.application.task-params": task,
                                   **extra})
        client = cluster.make_client(conf)
        client.run()
        with open(os.path.join(client.job_dir, "logs",
                               "worker-0-user.log"), errors="replace") as f:
            log = f.read()
    return {"status": client.final_status["status"], "log": log}


def test_sft_lora_payload_succeeds_in_both_packages():
    got = {pkg: _run(pkg) for pkg in PAYLOADS}
    for pkg, r in got.items():
        assert r["status"] == "SUCCEEDED", (pkg, r["log"][-3000:])
        hits = re.search(r"learned (\d)/4 completions", r["log"])
        assert hits and int(hits.group(1)) >= 3, (pkg, r["log"][-2000:])
    counts = {pkg: COUNTS.search(r["log"]).groups() for pkg, r in got.items()}
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == str(2 * (1024 + 1024 + 8224 + 1536 + 1536))
