"""The port's launchers, GPU discovery and per-task device sets.

Every process the port's control plane spawns runs ``tony_tpu_torch``: the
local, docker and ssh agent argvs, the client's coordinator, and a live
job's process lineage. With a fake ``nvidia-smi`` showing one GPU, a task
asking for one chip gets ``CUDA_VISIBLE_DEVICES=0`` and a second such
task fails its allocation, as the JAX coordinator does with one TPU chip;
without a GPU the request stays advisory, as in the JAX package. The ssh
launcher runs through ``tests/scripts/fake_ssh.sh``."""

import ast
import json
import os
import re
import sys
import time
import uuid

import pytest

from tony_tpu import constants as JC
from tony_tpu import config as jax_config
from tony_tpu.coordinator import coordinator as jax_coord
from tony_tpu.session import RoleRequest as JaxRoleRequest
from tony_tpu.session import Task as JaxTask
from tony_tpu_torch import constants as C
from tony_tpu_torch import config as port_config
from tony_tpu_torch.client import client as port_client
from tony_tpu_torch.coordinator import coordinator as port_coord
from tony_tpu_torch.coordinator import launcher as L
from tony_tpu_torch.mini import MiniTonyCluster, script_conf
from tony_tpu_torch.session import RoleRequest, Task
from tony_tpu_torch.utils import gpu_info

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCRIPTS = os.path.join(HERE, "scripts")
TORCH_SCRIPTS = os.path.join(HERE, "torch_scripts")
FAKE_SSH = os.path.join(SCRIPTS, "fake_ssh.sh")
FAKE_SMI = os.path.join(TORCH_SCRIPTS, "fake_nvidia_smi.py")


def _wait_for(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


# -- what the port spawns ----------------------------------------------------


def test_agent_argvs_name_the_port():
    assert L.AGENT_ARGV[1:] == ["-m", "tony_tpu_torch.agent"]
    assert L.REMOTE_AGENT_CMD == "python3 -m tony_tpu_torch.agent"
    argv = L.build_docker_command(Task(role="worker", index=0), {},
                                  image="img")
    assert argv[-3:] == ["python3", "-m", "tony_tpu_torch.agent"]


def test_client_spawns_the_port_coordinator(tmp_path, monkeypatch):
    seen = []

    class Proc:
        pid = 1

    monkeypatch.setattr(port_client.subprocess, "Popen",
                        lambda argv, **kw: seen.append(argv) or Proc())
    client = port_client.TonyClient(port_config.TonyConf())
    client.job_dir, client.app_id = str(tmp_path), "application_x"
    client.start_coordinator()
    assert seen[0][1:3] == ["-m", "tony_tpu_torch.coordinator"]


def test_no_port_source_names_a_jax_process():
    """No string in the port runs a module of the JAX package: neither an
    argv element like ``"tony_tpu.agent"`` nor ``-m tony_tpu.x`` in a
    command."""
    pattern = re.compile(r"(^|-m )tony_tpu\.[a-z]")
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tony_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                bad += [(path, n.lineno, n.value[:60])
                        for n in ast.walk(ast.parse(open(path).read()))
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)
                        and pattern.search(n.value)]
    assert not bad


def test_job_lineage_runs_the_port(tmp_path):
    """A live job's payload reads its ancestors: the agent and the
    coordinator are the port's modules, and nothing runs the JAX
    package's."""
    out = tmp_path / "lineage.txt"
    with MiniTonyCluster(device="cpu") as cluster:
        conf = script_conf(cluster, os.path.join(
            TORCH_SCRIPTS, "record_lineage.py"), {"worker": 1})
        conf.set("tony.application.shell-env", f"LINEAGE_OUT={out}")
        client = cluster.submit(conf)
    assert client.final_status["status"] == "SUCCEEDED", client.final_status
    text = out.read_text()
    assert "-m tony_tpu_torch.agent" in text
    assert "-m tony_tpu_torch.coordinator" in text
    assert not re.search(r"-m tony_tpu\.", text), text


# -- GPU discovery and device sets -------------------------------------------


def _coord(pkg, tmp, conf):
    conf.set("tony.staging-dir", tmp)
    conf.set("tony.history.location", os.path.join(tmp, "hist"))
    return pkg.Coordinator(conf, "application_chips",
                           os.path.join(tmp, "job"))


def _fake_tpu_info(tmp, n: int) -> str:
    path = os.path.join(tmp, "tpu-info")
    with open(path, "w") as f:
        f.write("#!/bin/sh\necho '%s'\n" % json.dumps(
            {"accelerator_type": "test",
             "chips": [{"device_id": i} for i in range(n)]}))
    os.chmod(path, 0o755)
    return path


def _envs(pkg, cfg, role_request, task_cls, tmp, info_path, chips=1):
    conf = cfg.TonyConf()
    conf.set("tony.worker.instances", 2)
    conf.set("tony.worker.chips", chips)
    conf.set("tony.tpu.info-exec-path", info_path)
    coord = _coord(pkg, tmp, conf)
    out = []
    try:
        req = role_request.from_conf(conf, "worker")
        for i in range(2):
            try:
                out.append(coord._task_env(req, task_cls(role="worker",
                                                         index=i)))
            except RuntimeError as e:
                out.append(("RuntimeError", str(e)))
    finally:
        coord.rpc.stop()
        coord.metrics_rpc.stop()
    return out


def test_one_gpu_for_two_one_chip_tasks_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FAKE_GPUS", "1")
    port = _envs(port_coord, port_config, RoleRequest, Task,
                 str(tmp_path / "p"), FAKE_SMI)
    ref = _envs(jax_coord, jax_config, JaxRoleRequest, JaxTask,
                str(tmp_path / "j"), _fake_tpu_info(str(tmp_path), 1))
    assert port[0][C.CUDA_VISIBLE_DEVICES] == "0"
    assert port[0][C.CUDA_DEVICE_ORDER] == "PCI_BUS_ID"
    assert C.TPU_VISIBLE_DEVICES not in port[0]
    assert ref[0][JC.TPU_VISIBLE_DEVICES] == "0"
    assert port[1] == ref[1] and port[1][0] == "RuntimeError"


def test_no_gpu_keeps_requests_advisory_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FAKE_GPUS", "0")
    port = _envs(port_coord, port_config, RoleRequest, Task,
                 str(tmp_path / "p"), FAKE_SMI, chips=8)
    ref = _envs(jax_coord, jax_config, JaxRoleRequest, JaxTask,
                str(tmp_path / "j"), _fake_tpu_info(str(tmp_path), 0),
                chips=8)
    assert all(C.CUDA_VISIBLE_DEVICES not in e for e in port)
    assert all(C.CUDA_DEVICE_ORDER not in e for e in port)
    assert all(JC.TPU_VISIBLE_DEVICES not in e for e in ref)
    drop = {C.JOB_ID, "TONY_CONF_PATH", C.JOB_DIR, C.COMPILE_CACHE_DIR,
            C.COORDINATOR_PORT, C.METRICS_PORT}
    assert [{k: v for k, v in e.items() if k not in drop} for e in port] \
        == [{k: v for k, v in e.items() if k not in drop} for e in ref]


def test_gpu_discoverer_reads_nvidia_smi(monkeypatch):
    monkeypatch.setenv("FAKE_GPUS", "2")
    monkeypatch.setenv("FAKE_GPU_USED_MIB", "300")
    d = gpu_info.GpuDiscoverer(FAKE_SMI)
    info = d.get_device_information()
    assert info.source == "nvidia-smi" and info.chip_count == 2
    assert info.chips[1].to_dict() == {
        "device_id": 1, "name": "NVIDIA H100 80GB HBM3",
        "memory_total_bytes": 81559 * 2 ** 20}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert d.device_metrics() == {"memory": 300.0 * 2 ** 20}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert d.device_metrics() == {"memory": 600.0 * 2 ** 20}
    missing = gpu_info.GpuDiscoverer("/nonexistent/nvidia-smi")
    assert missing.get_device_information().chip_count == 0
    assert missing.device_metrics() == {}


def test_agent_samples_the_card_without_torch(tmp_path):
    """The agent's metrics sampler reads the card's memory through
    nvidia-smi: it never imports torch, so it opens no CUDA context."""
    import subprocess

    code = (
        "import sys\n"
        "from tony_tpu_torch.agent import executor\n"
        "from tony_tpu_torch.metrics import TaskMetricsMonitor\n"
        "from tony_tpu_torch.utils.gpu_info import GpuDiscoverer\n"
        f"d = GpuDiscoverer({FAKE_SMI!r})\n"
        "m = TaskMetricsMonitor(lambda: 1, lambda x: None,\n"
        "                       device_fn=d.device_metrics)\n"
        "print(m.sample_once().get('MAX_GPU_MEMORY'),\n"
        "      'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "FAKE_GPUS": "1",
                              "FAKE_GPU_USED_MIB": "7"}, check=True)
    assert out.stdout.split() == [str(7.0 * 2 ** 20), "False"]


# -- launch modes -------------------------------------------------------------


def test_local_launcher_applies_rlimit(tmp_path, monkeypatch):
    probe = tmp_path / "probe.py"
    out_file = tmp_path / "rlimit.txt"
    probe.write_text("import resource\n"
                     f"open({str(out_file)!r}, 'w').write("
                     "str(resource.getrlimit(resource.RLIMIT_AS)[0]))\n")
    monkeypatch.setattr(L, "AGENT_ARGV", [sys.executable, str(probe)])
    lch = L.LocalProcessLauncher(on_exit=lambda t, c: None)
    lch.launch(Task(role="worker", index=0), {C.TASK_MEMORY: "256m"},
               str(tmp_path / "w.log"))
    assert _wait_for(lambda: out_file.exists()
                     and out_file.read_text() != "")
    assert int(out_file.read_text()) == 256 * 1024 ** 2


def test_ssh_launcher_remote_kill(tmp_path, monkeypatch):
    # the pgid file lies under /tmp on the "remote" host, here this one:
    # an app id of the run's own keeps concurrent runs off each other's
    app_id = f"torchtest-{uuid.uuid4().hex[:8]}"
    monkeypatch.setattr(L, "REMOTE_AGENT_CMD", "sleep 300")
    lch = L.SshLauncher(["fakehost"], on_exit=lambda t, c: None,
                        ssh_bin=FAKE_SSH, app_id=app_id)
    task = Task(role="worker", index=0)
    pgid_file = L.remote_pgid_file(task, app_id)
    if os.path.exists(pgid_file):
        os.remove(pgid_file)
    lch.launch(task, {"TONY_TEST": "1"}, str(tmp_path / "w.log"))
    assert _wait_for(lambda: os.path.exists(pgid_file)
                     and open(pgid_file).read().strip())
    pid = int(open(pgid_file).read().strip())
    assert _alive(pid)
    assert lch.kill_task(task.id)
    assert _wait_for(lambda: not _alive(pid))
    assert not os.path.exists(pgid_file)


def test_ssh_launcher_packs_cuda_visible_devices(tmp_path, monkeypatch):
    """Two 1-chip tasks on one 2-GPU host: disjoint CUDA_VISIBLE_DEVICES;
    a third cannot fit."""
    monkeypatch.setattr(L, "REMOTE_AGENT_CMD", "sleep 60")
    app_id = f"torchpack-{uuid.uuid4().hex[:8]}"
    lch = L.SshLauncher(["h1"], on_exit=lambda t, c: None,
                        ssh_bin=FAKE_SSH, chips_per_host=2, app_id=app_id)
    pgid_files = [L.remote_pgid_file(Task(role="worker", index=i), app_id)
                  for i in range(2)]
    placed = []
    orig = lch._place

    def spy(task, env):
        host, env2 = orig(task, env)
        placed.append(env2.get(C.CUDA_VISIBLE_DEVICES))
        assert env2[C.CUDA_DEVICE_ORDER] == "PCI_BUS_ID"
        assert C.TPU_VISIBLE_DEVICES not in env2
        return host, env2

    monkeypatch.setattr(lch, "_place", spy)
    try:
        for i in range(2):
            lch.launch(Task(role="worker", index=i), {C.TASK_CHIPS: "1"},
                       str(tmp_path / f"w{i}.log"))
        assert placed == ["0", "1"]
        with pytest.raises(RuntimeError, match="chips"):
            lch.launch(Task(role="worker", index=2), {C.TASK_CHIPS: "1"},
                       str(tmp_path / "w2.log"))
        # stop only once both remote trees have recorded their pgid
        for f in pgid_files:
            assert _wait_for(lambda f=f: os.path.exists(f)
                             and open(f).read().strip())
    finally:
        lch.stop_all()
    assert not any(os.path.exists(f) for f in pgid_files)


def test_ssh_mode_job(tmp_path):
    """A 2-worker gang over fake ssh: the agents start through
    ``REMOTE_AGENT_CMD`` and the env contract holds."""
    with MiniTonyCluster(device="cpu") as cluster:
        conf = script_conf(cluster, os.path.join(SCRIPTS, "check_env.py"),
                           {"worker": 2})
        conf.set("tony.application.launch-mode", "ssh")
        conf.set("tony.application.hosts", "hostA,hostB")
        conf.set("tony.application.ssh-bin", FAKE_SSH)
        conf.set("tony.application.remote-pythonpath", ROOT)
        client = cluster.submit(conf)
    assert client.final_status["status"] == "SUCCEEDED", client.final_status


# -- provisioning --------------------------------------------------------------


@pytest.mark.parametrize("case", ["tpu-vm", "queued", "doomed", "denied"])
def test_provisioner_flow_matches_jax(case, tmp_path, monkeypatch):
    """The copied provisioner drives ``tests/scripts/fake_gcloud.py`` as
    the JAX one does: the same gcloud calls, hosts, states and errors."""
    from tony_tpu.coordinator import provisioner as jax_prov
    from tony_tpu_torch.coordinator import provisioner as port_prov

    if case == "doomed":
        monkeypatch.setenv("FAKE_GCLOUD_DOOM", "1")
    if case == "denied":
        monkeypatch.setenv("FAKE_GCLOUD_FAIL_CREATE", "1")
    out = []
    for pkg in (jax_prov, port_prov):
        d = tmp_path / pkg.__name__
        d.mkdir()
        monkeypatch.setenv("FAKE_GCLOUD_DIR", str(d))
        runner = pkg.GcloudRunner(os.path.join(SCRIPTS, "fake_gcloud.py"),
                                  project="proj", zone="zone-a")
        prov = pkg.TpuVmProvisioner("t1", "v5p-8", "tpu-ubuntu2204-base",
                                    runner, timeout_s=10,
                                    poll_interval_s=0.01,
                                    queued=case == "queued")
        try:
            got = (prov.provision(), prov.state)
            prov.deprovision()
        except pkg.ProvisioningError as e:
            got = ("ProvisioningError", str(e))
        out.append((got, (d / "calls.log").read_text()))
    assert out[0] == out[1]


def test_preflight_counts_gpus(tmp_path, monkeypatch):
    """Local preflight against ``nvidia-smi``'s count: 4 chips wanted on
    a 2-GPU host fail the submission as the JAX package's does on a
    2-chip one; on 4 GPUs, or with no demand, it passes."""
    from tony_tpu.coordinator import provisioner as jax_prov
    from tony_tpu_torch.coordinator import provisioner as port_prov

    def conf(cfg, info):
        c = cfg.TonyConf()
        c.set("tony.worker.instances", 2)
        c.set("tony.worker.chips", 2)
        c.set("tony.tpu.info-exec-path", info)
        return c

    monkeypatch.setenv("FAKE_GPUS", "2")
    port = port_prov.preflight_chips(conf(port_config, FAKE_SMI))
    ref = jax_prov.preflight_chips(conf(jax_config, _fake_tpu_info(
        str(tmp_path), 2)))
    assert port.replace("nvidia-smi", "info-command") == ref
    monkeypatch.setenv("FAKE_GPUS", "4")
    assert port_prov.preflight_chips(conf(port_config, FAKE_SMI)) is None
    free = port_config.TonyConf()
    free.set("tony.worker.instances", 8)
    assert port_prov.preflight_chips(free) is None
