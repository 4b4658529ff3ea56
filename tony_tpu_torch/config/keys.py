"""Config key schema: every global key, its default, type, and doc line.

The PyTorch port's copy of ``tony_tpu/config/keys.py``.

Reference: TonyConfigurationKeys.java:13-337 + tony-default.xml (60 keys),
drift-locked by TestTonyConfigurationFields (SURVEY.md section 4.3). Here the
schema *is* the default source (no separate XML to drift), and
tests/test_config.py locks KEYS <-> DEFAULTS bijection plus doc coverage.

Per-role keys are regex-driven (reference: TonyConfigurationKeys.java:189-257):
``tony.<role>.instances|chips|memory|command|resources|depends-on|...`` —
see ROLE_KEY_RE / role_key() in config.py. Any role name is legal.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class Key(NamedTuple):
    default: Any
    type: type
    doc: str


# ---------------------------------------------------------------------------
# Global (non-role) keys. Names keep the reference's tony.* namespace with
# TPU-flavored semantics (chips instead of gpus, coordinator instead of am).
# ---------------------------------------------------------------------------
KEYS: dict[str, Key] = {
    # application
    "tony.application.name": Key("tony-tpu", str, "Display name of the job"),
    "tony.application.framework": Key(
        "jax", str, "Runtime adapter: jax|tensorflow|pytorch|mxnet|horovod|standalone|ray"
    ),
    "tony.application.distributed-mode": Key(
        "GANG", str, "GANG (all tasks rendezvous before start) or FCFS"
    ),
    "tony.application.security.tls": Key(
        False, bool, "TLS on the control-plane RPC: the client mints a "
        "per-job self-signed cert into the job dir; agents/client pin its "
        "SHA-256 fingerprint (ref: ClientToAM SASL transport, "
        "ApplicationMaster.java:484-504)"
    ),
    "tony.application.security.enabled": Key(
        True, bool, "HMAC-authenticate control-plane RPC with a per-job token"
    ),
    "tony.application.timeout-ms": Key(
        0, int, "Whole-job timeout in ms; 0 = unlimited (ref: tony.application.timeout)"
    ),
    "tony.application.node-label": Key(
        "", str, "Placement label for all roles unless overridden per-role"
    ),
    "tony.application.prepare-stage": Key(
        "", str, "Comma list of roles scheduled in the prepare stage (ref: Utils.java:377-403)"
    ),
    "tony.application.training-stage": Key(
        "", str, "Comma list of roles gated on prepare-stage completion"
    ),
    "tony.application.untracked.jobtypes": Key(
        "ps", str, "Comma list of roles whose exit does not gate job completion"
    ),
    "tony.application.sidecar.jobtypes": Key(
        "tensorboard", str, "Untracked helper roles whose failure is tolerated"
    ),
    "tony.application.tensorboard-log-dir": Key(
        "", str,
        "Log dir served by the built-in sidecar TensorBoard launcher "
        "(ref: setSidecarTBResources TonyClient.java:571-600)"
    ),
    "tony.application.checkpoint-dir": Key(
        "", str,
        "Checkpoint directory for restart-with-resume (no reference analog: "
        "TonY has no in-tree checkpointing, SURVEY.md 5.4). When set, tasks "
        "get TONY_CHECKPOINT_DIR (relative paths resolve under the job dir) "
        "and, on coordinator retry, TONY_RESUME_STEP with the newest step "
        "found there so training resumes instead of restarting from scratch"
    ),
    "tony.application.stop-on-failure.jobtypes": Key(
        "", str, "Roles whose single-task failure fails the whole job immediately"
    ),
    "tony.application.fail-on-worker-failure-enabled": Key(
        False, bool, "If true any tracked task failure fails the job"
    ),
    "tony.application.enable-preprocess": Key(
        False, bool, "Run the chief command inside the coordinator first (ref: doPreprocessingJob)"
    ),
    "tony.application.single-node-mode": Key(
        False, bool, "0-instance mode: the coordinator itself hosts the user process"
    ),
    "tony.application.launch-mode": Key(
        "local", str, "Agent placement: local (subprocesses), ssh (remote "
        "TPU-VM hosts), or docker (containers on this host)"
    ),
    # docker containers (ref: tony.docker.enabled + DOCKER_* env,
    # HadoopCompatibleAdapter.getContainerEnvForDocker)
    "tony.docker.enabled": Key(
        False, bool, "Run each agent inside a docker container (ref: tony.docker.enabled)"
    ),
    "tony.docker.image": Key(
        "", str, "Container image for docker launch mode (ref: tony.docker.containers.image)"
    ),
    "tony.docker.mounts": Key(
        "", str, "Comma list of host:container[:ro] bind mounts for docker tasks"
    ),
    "tony.docker.run-args": Key(
        "", str, "Extra args spliced into docker run (e.g. --shm-size=4g)"
    ),
    "tony.docker.bin": Key(
        "docker", str, "Container CLI binary (docker/podman; test shims)"
    ),
    "tony.application.hosts": Key(
        "", str, "Comma list of TPU-VM hosts for launch-mode=ssh, round-robin per task"
    ),
    "tony.application.remote-pythonpath": Key(
        "", str, "PYTHONPATH exported on ssh-launched hosts (repo/install location)"
    ),
    "tony.application.ssh-bin": Key(
        "ssh", str, "ssh binary for launch-mode=ssh (tests point this at a "
        "local fake that runs the command in-place)"
    ),
    "tony.ssh.ship-job-dir": Key(
        True, bool, "launch-mode=ssh: tar-pipe the staged job dir (src, "
        "venv, conf, resources) to each host before its first task; hosts "
        "that already see the dir (shared mount) are probed and skipped "
        "(ref: HDFS upload + per-container extract, TonyClient.java:229-310)"
    ),
    "tony.ssh.remote-job-root": Key(
        "", str, "launch-mode=ssh: directory on the remote hosts to place "
        "the shipped job dir under (job-dir paths in the task env are "
        "rewritten); empty = mirror the coordinator's absolute job-dir path"
    ),
    # coordinator (reference: tony.am.*)
    "tony.coordinator.memory": Key("2g", str, "Coordinator process memory hint"),
    "tony.coordinator.command": Key(
        "", str, "Preprocess command run on the coordinator before training "
        "roles launch (with tony.application.enable-preprocess); its stdout "
        "'Model parameters: ...' line is exported to tasks as MODEL_PARAMS "
        "(ref: tony.am.command + doPreprocessingJob stdout scrape)"
    ),
    "tony.coordinator.retry-count": Key(
        0, int, "Times the coordinator rebuilds the session after "
                "failure (ref: tony.am.retry-count)"
    ),
    "tony.coordinator.monitor-interval-ms": Key(
        1000, int, "Coordinator monitor loop cadence (ref AM 5s; faster since no YARN)"
    ),
    "tony.coordinator.registration-timeout-ms": Key(
        900_000, int, "Task allocated but never registered => fail (ref: 15 min)"
    ),
    "tony.coordinator.host": Key("127.0.0.1", str, "Bind host for control-plane RPC"),
    # task / agent
    "tony.task.heartbeat-interval-ms": Key(
        1000, int, "Agent->coordinator heartbeat cadence (ref: same default)"
    ),
    "tony.task.max-missed-heartbeats": Key(
        25, int, "Liveness expiry = interval * max(3, this) (ref: same)"
    ),
    "tony.task.metrics-interval-ms": Key(
        5000, int, "Resource-metrics sampling cadence (ref: same)"
    ),
    "tony.task.executor.execution-timeout-ms": Key(
        0, int, "Per-task user-process timeout; 0 = unlimited (ref: same)"
    ),
    "tony.task.reuse-port": Key(
        False, bool, "Reserve rendezvous ports with SO_REUSEPORT "
                     "across exec (ref: TF_GRPC_REUSE_PORT)"
    ),
    "tony.elastic.grace-ms": Key(
        15_000, int, "Grace period for tasks to checkpoint-and-exit on an "
        "elastic resize before the gang restart proceeds"
    ),
    "tony.task.preemption-grace-ms": Key(
        15_000, int, "On SIGTERM (TPU spot preemption / maintenance event — "
        "the heartbeat-expiry analog, SURVEY.md 7.9b), the agent forwards "
        "SIGTERM to the user process and waits this long for a "
        "checkpoint-and-exit before SIGKILL; the coordinator records the "
        "task as preempted so a retry (with checkpoint-dir set) resumes"
    ),
    "tony.task.profiler-port": Key(
        0, int, "Base port for per-task jax profiler servers (0 = off); "
        "task flat-index is added so shared hosts don't collide"
    ),
    # task command construction (ref: TonyClient.buildTaskCommand :618-635)
    "tony.application.executes": Key(
        "", str, "User training entrypoint (script or shell command) run by every task"
    ),
    "tony.application.task-params": Key(
        "", str, "Extra CLI args appended to the task entrypoint"
    ),
    # python environment shipped with the job
    "tony.application.python-venv": Key("", str, "Path to a venv zip shipped to tasks"),
    "tony.application.shell-env": Key(
        "", str, "Comma list of K=V pairs exported into every task's env (ref: --shell_env)"
    ),
    "tony.application.tags": Key(
        "", str, "Workflow tags (exec id, flow, project) attached by scheduler integrations"
    ),
    "tony.application.python-command": Key(
        "", str, "Python interpreter override used to build task commands"
    ),
    "tony.application.src-dir": Key(
        "", str, "User source dir zipped + shipped to every task (ref: src_dir)"
    ),
    # staging / history
    "tony.staging-dir": Key(
        "", str, "Shared staging root; default ~/.tony (ref: HDFS ~/.tony/<uuid>)"
    ),
    "tony.history.location": Key(
        "", str, "History root holding intermediate/ and finished/ (ref: tony.history.location)"
    ),
    "tony.history.retention-sec": Key(
        2_592_000, int, "Purge finished history older than this (ref: 30 days)"
    ),
    "tony.history.mover-interval-ms": Key(
        300_000, int, "History mover/purger cadence (ref: portal 5 min)"
    ),
    "tony.keytab.user": Key("", str, "Principal for secure deployments (slot only)"),
    # portal
    "tony.portal.port": Key(19885, int, "History portal HTTP port"),
    # client
    "tony.client.poll-interval-ms": Key(
        1000, int, "Client job-status poll cadence (ref: TonyClient 1s)"
    ),
    "tony.client.coordinator-max-attempts": Key(
        1, int, "Times the client will (re)spawn the coordinator process; "
        ">1 restarts a crashed coordinator, the YARN AM-attempt analog "
        "(checkpoint-dir jobs resume from the last checkpoint)"
    ),
    # limits (reference: tony.application.max-total-instances etc.)
    "tony.application.max-total-instances": Key(
        -1, int, "Cap on total task instances; -1 = unlimited"
    ),
    "tony.application.max-total-chips": Key(
        -1, int, "Cap on total TPU chips requested; -1 = unlimited"
    ),
    # provisioner — the RM capacity-acquisition analog (ref:
    # TonyClient.submitApplication :314-349 + setupContainerRequestForRM,
    # util/Utils.java:420-430; allocation timeout TonyConfigurationKeys
    # .java:261-262)
    "tony.provisioner.mode": Key(
        "none", str, "none (hosts pre-exist / local devices), tpu-vm "
        "(gcloud compute tpus tpu-vm create), or queued (queued-resources "
        "capacity queue — the tony.yarn.queue analog)"
    ),
    "tony.provisioner.name": Key(
        "", str, "TPU resource name; default tony-<app_id>"
    ),
    "tony.provisioner.zone": Key("", str, "GCE zone for the slice"),
    "tony.provisioner.project": Key("", str, "GCP project (empty = gcloud default)"),
    "tony.provisioner.accelerator-type": Key(
        "", str, "Slice accelerator type (v5p-32, v6e-16, ...); falls back "
        "to tony.tpu.topology"
    ),
    "tony.provisioner.runtime-version": Key(
        "tpu-ubuntu2204-base", str, "TPU-VM runtime/software version"
    ),
    "tony.provisioner.gcloud-bin": Key(
        "gcloud", str, "gcloud binary path (tests point this at a fake)"
    ),
    "tony.provisioner.timeout-ms": Key(
        900_000, int, "Slice-allocation timeout (ref: 15-min container-"
        "allocation timeout, TonyConfigurationKeys.java:261-262)"
    ),
    "tony.provisioner.poll-interval-ms": Key(
        10_000, int, "Describe-poll cadence while waiting for READY"
    ),
    "tony.provisioner.keep": Key(
        False, bool, "Leave the slice up at job end (reuse across jobs)"
    ),
    "tony.provisioner.reuse": Key(
        True, bool, "Adopt an existing same-name slice instead of failing"
    ),
    "tony.provisioner.spot": Key(
        False, bool, "Request spot/preemptible capacity"
    ),
    "tony.provisioner.network": Key("", str, "VPC network for the slice"),
    "tony.provisioner.labels": Key(
        "", str, "Comma k=v labels attached to the slice"
    ),
    # TPU topology (new territory: replaces YARN gpus/vcores resource model)
    "tony.tpu.topology": Key(
        "", str, "Requested TPU slice topology, e.g. v5p-32; empty = local devices"
    ),
    "tony.tpu.chips-per-host": Key(
        0, int, "TPU chips per agent host; > 0 turns on capacity-aware "
        "packing + per-task TPU_VISIBLE_DEVICES subsets in the ssh "
        "launcher (0 = unknown: plain round-robin placement)"
    ),
    "tony.tpu.info-exec-path": Key(
        "", str, "Path to a tpu-info-style command emitting chip metrics JSON "
        "(ref: tony.gpu-exec-path for nvidia-smi)"
    ),
    "tony.tpu.num-slices": Key(
        1, int, "Multislice job shape: >1 groups the gang into N equal "
        "DCN-connected slices — the jax runtime injects MEGASCALE_* + "
        "per-slice TPU_WORKER_HOSTNAMES env, and the queued provisioner "
        "creates an N-node queued resource (--node-count)"
    ),
    "tony.tpu.megascale-port": Key(
        8080, int, "Port of the megascale DCN coordinator (slice 0, host 0) "
        "baked into MEGASCALE_COORDINATOR_ADDRESS"
    ),
    # test fault injection via conf (reference: tony.horovod.mode.test etc.)
    "tony.test.crash-coordinator": Key(
        False, bool, "Crash the coordinator once after start (ref: TEST_AM_CRASH conf twin)"
    ),
    # horovod-compat runtime (reference: TonyConfigurationKeys.java:313-316)
    "tony.horovod.test-mode": Key(
        False, bool,
        "Rendezvous driver emits a fake 2-slot plan on a fake port "
        "(ref: tony.horovod.mode.test)"
    ),
    "tony.horovod.test-fast-fail": Key(
        False, bool,
        "Rendezvous driver exits 1 immediately (ref: tony.horovod.mode.test.fast.fail)"
    ),
    "tony.horovod.driver-injected": Key(
        False, bool,
        "Internal marker: the hidden driver role was already injected "
        "(keeps validateAndUpdateConfig idempotent across client+coordinator)"
    ),
    "tony.horovod.driver.debug-command": Key(
        "", str,
        "User-supplied command replacing the built-in rendezvous driver "
        "(ref: HorovodDriver debug mode :189-216)"
    ),
    "tony.horovod.elastic": Key(
        False, bool,
        "Elastic rendezvous: the driver polls the discovery command and "
        "republishes the slot plan (new generation) on membership change "
        "(ref: horovod_driver.py elastic_driver_fn stub :28-29 — real here)"
    ),
    "tony.horovod.discovery-command": Key(
        "", str,
        "Elastic host-discovery command printing host[:slots] lines "
        "(horovod's discovery-script contract); required with "
        "tony.horovod.elastic"
    ),
}

# Per-role key suffixes (reference: TonyConfigurationKeys.java:189-257)
ROLE_SUFFIXES: dict[str, Key] = {
    "instances": Key(0, int, "Number of task instances for the role"),
    "max-instances": Key(-1, int, "Upper bound on instances; -1 = unlimited"),
    "chips": Key(0, int, "TPU chips per instance (ref: tony.<role>.gpus)"),
    "memory": Key("2g", str, "Memory per instance (ref: tony.<role>.memory)"),
    "vcores": Key(1, int, "CPU cores per instance"),
    "command": Key("", str, "Role-specific command overriding the global task command"),
    "resources": Key("", str, "Comma list of path[::localName][#archive] to localize"),
    "node-label": Key("", str, "Placement label for this role"),
    "depends-on": Key("", str, "Comma list of roles that must complete first (DAG)"),
}

MULTI_VALUE_KEYS = frozenset({"tony.application.untracked.jobtypes"})
"""Keys where repeated --conf occurrences append rather than replace
(reference: TonyConfigurationKeys.MULTI_VALUE_CONF / TonyClient.java:672-684)."""


def defaults() -> dict[str, Any]:
    """Flat {key: default} map for all global keys."""
    return {k: v.default for k, v in KEYS.items()}
