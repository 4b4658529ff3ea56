"""Framework-wide constants: env var names, canonical roles, file names.

The PyTorch port's copy of ``tony_tpu/constants.py``, with
``CUDA_VISIBLE_DEVICES`` as the counterpart of ``TPU_VISIBLE_DEVICES``.

Reference: tony-core Constants.java:13-196. Names are re-derived for TPU
(coordinator env is jax.distributed's, not TF_CONFIG/MASTER_ADDR), but the
*set* of contracts is the same: task identity env, coordinator address env,
distributed-mode env, test fault-injection env, staging file names.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Task identity env, injected by the coordinator into every agent-launched
# task (reference: ApplicationMaster.java:1168-1188 container env).
# ---------------------------------------------------------------------------
JOB_NAME = "TONY_JOB_NAME"  # role name, e.g. "worker" (ref: JOB_NAME)
TASK_INDEX = "TONY_TASK_INDEX"  # index within the role (ref: TASK_INDEX)
TASK_NUM = "TONY_TASK_NUM"  # instance count of this role (ref: TASK_NUM)
IS_CHIEF = "TONY_IS_CHIEF"  # "true"/"false" (ref: IS_CHIEF)
JOB_ID = "TONY_JOB_ID"  # application id (ref: JOB_ID)
SESSION_ID = "TONY_SESSION_ID"  # session epoch, bumped on retry (ref: SESSION_ID)
DISTRIBUTED_MODE = "TONY_DISTRIBUTED_MODE"  # GANG | FCFS
ATTEMPT_NUMBER = "TONY_ATTEMPT_NUMBER"  # coordinator retry attempt (ref: ATTEMPT_NUMBER)
CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"  # resume: checkpoint root (no ref analog, SURVEY 5.4)
RESUME_STEP = "TONY_RESUME_STEP"  # resume: newest step found at (re)launch
JOB_DIR = "TONY_JOB_DIR"  # per-job working dir (staging, logs, events)
COMPILE_CACHE_DIR = "TONY_COMPILE_CACHE_DIR"  # persistent XLA compile cache
# (job-dir scoped: retry attempts reuse each other's compiles)
AGENT_PID = "TONY_AGENT_PID"  # pid of the task agent (preemption-notice target)
PREPROCESSING_JOB = "PREPROCESSING_JOB"  # "true" inside the preprocess task
# (ref: Constants.PREPROCESSING_JOB :75)
MODEL_PARAMS = "MODEL_PARAMS"  # preprocess stdout "Model parameters: ..."
# remainder, exported to every training task (ref: TASK_PARAM_KEY :90)
NUM_AM_RETRIES = "TONY_NUM_COORD_RETRIES"  # retries left (ref: NUM_AM_RETRIES)
TASK_MEMORY = "TONY_TASK_MEMORY"  # role memory (launchers enforce: rlimit/--memory)
TASK_CHIPS = "TONY_TASK_CHIPS"  # chips requested (ssh launcher packs per host)
TASK_VCORES = "TONY_TASK_VCORES"  # role vcores (docker --cpus; advisory locally)
TPU_VISIBLE_DEVICES = "TPU_VISIBLE_DEVICES"  # libtpu device-subset contract
# the port's device-subset contract: the coordinator and the ssh launcher
# export a task's allocated GPU ids under this name
CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
# exported beside it as PCI_BUS_ID: the ids are nvidia-smi's indices, in
# PCI bus order, while CUDA numbers devices fastest first unless told so
CUDA_DEVICE_ORDER = "CUDA_DEVICE_ORDER"
PCI_BUS_ID = "PCI_BUS_ID"

# Coordinator (AM) control-plane address, for agents to register back
# (reference: AM_HOST/AM_PORT consumed in TaskExecutor.initConfigs :240-281).
COORDINATOR_HOST = "TONY_COORDINATOR_HOST"
COORDINATOR_PORT = "TONY_COORDINATOR_PORT"
METRICS_PORT = "TONY_METRICS_PORT"
JOB_TOKEN = "TONY_JOB_TOKEN"  # HMAC control-plane auth (ref: ClientToAM tokens)
TLS_FINGERPRINT = "TONY_TLS_FINGERPRINT"  # pin of the per-job cert (rpc/tls.py)

# ---------------------------------------------------------------------------
# Rendezvous env injected by runtimes (the TPU-native replacement for
# TF_CONFIG / RANK / DMLC_* / HOROVOD_* — see SURVEY.md section 2.5).
# ---------------------------------------------------------------------------
COORDINATOR_ADDRESS = "TONY_JAX_COORDINATOR"  # host:port for jax.distributed
PROCESS_ID = "TONY_PROCESS_ID"  # global process index
NUM_PROCESSES = "TONY_NUM_PROCESSES"
CLUSTER_SPEC = "CLUSTER_SPEC"  # JSON {role: ["host:port", ...]} (ref name kept:
# ray-on-tony discovery.py reads CLUSTER_SPEC verbatim)
TB_PORT = "TB_PORT"  # TensorBoard port reserved on chief / sidecar
TB_LOG_DIR = "TB_LOG_DIR"

# Framework-compat rendezvous env (emitted by the respective runtime adapters)
TF_CONFIG = "TF_CONFIG"
PT_RANK = "RANK"
PT_WORLD = "WORLD"
PT_INIT_METHOD = "INIT_METHOD"
MX_DMLC_ROLE = "DMLC_ROLE"
MX_DMLC_PS_ROOT_URI = "DMLC_PS_ROOT_URI"
MX_DMLC_PS_ROOT_PORT = "DMLC_PS_ROOT_PORT"
MX_DMLC_NUM_SERVER = "DMLC_NUM_SERVER"
MX_DMLC_NUM_WORKER = "DMLC_NUM_WORKER"
MX_DMLC_LOCAL = "DMLC_LOCAL"

# Horovod-compat env (emitted by the horovod runtime's worker adapter;
# reference: runtime/HorovodRuntime.java setHorovodRunEnv :312-350)
HOROVOD_CONTROLLER = "HOROVOD_CONTROLLER"
HOROVOD_CPU_OPERATIONS = "HOROVOD_CPU_OPERATIONS"
HOROVOD_GLOO_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_GLOO_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"

# ---------------------------------------------------------------------------
# Canonical role names (reference: Constants.java:111-118). Arbitrary role
# names are allowed via the config regex; these get special semantics.
# ---------------------------------------------------------------------------
CHIEF_JOB_NAME = "chief"
WORKER_JOB_NAME = "worker"
PS_JOB_NAME = "ps"
EVALUATOR_JOB_NAME = "evaluator"
TENSORBOARD_JOB_NAME = "tensorboard"
DRIVER_JOB_NAME = "driver"
NOTEBOOK_JOB_NAME = "notebook"

# ---------------------------------------------------------------------------
# Staging / history file names (reference: Constants.java TONY_FINAL_XML etc.)
# ---------------------------------------------------------------------------
TONY_FINAL_CONF = "tony-final.json"  # merged conf shipped to coord + agents
TONY_SRC_ZIP = "tony_src.zip"
TONY_VENV_ZIP = "venv.zip"
TONY_STAGING_PREFIX = ".tony"  # per-user staging dir (ref: ~/.tony/<uuid>)
HISTORY_INTERMEDIATE = "intermediate"
HISTORY_FINISHED = "finished"
JHIST_SUFFIX = ".jhist.jsonl"  # event-log container (jsonl in place of Avro)
INPROGRESS_SUFFIX = ".inprogress"
METADATA_FILE = "metadata.json"
LOG_SUFFIX = ".log"

# ---------------------------------------------------------------------------
# Exit codes (reference: TaskExecutor / ApplicationMaster conventions)
# ---------------------------------------------------------------------------
EXIT_SUCCESS = 0
EXIT_FAIL = 1
EXIT_INVALID_CONF = 2

# ---------------------------------------------------------------------------
# Fault-injection env for tests, honored by *production* code paths
# (reference: Constants.java:124-129, SURVEY.md section 4.2).
# ---------------------------------------------------------------------------
TEST_COORD_CRASH = "TEST_TONY_COORD_CRASH"  # ref: TEST_AM_CRASH
# which client-side (re)spawn of the coordinator this process is —
# the YARN attempt-number analog, used by crash injection to die once
COORD_CLIENT_ATTEMPT = "TONY_COORD_CLIENT_ATTEMPT"
TEST_COORD_THROW = "TEST_TONY_COORD_THROW"  # ref: TEST_AM_THROW_EXCEPTION_CRASH
TEST_TASK_NUM_HB_MISS = "TEST_TONY_NUM_HB_MISS"  # ref: TEST_TASK_EXECUTOR_NUM_HB_MISS
TEST_TASK_SKEW = "TEST_TONY_TASK_SKEW"  # "role#idx#ms" (ref: TEST_TASK_EXECUTOR_SKEW)
TEST_WORKER_TERMINATION = "TEST_TONY_WORKER_TERMINATION"  # kill chief mid-run
TEST_COMPLETION_DELAY = "TEST_TONY_COMPLETION_NOTIFICATION_DELAYED"

# Distributed modes (reference: TonyConfigurationKeys.DistributedMode)
GANG = "GANG"
FCFS = "FCFS"
