"""TPU slice provisioning — the resource-acquisition half of the RM role.

The PyTorch port's copy of ``tony_tpu/coordinator/provisioner.py``.

Reference: the TonY client ASKS a resource manager for capacity —
``TonyClient.submitApplication`` (TonyClient.java:314-349) submits the AM
container request to YARN, and every role's task becomes a container
request carrying its GPU count and node label (TaskScheduler.java:93-105,
util/Utils.java:420-430 ``setupContainerRequestForRM``); YARN then grants
containers incrementally, within a 15-minute allocation timeout
(TonyConfigurationKeys.java:261-262).

On TPU there is no incremental container negotiation: capacity arrives as
a SLICE whose hosts are created together. The Provisioner is therefore the
whole-slice analog of that RM conversation:

- ``StaticProvisioner``: hosts pre-exist (``tony.application.hosts`` /
  local devices) — no acquisition, the pre-round-2 behavior and still the
  default (``tony.provisioner.mode = none``).
- ``TpuVmProvisioner``: drives ``gcloud compute tpus tpu-vm
  create/describe/delete`` (mode ``tpu-vm``) or the queued-resources API
  (mode ``queued``) through a mockable subprocess layer; waits for READY
  within ``tony.provisioner.timeout-ms`` (the container-allocation-timeout
  analog), derives the host list from the node's ``networkEndpoints``, and
  deletes the slice when the job stops (unless ``tony.provisioner.keep``).

Sizing comes from the session's aggregate chip demand
(sum over roles of instances x tony.<role>.chips — the GPU-count analog)
checked against the accelerator type's chip count; ``preflight_chips``
applies the same demand to LOCAL launches by comparing against discovered
GPUs (utils/gpu_info.py), failing at submit rather than mid-gang.
"""

from __future__ import annotations

import json
import logging
import re
import subprocess
import time

from tony_tpu_torch.config import ConfError, TonyConf

log = logging.getLogger(__name__)

# provisioning states surfaced in the client's status line
STATE_NONE = "NONE"
STATE_CREATING = "CREATING"
STATE_WAITING = "WAITING"
STATE_READY = "READY"
STATE_DELETING = "DELETING"
STATE_FAILED = "FAILED"

_READY_NODE_STATES = frozenset({"READY"})
_DOOMED_NODE_STATES = frozenset({"PREEMPTED", "TERMINATED", "FAILED"})
_DOOMED_QR_STATES = frozenset({"FAILED", "SUSPENDED", "SUSPENDING"})


class ProvisioningError(RuntimeError):
    """Slice acquisition failed (create error, timeout, doomed state)."""


def required_chips(conf: TonyConf) -> int:
    """Aggregate chip demand: sum over roles of instances x chips
    (ref: per-container GPU counts, util/Utils.java:420-430)."""
    total = 0
    for role in conf.roles():
        inst = _conf_int(conf, f"tony.{role}.instances", 0)
        chips = _conf_int(conf, f"tony.{role}.chips", 0)
        if inst > 0 and chips > 0:
            total += inst * chips
    return total


def chips_in_accelerator_type(accel: str) -> int:
    """Chip count encoded in an accelerator type string.

    TPU naming: ``v5p-32`` counts TensorCores for v2-v5p (2 cores/chip:
    v5p-32 = 16 chips) and chips for v5e/v6e+ (``v5litepod-16``/``v6e-16``
    = 16 chips). Unknown shapes return 0 (caller skips the check)."""
    m = re.fullmatch(r"(v\d+[a-z]*(?:pod)?)-(\d+)", accel.strip())
    if not m:
        return 0
    gen, n = m.group(1), int(m.group(2))
    cores_per_chip = 1 if gen in ("v5litepod", "v5e", "v6e", "v7e") else 2
    return max(n // cores_per_chip, 1)


class Provisioner:
    """Base: acquire capacity before the gang, release it after."""

    state = STATE_NONE

    def provision(self) -> list[str]:
        """Acquire (or adopt) the slice; returns its host list. Raises
        ProvisioningError on failure/timeout."""
        raise NotImplementedError

    def deprovision(self) -> None:
        raise NotImplementedError


class StaticProvisioner(Provisioner):
    """Hosts pre-exist; provisioning is a no-op (the default)."""

    def __init__(self, hosts: list[str] | None = None):
        self.hosts = hosts or []
        self.state = STATE_READY

    def provision(self) -> list[str]:
        return self.hosts

    def deprovision(self) -> None:
        pass


class GcloudRunner:
    """One exec point for gcloud so tests swap in a fake binary
    (ref pattern: GpuDiscoverer's configurable nvidia-smi path)."""

    def __init__(self, gcloud_bin: str, project: str, zone: str,
                 timeout_s: float = 120.0):
        self.gcloud_bin = gcloud_bin
        self.project = project
        self.zone = zone
        self.timeout_s = timeout_s

    def run(self, *args: str, parse_json: bool = False):
        argv = [self.gcloud_bin, *args]
        if self.zone:
            argv += ["--zone", self.zone]
        if self.project:
            argv += ["--project", self.project]
        if parse_json:
            argv += ["--format", "json"]
        try:
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=self.timeout_s)
        except (OSError, subprocess.SubprocessError) as e:
            # missing/typo'd binary or a hung gcloud must FAIL the job,
            # not crash the coordinator past _stop()
            raise ProvisioningError(f"gcloud invocation failed: {e}") from e
        if proc.returncode != 0:
            raise ProvisioningError(
                f"{' '.join(argv[:5])}... exited {proc.returncode}: "
                f"{(proc.stderr or proc.stdout).strip()[-500:]}")
        if parse_json:
            try:
                return json.loads(proc.stdout or "{}")
            except json.JSONDecodeError as e:
                raise ProvisioningError(
                    f"unparseable gcloud JSON from {argv[1:4]}: {e}") from e
        return proc.stdout


class TpuVmProvisioner(Provisioner):
    """Create/await/teardown a TPU-VM slice via gcloud.

    ``queued=True`` goes through queued-resources (the capacity queue —
    the YARN queue analog of ``tony.yarn.queue``); otherwise a direct
    ``tpu-vm create``. Either way the node must reach READY within
    ``timeout_s`` and its networkEndpoints become the launcher's hosts.
    """

    def __init__(self, name: str, accelerator_type: str,
                 runtime_version: str, runner: GcloudRunner, *,
                 queued: bool = False, spot: bool = False,
                 reuse: bool = True, keep: bool = False,
                 timeout_s: float = 900.0, poll_interval_s: float = 10.0,
                 network: str = "", labels: str = "", node_count: int = 1):
        if not name:
            raise ConfError("provisioner needs tony.provisioner.name")
        if not accelerator_type:
            raise ConfError(
                "tony.provisioner.accelerator-type (or tony.tpu.topology) "
                "is required for provisioner mode tpu-vm/queued")
        if node_count > 1 and not queued:
            # only the queued-resources API creates multiple nodes under
            # one resource (the multislice shape, VERDICT r2 #4)
            raise ConfError(
                f"tony.tpu.num-slices={node_count} requires "
                "tony.provisioner.mode=queued (multi-node queued-resources)")
        self.name = name
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.runner = runner
        self.queued = queued
        self.spot = spot
        self.reuse = reuse
        self.keep = keep
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s
        self.network = network
        self.labels = labels
        self.node_count = max(1, node_count)
        self.state = STATE_NONE
        self._created = False  # only delete what we created (unless adopt)

    def node_names(self) -> list[str]:
        """Single-node: the resource name itself. Multi-node queued
        resources: gcloud derives ``<prefix>-0..N-1`` from --node-prefix."""
        if self.node_count <= 1:
            return [self.name]
        return [f"{self.name}-{i}" for i in range(self.node_count)]

    # ------------------------------------------------------------- describe
    def _describe_node(self, node_name: str | None = None) -> dict | None:
        try:
            return self.runner.run("compute", "tpus", "tpu-vm", "describe",
                                   node_name or self.name, parse_json=True)
        except ProvisioningError:
            return None

    def _describe_queued(self) -> dict | None:
        try:
            return self.runner.run("compute", "tpus", "queued-resources",
                                   "describe", self.name, parse_json=True)
        except ProvisioningError:
            return None

    @staticmethod
    def hosts_from_node(node: dict) -> list[str]:
        hosts = []
        for ep in node.get("networkEndpoints") or []:
            addr = ep.get("ipAddress") or \
                (ep.get("accessConfig") or {}).get("externalIp", "")
            if addr:
                hosts.append(addr)
        return hosts

    # --------------------------------------------------------------- create
    def _create(self) -> None:
        args = ["--accelerator-type", self.accelerator_type,
                "--version" if not self.queued else "--runtime-version",
                self.runtime_version, "--quiet"]
        if self.spot:
            args.append("--spot")
        if self.network:
            args += ["--network", self.network]
        if self.labels:
            args += ["--labels", self.labels]
        if self.queued and self.node_count > 1:
            # one queued resource, N nodes = N slices (DCN-connected);
            # gcloud names them <prefix>-0..N-1
            self.runner.run("compute", "tpus", "queued-resources", "create",
                            self.name, "--node-count", str(self.node_count),
                            "--node-prefix", self.name, *args)
        elif self.queued:
            self.runner.run("compute", "tpus", "queued-resources", "create",
                            self.name, "--node-id", self.name, *args)
        else:
            # --async: gcloud's synchronous create can outlive any sane RPC
            # timeout; we poll describe ourselves either way
            self.runner.run("compute", "tpus", "tpu-vm", "create", self.name,
                            "--async", *args)
        self._created = True

    def provision(self) -> list[str]:
        existing = self._describe_node(self.node_names()[0])
        if existing is not None:
            state = str(existing.get("state", ""))
            if not self.reuse:
                raise ProvisioningError(
                    f"TPU {self.name} already exists (state {state}) and "
                    "tony.provisioner.reuse is off")
            log.info("adopting existing TPU %s (state %s)", self.name, state)
        else:
            self.state = STATE_CREATING
            log.info("creating TPU slice %s (%s, %s%s)", self.name,
                     self.accelerator_type, self.runtime_version,
                     ", queued" if self.queued else "")
            self._create()
        self.state = STATE_WAITING
        hosts = self._await_ready()
        self.state = STATE_READY
        log.info("TPU slice %s READY with %d host(s): %s", self.name,
                 len(hosts), ",".join(hosts))
        return hosts

    def _await_ready(self) -> list[str]:
        """Poll until the node is READY + has endpoints (ref: the AM's
        container-allocation wait with its 15-min timeout)."""
        deadline = time.monotonic() + self.timeout_s
        last = "(no describe yet)"
        while time.monotonic() < deadline:
            if self.queued:
                qr = self._describe_queued()
                if qr is not None:
                    qstate = str((qr.get("state") or {}).get("state", ""))
                    last = f"queued-resource {qstate}"
                    if qstate in _DOOMED_QR_STATES:
                        raise ProvisioningError(
                            f"queued resource {self.name} is {qstate}: "
                            f"{json.dumps(qr.get('state', {}))[:300]}")
            # every node (1 for single-slice, N for multislice) must be
            # READY with endpoints; hosts concatenate in node order so
            # contiguous flat-index ranges land on one slice — the same
            # grouping multislice_env assumes
            all_hosts: list[str] = []
            ready = 0
            for node_name in self.node_names():
                node = self._describe_node(node_name)
                if node is None:
                    last = f"node {node_name} not yet describable"
                    break
                nstate = str(node.get("state", ""))
                last = f"node {node_name} {nstate}"
                if nstate in _DOOMED_NODE_STATES:
                    raise ProvisioningError(
                        f"TPU {node_name} entered {nstate} while waiting")
                if nstate not in _READY_NODE_STATES:
                    break
                hosts = self.hosts_from_node(node)
                if not hosts:
                    last = f"node {node_name} READY but no networkEndpoints"
                    break
                ready += 1
                all_hosts.extend(hosts)
            if ready == len(self.node_names()):
                return all_hosts
            time.sleep(self.poll_interval_s)
        raise ProvisioningError(
            f"TPU {self.name} not READY within {self.timeout_s:.0f}s "
            f"(last: {last})")

    # ------------------------------------------------------------- teardown
    def deprovision(self) -> None:
        if self.keep:
            log.info("tony.provisioner.keep: leaving TPU %s up", self.name)
            return
        if not self._created and self.state != STATE_READY:
            return  # nothing acquired
        self.state = STATE_DELETING
        try:
            if self.queued:
                self.runner.run("compute", "tpus", "queued-resources",
                                "delete", self.name, "--force", "--quiet")
            else:
                self.runner.run("compute", "tpus", "tpu-vm", "delete",
                                self.name, "--quiet")
            log.info("deleted TPU slice %s", self.name)
        except (ProvisioningError, subprocess.SubprocessError, OSError):
            # teardown is best-effort: the job outcome must not flip over
            # a delete hiccup, but operators need the trail
            log.exception("failed to delete TPU slice %s", self.name)
        self.state = STATE_NONE


def _conf_int(conf: TonyConf, key: str, default: int) -> int:
    """``get_int`` with a TYPED failure: a garbage value in a numeric
    provisioner key must fail the submission with a ConfError naming
    the key, not escape as a bare ValueError stack trace — the
    autoscaler's ProvisionerBackend (gateway/autoscale.py) turns any
    provisioning exception into a logged decision, and 'invalid
    literal for int()' tells an operator nothing."""
    try:
        return conf.get_int(key, default)
    except (TypeError, ValueError) as e:
        raise ConfError(f"{key} must be an integer "
                        f"(got {conf.get(key)!r}): {e}") from None


def provisioner_from_conf(conf: TonyConf, app_id: str) -> Provisioner:
    """Build the configured provisioner (cheap: no subprocess here).
    Raises ``ConfError`` (typed, operator-readable) for unknown modes,
    undersized slices, and malformed numeric values — never a bare
    ``ValueError`` stack trace."""
    mode = str(conf.get("tony.provisioner.mode", "none"))
    if mode == "none":
        hosts = [h.strip() for h in
                 str(conf.get("tony.application.hosts", "")).split(",")
                 if h.strip()]
        return StaticProvisioner(hosts)
    if mode not in ("tpu-vm", "queued"):
        raise ConfError(f"unknown tony.provisioner.mode: {mode}")
    accel = str(conf.get("tony.provisioner.accelerator-type", "")) or \
        str(conf.get("tony.tpu.topology", ""))
    need = required_chips(conf)
    n_nodes = max(1, _conf_int(conf, "tony.tpu.num-slices", 1))
    have = chips_in_accelerator_type(accel) * n_nodes
    if need > 0 and have > 0 and have < need:
        raise ConfError(
            f"accelerator type {accel} x {n_nodes} node(s) has {have} chips "
            f"but roles request {need} (sum of instances x "
            f"tony.<role>.chips)")
    runner = GcloudRunner(
        str(conf.get("tony.provisioner.gcloud-bin", "gcloud")),
        str(conf.get("tony.provisioner.project", "")),
        str(conf.get("tony.provisioner.zone", "")))
    return TpuVmProvisioner(
        str(conf.get("tony.provisioner.name", "")) or
        f"tony-{app_id.replace('_', '-')}",
        accel,
        str(conf.get("tony.provisioner.runtime-version",
                     "tpu-ubuntu2204-base")),
        runner,
        queued=(mode == "queued"),
        spot=conf.get_bool("tony.provisioner.spot"),
        reuse=conf.get_bool("tony.provisioner.reuse", True),
        keep=conf.get_bool("tony.provisioner.keep"),
        timeout_s=_conf_int(conf, "tony.provisioner.timeout-ms",
                            900_000) / 1000,
        poll_interval_s=_conf_int(
            conf, "tony.provisioner.poll-interval-ms", 10_000) / 1000,
        network=str(conf.get("tony.provisioner.network", "")),
        labels=str(conf.get("tony.provisioner.labels", "")),
        node_count=_conf_int(conf, "tony.tpu.num-slices", 1))


def preflight_chips(conf: TonyConf) -> str | None:
    """LOCAL-launch preflight: discovered chips must cover the aggregate
    demand. Returns an error string (caller fails the submission) or None.

    Only enforced when roles actually request chips AND discovery finds
    any (a CPU CI host discovers none — chip requests there are advisory,
    like the reference on clusters without the GPU resource plugin)."""
    need = required_chips(conf)
    if need <= 0:
        return None
    from tony_tpu_torch.utils.gpu_info import GpuDiscoverer

    info = GpuDiscoverer(
        str(conf.get("tony.tpu.info-exec-path", ""))).get_device_information()
    have = len(info.chips)
    if have and have < need:
        return (f"roles request {need} chips but this host has {have} "
                f"(source: {info.source}); lower tony.<role>.chips/"
                "instances or provision a slice (tony.provisioner.mode)")
    return None
