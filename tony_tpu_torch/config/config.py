"""Layered job configuration with regex-driven per-role keys.

The PyTorch port's copy of ``tony_tpu/config/config.py``.

Reference precedence (TonyClient.java:657-691, SURVEY.md section 5.6),
low -> high:
  bundled defaults -> user conf file (tony.toml/json via --conf_file)
  -> repeated --conf k=v CLI overrides -> site file $TONY_CONF_DIR/tony-site.*

The merged conf is serialized to ``tony-final.json`` by the client and
re-read verbatim by the coordinator and agents (ref: tony-final.xml,
TonyClient.java:303-310 / ApplicationMaster.java:230 / TaskExecutor.java:257).
"""

from __future__ import annotations

import json
import os
import re

try:
    import tomllib
except ModuleNotFoundError:  # python < 3.11: tomli IS tomllib upstream
    import tomli as tomllib
from typing import Any, Iterable

from tony_tpu_torch.config import keys as K

ROLE_KEY_RE = re.compile(
    r"^tony\.(?P<role>[A-Za-z0-9_\-]+)\.(?P<suffix>"
    + "|".join(re.escape(s) for s in K.ROLE_SUFFIXES)
    + r")$"
)

# Reserved namespaces that must not be parsed as role names by the regex
# (reference excludes tony.application.* etc. the same way).
_NON_ROLE_SEGMENTS = frozenset(
    {
        "application",
        "coordinator",
        "task",
        "history",
        "portal",
        "client",
        "staging-dir",
        "keytab",
        "tpu",
        "test",
        "horovod",
    }
)


def role_key(role: str, suffix: str) -> str:
    if suffix not in K.ROLE_SUFFIXES:
        raise KeyError(f"unknown role key suffix: {suffix}")
    return f"tony.{role}.{suffix}"


class ConfError(ValueError):
    pass


class TonyConf:
    """A flat, typed key/value job config (Hadoop-Configuration equivalent)."""

    def __init__(self, values: dict[str, Any] | None = None, load_defaults: bool = True):
        self._values: dict[str, Any] = K.defaults() if load_defaults else {}
        if values:
            for k, v in values.items():
                self.set(k, v)

    # -- core accessors -----------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._values[key] = self._coerce(key, value)

    def append(self, key: str, value: str) -> None:
        """Append to a comma-joined multi-value key (ref: MULTI_VALUE_CONF)."""
        cur = str(self._values.get(key, "") or "")
        self._values[key] = f"{cur},{value}" if cur else value

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._values:
            return self._values[key]
        m = ROLE_KEY_RE.match(key)
        if m and m.group("role") not in _NON_ROLE_SEGMENTS:
            return K.ROLE_SUFFIXES[m.group("suffix")].default
        return default

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return int(v) if v is not None and v != "" else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes")

    def get_list(self, key: str) -> list[str]:
        v = self.get(key, "")
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def items(self) -> Iterable[tuple[str, Any]]:
        return self._values.items()

    def __contains__(self, key: str) -> bool:
        return key in self._values

    # -- typing -------------------------------------------------------------
    @staticmethod
    def _coerce(key: str, value: Any) -> Any:
        spec = K.KEYS.get(key)
        if spec is None:
            m = ROLE_KEY_RE.match(key)
            if m and m.group("role") not in _NON_ROLE_SEGMENTS:
                spec = K.ROLE_SUFFIXES[m.group("suffix")]
        if spec is None:
            return value  # unknown keys pass through untyped (Hadoop semantics)
        t = spec.type
        if t is bool and not isinstance(value, bool):
            return str(value).strip().lower() in ("true", "1", "yes")
        if t is int and not isinstance(value, int):
            try:
                return int(str(value).strip())
            except ValueError:
                # a typo'd numeric in a conf file must fail as a typed,
                # key-naming ConfError — "invalid literal for int()"
                # with no key is useless to an operator (and the
                # provisioner/autoscaler paths log exceptions verbatim)
                raise ConfError(
                    f"{key} must be an integer, got {value!r}") from None
        if t is str:
            return str(value)
        return value

    # -- roles --------------------------------------------------------------
    def roles(self) -> list[str]:
        """All role names with instances configured, in config order.

        Reference: Utils.getAllJobTypes regex scan (util/Utils.java:451) over
        ``tony.<role>.instances``.
        """
        out: list[str] = []
        for k in self._values:
            m = ROLE_KEY_RE.match(k)
            if m and m.group("suffix") == "instances" \
                    and m.group("role") not in _NON_ROLE_SEGMENTS:
                if m.group("role") not in out:
                    out.append(m.group("role"))
        return out

    def role_get(self, role: str, suffix: str) -> Any:
        return self.get(role_key(role, suffix))

    # -- layering -----------------------------------------------------------
    def load_file(self, path: str) -> None:
        """Merge a TOML or JSON conf file. Nested tables flatten with dots.
        ``gs://`` paths are fetched to a temp file first (ref: remote-scheme
        --conf_file, TonyClient.java:657-691)."""
        from tony_tpu_torch.utils import remotefs

        if remotefs.is_remote(path):
            import tempfile

            with tempfile.TemporaryDirectory(prefix="tony_conf_") as tmp:
                return self.load_file(remotefs.fetch_to_dir(path, tmp))
        with open(path, "rb") as f:
            if path.endswith(".json"):
                data = json.load(f)
            elif path.endswith(".toml"):
                data = tomllib.load(f)
            else:
                raise ConfError(f"unsupported conf file (want .toml/.json): {path}")
        for k, v in _flatten(data):
            self.set(k, v)

    def apply_overrides(self, kvs: Iterable[str]) -> None:
        """Apply repeated ``--conf k=v`` overrides (ref: TonyClient.java:672-684)."""
        for kv in kvs:
            if "=" not in kv:
                raise ConfError(f"--conf expects k=v, got: {kv}")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k in K.MULTI_VALUE_KEYS:
                self.append(k, v.strip())
            else:
                self.set(k, v.strip())

    def load_site(self, conf_dir: str | None = None) -> None:
        """Highest-precedence site overrides from $TONY_CONF_DIR/tony-site.*"""
        d = conf_dir or os.environ.get("TONY_CONF_DIR", "")
        if not d:
            return
        for name in ("tony-site.toml", "tony-site.json"):
            p = os.path.join(d, name)
            if os.path.isfile(p):
                self.load_file(p)

    # -- finalization -------------------------------------------------------
    def write_final(self, path: str) -> None:
        """Serialize the merged conf + build version info (ref: VersionInfo
        injection, TonyConfigurationKeys.java:34-41). Key order is preserved:
        roles() order — and thus the is_chief first-role fallback — must
        survive the client -> coordinator round-trip."""
        from tony_tpu_torch.version import version_info

        for k, v in version_info().items():
            self._values.setdefault(k, v)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._values, f, indent=2)

    @classmethod
    def from_final(cls, path: str) -> "TonyConf":
        with open(path) as f:
            values = json.load(f)
        conf = cls(load_defaults=True)
        for k, v in values.items():
            conf.set(k, v)
        return conf

    # -- validation (reference: TonyClient.validateTonyConf :788-857) -------
    def validate(self) -> None:
        total_instances = 0
        total_chips = 0
        for role in self.roles():
            n = int(self.role_get(role, "instances"))
            if n < 0:
                raise ConfError(f"negative instances for role {role}")
            cap = int(self.role_get(role, "max-instances"))
            if cap >= 0 and n > cap:
                raise ConfError(f"role {role}: instances {n} exceeds max-instances {cap}")
            total_instances += n
            total_chips += n * int(self.role_get(role, "chips"))
        cap = self.get_int("tony.application.max-total-instances", -1)
        if cap >= 0 and total_instances > cap:
            raise ConfError(f"total instances {total_instances} exceeds cap {cap}")
        cap = self.get_int("tony.application.max-total-chips", -1)
        if cap >= 0 and total_chips > cap:
            raise ConfError(f"total chips {total_chips} exceeds cap {cap}")
        mode = self.get("tony.application.distributed-mode")
        if mode not in ("GANG", "FCFS"):
            raise ConfError(f"bad distributed-mode: {mode}")


def _flatten(data: dict, prefix: str = "") -> Iterable[tuple[str, Any]]:
    for k, v in data.items():
        full = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, full)
        else:
            yield full, v


def build_conf(
    conf_file: str | None = None,
    overrides: Iterable[str] = (),
    conf_dir: str | None = None,
) -> TonyConf:
    """Full layering pipeline: defaults -> file -> --conf -> site."""
    conf = TonyConf()
    if conf_file:
        conf.load_file(conf_file)
    conf.apply_overrides(overrides)
    conf.load_site(conf_dir)
    return conf
