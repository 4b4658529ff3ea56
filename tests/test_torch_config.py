"""The port's job conf against the JAX package's: the same TOML, JSON and
``--conf`` layers merge to the same values, the schema and its checks
agree, and ``config.docs`` renders the same reference table."""

import json

import pytest

from tony_tpu import config as jax_config
from tony_tpu.config import docs as jax_docs
from tony_tpu_torch import config as port_config
from tony_tpu_torch.config import docs as port_docs

PKGS = [jax_config, port_config]


def _files(tmp_path):
    f = tmp_path / "job.toml"
    f.write_text('[tony.application]\nname = "from-file"\n'
                 'framework = "pytorch"\n\n[tony.worker]\ninstances = 3\n'
                 'chips = 1\n\n[tony.ps]\ninstances = 1\n')
    site = tmp_path / "site"
    site.mkdir()
    (site / "tony-site.json").write_text(json.dumps(
        {"tony.worker.instances": 5, "tony.task.heartbeat-interval-ms": 250}))
    j = tmp_path / "job.json"
    j.write_text(json.dumps({"tony.application": {"name": "from-json"},
                             "tony.evaluator.instances": 1}))
    return str(f), str(j), str(site)


OVERRIDES = ["tony.application.name=from-cli",
             "tony.application.untracked.jobtypes=a",
             "tony.application.untracked.jobtypes=b",
             "tony.worker.memory=4g", "tony.chief.instances=1"]


@pytest.mark.parametrize("which", ["toml", "json"])
def test_merged_conf_matches_jax(tmp_path, which):
    toml, js, site = _files(tmp_path)
    path = toml if which == "toml" else js
    got = [dict(pkg.build_conf(path, OVERRIDES, site).items())
           for pkg in PKGS]
    assert got[0] == got[1]
    confs = [pkg.build_conf(path, OVERRIDES, site) for pkg in PKGS]
    assert confs[0].roles() == confs[1].roles()
    assert confs[0].get_list("tony.application.untracked.jobtypes") \
        == confs[1].get_list("tony.application.untracked.jobtypes") \
        == ["ps", "a", "b"]


def test_schema_matches_jax():
    for a, b in ((jax_config.keys.KEYS, port_config.keys.KEYS),
                 (jax_config.keys.ROLE_SUFFIXES,
                  port_config.keys.ROLE_SUFFIXES)):
        assert list(a) == list(b)
        assert [(s.default, s.type, s.doc) for s in a.values()] \
            == [(s.default, s.type, s.doc) for s in b.values()]
    assert jax_config.keys.MULTI_VALUE_KEYS \
        == port_config.keys.MULTI_VALUE_KEYS


def test_docs_render_the_same_table():
    """Equal but for the module the header tells to regenerate with."""
    port = port_docs.render_config_reference()
    assert "python -m tony_tpu_torch.config.docs" in port
    assert port.replace("tony_tpu_torch.", "tony_tpu.") \
        == jax_docs.render_config_reference()


def test_final_conf_roundtrip_matches_jax(tmp_path):
    out = []
    for i, pkg in enumerate(PKGS):
        conf = pkg.TonyConf()
        conf.set("tony.worker.instances", 2)
        conf.set("tony.head.instances", "1")
        conf.set("tony.application.name", "rt")
        p = tmp_path / f"final{i}.json"
        conf.write_final(str(p))
        back = pkg.TonyConf.from_final(str(p))
        out.append((back.roles(), back.get_int("tony.worker.instances"),
                    back.get("tony.application.name"),
                    back.get_int("tony.task.heartbeat-interval-ms"),
                    sorted(json.loads(p.read_text()))))
    assert out[0] == out[1]


@pytest.mark.parametrize("case", [
    {"tony.worker.instances": 4, "tony.worker.chips": 8,
     "tony.application.max-total-chips": 16},
    {"tony.worker.instances": 4, "tony.worker.max-instances": 2},
    {"tony.application.distributed-mode": "RING"},
    {"tony.worker.instances": 2},
    {"tony.task.max-missed-heartbeats": "7",
     "tony.application.fail-on-worker-failure-enabled": "TRUE"},
], ids=["chips", "max-instances", "mode", "ok", "coercion"])
def test_validation_matches_jax(case):
    outcomes = []
    for pkg in PKGS:
        conf = pkg.TonyConf()
        for k, v in case.items():
            conf.set(k, v)
        try:
            conf.validate()
            outcomes.append(("ok", dict(conf.items())))
        except pkg.ConfError as e:
            outcomes.append(("ConfError", str(e)))
    assert outcomes[0] == outcomes[1]


def test_bad_override_refused_by_both():
    for pkg in PKGS:
        with pytest.raises(pkg.ConfError):
            pkg.TonyConf().apply_overrides(["no-equals-sign"])
        with pytest.raises(KeyError):
            pkg.role_key("worker", "nope")
