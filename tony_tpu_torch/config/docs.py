"""Config reference generator.

The PyTorch port's copy of ``tony_tpu/config/docs.py``.

The reference ships ``tony-default.xml`` (417 lines, 60 keys) which doubles
as the user-facing documentation of every configuration key
(tony-core/src/main/resources/tony-default.xml); TonY's wiki renders it.
Here the typed schema in ``keys.py`` is the single source of truth, and this
module renders it to markdown. ``CONFIG.md`` at the repo root is the checked
-in rendering, drift-locked by ``tests/test_config.py`` the same way
``TestTonyConfigurationFields`` locks keys <-> XML in the reference
(SURVEY.md section 4.3).

Regenerate with::

    python -m tony_tpu_torch.config.docs > CONFIG.md
"""

from __future__ import annotations

from tony_tpu_torch.config import keys as K

_HEADER = """\
# tony-tpu configuration reference

<!-- GENERATED FILE — do not edit. Regenerate with:
     python -m tony_tpu_torch.config.docs > CONFIG.md
     tests/test_config.py fails if this file drifts from the schema. -->

Every key, its default, type, and meaning. Layering precedence (low to
high): built-in defaults -> `--conf_file` (TOML/JSON/k=v) -> repeated
`--conf k=v` CLI overrides -> `$TONY_CONF_DIR/tony-site.*`. The merged
config is written to the job dir as `tony-final.json` and re-read by the
coordinator and every agent (reference: tony-default.xml + tony.xml +
`--conf` + tony-site.xml -> tony-final.xml).
"""

_ROLE_HEADER = """\
## Per-role keys: `tony.<role>.*`

Role names are free-form (reference: TonyConfigurationKeys.java:189-257 —
`tony.<role>.instances` etc. are regex-matched, so users can invent roles
like `head` for ray). Reserved namespace segments that are never parsed as
role names: {reserved}.
"""


def _fmt_default(v) -> str:
    if v == "":
        return "(empty)"
    if isinstance(v, bool):
        return "true" if v else "false"
    return f"`{v}`"


def _table(rows: list[tuple[str, K.Key]]) -> list[str]:
    out = ["| Key | Default | Type | Description |",
           "|---|---|---|---|"]
    for name, key in rows:
        doc = key.doc.replace("|", "\\|")  # literal pipes break md tables
        out.append(f"| `{name}` | {_fmt_default(key.default)} | "
                   f"{key.type.__name__} | {doc} |")
    return out


def render_config_reference() -> str:
    """Markdown reference for every global and per-role key."""
    from tony_tpu_torch.config.config import _NON_ROLE_SEGMENTS

    groups: dict[str, list[tuple[str, K.Key]]] = {}
    for name, key in K.KEYS.items():
        prefix = ".".join(name.split(".")[:2])
        groups.setdefault(prefix, []).append((name, key))

    lines = [_HEADER]
    for prefix in sorted(groups):
        lines.append(f"## `{prefix}.*`\n")
        lines.extend(_table(sorted(groups[prefix])))
        lines.append("")
    reserved = ", ".join(f"`{s}`" for s in sorted(_NON_ROLE_SEGMENTS))
    lines.append(_ROLE_HEADER.format(reserved=reserved))
    lines.extend(_table(sorted(K.ROLE_SUFFIXES.items())))
    lines.append("")
    multi = ", ".join(f"`{k}`" for k in sorted(K.MULTI_VALUE_KEYS))
    lines.append("## Multi-value keys\n")
    lines.append(f"Repeated `--conf` occurrences append (not replace) for: "
                 f"{multi} (reference: TonyClient.java:672-684).")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(render_config_reference(), end="")
