"""Hydra-compatible YAML config composition (no hydra dependency); a copy
of bflow_tpu/confsys.py, over the port's copy of the config tree
(bflow_tpu_torch/config, byte-identical to bflow_tpu/config).

Supports exactly the subset the CLI surface uses:

  * primary configs with `defaults:` lists (`- general`, `- dataset: ???`)
  * config groups merged at their group path (`dataset=dsec` loads
    config/dataset/dsec.yaml into the `dataset` subtree), with nested
    group-relative defaults (`- base`)
  * `# @package _global_` experiment overlays added via
    `+experiment/dsec/raft_spline=NAME`, including their
    `defaults: - override /model: X` group re-selection
  * OmegaConf-style interpolation: absolute `${a.b}` and relative
    `${..sibling}` references
  * `???` mandatory markers — composition fails listing unresolved keys
  * dotted CLI value overrides (`dataset.path=/x`, `batch_size=8`,
    `hardware.gpus=[0,1]`), parsed as YAML values

Result is a plain nested dict: picklable, no framework type.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import yaml

MISSING = "???"


class ConfigError(ValueError):
    pass


def _load_yaml(path: Path) -> Tuple[dict, bool]:
    """Returns (content, is_global_package)."""
    text = path.read_text()
    is_global = bool(
        re.search(r"^#\s*@package\s+_global_\s*$", text, re.MULTILINE)
    )
    data = yaml.safe_load(text) or {}
    assert isinstance(data, dict), path
    return data, is_global


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Overlay wins; dicts merge recursively; everything else replaces."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(tree: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _compose_file(config_dir: Path, rel: str, choices: Dict[str, str]) -> dict:
    """Compose one config file with its defaults list.

    `rel` is the path relative to config_dir without extension
    (e.g. 'train', 'dataset/dsec', 'experiment/dsec/raft_spline/X').
    """
    path = config_dir / f"{rel}.yaml"
    if not path.is_file():
        raise ConfigError(f"config file not found: {path}")
    data, is_global = _load_yaml(path)
    defaults = data.pop("defaults", None)
    group_dir = str(Path(rel).parent) if "/" in rel else ""

    if defaults is None:
        return data

    merged: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, data)
            self_merged = True
            continue
        if isinstance(entry, str):
            # sibling config in the same (group) directory, root package
            # within that group
            sub_rel = f"{group_dir}/{entry}" if group_dir else entry
            merged = _deep_merge(merged, _compose_file(config_dir, sub_rel, choices))
            continue
        assert isinstance(entry, dict) and len(entry) == 1, entry
        (key, option), = entry.items()
        if key.startswith("override "):
            # handled during pre-scan; already reflected in `choices`
            continue
        group = key
        if option == MISSING or option is None:
            option = choices.get(group)
            if option is None:
                raise ConfigError(
                    f"missing mandatory config group choice '{group}=' "
                    f"(e.g. {group}=<option>)"
                )
        sub = _compose_file(config_dir, f"{group}/{option}", choices)
        merged = _deep_merge(merged, _nest(group, sub))
    if not self_merged:
        merged = _deep_merge(merged, data)  # hydra 1.1+: _self_ last
    return merged


def _nest(group: str, content: dict) -> dict:
    """Place group content at its package path (group path)."""
    out = content
    for part in reversed(group.split("/")):
        out = {part: out}
    return out


def _scan_overrides(
    config_dir: Path, overrides: List[str]
) -> Tuple[Dict[str, str], List[str], List[Tuple[str, Any]]]:
    """Split CLI overrides into (group choices, experiment overlays,
    value overrides)."""
    choices: Dict[str, str] = {}
    experiments: List[str] = []
    values: List[Tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override must be key=value: {ov!r}")
        key, _, raw = ov.partition("=")
        key = key.strip()
        if key.startswith("+"):
            experiments.append(f"{key[1:]}/{raw.strip()}")
            continue
        if "." not in key and (config_dir / key).is_dir():
            choices[key] = raw.strip()
            continue
        values.append((key, yaml.safe_load(raw)))
    return choices, experiments, values


def _resolve_interpolations(root: dict) -> None:
    pattern = re.compile(r"^\$\{([^}]+)\}$")

    def lookup(ref: str, stack: List[dict]) -> Any:
        if ref.startswith("."):
            # relative: one leading dot = current node, each extra = up one
            ups = len(ref) - len(ref.lstrip("."))
            name = ref[ups:]
            node = stack[-ups] if ups <= len(stack) else root
            return node.get(name, MISSING)
        node: Any = root
        for part in ref.split("."):
            if not isinstance(node, dict) or part not in node:
                return MISSING
            node = node[part]
        return node

    def walk(node: dict, stack: List[dict]) -> None:
        for k, v in list(node.items()):
            if isinstance(v, dict):
                walk(v, stack + [v])
            elif isinstance(v, str):
                m = pattern.match(v)
                if m:
                    node[k] = lookup(m.group(1), stack)

    # two passes handle chained references
    for _ in range(2):
        walk(root, [root])


def _find_missing(node: Any, prefix: str = "") -> List[str]:
    out = []
    if isinstance(node, dict):
        for k, v in node.items():
            out.extend(_find_missing(v, f"{prefix}.{k}" if prefix else k))
    elif node == MISSING:
        out.append(prefix)
    return out


def compose(
    config_dir: Union[str, Path],
    config_name: str,
    overrides: Optional[List[str]] = None,
    allow_missing: bool = False,
) -> dict:
    config_dir = Path(config_dir)
    overrides = list(overrides or [])
    choices, experiments, values = _scan_overrides(config_dir, overrides)

    # Pre-scan experiment overlays for group re-selection (`override /g: x`).
    overlay_data = []
    for exp_rel in experiments:
        data, is_global = _load_yaml(config_dir / f"{exp_rel}.yaml")
        if not is_global:
            raise ConfigError(
                f"experiment overlay must be @package _global_: {exp_rel}"
            )
        for entry in data.pop("defaults", []) or []:
            if isinstance(entry, dict):
                (key, option), = entry.items()
                if key.startswith("override "):
                    group = key[len("override "):].lstrip("/")
                    choices.setdefault(group, option)
        overlay_data.append(data)

    cfg = _compose_file(config_dir, Path(config_name).stem, choices)
    for data in overlay_data:
        cfg = _deep_merge(cfg, data)
    for key, value in values:
        _set_path(cfg, key, value)

    _resolve_interpolations(cfg)

    if not allow_missing:
        missing = _find_missing(cfg)
        if missing:
            raise ConfigError(
                "mandatory config values not provided: " + ", ".join(missing)
            )
    return cfg
