"""Unified typed configuration tree with YAML loading (port of
lidar_slam_tpu/config.py).

Replaces the reference's three config mechanisms — per-node YAML files
keyed by WORK_SPACE_PATH (front_end.cpp:28-86), ROS params
(front_end_node.cpp:22-24), and the compile-time WORK_SPACE_PATH injection
(cmake/global_defination.cmake:1-5) — with one dataclass tree that can be
constructed in code or loaded/overridden from a single YAML file.

YAML schema mirrors the frozen dataclass fields; unknown keys raise. The
file is read by `parse_yaml`, the package's own reader of the YAML subset
the configs use (block mappings, plain and quoted scalars, flow lists,
comments), which gives what `yaml.safe_load` gives on that subset and
raises on anything else: the port needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from .models.graph_optimizer import GraphOptimizerConfig
from .models.registration.icp import ICPConfig
from .models.registration.ndt import NDTConfig
from .models.scan_context import ScanContextConfig
from .pipeline.aloam.pipeline import AloamConfig
from .pipeline.back_end import BackEndConfig
from .pipeline.data_pretreat import DataPretreatConfig
from .pipeline.front_end import FrontEndConfig
from .pipeline.loop_closing import LoopClosingConfig
from .pipeline.matching import MatchingConfig
from .pipeline.viewer import ViewerConfig


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level configuration for the full mapping + localization system."""

    data_pretreat: DataPretreatConfig = DataPretreatConfig()
    front_end: FrontEndConfig = FrontEndConfig()
    back_end: BackEndConfig = BackEndConfig()
    loop_closing: LoopClosingConfig = LoopClosingConfig()
    viewer: ViewerConfig = ViewerConfig()
    matching: MatchingConfig = MatchingConfig()
    aloam: AloamConfig = AloamConfig()  # the A-LOAM front end (mapping_with_aloam.launch)
    front_end_method: str = "ndt"  # mapping's front end, "ndt" or "aloam"; `--front-end` overrides it
    data_dir: str = "slam_data"


_NESTED = {
    "ndt": NDTConfig,
    "icp": ICPConfig,
    "sc": ScanContextConfig,
    "optimizer": GraphOptimizerConfig,
}


# -- the YAML subset ---------------------------------------------------------
class YAMLSubsetError(ValueError):
    """The text is outside the YAML subset `parse_yaml` reads."""


# PyYAML's (YAML 1.1) implicit resolvers for the scalar types read here
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# typed forms PyYAML resolves that this reader does not: binary, octal, hex
# and sexagesimal numbers, timestamps; and plain scalars that start with an
# indicator
_UNSUPPORTED = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|[-?:,\[\]{}#&*!|>'\"%@`].*)$"
)
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+(.*))?$")


def _scalar(text: str, where: str):
    if text.startswith("'") and text.endswith("'") and len(text) >= 2:
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise YAMLSubsetError(f"{where}: malformed single-quoted scalar {text!r}")
        return body.replace("''", "'")
    if text.startswith('"') and text.endswith('"') and len(text) >= 2:
        body = text[1:-1]
        if "\\" in body or '"' in body:
            raise YAMLSubsetError(f"{where}: escapes in double-quoted scalars are not read: {text!r}")
        return body
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF_NAN.match(text):
        return float(text.replace(".", "").lower())
    if _UNSUPPORTED.match(text) or ": " in text or " #" in text:
        raise YAMLSubsetError(f"{where}: scalar {text!r} is outside the YAML subset read here")
    return text


def _flow_list(text: str, where: str) -> list:
    body = text[1:-1].strip()
    if any(c in body for c in "[]{}"):
        raise YAMLSubsetError(f"{where}: nested flow collections are not read: {text!r}")
    if not body:
        return []
    items = [s.strip() for s in body.split(",")]
    if items[-1] == "":  # one trailing comma, as YAML allows
        items.pop()
    if any(s == "" for s in items):
        raise YAMLSubsetError(f"{where}: empty item in flow list {text!r}")
    return [_scalar(s, where) for s in items]


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after whitespace,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(body: str, where: str):
    if body.startswith("["):
        if not body.endswith("]"):
            raise YAMLSubsetError(f"{where}: unterminated flow list {body!r}")
        return _flow_list(body, where)
    return _scalar(body, where)


def _mapping(lines, pos: int, indent: int):
    out: dict = {}
    while pos < len(lines):
        no, ind, body = lines[pos]
        if ind < indent:
            break
        where = f"line {no}"
        if ind > indent:
            raise YAMLSubsetError(f"{where}: unexpected indentation")
        m = _KEY.match(body)
        if m is None:
            raise YAMLSubsetError(f"{where}: expected 'key: value', got {body!r}")
        key, rest = m.group(1), m.group(2)
        if key in out:
            raise YAMLSubsetError(f"{where}: duplicate key {key!r}")
        pos += 1
        if rest:
            out[key] = _value(rest.strip(), where)
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][1])
        else:
            out[key] = None
    return out, pos


def parse_yaml(text: str):
    """Parse the YAML subset of the config files: nested block mappings
    with identifier keys, plain scalars (resolved as PyYAML's safe loader
    resolves null, bool, int and float), simple quoted strings, flow lists
    of scalars, and '#' comments. Returns what `yaml.safe_load` returns on
    such text (None for an empty document); raises YAMLSubsetError on
    anything else (block sequences, anchors, tags, multi-line scalars,
    documents markers, tabs)."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        stripped = line.lstrip(" ")
        if stripped.startswith("\t") or "\t" in line[: len(line) - len(stripped)]:
            raise YAMLSubsetError(f"line {no}: tab in indentation")
        lines.append((no, len(line) - len(stripped), stripped))
    if not lines:
        return None
    out, pos = _mapping(lines, 0, lines[0][1])
    if pos != len(lines):
        raise YAMLSubsetError(f"line {lines[pos][0]}: indentation below the document's")
    return out


# -- the config tree ---------------------------------------------------------
def _build(cls, data: dict, base=None):
    """`cls` from a YAML mapping: its keys over the class defaults, or over
    the instance `base`. A sub-section named in _NESTED starts from its
    class defaults, as in the JAX package; any other starts from the
    field's default instance (the `aloam` section's stages)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__}: unknown config key '{key}'")
        if isinstance(value, dict):
            sub = _NESTED.get(key)
            default = fields[key].default
            kwargs[key] = _build(sub, value) if sub is not None else _build(type(default), value, base=default)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs) if base is None else dataclasses.replace(base, **kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> SlamConfig:
    """Load SlamConfig from YAML (optional) with dict overrides (optional)."""
    data: dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            data = parse_yaml(f.read()) or {}
    if overrides:
        def merge(a, b):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(a.get(k, {}), v) if isinstance(v, dict) and isinstance(a.get(k), dict) else v
            return out

        data = merge(data, overrides)
    sections = {}
    top = {f.name: f for f in dataclasses.fields(SlamConfig)}
    for key, value in data.items():
        if key not in top:
            raise KeyError(f"SlamConfig: unknown section '{key}'")
        if isinstance(value, dict):
            sections[key] = _build(top[key].default.__class__, value)
        else:
            sections[key] = value
    return SlamConfig(**sections)
