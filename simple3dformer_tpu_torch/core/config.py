"""Task configs over the repository's configs/ (port of
simple3dformer_tpu/core/config.py).

The same surface: ``Config`` (a dict with attribute access and dotted
set), ``load_task_config(task, overrides)`` reading configs/<task>.yaml,
resolving the ``defaults: - model: X`` group from configs/model/X.yaml and
applying Hydra-style ``key=value`` overrides (``model=Name`` swaps the group).

The JAX package reads the files with PyYAML, which the port does not depend
on. The files use a small subset of YAML: ``key: scalar`` lines, nested
mappings by indentation, ``- key: value`` list items, and ``#`` comments.
``parse_yaml`` reads that subset, and scalars resolve by PyYAML's YAML 1.1
rules (so ``1e-2``, which has no dot, stays the string '1e-2', as it does
there; the trainers convert with ``float``). Anything beyond the subset
raises.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Iterable, Mapping

CONFIG_ROOT = Path(__file__).resolve().parent.parent.parent / "configs"

# PyYAML's implicit resolvers (resolver.py, YAML 1.1) for the plain scalars
# the configs use; its other number forms raise rather than resolve otherwise
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
_OTHER_NUMBER = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")


def parse_scalar(text: str) -> Any:
    """One plain or quoted YAML scalar, resolved as PyYAML's safe_load does."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text.lower()]
    if _OTHER_NUMBER.match(text) or text[0] in "[{&*!|>%@`" or ": " in text:
        raise ValueError(f"YAML beyond the configs' subset: {text!r}")
    return text


def _lines(text: str):
    for raw in text.splitlines():
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if line.strip():
            yield len(line) - len(line.lstrip(" ")), line.strip()


def _block(lines: list, i: int, indent: int):
    """Parse the block of lines at ``indent`` from lines[i]; (value, next i)."""
    if lines[i][1].startswith("- "):
        out = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
            item = lines[i][1][2:].strip()
            sub = [(indent + 2, item)] + lines[i + 1:]
            if ":" in item and not item.startswith(("'", '"')):
                value, j = _block(sub, 0, indent + 2)
            else:
                value, j = parse_scalar(item), 1
            out.append(value)
            i += j
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep:
            raise ValueError(f"YAML beyond the configs' subset: {lines[i][1]!r}")
        i += 1
        if rest.strip():
            out[key.strip()] = parse_scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key.strip()], i = _block(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
            out[key.strip()], i = _block(lines, i, indent)
        else:
            out[key.strip()] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """The configs' subset of YAML -> dicts, lists and scalars."""
    lines = list(_lines(text))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"YAML beyond the configs' subset at {lines[i][1]!r}")
    return value


def _dump(value: Any, indent: int = 0) -> list[str]:
    pad = " " * indent
    out = []
    for k, v in value.items():
        if isinstance(v, Mapping):
            out += [f"{pad}{k}:"] + _dump(v, indent + 2)
        elif isinstance(v, list):
            out.append(f"{pad}{k}:")
            for item in v:
                sub = _dump(item, indent + 2) if isinstance(item, Mapping) else [f"{item}"]
                out += [f"{pad}- {sub[0].strip()}"] + sub[1:]
        else:
            out.append(f"{pad}{k}: {'null' if v is None else v}")
    return out


class Config(dict):
    """A dict with attribute access and dotted-key set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        return cls._wrap(dict(d))

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        return cls.from_dict(parse_yaml(Path(path).read_text()) or {})

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def to_yaml(self) -> str:
        return "\n".join(_dump(self.to_dict())) + "\n"

    def set_dotted(self, dotted: str, value: Any) -> None:
        keys = dotted.split(".")
        node = self
        for k in keys[:-1]:
            if k not in node or not isinstance(node[k], Config):
                node[k] = Config()
            node = node[k]
        node[keys[-1]] = value


def load_task_config(task: str, overrides: Iterable[str] = (),
                     config_root: str | Path | None = None) -> Config:
    """Load configs/<task>.yaml, resolve the model group, apply overrides.

    ``model=Hengshuang`` swaps the model group file; ``learning_rate=0.05`` and
    ``model.nblocks=2`` set values.
    """
    root = Path(config_root) if config_root is not None else CONFIG_ROOT
    cfg = Config.from_yaml(root / f"{task}.yaml")

    model_group = cfg.pop("defaults", {})
    model_name = None
    if isinstance(model_group, list):  # hydra-style: [{model: name}]
        for entry in model_group:
            if isinstance(entry, Mapping) and "model" in entry:
                model_name = entry["model"]
    elif isinstance(model_group, Mapping):
        model_name = model_group.get("model")

    pending = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        if key == "model":
            model_name = value
        else:
            pending.append((key, parse_scalar(value)))

    if model_name is not None:
        cfg["model"] = Config.from_yaml(root / "model" / f"{model_name}.yaml")

    for key, value in pending:
        cfg.set_dotted(key, value)
    return cfg
