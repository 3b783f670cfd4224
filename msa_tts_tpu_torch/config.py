"""Config system (the port's own copy of ``msa_tts_tpu/config.py``):
YAML ``params.yml`` per experiment, reference-compatible vocabulary (reference: msa_tts/utils/generic.py:4-9).

Optimizer params in reference configs are strings that were ``eval()``'d
(msa_tts/utils/helpers.py:20-26) — we parse them with
``ast.literal_eval`` instead (no arbitrary code execution) with a
fallback for simple arithmetic like ``1e-3``.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any


def load_params(path: str) -> dict:
    """Load a YAML params file.  ``yaml`` is imported here, not with the
    module: serving from in-memory params must not need it."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def save_params(params: dict, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.dump(_plain(params), f)


def _plain(obj):
    """Recursively convert to YAML-safe plain Python types."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def literal(value: Any) -> Any:
    """Parse a possibly-stringified literal ("1e-3", "(0.9, 0.999)",
    "True") to a Python value; non-strings pass through."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        try:
            return float(value)
        except ValueError:
            return value


def parse_optim_params(optim_cfg: dict) -> tuple[str, dict]:
    """Split a reference-style optimizer section into (name, kwargs).

    Two accepted shapes (both appear in the reference configs):
      * flat: ``{"optimizer_type": "Adam", "lr": "1e-3", ...}``;
      * nested (msa_tts/utils/helpers.py:20-26):
        ``{"optimizer_name": "Adam", "optim_params": {"lr": "1e-3"}}``.
    Values may be stringified literals (the reference ``eval()``s them;
    we parse them safely).
    """
    cfg = dict(optim_cfg)
    if "optim_params" in cfg:
        name = cfg.get("optimizer_name", cfg.get("optimizer_type", "Adam"))
        kw = dict(cfg["optim_params"])
    else:
        name = cfg.pop(
            "optimizer_type",
            cfg.pop("optimizer_name", cfg.pop("optim_type", "Adam")),
        )
        kw = cfg
    return name, {k: literal(v) for k, v in kw.items()}


def apply_cli_overrides(params: dict, overrides: list[str]) -> dict:
    """Apply ``--key value`` free-form overrides (reference
    infer.py:378-393 semantics): dotted keys descend into nested dicts.
    """
    params = copy.deepcopy(params)
    if len(overrides) % 2 != 0:
        raise ValueError("overrides must be --key value pairs")
    for i in range(0, len(overrides), 2):
        key = overrides[i].lstrip("-")
        value = literal(overrides[i + 1])
        node = params
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                # an empty YAML section ("optim:") loads as None; an
                # override into it should create the dict, not TypeError
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value
    return params


def experiment_path_from_env(params_path: str | None = None) -> str:
    """Resolve the experiment directory: explicit arg, else the
    ``EXPERIMENT_PATH`` env var (reference infer.py:349)."""
    path = params_path or os.environ.get("EXPERIMENT_PATH")
    if not path:
        raise ValueError(
            "no experiment path: pass --params_path or set EXPERIMENT_PATH"
        )
    return path
