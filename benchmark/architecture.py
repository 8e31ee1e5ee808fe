"""A configuration's architecture, found by the name its file gives under
"architecture", as a call or a metric reader is found by its name:

- benchmark/systems/<name>.py builds the program's engine over the
  architecture's holder, its weights made from the seed;
- benchmark/reference/<name>.py computes the architecture plainly: its
  weight parts, conditioning, guided model output, sampler step, noise and
  decode;
- benchmark/yardstick/<name>.py counts the model work a transition needs.

A new architecture is these three files beside its configuration; the
shared modules name none of them.
"""
from __future__ import annotations

import importlib
import re

KINDS = ("systems", "reference", "yardstick")


def load(kind: str, cfg: dict):
    """The architecture module of `kind` for configuration `cfg`; a
    ValueError that names the module where there is none."""
    arch = cfg.get("architecture")
    if not isinstance(arch, str) or not re.fullmatch(r"[a-z_][a-z0-9_]*", arch):
        raise ValueError(f"configuration {cfg.get('name')!r} names no architecture module: {arch!r}")
    name = f"benchmark.{kind}.{arch}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"configuration {cfg.get('name')!r}: architecture {arch!r} has no module "
                         f"benchmark/{kind}/{arch}.py") from None


def check(cfg: dict) -> None:
    """Refuse a configuration whose architecture lacks any of its three
    modules, naming each one missing."""
    missing = []
    for kind in KINDS:
        try:
            load(kind, cfg)
        except ValueError as e:
            missing.append(str(e))
    if missing:
        raise ValueError("; ".join(missing))
