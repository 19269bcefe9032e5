"""Minimal hierarchical config node with YAML + key-value override merging.

Re-implements the subset of fvcore/yacs ``CfgNode`` behavior the reference
relies on (ref: utils/defaults.py, utils/parser.py:65-90): attribute access,
nested sections, ``merge_from_file`` (YAML), ``merge_from_list`` (the trailing
``--opts KEY VALUE ...`` CLI pairs), and tolerant dynamic key creation --
reference scripts attach keys that are absent from the defaults tree at
runtime (e.g. ``cfg.DATASET``, ``cfg.LOSS_FILE``,
ref: timesformer_evaluation.py:42-45).

Copied from the JAX package's ``config/cfg_node.py`` so the port imports
nothing of it. PyYAML is imported only where YAML is parsed: the
scoring path needs no YAML, and a machine without PyYAML still imports
the package.
"""

from __future__ import annotations

import copy
from typing import Any


class CfgNode(dict):
    """dict subclass with attribute access and recursive merge."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- merging -----------------------------------------------------------
    def merge_from_other(self, other: "CfgNode") -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge_from_other(v)
            else:
                self[k] = copy.deepcopy(v)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            self.merge_from_other(CfgNode(loaded))

    def merge_from_list(self, opts: list) -> None:
        """Merge ``[KEY, VALUE, KEY, VALUE, ...]`` pairs; KEY is dotted."""
        assert len(opts) % 2 == 0, f"odd number of override opts: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    node[p] = CfgNode()
                node = node[p]
            leaf = parts[-1]
            node[leaf] = _coerce(value, node.get(leaf))

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)


def _coerce(value: Any, old: Any) -> Any:
    """Interpret a CLI string override, preferring the existing value's type."""
    if not isinstance(value, str):
        return value
    if old is not None and not isinstance(old, str):
        if isinstance(old, bool):
            return value.lower() in ("1", "true", "on", "yes")
        for caster in (int, float):
            if isinstance(old, caster):
                try:
                    return caster(value)
                except ValueError:
                    break
        if isinstance(old, (list, tuple)):
            import yaml

            return yaml.safe_load(value)
    # best-effort literal parse for unknown keys
    import yaml

    try:
        parsed = yaml.safe_load(value)
        return parsed
    except yaml.YAMLError:
        return value
