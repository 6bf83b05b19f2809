"""Settings tree: a dict with recursive attribute access, and its YAML loader.

Counterpart of ``loner_tpu/common/settings.py::Settings``: ``load_from_file``
reads YAML with ``!include`` (resolved relative to the including file),
``augment`` deep-overlays a change dict, and ``load_config`` also reads the
per-sequence form (``baseline:`` + ``changes:``) that ``examples/run_loner.py``
accepts. ``yaml`` is imported inside the loaders only: a run from a plain dict
or from ``full_config.pkl`` parses no YAML.
"""
from __future__ import annotations

import copy
import os
from typing import Any, List, Optional, Tuple


class Settings(dict):
    """Dict with recursive attribute access. Nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Settings):
            value = Settings(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Settings({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def load_from_file(filename: str) -> "Settings":
        return Settings(_load_yaml_with_includes(filename))

    def as_plain_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(val) for k, val in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def augment(self, changes: Optional[dict]) -> "Settings":
        """Apply a (possibly nested) change dict onto self, in place."""
        if changes is None:
            return self
        for path, value in generate_change_list(changes):
            node = self
            for attr in path[:-1]:
                if attr not in node:
                    node[attr] = {}  # overlays may introduce new sections
                node = node[attr]
            node[path[-1]] = value
        return self


def _load_yaml_with_includes(filename: str):
    import yaml

    class IncludeLoader(yaml.SafeLoader):
        """SafeLoader that resolves ``!include other.yaml`` relative to the file."""

    def include(loader, node):
        root = os.path.dirname(getattr(loader.stream, "name", "."))
        return _load_yaml_with_includes(os.path.join(root, loader.construct_scalar(node)))

    IncludeLoader.add_constructor("!include", include)
    with open(os.path.expanduser(filename), "r") as f:
        return yaml.load(f, IncludeLoader)


def generate_change_list(changes: dict) -> List[Tuple[Tuple[str, ...], Any]]:
    """Flatten a nested change dict to [(path_tuple, leaf_value), ...]."""
    options: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(data, stack):
        if not isinstance(data, dict):
            options.append((tuple(stack), data))
            return
        for key in data:
            walk(data[key], stack + [key])

    walk(changes, [])
    return options


# Keys of a sequence config that the runner consumes; the rest pass through
# into the saved settings (the offline tools read them from there).
_SEQUENCE_KEYS = {"baseline", "changes", "dataset", "calibration", "groundtruth_traj",
                  "experiment_name", "dataset_family"}


def load_config(config_path: str) -> Tuple[Settings, Optional[str]]:
    """Settings from a config file, and the dataset path it names (or None).

    A plain config loads as it is. A sequence config (``baseline:`` a config
    path relative to the file, ``changes:`` an overlay, ``dataset:``) loads its
    baseline and applies the pass-through keys, then the changes, as
    ``examples/run_loner.py`` does."""
    raw = _load_yaml_with_includes(config_path)
    if not (isinstance(raw, dict) and "baseline" in raw):
        return Settings(raw), None
    settings = Settings.load_from_file(os.path.join(os.path.dirname(config_path), raw["baseline"]))
    settings.augment({k: v for k, v in raw.items() if k not in _SEQUENCE_KEYS} or None)
    settings.augment(raw.get("changes"))
    return settings, raw.get("dataset")
