"""Settings tree: a dict with recursive attribute access, and its YAML loader.

Counterpart of ``loner_tpu/common/settings.py::Settings``: ``load_from_file``
reads YAML with ``!include`` (resolved relative to the including file),
``augment`` deep-overlays a change dict, ``load_config`` also reads the
per-sequence form (``baseline:`` + ``changes:``) that ``examples/run_loner.py``
accepts (``load_sequence_config`` splits it), and ``generate_options`` makes the
variants of an ablation sweep from an overrides file. YAML is read by the port's
own reader (``common/yaml_lite.py``, the standard library only), to the values
PyYAML's include loader gives.
"""
from __future__ import annotations

import copy
import itertools
import os
from typing import Any, List, Optional, Tuple

from loner_tpu_torch.common import yaml_lite


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
    """The YAML file, ``!include other.yaml`` resolved relative to the file."""
    return yaml_lite.load_file(filename)


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


def generate_options(
    filename: str,
    overrides: Optional[str],
    run_all_combos: bool = False,
    augmentations: Optional[List[Optional[dict]]] = None,
) -> Tuple[List[Settings], List[str]]:
    """The variants of an ablation sweep and their descriptions.

    The baseline is the config ``filename`` with ``augmentations`` applied in
    order. Each document (list entry) of the ``overrides`` file adds its own
    variants: without ``run_all_combos`` one setting varied at a time (a listed
    leaf sweeps its values, a list of lists is one list-valued setting), with it
    the cross-product of the document's leaves. No overrides, or none that make a
    variant: the baseline alone, described as "". Equal to
    ``loner_tpu/common/settings.py::generate_options`` (settings, descriptions
    and order)."""
    baseline = Settings.load_from_file(filename)
    for changes in augmentations or []:
        baseline.augment(changes)
    if overrides is None:
        return [baseline], [""]

    overrides_docs = yaml_lite.load_file(overrides)
    if not isinstance(overrides_docs, list):
        overrides_docs = [overrides_docs]

    all_options: List[Settings] = []
    all_descriptions: List[str] = []

    def variant(assignments) -> Settings:
        out = copy.deepcopy(baseline)
        for path, value in assignments:
            node = out
            for attr in path[:-1]:
                node = node[attr]
            node[path[-1]] = value
        return out

    for doc in overrides_docs:
        if doc is None:
            continue
        options = [(path, values if isinstance(values, list) else [values])
                   for path, values in generate_change_list(doc)]
        if run_all_combos:
            paths = [o[0] for o in options]
            for combo in itertools.product(*(o[1] for o in options)):
                all_options.append(variant(zip(paths, combo)))
                all_descriptions.append(
                    "\n".join(f"{'.'.join(p)}={v}" for p, v in zip(paths, combo)) + "\n")
        else:
            for path, values in options:
                if values and isinstance(values[0], list):
                    values = [values]
                for value in values:
                    all_options.append(variant([(path, value)]))
                    all_descriptions.append(f"{'.'.join(path)}={value}")

    if not all_options:
        return [baseline], [""]
    return all_options, all_descriptions


# Keys of a sequence config that the runner consumes; the rest pass through
# into the saved settings (the offline tools read them from there).
_SEQUENCE_KEYS = {"baseline", "changes", "dataset", "calibration", "groundtruth_traj",
                  "experiment_name", "dataset_family"}


def load_sequence_config(config_path: str) -> Optional[dict]:
    """A sequence config (``baseline:`` a config path relative to the file,
    ``changes:``, ``dataset:``, ...) split as ``examples/run_loner.py`` splits it:
    {"baseline": the baseline's path, "changes": the overlay or None,
    "passthrough": the keys the runner does not consume (the offline tools read
    them from the saved settings) or None, "raw": the file's dict}. None for a
    plain config."""
    return _split_sequence(_load_yaml_with_includes(config_path), config_path)


def _split_sequence(raw: Any, config_path: str) -> Optional[dict]:
    if not (isinstance(raw, dict) and "baseline" in raw):
        return None
    return {"baseline": os.path.join(os.path.dirname(config_path), raw["baseline"]),
            "changes": raw.get("changes"),
            "passthrough": {k: v for k, v in raw.items() if k not in _SEQUENCE_KEYS} or None,
            "raw": raw}


def load_config(config_path: str) -> Tuple[Settings, Optional[str]]:
    """Settings from a config file, and the dataset path it names (or None).

    A plain config loads as it is. A sequence config loads its baseline and
    applies the pass-through keys, then the changes (``load_sequence_config``),
    as ``examples/run_loner.py`` does."""
    raw = _load_yaml_with_includes(config_path)
    seq = _split_sequence(raw, config_path)
    if seq is None:
        return Settings(raw), None
    settings = Settings.load_from_file(seq["baseline"])
    settings.augment(seq["passthrough"])
    settings.augment(seq["changes"])
    return settings, seq["raw"].get("dataset")
