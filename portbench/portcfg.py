"""The port's configuration objects from a configuration file (``configs/<name>.json``).

A file's ``optimizer`` and ``field`` groups hold every field of the port's
``OptimizerConfig`` and ``FieldConfig`` under its own name (nested groups as
nested objects, dtypes by name), as the port reads them from the YAML the file
names under ``from``; ``phase`` is the joint phase of the keyframe schedule.
"""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _build(cls, data: dict):
    """``cls`` from ``data``: a field whose default is a dataclass is built from
    its nested object, a dtype from its name, a tuple from its list."""
    defaults = cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            raise KeyError(f"{cls.__name__}.{f.name} is missing from the configuration file")
        value, default = data[f.name], getattr(defaults, f.name)
        if dataclasses.is_dataclass(default):
            value = _build(type(default), value)
        elif isinstance(default, torch.dtype):
            value = DTYPES[value]
        elif isinstance(default, tuple):
            value = tuple(value)
        kwargs[f.name] = value
    unknown = set(data) - set(kwargs)
    if unknown:
        raise KeyError(f"{cls.__name__} has no field {sorted(unknown)}")
    return cls(**kwargs)


def build(config: dict):
    """(OptimizerConfig, FieldConfig, PhaseSettings) of a configuration file."""
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig, PhaseSettings
    from loner_tpu_torch.models.field import FieldConfig

    return (_build(OptimizerConfig, config["optimizer"]), _build(FieldConfig, config["field"]),
            PhaseSettings.from_dict(config["phase"]))
