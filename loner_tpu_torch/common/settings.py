"""Settings tree: a dict with recursive attribute access.

Counterpart of ``loner_tpu/common/settings.py::Settings`` without the YAML
loader: an experiment's settings arrive as ``full_config.pkl``, a pickled
plain dict, and nothing on the port's path parses YAML.
"""
from __future__ import annotations

import copy
from typing import Any


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

    def as_plain_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(val) for k, val in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)
