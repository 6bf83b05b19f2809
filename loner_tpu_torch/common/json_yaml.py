"""YAML files written as JSON text, with no YAML writer.

The port's runtime (``full_config.yaml``, ``world_cube.yaml``) and its metric
writers (``metrics/statistics.yaml``, ``metrics/l1.yaml``, ``regression.yaml``)
write JSON text that ``yaml.safe_load`` reads back to the same values: every
float is spelled with a decimal point, and a non-finite float (the mean of an
empty cloud) as YAML's ``.nan``, ``.inf`` or ``-.inf``, which
``read_json_yaml`` reads too. The port reads and writes YAML without PyYAML.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np

from loner_tpu_torch.common import yaml_lite

# A JSON string (kept as it is), or a YAML non-finite float outside one.
_STRING_OR_NON_FINITE = re.compile(r'"(?:\\.|[^"\\])*"|(-?)\.(nan|inf)\b')
_JSON_NON_FINITE = {("", "nan"): "NaN", ("", "inf"): "Infinity", ("-", "inf"): "-Infinity"}


def _json_text(value) -> str:
    """JSON text that YAML 1.1 loaders read to the same values: floats always
    carry a decimal point (``1.0e-08``, not ``1e-08``, which PyYAML reads as a
    string); mappings in key order, as ``yaml.safe_dump`` writes them."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_json_text(v)}"
                               for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_json_text(v) for v in value) + "]"
    if isinstance(value, (bool, np.bool_)) or value is None:
        return json.dumps(None if value is None else bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(float(value))
        return text.replace("e", ".0e") if "e" in text and "." not in text else text
    return json.dumps(str(value))


def write_json_yaml(path: str, value) -> None:
    """``value`` as one line of JSON text."""
    with open(path, "w") as f:
        f.write(_json_text(value) + "\n")


def read_json_yaml(path: str):
    """A metrics file: JSON text as this module writes it, else YAML (a file
    the JAX package wrote), read by the port's own YAML reader."""
    with open(path) as f:
        text = f.read()
    json_text = _STRING_OR_NON_FINITE.sub(
        lambda m: m.group(0) if m.group(2) is None else _JSON_NON_FINITE[m.group(1, 2)], text)
    try:
        return json.loads(json_text)
    except json.JSONDecodeError:
        return yaml_lite.loads(text, path)
