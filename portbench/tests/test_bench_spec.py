"""BENCHMARK.json against the contract, and every file it names found by name."""
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of
    # compiling a cell and 1200 s spare within 43200 s.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    entry = harness.find(SPEC["workloads"], cell, "workload")
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    config = harness.find(SPEC["configs"], entry["config"], "config")
    assert config["file"] == f"portbench/configs/{entry['config']}.json"
    traffic = harness.load_json(harness.PKG / "traffic" / f"{entry['traffic']}.json")
    assert (harness.PKG / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = harness.load_json(harness.PKG / "limits" / f"{cell}.json")
    assert limits["limits"] and all(v > 0 for v in limits["limits"].values())
    e2e = harness.end_to_end_names(SPEC, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_names(SPEC, cell)
    assert layer
    for name in layer:
        assert callable(harness.load_metric(name).read)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_yaml_as_the_port_reads_it(name):
    """Each configuration file holds what the port reads from the YAML it names,
    key for key, and the Fourier projections of the port's fixture."""
    import dataclasses

    import numpy as np
    import torch

    from loner_tpu_torch.common.settings import load_config
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig
    from loner_tpu_torch.models.field import FieldConfig, _unscaled_bmat
    from portbench import portcfg

    entry = harness.find(SPEC["configs"], name, "config")
    config = harness.load_json(harness.ROOT / entry["file"])
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"] == []
    settings, _ = load_config(str(harness.ROOT / config["from"]))
    opt = settings.mapper.optimizer
    want_opt = dataclasses.replace(
        OptimizerConfig.from_settings(opt, opt.model_config),
        window_size=int(settings.mapper.keyframe_manager.window_selection.window_size))
    want_field = FieldConfig.from_settings(opt.model_config.model.nerf_config,
                                           int(opt.model_config.model.num_colors))
    got_opt, got_field, phase = portcfg.build(config)
    assert got_opt == want_opt and got_field == want_field
    assert phase.num_iterations == opt.keyframe_schedule[-1]["iteration_schedule"][-1][
        "num_iterations"]
    assert config["compute_dtype"] == str(got_field.compute_dtype).replace("torch.", "")
    for key, rows in config["bmats"].items():
        seed, n = (int(x) for x in key.split("_"))
        assert np.array_equal(np.asarray(rows, np.float32), _unscaled_bmat(seed, n))
    assert torch.float32 in portcfg.DTYPES.values()
