"""The port's runner flags against the JAX package's runner, on the same inputs.

``generate_options`` (settings, descriptions and order) on the repo's overrides
files; the runner's ``--overrides`` / ``--run_all_combos`` / ``--num_repeats``
/ ``--lite`` / ``--precompile`` trials (each run_trial call's settings, indices
and arguments, both runners' ``run_trial`` replaced by a recorder); the
``synthetic`` dataset's directory names and scans; the trial pool
(``--trial_workers``, ``--gpu_ids``: the children's commands and pickled specs,
both runners' ``run_pool`` replaced by a recorder); and what the port refuses:
``--synthetic_dropout`` on the box-room scenes.
"""
import os
import sys

import numpy as np
import pytest

from loner_tpu.common.settings import generate_options as jax_generate_options
from loner_tpu_torch import run_loner as trun
from loner_tpu_torch.common.settings import generate_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "cfg", "synthetic", "box_room.yaml")
OVERRIDES = ["overrides.yaml", "ablation_study.yaml", "kf_selection_ablation.yaml"]


def _jax_runner():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import run_loner

    return run_loner


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("combos", [False, True])
@pytest.mark.parametrize("overrides", OVERRIDES + [None])
def test_generate_options_matches_jax(overrides, combos):
    path = None if overrides is None else os.path.join(REPO, "cfg", overrides)
    aug = [None, {"system": {"precompile": True}}]
    ours, ours_desc = generate_options(BASE, path, combos, augmentations=aug)
    theirs, theirs_desc = jax_generate_options(BASE, path, combos, augmentations=aug)
    assert ours_desc == theirs_desc
    assert [_plain(s) for s in ours] == [_plain(s) for s in theirs]
    assert len({id(s) for s in ours}) == len(ours)  # every variant its own copy
    if overrides == "ablation_study.yaml":
        assert len(ours) == (10 if combos else 13)


def _record(module, monkeypatch):
    calls = []

    def fake_run_trial(settings, dataset_path, **kwargs):
        kwargs.pop("device", None)
        calls.append((_plain(settings), dataset_path, kwargs))
        return "log"

    monkeypatch.setattr(module, "run_trial", fake_run_trial)
    return calls


RUNS = [
    ["ds", BASE],
    ["ds", BASE, "--num_repeats", "3", "--experiment_name", "rep"],
    ["ds", BASE, "--overrides", os.path.join(REPO, "cfg", "ablation_study.yaml"),
     "--num_repeats", "2", "--lite", "--precompile", "--duration", "5"],
    ["ds", BASE, "--overrides", os.path.join(REPO, "cfg", "kf_selection_ablation.yaml"),
     "--run_all_combos"],
    ["ds", os.path.join(REPO, "cfg", "synthetic", "box_room_tpu_rt_r4.yaml"), "--lite"],
    ["auto", os.path.join(REPO, "cfg", "fusion_portable", "canteen.yaml"), "--num_repeats", "2"],
]


@pytest.mark.parametrize("argv", RUNS, ids=range(len(RUNS)))
def test_runner_trials_match_jax(argv, monkeypatch):
    """Every trial's settings (the sweep's variant, the repeat's seed offset,
    --lite and --precompile applied), dataset, experiment name, config and trial
    indices and duration, as the JAX runner passes them."""
    jrun = _jax_runner()
    theirs, ours = _record(jrun, monkeypatch), _record(trun, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["run_loner.py"] + argv)
    jrun.main()
    trun.main(argv)
    assert len(ours) == len(theirs) > 0
    for (s_o, d_o, k_o), (s_t, d_t, k_t) in zip(ours, theirs):
        assert s_o == s_t and d_o == d_t and k_o == k_t
    if "--num_repeats" in argv:
        seeds = [s["mapper"]["optimizer"].get("seed", 0) for s, _, _ in ours]
        n = int(argv[argv.index("--num_repeats") + 1])
        assert seeds[:n] == [seeds[0] + j for j in range(n)]
        assert [k["trial_idx"] for _, _, k in ours[:n]] == list(range(n))
    if "--lite" in argv:
        opt = ours[0][0]["mapper"]["optimizer"]
        assert opt["num_samples"]["lidar"] == 256 and opt["num_samples"]["sky"] == 32
        assert opt["model_config"]["model"]["render"]["N_samples_train"] == 128
        assert opt["model_config"]["model"]["render"]["N_samples_test"] == 256


SYNTHETIC = [
    [],
    ["--synthetic_scans", "40", "--synthetic_camera"],
    ["--synthetic_scene", "open_sky", "--synthetic_noise_std", "0.02"],
    ["--synthetic_scene", "courtyard", "--synthetic_scans", "7"],
    ["--synthetic_scene", "courtyard_actors", "--synthetic_dropout", "0.1",
     "--synthetic_noise_std", "0.05", "--synthetic_camera"],
]


@pytest.mark.parametrize("flags", SYNTHETIC, ids=range(len(SYNTHETIC)))
def test_synthetic_dataset_directory_matches_jax(flags, tmp_path, monkeypatch):
    """The 'synthetic' dataset: the same directory, built with the same
    arguments; the runs get it as their dataset."""
    monkeypatch.chdir(tmp_path)
    jrun = _jax_runner()
    built = {"jax": [], "port": []}
    for name, module in (("jax", jrun), ("port", trun)):
        monkeypatch.setattr(module, "build_synthetic_dataset",
                            lambda path, _n=name, **kw: built[_n].append((path, kw)))
    theirs, ours = _record(jrun, monkeypatch), _record(trun, monkeypatch)
    argv = ["synthetic", BASE] + flags
    monkeypatch.setattr(sys, "argv", ["run_loner.py"] + argv)
    jrun.main()
    trun.main(argv)
    assert ours[0][1] == theirs[0][1] == built["jax"][0][0] == built["port"][0][0]
    assert built["port"][0][1] == built["jax"][0][1]


@pytest.mark.parametrize("scene,camera,noise", [("box_room", True, 0.0),
                                                ("open_sky", False, 0.03)])
def test_build_synthetic_dataset_writes_the_jax_scans(scene, camera, noise, tmp_path):
    jrun = _jax_runner()
    kw = dict(num_scans=3, with_camera=camera, scene_name=scene, noise_std=noise)
    jrun.build_synthetic_dataset(str(tmp_path / "j"), **kw)
    trun.build_synthetic_dataset(str(tmp_path / "t"), **kw)
    assert not os.path.exists(str(tmp_path / "t") + ".partial")
    for sub in ("scans", "images") if camera else ("scans",):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub)) and len(names) == 3
        for name in names:
            a, b = np.load(tmp_path / "t" / sub / name), np.load(tmp_path / "j" / sub / name)
            for key in b.files:
                np.testing.assert_array_equal(a[key], b[key])
    gt_t, gt_j = (np.loadtxt(tmp_path / d / "poses_gt.tum") for d in ("t", "j"))
    np.testing.assert_array_equal(gt_t, gt_j)


@pytest.mark.parametrize("argv,error", [
    (["synthetic", BASE, "--synthetic_dropout", "0.1"], ValueError),
    (["synthetic", BASE, "--synthetic_scene", "open_sky", "--synthetic_dropout", "0.2"],
     ValueError),
])
def test_runner_refuses_what_it_does_not_do(argv, error, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = _record(trun, monkeypatch)
    with pytest.raises(error):
        trun.main(argv)
    assert not calls and not os.path.exists(tmp_path / "outputs")


POOLS = [
    ["ds", BASE, "--num_repeats", "2", "--trial_workers", "2", "--experiment_name", "pool"],
    ["ds", BASE, "--overrides", os.path.join(REPO, "cfg", "ablation_study.yaml"),
     "--trial_workers", "3", "--gpu_ids", "0", "1", "--duration", "4"],
]


@pytest.mark.parametrize("argv", POOLS, ids=["repeats", "sweep_gpu_ids"])
def test_runner_runs_a_trial_pool_as_jax_does(argv, monkeypatch):
    """The trial pool (formerly refused): one child a trial, at most
    --trial_workers at a time, pinned to --gpu_ids; each child's pickled spec
    holds the JAX runner's trial (settings as a plain dict, dataset, names,
    indices, duration); the children take the parent's --device. Without
    --trial_workers, --gpu_ids is not read and the trials run in the process."""
    import pickle

    from loner_tpu.parallel import trial_pool as jpool
    from loner_tpu_torch.parallel import trial_pool as tpool

    jrun = _jax_runner()
    pools = {"jax": [], "port": []}
    for name, module in (("jax", jpool), ("port", tpool)):
        def fake_run_pool(commands, workers, devices=None, on_start=None, _n=name, **kw):
            specs = []
            for cmd in commands:
                with open(cmd[cmd.index("--_trial_spec") + 1], "rb") as f:
                    specs.append(pickle.load(f))
            pools[_n].append((specs, workers, devices, commands))
            return [tpool.TrialResult(i, 0, None, 0.0) for i in range(len(commands))]
        monkeypatch.setattr(module, "run_pool", fake_run_pool)
    theirs, ours = _record(jrun, monkeypatch), _record(trun, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["run_loner.py"] + argv)
    jrun.main()
    trun.main(argv + ["--device", "cpu"])
    assert not ours and not theirs  # every trial went to the pool
    (specs_t, workers_t, devs_t, cmds_t), = pools["port"]
    (specs_j, workers_j, devs_j, _), = pools["jax"]
    assert workers_t == workers_j == int(argv[argv.index("--trial_workers") + 1])
    assert devs_t == devs_j == (["0", "1"] if "--gpu_ids" in argv else None)
    assert len(specs_t) == len(specs_j) > 1
    for a, b in zip(specs_t, specs_j):
        assert _plain(a) == _plain(b)
    assert all(cmd[-2:] == ["--device", "cpu"] for cmd in cmds_t)
    # --gpu_ids alone: the trials run here, one after another.
    trun.main(["ds", BASE, "--gpu_ids", "0", "1"])
    assert len(ours) == 1
