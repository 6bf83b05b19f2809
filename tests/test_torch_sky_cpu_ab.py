"""Sky opacity of both packages on the same open-sky scans, on the CPU.

A one-off comparison, not a test: the open-sky box room (no ceiling; the
generators of both packages give the same scans) through each package's own
single-threaded SLAM at ``cfg/synthetic/box_room_sky.yaml`` and
``box_room_sky_off.yaml``, cut to one reduced width that both run on the CPU
(the overlay ``REDUCED``: the schedule, the sky settings and the 64 sky rays a
slot are the configurations' own), then every run's mean sky opacity through
the port's ``analysis/sky_floaters.py::sky_opacity`` (it loads either
package's checkpoint) and the ratio sky / sky off, against the bar of 0.6.

    JAX_PLATFORMS=cpu python tests/test_torch_sky_cpu_ab.py [--scans 150] [--out DIR] \
        [--seeds 0 1 2]

``--seeds``: the mapper's seeds (``mapper.optimizer.seed``, the random draws of
the mapping iteration in each package), one set of four runs a seed. Prints one
JSON line per run and a summary line with each package's ratios. The file holds
no test function: pytest collects nothing from it.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# The one reduced width of all four runs: fewer LiDAR rays and samples, a
# narrower field and proposal, the bootstrap cut from 1000 to 300 iterations.
REDUCED = {
    "system": {"single_threaded": True},
    "mapper": {"optimizer": {
        "num_samples": {"lidar": 128},
        "keyframe_schedule": [
            {"num_keyframes": 1, "iteration_schedule": [
                {"num_iterations": 300, "freeze_poses": True, "freeze_sigma_mlp": False,
                 "freeze_rgb_mlp": True}]},
            {"num_keyframes": -1, "iteration_schedule": [
                {"num_iterations": 50, "freeze_poses": False, "latest_kf_only": True,
                 "freeze_sigma_mlp": True, "freeze_rgb_mlp": True},
                {"num_iterations": 50, "freeze_poses": False, "freeze_sigma_mlp": False,
                 "freeze_rgb_mlp": True}]}],
        "model_config": {"model": {
            "render": {"N_samples_train": 64},
            "nerf_config": {"fourier_sigma": {"n_freqs": 16},
                            "sigma_network": {"n_neurons": 64}},
            "occ_model": {"proposal": {"n_freqs": 8, "n_neurons": 32}}}}}},
    "tracker": {"icp": {"downsample": {"target_uniform_point_count": 2000}}},
}


def _write_dataset(root: str, n: int) -> None:
    from loner_tpu_torch.datasets import synthetic as syn

    scans, poses, ts, scene, _ = syn.generate_sequence(
        num_scans=n, scene=syn.BoxRoomScene(open_top=True), lidar=syn.VirtualLidar(32, 512))
    syn.write_sequence(root, scans, poses, ts, scene=scene)


def _overlay(out: str, seed: int) -> dict:
    return {**REDUCED, "system": {**REDUCED["system"], "log_dir_prefix": out + "/"},
            "mapper": {"optimizer": {**REDUCED["mapper"]["optimizer"], "seed": seed}}}


def _run_jax(name: str, dataset: str, out: str, seed: int) -> str:
    import run_loner as jrun
    from loner_tpu.common.settings import Settings

    base, changes, passthrough, _ = jrun.load_sequence_config(str(REPO / "cfg/synthetic" / name))
    settings = Settings.load_from_file(base)
    settings.augment(passthrough)
    settings.augment(changes)
    settings.augment(_overlay(out, seed))
    jrun.run_trial(settings, dataset, experiment_name=f"jax_{name[:-5]}_{seed}")
    return os.path.join(out, f"jax_{name[:-5]}_{seed}")


def _run_port(name: str, dataset: str, out: str, seed: int) -> str:
    from loner_tpu_torch.common.settings import load_config
    from loner_tpu_torch.run_loner import run_trial

    settings, _ = load_config(str(REPO / "cfg/synthetic" / name))
    settings.augment(_overlay(out, seed))
    return run_trial(settings, dataset, experiment_name=f"port_{name[:-5]}_{seed}", device="cpu")


def main() -> None:
    sys.path[:0] = [str(REPO), str(REPO / "examples")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    from loner_tpu_torch.analysis.render_utils import load_experiment
    from loner_tpu_torch.analysis.sky_floaters import sky_opacity

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scans", type=int, default=150)
    p.add_argument("--out", default=None)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = p.parse_args()
    torch.set_num_threads(4)
    out = args.out or tempfile.mkdtemp(prefix="sky_cpu_ab_")
    dataset = os.path.join(out, "dataset")
    if not os.path.exists(dataset):
        _write_dataset(dataset, args.scans)
    ratios = {"jax": [], "port": []}
    for seed in args.seeds:
        opacity = {}
        for package, run in (("jax", _run_jax), ("port", _run_port)):
            for name in ("box_room_sky.yaml", "box_room_sky_off.yaml"):
                t0 = time.time()
                log_dir = run(name, dataset, out, seed)
                op = sky_opacity(load_experiment(log_dir, device="cpu"))
                opacity[(package, name)] = float(op.mean())
                print(json.dumps({"package": package, "config": name, "seed": seed,
                                  "log_dir": log_dir, "mean_sky_opacity": float(op.mean()),
                                  "p90_sky_opacity": float(torch.tensor(op).quantile(0.9)),
                                  "seconds": time.time() - t0}), flush=True)
        for package in ratios:
            ratios[package].append(opacity[(package, "box_room_sky.yaml")]
                                   / opacity[(package, "box_room_sky_off.yaml")])
    print(json.dumps({"scans": args.scans, "seeds": args.seeds, "ratio_bar": 0.6,
                      "ratios": ratios,
                      "missed": {k: [r >= 0.6 for r in v] for k, v in ratios.items()}}),
          flush=True)

if __name__ == "__main__":
    main()
