"""Where the time of one mapping iteration goes, on one CUDA card.

    python3 -m loner_tpu_torch.analysis.profile_iteration [--config reference|flagship]
        [--window 8] [--iters 20] [--freeze-poses]

Builds the mapper's joint iteration through ``make_phase_runner`` on a synthetic
window of ``--window`` keyframes (65,536 unit directions and depths in [1.5, 9.5]
m each, from a seed) at the configuration's widths, then:

* host ms per iteration over ``--iters`` iterations (host clock around the
  phase, ending in ``torch.cuda.synchronize()``), after a 3-iteration warm-up;
* a ``torch.profiler`` trace (CPU and CUDA) of 5 iterations: device ms per
  iteration by kernel name (the 15 largest), the sum over all kernels, and the
  device's busy share of the traced wall time (kernel time over wall; the
  profiler's own overhead stretches the wall, so the share is a lower bound).

``reference`` is cfg/defaults.yaml's model (hash grid 16 x 2 at 2^18, 64-wide
MLP, OGM sampler, bf16 training encode); ``flagship`` the Fourier field and
proposal sampler of cfg/synthetic/box_room_tpu_rt_r4.yaml. ``--freeze-poses``
runs the phase with frozen poses, as the W=1 bootstrap of KF#1 does
(``--window 1 --freeze-poses``). Prints the card's name and power limit, then
one JSON line. ``profile`` is the same measurement as a function; it imports
the package only inside, so ``ab_compare.py`` runs it against either checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def configs(name: str):
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig
    from loner_tpu_torch.models.field import FieldConfig, FourierConfig, MLPConfig
    from loner_tpu_torch.models.proposal import ProposalConfig

    if name == "reference":  # the dataclasses' defaults are cfg/defaults.yaml's
        return OptimizerConfig(n_sky_samples=0), FieldConfig()
    cfg = OptimizerConfig(
        n_sky_samples=0, ray_range=(0.5, 14.0), samples_strategy="PROPOSAL", lr_sigma=0.005,
        prop_n_ctrl=33, prop_train_subsample=8,
        proposal=ProposalConfig(n_freqs=16, scale=3.0, n_neurons=64, n_hidden_layers=2))
    field_cfg = FieldConfig(
        encoding_sigma="fourier", fourier_sigma=FourierConfig(n_freqs=48, scale=6.0),
        sigma_mlp=MLPConfig(n_neurons=256, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=torch.bfloat16)
    return cfg, field_cfg


def profile(config: str = "reference", window: int = 8, iters: int = 20,
            freeze_poses: bool = False) -> dict:
    """The measurement of the module docstring, on cuda:0; returns its record."""
    from loner_tpu_torch.mapping.optimizer import Optimizer, PhaseSettings, make_phase_runner
    from loner_tpu_torch.mapping.rays import build_window_buffers

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, field_cfg = configs(config)
    w = window
    rng = np.random.default_rng(0)
    dirs, depths = [], []
    for _ in range(w):
        d = rng.normal(size=(3, 65536))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        dirs.append(d.astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, 65536).astype(np.float32))
    buffers = build_window_buffers(dirs, depths, [None] * w, w, device=dev)
    opt = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev)  # for its initial state only
    state = opt.state
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32)).to(dev)
    run = make_phase_runner(cfg, field_cfg, PhaseSettings(freeze_poses=freeze_poses), w,
                            buffers.dirs.shape[1], buffers.sky_dirs.shape[1], dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    common = (twists, buffers, torch.ones(w, device=dev), torch.tensor(12.0, device=dev),
              torch.zeros(3, device=dev))

    def phase(n: int, step0: int = 1):
        return run(state.field_params, state.occ_grid, *common, step0, gen, num_iterations=n)

    phase(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase(iters)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters

    n_prof = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        phase(n_prof)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {
        "config": config, "window": w, "freeze_poses": freeze_poses,
        "points": w * cfg.n_lidar_samples * cfg.n_samples_per_ray,
        "host_ms_per_iteration": host_ms, "device_ms_per_iteration": device_ms / n_prof,
        "device_busy_share_traced": device_ms / wall_ms, "kernel_launches_per_iteration":
            sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / n_prof,
        "top_kernels_ms_per_iteration": {k[:90]: v / n_prof for k, v in top},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=("reference", "flagship"), default="reference")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--freeze-poses", action="store_true",
                        help="frozen poses, as the W=1 bootstrap")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_iteration needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(profile(args.config, args.window, args.iters, args.freeze_poses)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
