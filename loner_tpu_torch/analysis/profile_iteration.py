"""Where the time of one mapping iteration goes, on one CUDA card.

    python3 -m loner_tpu_torch.analysis.profile_iteration
        [--config reference|flagship|sky|camera]
        [--window 8] [--iters 20] [--freeze-poses] [--graphs | --eager]

Builds the mapper's joint iteration through ``make_phase_runner`` on a synthetic
window of ``--window`` keyframes (65,536 unit directions and depths in [1.5, 9.5]
m each, from a seed) at the configuration's widths, then:

* host ms per iteration over ``--iters`` iterations (host clock around the
  phase, ending in ``torch.cuda.synchronize()``), after a 3-iteration warm-up
  (with graphs, the warm-up phase captures the program);
* a ``torch.profiler`` trace (CPU and CUDA) of 10 iterations: device ms per
  iteration by kernel name (the 15 largest), the sum over all kernels
  (``device_events``: host ranges that the trace reports again on the device,
  such as the eager Adam step's, are left out), the
  device's busy share of the traced wall time (kernel time over wall; the
  profiler's own overhead stretches the wall, so the share is a lower bound),
  kernel launches per iteration and, with graphs, graph launches per dispatch.

``--graphs`` (the default) replays the captured iteration, k =
``steps_per_dispatch`` replays a dispatch, as the mapper runs it; ``--eager``
runs the same iterations eagerly (``make_phase_runner(..., graphs=False)``).
``reference`` is cfg/defaults.yaml's model (hash grid 16 x 2 at 2^18, 64-wide
MLP, OGM sampler, bf16 training encode; k = 10, 2 dispatches in flight);
``flagship`` the Fourier field and proposal sampler of
cfg/synthetic/box_room_tpu_rt_r4.yaml (k = 3, 1 in flight); ``sky`` the
flagship with 64 sky rays a slot (cfg/synthetic/box_room_sky.yaml; 2048 sky
directions a slot); ``camera`` cfg/synthetic/box_room_tpu_camera_r5.yaml, its
intensity head trained from 128 camera rays a slot of random 96 x 64 images. ``--freeze-poses``
runs the phase with frozen poses, as the W=1 bootstrap of KF#1 does
(``--window 1 --freeze-poses``). Prints the card's name and power limit, then
one JSON line. ``profile`` is the same measurement as a function; it imports
the package only inside, so ``ab_compare.py`` runs it against either checkout
(one whose ``make_phase_runner`` takes no ``graphs`` runs its own loop).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SKY_RAYS = 64  # sky rays a slot of ``sky`` (cfg/synthetic/box_room_sky.yaml)
SKY_DIRS = 2048  # sky directions a slot of its window

def configs(name: str):
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig
    from loner_tpu_torch.models.field import FieldConfig, FourierConfig, MLPConfig
    from loner_tpu_torch.models.proposal import ProposalConfig

    if name == "reference":  # the dataclasses' defaults are cfg/defaults.yaml's
        return OptimizerConfig(n_sky_samples=0), FieldConfig()
    if name == "camera":
        from loner_tpu_torch.common.settings import load_config

        settings, _ = load_config(os.path.join(REPO, "cfg", "synthetic",
                                               "box_room_tpu_camera_r5.yaml"))
        opt = settings.mapper.optimizer
        return (OptimizerConfig.from_settings(opt, opt.model_config),
                FieldConfig.from_settings(opt.model_config.model.nerf_config))
    # box_room_tpu_rt_r4.yaml's dispatch knobs (a checkout before them reads neither).
    dispatch = {"steps_per_dispatch": 3}
    if "max_inflight_dispatches" in {f.name for f in dataclasses.fields(OptimizerConfig)}:
        dispatch["max_inflight_dispatches"] = 1
    cfg = OptimizerConfig(
        n_sky_samples=0, ray_range=(0.5, 14.0), samples_strategy="PROPOSAL", lr_sigma=0.005,
        prop_n_ctrl=33, prop_train_subsample=8, **dispatch,
        proposal=ProposalConfig(n_freqs=16, scale=3.0, n_neurons=64, n_hidden_layers=2))
    field_cfg = FieldConfig(
        encoding_sigma="fourier", fourier_sigma=FourierConfig(n_freqs=48, scale=6.0),
        sigma_mlp=MLPConfig(n_neurons=256, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=torch.bfloat16)
    if name == "sky":
        cfg = dataclasses.replace(cfg, enable_sky=True, n_sky_samples=SKY_RAYS)
    return cfg, field_cfg


def device_events(prof) -> list:
    """The kernels (and copies, memsets) a ``torch.profiler`` trace saw on the
    card: its CUDA events less the host ranges it reports again on the device
    (``record_function``'s, such as the eager Adam step's
    "Optimizer.step#Adam.step"), which span kernels counted already."""
    events = prof.events()
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in host]


def camera_window(w: int, num_colors: int, dev):
    """Static camera buffers of ``w`` slots: random 96 x 64 images through the
    virtual camera of cfg/synthetic/box_room_tpu_camera_r5.yaml."""
    from loner_tpu_torch.common.camera import get_ray_directions
    from loner_tpu_torch.datasets.synthetic import VirtualCamera
    from loner_tpu_torch.mapping.rays import build_camera_window_buffers

    camera = VirtualCamera()
    cam_dirs, _, _ = get_ray_directions(camera.height, camera.width, camera.k)
    rng = np.random.default_rng(4)
    images = [rng.uniform(size=(camera.height, camera.width, num_colors)).astype(np.float32)
              for _ in range(w)]
    return build_camera_window_buffers(images, cam_dirs,
                                       camera.lidar_to_camera().matrix.astype(np.float32), w,
                                       num_colors, dev)


def profile(config: str = "reference", window: int = 8, iters: int = 20,
            freeze_poses: bool = False, graphs: bool = True) -> dict:
    """The measurement of the module docstring, on cuda:0; returns its record."""
    import inspect

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
    sky = [None] * w
    if cfg.enable_sky:
        sky_rng = np.random.default_rng(1)
        for i in range(w):
            u = sky_rng.normal(size=(3, SKY_DIRS))
            u[2] = np.abs(u[2]) + 0.5
            sky[i] = (u / np.linalg.norm(u, axis=0, keepdims=True)).astype(np.float32)
    buffers = build_window_buffers(dirs, depths, sky, w, device=dev)
    opt = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev)  # for its initial state only
    state = opt.state
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32)).to(dev)
    has_graphs = "graphs" in inspect.signature(make_phase_runner).parameters
    if graphs and not has_graphs:
        raise ValueError("this checkout's make_phase_runner has no CUDA graphs")
    kwargs = {"graphs": graphs} if has_graphs else {}
    camera = config == "camera"
    if camera:
        kwargs["camera"] = camera_window(w, field_cfg.num_colors, dev)
    run = make_phase_runner(cfg, field_cfg,
                            PhaseSettings(freeze_poses=freeze_poses, freeze_rgb_mlp=not camera), w,
                            buffers.dirs.shape[1], buffers.sky_dirs.shape[1], dev, **kwargs)
    gen = torch.Generator(device=dev).manual_seed(1)
    common = (twists, buffers, torch.ones(w, device=dev), torch.tensor(12.0, device=dev),
              torch.zeros(3, device=dev))

    def phase(n: int, step0: int = 1):
        return run(state.field_params, state.occ_grid, *common, step0, gen, num_iterations=n,
                   **({"camera": kwargs["camera"]} if camera else {}))

    phase(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase(iters)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters

    n_prof = 10
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        phase(n_prof)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(prof)
    kernels = {}  # by the first 90 characters of the name
    for e in events:
        kernels[e.name[:90]] = kernels.get(e.name[:90], 0.0) + e.device_time_total / 1e3
    graph_launches = sum(1 for e in prof.events() if e.name == "cudaGraphLaunch")
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    k = max(int(cfg.steps_per_dispatch), 1) if has_graphs else 1
    return {
        "config": config, "window": w, "freeze_poses": freeze_poses,
        "graphs": bool(graphs and has_graphs), "steps_per_dispatch": k,
        "points": w * (cfg.n_lidar_samples + (SKY_RAYS if cfg.enable_sky else 0)
                       + (cfg.n_camera_samples if camera else 0)) * cfg.n_samples_per_ray,
        "host_ms_per_iteration": host_ms, "device_ms_per_iteration": device_ms / n_prof,
        "device_busy_share_traced": device_ms / wall_ms,
        "kernel_launches_per_iteration": len(events) / n_prof,
        "graph_launches_per_dispatch": graph_launches / n_prof * k,  # of k iterations
        "top_kernels_ms_per_iteration": {name: v / n_prof for name, v in top},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=("reference", "flagship", "sky", "camera"),
                        default="reference")
    parser.add_argument("--window", type=int, default=8)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--freeze-poses", action="store_true",
                        help="frozen poses, as the W=1 bootstrap")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--graphs", dest="graphs", action="store_true", default=True,
                      help="replay the captured iteration (the default)")
    mode.add_argument("--eager", dest="graphs", action="store_false",
                      help="run the iterations eagerly")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_iteration needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(profile(args.config, args.window, args.iters, args.freeze_poses,
                             args.graphs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
