#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (loner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card; imports
nothing of JAX. Phases, each of which raises on failure:

1. Device: no CUDA card, no run. Prints the card's name and power limit.
2. Build: compiles the CUDA sources of loner_tpu_torch/csrc into build/, one
   nvcc process per source, all started together.
3. Kernels: the fused Fourier-MLP forward and backward kernels against their
   plain PyTorch version on the card, at the flagship shapes (2,097,152
   points, 48 frequencies, 99 -> 256 -> 256 -> 1, bf16), each timed with CUDA
   events beside the plain version.
4. Slice: the mapper's joint pose+map iteration at the flagship configuration
   (8 keyframes x 512 rays x 512 samples) through ``make_phase_runner``, with
   the kernels' launch counts; then one iteration's loss and twist gradient
   through the kernels against the plain sigma path, on the same draws.
5. Composite kernel: the fused alpha-compositing kernel against its plain
   version at 16384 rays x 1024 and 2048 samples (relu, softplus, an opaque
   wall), each timed with CUDA events beside the plain version.
6. Experiment: a temporary experiment directory (full_config.pkl with the
   flagship settings, checkpoints/final.tar from the port's save_checkpoint)
   holding the slice's trained field and proposal and 8 keyframe poses.
7. Render slice: ``render_full_map`` with its defaults (8 poses x 65,536 rays x
   1024 samples, 2048-ray chunks) through the composite and Fourier forward
   kernels, with their launch counts; the render layers of one chunk; one
   512 x 256 spherical depth frame at 2048 samples.
8. Render against plain: one virtual scan through the kernels and through the
   plain sigma path and plain compositor, depth and variance compared.
9. SLAM: a box-room sequence (``SLAM_SCANS`` scans of a 32 x 512 virtual
   LiDAR at 10 Hz) through ``loner_tpu_torch.run_loner.run_trial``, threaded,
   on cuda:0, at the flagship SLAM settings (cfg/synthetic/box_room_tpu_rt_r4.yaml
   as a plain dict): the real-time factor, ms per mapping iteration, the
   tracking latency, peak device memory and the kernels' launch counts; ATE of
   both trajectories against the ground truth; the map's depth (one virtual
   scan of ``render_full_map`` at the first keyframe) against the analytic
   raycast of the scene; the ICP of one frame pair on the card against the
   CPU, with no host synchronisation in a dispatch.

The second-to-last line of output is a JSON record of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# bf16 tolerances of kernel against plain version, both on the card. They
# differ only in f32 summation order, which flips a bf16 rounding or a ReLU
# mask now and then: at 2.1 M points the forward's largest difference is a few
# bf16 ulps of sigma, and one flipped mask moves one point's position gradient
# by ~10%, so gradients are held to a relative L2 error.
FWD_MAX_ABS = 5e-2  # sigma is O(1)-O(10); 5e-2 is ~2 bf16 ulps at 8
GRAD_REL_L2 = 1e-2  # ||kernel - plain|| / ||plain|| for dW, db and dpts
LOSS_RTOL = 1e-3  # the slice's loss, kernel vs plain sigma path
TWIST_GRAD_REL_L2 = 2e-2  # the slice's twist gradient, kernel vs plain
# Composite kernel against its plain version, f32 (the warp scan multiplies in
# another order than cumprod): (rtol, atol), the tolerances of
# tests/test_pallas_ops.py:31-34.
COMPOSITE_TOL = {"depth": (2e-4, 2e-4), "opacity": (2e-4, 2e-4), "var": (1e-3, 2e-4),
                 "weights": (5e-3, 2e-4)}
# One virtual scan, kernels against the plain path, on finite rays with depth in
# [near, far]: sigma differs by a bf16 ulp at rare points (f32 summation order)
# and compositing in f32 rounding. Measured on an H100: median 1.6e-7, p99
# 6.4e-7; variance p99 1.2e-7. The bounds leave two orders of magnitude.
RENDER_DEPTH_MEDIAN = 1e-5  # median |depth_k - depth_p| / (far - near)
RENDER_DEPTH_P99 = 1e-4  # 99th percentile of the same
RENDER_VAR_P99 = 1e-4  # 99th percentile of |var_k - var_p| / (far - near)^2

WINDOW = 8  # keyframes in the flagship window
RAY_RANGE = (1.0, 10.0)  # meters, cfg/model_config/tpu_native_model_config.yaml
WORLD_CUBE = {"scale_factor": 12.0, "shift": [0.0, 0.0, 0.0]}
# cfg/nerf_config/tpu_fourier.yaml as a plain dict (the card's machine has no PyYAML).
FLAGSHIP_NERF = {
    "enable_view_dependence": True, "encoding_sigma": "fourier", "compute_dtype": "bfloat16",
    "sigma_kernel": "xla",
    "fourier_sigma": {"n_freqs": 48, "scale": 6.0, "include_input": True, "seed": 1234,
                      "encode_impl": "vjp"},
    "dir_encoding_intensity": {"degree": 4, "otype": "SphericalHarmonics"},
    "intensity_network": {"activation": "ReLU", "n_hidden_layers": 4, "n_neurons": 64,
                          "otype": "MLP", "output_activation": "None"},
    "pos_encoding_intensity": {"base_resolution": 16, "log2_hashmap_size": 19,
                               "n_features_per_level": 2, "n_levels": 16, "otype": "HashGrid"},
    "sigma_network": {"activation": "ReLU", "n_hidden_layers": 2, "n_neurons": 256,
                      "otype": "MLP", "output_activation": "None"},
}


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()).clamp_min(1e-30))


def flagship_configs():
    from loner_tpu_torch.mapping.loss import LossConfig
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig
    from loner_tpu_torch.models.field import (
        FieldConfig, FourierConfig, HashEncodingConfig, MLPConfig,
    )
    from loner_tpu_torch.models.proposal import ProposalConfig

    # cfg/model_config/tpu_native_model_config.yaml + cfg/nerf_config/tpu_fourier.yaml,
    # as bench.py builds them, with the sigma head on the fused Fourier-MLP path.
    cfg = OptimizerConfig(
        n_lidar_samples=512, n_sky_samples=0, n_samples_per_ray=512,
        ray_range=(1.0, 10.0), samples_strategy="PROPOSAL", lr_sigma=0.005, lr_pose=0.001,
        prop_lr=1e-3, lr_gamma=1.0, perturb=1.0, raw_noise_std=1.0, prop_n_ctrl=33,
        prop_train_subsample=8,
        proposal=ProposalConfig(n_freqs=16, scale=3.0, n_neurons=64, n_hidden_layers=2),
        loss=LossConfig(loss_selection="L1_JS"),
    )
    field_cfg = FieldConfig(
        encoding_sigma="fourier", fourier_sigma=FourierConfig(n_freqs=48, scale=6.0),
        sigma_mlp=MLPConfig(n_neurons=256, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=torch.bfloat16,
        pos_encoding_intensity=HashEncodingConfig(log2_hashmap_size=19),
    )
    return cfg, field_cfg


def check_kernels(dev, field_cfg) -> list:
    from loner_tpu_torch.models.field import fourier_bmat, init_field_params
    from loner_tpu_torch.ops import fourier_mlp as fm

    n = 8 * 512 * 512
    gen = torch.Generator(device=dev).manual_seed(11)
    mlp = init_field_params(gen, field_cfg, dev)["sigma"]["mlp"]
    n_layers = sum(1 for k in mlp if k.startswith("w"))
    ws = [mlp[f"w{i}"] for i in range(n_layers)]
    # Non-zero biases, so the bias adds are checked too.
    bs = [torch.randn(mlp[f"b{i}"].shape, generator=gen, device=dev) * 0.1 for i in range(n_layers)]
    bmat = fourier_bmat(field_cfg.fourier_sigma, dev)
    pts01 = torch.rand((n, 3), generator=gen, device=dev)
    dout = torch.randn((n, 1), generator=gen, device=dev) / n ** 0.5
    bf = torch.bfloat16

    out_k = fm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, bf)
    out_p = fm.fourier_mlp_fwd_plain(ws, bs, bmat, pts01, bf)
    torch.cuda.synchronize()
    if out_k.shape != (n, 1) or not torch.isfinite(out_k).all():
        raise RuntimeError("forward kernel: wrong shape or non-finite output")
    fwd_err = float((out_k - out_p).abs().max())
    print(f"kernel fourier_mlp_fwd: max |kernel - plain| {fwd_err:.3e} "
          f"(tolerance {FWD_MAX_ABS}), sigma range {float(out_p.abs().max()):.3e}", flush=True)
    if not fwd_err <= FWD_MAX_ABS:
        raise RuntimeError(f"forward kernel disagrees with its plain version: {fwd_err}")

    dws_k, dbs_k, dpts_k = fm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, bf)
    dws_p, dbs_p, dpts_p = fm.fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, bf)
    torch.cuda.synchronize()
    pairs = [(f"dw{i}", a, b) for i, (a, b) in enumerate(zip(dws_k, dws_p))]
    pairs += [(f"db{i}", a, b.reshape(a.shape)) for i, (a, b) in enumerate(zip(dbs_k, dbs_p))]
    pairs.append(("dpts", dpts_k, dpts_p))
    bwd_err = 0.0
    for name, a, b in pairs:
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"backward kernel: {name} has the wrong shape or is non-finite")
        err, rel = float((a - b).abs().max()), rel_l2(a, b)
        bwd_err = max(bwd_err, err)
        print(f"kernel fourier_mlp_bwd: {name} {tuple(a.shape)} max |err| {err:.3e} "
              f"rel L2 {rel:.3e} (tolerance {GRAD_REL_L2})", flush=True)
        if not rel <= GRAD_REL_L2:
            raise RuntimeError(f"backward kernel disagrees with its plain version on {name}: {rel}")

    times = {
        "fwd": cuda_ms(lambda: fm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, bf)),
        "fwd_plain": cuda_ms(lambda: fm.fourier_mlp_fwd_plain(ws, bs, bmat, pts01, bf)),
        "bwd": cuda_ms(lambda: fm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, bf)),
        "bwd_plain": cuda_ms(lambda: fm.fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, bf)),
    }
    print(f"kernel times at N={n} (median of 5, ms): " + json.dumps(times), flush=True)
    src = "loner_tpu_torch/csrc/fourier_mlp.cu"
    return [
        {"name": "fourier_mlp_fwd", "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:52", "launches": 0,
         "max_abs_err": fwd_err, "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "fourier_mlp_bwd", "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:80", "launches": 0,
         "max_abs_err": bwd_err, "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]


def run_slice(dev, cfg, field_cfg, n_iters: int = 20, w: int = WINDOW) -> dict:
    from dataclasses import replace

    from loner_tpu_torch.mapping.optimizer import (
        PhaseSettings, draw_step, iteration_loss, make_phase_runner,
    )
    from loner_tpu_torch.mapping.rays import build_window_buffers
    from loner_tpu_torch.models.field import init_field_params
    from loner_tpu_torch.models.proposal import init_proposal_params
    from loner_tpu_torch.ops import fourier_mlp as fm

    rng = np.random.default_rng(0)
    dirs, depths = [], []
    for _ in range(w):
        d = rng.normal(size=(3, 65536))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        dirs.append(d.astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, 65536).astype(np.float32))
    buffers = build_window_buffers(dirs, depths, [None] * w, w, device=dev)
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32)).to(dev)
    params = init_field_params(torch.Generator(device=dev).manual_seed(0), field_cfg, dev)
    prop = init_proposal_params(torch.Generator(device=dev).manual_seed(5), cfg.proposal, dev)
    world_scale = torch.tensor(12.0, device=dev)
    world_shift = torch.zeros(3, device=dev)
    pose_mask = torch.ones(w, device=dev)
    phase = PhaseSettings(num_iterations=n_iters)
    run_phase = make_phase_runner(cfg, field_cfg, phase, w, buffers.dirs.shape[1],
                                  buffers.sky_dirs.shape[1], dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    # Warm-up (cuBLAS handles, allocator), then the measured run.
    run_phase(params, prop, twists, buffers, pose_mask, world_scale, world_shift, 0, gen,
              num_iterations=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fm.counts.reset()
    t0 = time.perf_counter()
    new_field, new_prop, new_twists, losses, eps = run_phase(
        params, prop, twists, buffers, pose_mask, world_scale, world_shift, 0, gen,
        num_iterations=n_iters,
    )
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"fourier_mlp_fwd": fm.counts.fwd_launches, "fourier_mlp_bwd": fm.counts.bwd_launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    if losses.shape != (n_iters,) or eps.shape != (n_iters,):
        raise RuntimeError(f"run_phase returned {tuple(losses.shape)} losses for {n_iters} iterations")
    for name, t in [("losses", losses), ("depth_eps", eps), ("twists", new_twists)] + [
        (f"sigma {k}", v) for k, v in new_field["sigma"]["mlp"].items()
    ] + [(f"proposal {k}", v) for k, v in new_prop.items()]:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"non-finite {name} after {n_iters} iterations")
    if new_twists.shape != twists.shape:
        raise RuntimeError("twists changed shape")
    for name, count in launches.items():
        if count < n_iters:
            raise RuntimeError(f"{name} launched {count} times in {n_iters} iterations")
    ms_it = 1e3 * elapsed / n_iters
    rays = w * cfg.n_lidar_samples
    print(f"slice: {n_iters} iterations, {ms_it:.3f} ms/iteration, "
          f"{rays / (ms_it / 1e3):.1f} mapped rays/s, {rays * cfg.n_samples_per_ray} field "
          f"points/iteration, peak device memory {peak_gb:.3f} GB, launches {launches}, "
          f"losses first/last {float(losses[0]):.4f}/{float(losses[-1]):.4f}", flush=True)

    # One iteration, kernel against plain sigma path: same params, same draws.
    draws = draw_step(torch.Generator(device=dev).manual_seed(2), cfg, w, dev)
    results = {}
    for name, fc in (("kernel", field_cfg), ("plain", replace(field_cfg, sigma_kernel="plain"))):
        tw = twists.clone().requires_grad_(True)
        total, aux = iteration_loss(cfg, fc, params["sigma"], prop, tw, params["intensity"],
                                    buffers, world_scale, world_shift, draws)
        (g,) = torch.autograd.grad(total, tw)
        results[name] = (float(aux["loss"].detach()), g)
    (loss_k, g_k), (loss_p, g_p) = results["kernel"], results["plain"]
    loss_rel, grad_rel = abs(loss_k - loss_p) / abs(loss_p), rel_l2(g_k, g_p)
    print(f"slice kernel vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, "
          f"tolerance {LOSS_RTOL}); twist grad rel L2 {grad_rel:.2e} "
          f"(tolerance {TWIST_GRAD_REL_L2})", flush=True)
    if not (np.isfinite(loss_k) and loss_rel <= LOSS_RTOL):
        raise RuntimeError("slice loss: kernel path disagrees with the plain path")
    if not (torch.isfinite(g_k).all() and grad_rel <= TWIST_GRAD_REL_L2):
        raise RuntimeError("slice twist gradient: kernel path disagrees with the plain path")
    return launches, new_field, new_prop


def check_composite(dev) -> dict:
    from loner_tpu_torch.ops import composite as cp

    b, near, far = 16384, RAY_RANGE[0] / 12.0, RAY_RANGE[1] / 12.0
    gen = torch.Generator(device=dev).manual_seed(21)
    worst, times = 0.0, {}
    for s in (1024, 2048):
        u = torch.rand((b, s), generator=gen, device=dev)
        z = torch.sort(near + (far - near) * u, dim=1).values
        sigma = 3.0 * torch.randn((b, s), generator=gen, device=dev)
        wall = torch.zeros_like(sigma)
        wall[: b // 2, s // 2] = 1e8  # half the rays hit an opaque wall mid-ray
        far_t = torch.full((b,), far, device=dev)
        dnorm = 0.9 + 0.2 * torch.rand((b,), generator=gen, device=dev)
        for case, sig, softplus in (("relu", sigma, False), ("softplus", sigma, True),
                                    ("wall", wall, False)):
            out_k = cp.composite_cuda(z, sig, far_t, dnorm, softplus)
            out_p = cp.composite_plain(z, sig, far_t, dnorm, softplus)
            torch.cuda.synchronize()
            errs = []
            for name, a, p in zip(("depth", "opacity", "var", "weights"), out_k, out_p):
                rtol, atol = COMPOSITE_TOL[name]
                if a.shape != p.shape or not torch.isfinite(a).all():
                    raise RuntimeError(f"composite kernel: {name} wrong shape or non-finite")
                err = float((a - p).abs().max())
                errs.append(f"{name} {err:.2e}")
                worst = max(worst, err)
                if not torch.allclose(a, p, rtol=rtol, atol=atol):
                    raise RuntimeError(f"composite kernel disagrees with its plain version: "
                                       f"S={s} {case} {name}, max |err| {err}")
            print(f"kernel composite S={s} {case}: max |kernel - plain| " + ", ".join(errs),
                  flush=True)
        times[s] = (cuda_ms(lambda: cp.composite_cuda(z, sigma, far_t, dnorm, True)),
                    cuda_ms(lambda: cp.composite_plain(z, sigma, far_t, dnorm, True)))
        print(f"kernel composite times at {b} x {s}, softplus (median of 5, ms): "
              f"kernel {times[s][0]:.4f}, plain {times[s][1]:.4f}", flush=True)
    return {"name": "composite", "route": "cuda", "source": "loner_tpu_torch/csrc/composite.cu",
            "replaces": "loner_tpu/ops/pallas/composite.py:27", "launches": 0,
            "max_abs_err": worst, "ms": times[1024][0], "plain_ms": times[1024][1]}


def write_experiment(log_dir: str, field, prop, field_cfg, seed: int = 3) -> None:
    """An experiment directory as a run of the system leaves it: the flagship
    settings in full_config.pkl and checkpoints/final.tar in Mapper.build_ckpt's
    schema, with WINDOW keyframe poses from a seed inside the world cube."""
    import pickle

    from loner_tpu_torch.common.pose import Pose
    from loner_tpu_torch.common.world_cube import WorldCube
    from loner_tpu_torch.mapping.mapper import build_ckpt, save_checkpoint
    from loner_tpu_torch.models.field import FieldConfig

    if FieldConfig.from_settings(FLAGSHIP_NERF, 3) != field_cfg:
        raise RuntimeError("FLAGSHIP_NERF does not parse to the slice's field config")
    model_config = {
        "data": {"ray_range": list(RAY_RANGE)},
        "model": {"num_colors": 3, "nerf_config": FLAGSHIP_NERF,
                  "render": {"N_samples_test": 2048, "chunk": 16384, "compositor": "pallas"},
                  "occ_model": {"prop_n_ctrl": 33, "prop_train_subsample": 8,
                                "proposal": {"n_freqs": 16, "scale": 3.0, "n_neurons": 64,
                                             "n_hidden_layers": 2}}},
    }
    os.makedirs(os.path.join(log_dir, "checkpoints"))
    with open(os.path.join(log_dir, "full_config.pkl"), "wb") as f:
        pickle.dump({"mapper": {"optimizer": {"model_config": model_config}},
                     "world_cube": WORLD_CUBE}, f)
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(WINDOW):
        twist = np.concatenate([rng.uniform(-2.0, 2.0, 3), rng.normal(0.0, 0.1, 3)])
        twist = Pose.from_twist(twist).to_twist()
        poses.append({"timestamp": 3.0 * i, "lidar_to_camera": None, "lidar_pose": twist,
                      "gt_lidar_pose": None, "tracked_pose": twist})
    save_checkpoint(os.path.join(log_dir, "checkpoints", "final.tar"),
                    build_ckpt(field, prop, poses, WorldCube.from_dict(WORLD_CUBE), 20))


def render_layers(model) -> dict:
    """Device ms of one 2048-ray x 1024-sample chunk's layers (CUDA events)."""
    from loner_tpu_torch.analysis._render_impl import get_chunk_renderer
    from loner_tpu_torch.analysis.renderer_lidar import build_lidar_ray_directions
    from loner_tpu_torch.mapping.rays import get_far_val
    from loner_tpu_torch.models.field import query_field
    from loner_tpu_torch.models.rendering import make_sampler, pack_rays
    from loner_tpu_torch.ops.composite import composite_rays

    dev, cube = model.device, model.world_cube
    d = torch.from_numpy(build_lidar_ray_directions()[:2048]).to(dev)
    o = torch.zeros_like(d)
    near = torch.full((2048,), RAY_RANGE[0] / cube.scale_factor, device=dev)
    far = torch.clamp(get_far_val(o, d), max=RAY_RANGE[1] / cube.scale_factor)
    rays = pack_rays(o, d, near, far)
    sampler = make_sampler(model.occ_grid, n_ctrl=33)
    chunk = get_chunk_renderer(model, 1024, True, True)
    with torch.inference_mode():
        z = sampler.get_samples(rays, 1024, 0.0, model.occ_grid)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
        raw = query_field(model.field_params, pts, None, model.field_cfg, sigma_only=True)
        sig, dn = raw.reshape(2048, 1024), torch.linalg.norm(d, dim=-1)
        return {
            "sampler": cuda_ms(lambda: sampler.get_samples(rays, 1024, 0.0, model.occ_grid)),
            "sigma_fwd": cuda_ms(lambda: query_field(model.field_params, pts, None,
                                                     model.field_cfg, sigma_only=True)),
            "composite": cuda_ms(lambda: composite_rays(z, sig, far, dn, softplus=True)),
            "chunk": cuda_ms(lambda: chunk(rays, model.field_params, model.occ_grid)),
        }


def check_cloud(cloud: np.ndarray, out_dir: str, voxel_size: float) -> None:
    """A map cloud is finite xyz and is what render_full_map wrote to disk."""
    from loner_tpu_torch.analysis.renderer_lidar import read_pcd

    npy, pcd = (os.path.join(out_dir, f"render_full_{voxel_size}.{ext}") for ext in ("npy", "pcd"))
    if not (os.path.exists(npy) and os.path.exists(pcd)):
        raise RuntimeError(f"render_full_map wrote no {npy} / .pcd")
    if cloud.ndim != 2 or cloud.shape[1] != 3 or not np.isfinite(cloud).all():
        raise RuntimeError(f"render_full_map: cloud of shape {cloud.shape} or non-finite")
    if not np.array_equal(np.load(npy), cloud) or not np.allclose(read_pcd(pcd), cloud,
                                                                    atol=1e-5):
        raise RuntimeError("render_full_map: the .npy / .pcd files differ from the cloud")


def run_render(dev, field, prop, field_cfg) -> int:
    import tempfile
    from dataclasses import replace

    from loner_tpu_torch.analysis.render_utils import (
        kf_pose_matrices, load_experiment, render_depth_chunked,
    )
    from loner_tpu_torch.analysis.renderer import render_dataset_frame, spherical_ray_directions
    from loner_tpu_torch.analysis.renderer_lidar import build_lidar_ray_directions, render_full_map
    from loner_tpu_torch.ops import composite as cp
    from loner_tpu_torch.ops import fourier_mlp as fm

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_smoke_") as log_dir:
        write_experiment(log_dir, field, prop, field_cfg)
        n_rays, chunk = 64 * 1024, 2048
        chunks = WINDOW * -(-n_rays // chunk)

        # The render slice through the entry point, with its defaults.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fm.counts.reset()
        cp.counts.reset()
        t0 = time.perf_counter()
        cloud = render_full_map(log_dir)
        elapsed = time.perf_counter() - t0
        launches = {"composite": cp.counts.composite_launches,
                    "fourier_mlp_fwd": fm.counts.fwd_launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check_cloud(cloud, os.path.join(log_dir, "lidar_renders"), 0.1)
        for name, count in launches.items():
            if count < chunks:
                raise RuntimeError(f"{name} launched {count} times for {chunks} render chunks")
        print(f"render slice: render_full_map, {WINDOW} poses x {n_rays} rays x 1024 samples "
              f"in {chunk}-ray chunks: {elapsed:.3f} s, {1e3 * elapsed / WINDOW:.3f} ms per "
              f"virtual scan, {WINDOW * n_rays / elapsed:.1f} rendered rays/s, peak device "
              f"memory {peak_gb:.3f} GB, launches {launches}, cloud {cloud.shape[0]} points "
              "(var_threshold 1 m^2)", flush=True)
        # A field trained 20 iterations on random depths spreads each ray's
        # weights over metres, so the default variance threshold may keep no
        # point; a loose threshold on two poses checks the cloud's contents.
        loose = render_full_map(log_dir, skip_step=4, var_threshold=1e3, voxel_size=0.2,
                                out_dir=os.path.join(log_dir, "loose"))
        check_cloud(loose, os.path.join(log_dir, "loose"), 0.2)
        reach = np.linalg.norm(loose, axis=1).max()  # poses lie within 2 * sqrt(3) m
        if loose.shape[0] < 1000 or reach > RAY_RANGE[1] + 2.0 * np.sqrt(3.0):
            raise RuntimeError(f"loose cloud: {loose.shape[0]} points reaching {reach:.2f} m")
        print(f"render slice, var_threshold 1e3 m^2, 2 poses: cloud {loose.shape[0]} points",
              flush=True)

        model = load_experiment(log_dir)
        if model.device.type != "cuda" or model.compositor != "pallas":
            raise RuntimeError(f"loaded on {model.device} with compositor {model.compositor}")
        print("render layers of one 2048-ray x 1024-sample chunk (device ms, median of 5): "
              + json.dumps(render_layers(model)), flush=True)

        # One depth frame at the entry point's 2048 samples.
        pose = kf_pose_matrices(model)[0][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = render_dataset_frame(model, pose, spherical_ray_directions(512, 256), (256, 512))
        frame_s = time.perf_counter() - t0
        if frame["depth"].shape != (256, 512) or not all(
                np.isfinite(frame[k]).all() for k in ("depth", "variance", "opacity")):
            raise RuntimeError("render_dataset_frame: wrong shape or non-finite")
        print(f"depth frame: 512 x 256 spherical, 2048 samples: {1e3 * frame_s:.3f} ms",
              flush=True)

        # One virtual scan through the kernels and through the plain path.
        plain = replace(model, field_cfg=replace(model.field_cfg, sigma_kernel="plain"),
                        compositor="plain", render_cache={})
        dirs = build_lidar_ray_directions() @ pose[:3, :3].T
        origins = np.broadcast_to(pose[:3, 3], dirs.shape)
        scans, scan_ms = {}, {}
        for name, m in (("kernel", model), ("plain", plain), ("kernel", model),
                        ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scans[name] = render_depth_chunked(m, origins, dirs, RAY_RANGE, n_samples=1024,
                                               chunk=chunk)
            scan_ms[name] = 1e3 * (time.perf_counter() - t0)  # the second of each pair
    (dk, vk), (dp, vp) = [(scans[n]["depth"], scans[n]["variance"]) for n in ("kernel", "plain")]
    span = RAY_RANGE[1] - RAY_RANGE[0]
    ok = np.isfinite(dk) & np.isfinite(dp) & (dp >= RAY_RANGE[0]) & (dp <= RAY_RANGE[1])
    rel_d = np.abs(dk - dp)[ok] / span
    rel_v = np.abs(vk - vp)[ok] / span ** 2
    med, p99, vp99 = float(np.median(rel_d)), float(np.quantile(rel_d, 0.99)), float(
        np.quantile(rel_v, 0.99))
    print(f"render kernel vs plain, one scan ({int(ok.sum())} of {ok.size} rays finite and in "
          f"range; variance median {float(np.median(vp)):.3f} m^2): |ddepth|/range median "
          f"{med:.3e} (tolerance {RENDER_DEPTH_MEDIAN}), p99 "
          f"{p99:.3e} (tolerance {RENDER_DEPTH_P99}), max {float(rel_d.max()):.3e}; "
          f"|dvar|/range^2 p99 {vp99:.3e} (tolerance {RENDER_VAR_P99}); scan ms kernel "
          f"{scan_ms['kernel']:.3f}, plain {scan_ms['plain']:.3f}", flush=True)
    if ok.mean() < 0.99 or not (med <= RENDER_DEPTH_MEDIAN and p99 <= RENDER_DEPTH_P99
                                and vp99 <= RENDER_VAR_P99):
        raise RuntimeError("render: the kernel path disagrees with the plain path")
    return launches["composite"]


SLAM_SCANS = 150  # 15 s of a 10 Hz box-room sequence
SLAM_LIDAR = (32, 512)  # channels x columns: 16,384 returns per scan
ATE_MAX = 0.15  # m, ATE RMSE bar of tests/test_e2e_slam.py:143,151
MAP_DEPTH_MEDIAN_MAX = 0.3  # m, |rendered - analytic depth| median of the map check
ICP_CARD_CPU_TOL = 1e-4  # transform entries, ICP on the card against the CPU


def flagship_slam_settings(log_prefix: str) -> dict:
    """cfg/synthetic/box_room_tpu_rt_r4.yaml over cfg/defaults.yaml as a plain
    dict (the card's machine has no PyYAML). On purpose it differs in the log
    prefix, ``system.precompile`` (kernels built and every program run once
    before the clock starts, as the JAX drives ran with --precompile) and the
    test-render compositor (the fused one, as cfg/model_config/
    tpu_native_model_config.yaml has it; mapping does not read it).
    tests/test_torch_slam.py holds the rest equal to the YAML."""
    schedule_item = lambda n, **kw: {"num_iterations": n, "freeze_poses": False,  # noqa: E731
                                     **kw, "freeze_rgb_mlp": True}
    sync = {"enabled": True, "min_buffer_size": 2, "max_time_delta": 3}
    icp_stage = lambda t: {"threshold": t, "max_iterations": 10, "relative_fitness": 1e-08,  # noqa: E731
                           "relative_rmse": 1e-08}
    return {
        "calibration": {
            "lidar_to_camera": {"xyz": [0, 0, 0], "orientation": [0, 0, 0, 1]},
            "camera_intrinsic": {"k": None, "distortion": None, "new_k": None, "width": None,
                                 "height": None},
        },
        "debug": {"global_enabled": True, "flags": {
            "use_groundtruth_poses": False, "log_losses": False, "log_times": True,
            "profile": False, "profile_optimizer": False, "write_frame_point_clouds": False,
            "write_ray_point_clouds": False, "store_ray": False, "draw_samples": False,
            "draw_rays_eps": False}},
        "mapper": {
            "data_prep_on_cpu": True, "log_level": "DISABLED",
            "keyframe_manager": {
                "keyframe_selection": {"strategy": "TEMPORAL", "temporal": {"time_diff_seconds": 3.0},
                                       "motion": {"translation_threshold_m": 0.5,
                                                  "rotation_threshold_deg": 22.5}},
                "window_selection": {"strategy": "HYBRID", "hybrid_settings": {"num_recent_frames": 1},
                                     "window_size": 8},
            },
            "optimizer": {
                "freeze_poses": False, "enabled": True, "seed": 0, "detach_rgb_from_poses": True,
                "detach_rgb_from_sigma": False, "skip_pose_refinement": True,
                "num_samples": {"lidar": 512, "sky": 0, "camera": 0},
                "rays_selection": {"strategy": "RANDOM"},
                "samples_selection": {"strategy": "PROPOSAL"},
                "keyframe_schedule": [
                    {"num_keyframes": 1, "iteration_schedule": [
                        {"num_iterations": 1000, "freeze_poses": True, "freeze_sigma_mlp": False,
                         "freeze_rgb_mlp": True}]},
                    {"num_keyframes": -1, "iteration_schedule": [
                        schedule_item(50, latest_kf_only=True, freeze_sigma_mlp=True),
                        schedule_item(50, freeze_sigma_mlp=False)]},
                ],
                "model_config": {
                    "data": {"ray_range": [0.5, 14.0]},
                    "model": {
                        "num_colors": 3, "model_type": "nerf_decoupled",
                        "nerf_config": {
                            **{k: v for k, v in FLAGSHIP_NERF.items()
                               if k not in ("sigma_kernel", "fourier_sigma")},
                            "fourier_sigma": {"n_freqs": 48, "scale": 6.0, "include_input": True},
                            "pos_encoding_sigma": {"base_resolution": 16, "log2_hashmap_size": 18,
                                                   "n_features_per_level": 2, "n_levels": 16,
                                                   "otype": "HashGrid"},
                        },
                        "ray_range": [0.5, 14.0],
                        "render": {"N_samples_train": 512, "N_samples_test": 1024, "retraw": True,
                                   "lindisp": False, "perturb": 1.0, "white_bkgd": False,
                                   "raw_noise_std": 1.0, "chunk": 16384, "netchunk": 0,
                                   "compositor": "pallas"},
                        "occ_model": {"voxel_size": 100, "lr": 0.0001, "N_iters_acc": 10,
                                      "prop_lr": 0.001, "prop_n_ctrl": 33,
                                      "proposal": {"n_freqs": 16, "scale": 3.0, "n_neurons": 64,
                                                   "n_hidden_layers": 2},
                                      "prop_train_subsample": 8},
                    },
                    "train": {"lrate_sigma_mlp": 0.005, "lrate_rgb": 0.01, "lrate_pose": 0.001,
                              "encode_impl": "vjp_bf16", "lrate_gamma": 1.0, "decay_rate": 0.001,
                              "pose_lrate_gamma": 1.0, "rgb_weight_decay": 1e-05,
                              "sigma_weight_decay": 0.0, "steps_per_dispatch": 3,
                              "max_inflight_dispatches": 1, "point_chunk": 0},
                    "loss": {"loss_selection": "L1_JS",
                             "JS_loss": {"min_js_score": 1.0, "max_js_score": 10.0, "alpha": 1.0},
                             "decay_los_lambda": False, "los_lambda": 1000.0,
                             "min_los_lambda": 10.0, "los_lambda_decay_rate": 0.001,
                             "los_lambda_decay_steps": 15000, "decay_depth_eps": True,
                             "depth_eps": 3.0, "min_depth_eps": 0.5, "depth_eps_decay_rate": 0.95,
                             "depth_eps_decay_steps": 1, "depthloss_lambda": 0.005},
                },
            },
        },
        "system": {
            "single_threaded": False, "precompile": True, "log_dir_prefix": log_prefix,
            "lidar_only": True, "sky_segmentation": False, "image_scale_factor": 0.5,
            "synchronization": dict(sync),
            "world_cube": {"compute_from_groundtruth": True,
                           "trajectory_bounding_box": {"x": [-10, 10], "y": [-10, 10],
                                                       "z": [-10, 10]}},
            "lidar_fov": {"enabled": False, "range": [[0, 235], [305, 360]]},
            "lidar_timestamps_relative_to_start": True,
        },
        "tracker": {
            "synchronization": dict(sync),
            "frame_synthesis": {"strategy": None, "sky_removal": None,
                                "frame_decimation_rate_hz": 5, "frame_match_tolerance": 0.01,
                                "frame_delta_t_sec_tolerance": 0.02, "decimate_on_load": False},
            "icp": {"scan_duration": 0.9, "schedule": [icp_stage(1.5), icp_stage(0.125)],
                    "downsample": {"type": "UNIFORM", "target_uniform_point_count": 5000,
                                   "voxel_downsample_size": 0.1}},
            "motion_compensation": {"enabled": True},
            "compute_sky_rays": False,
        },
    }


def write_slam_dataset(root: str):
    """The box-room sequence through the port's ScanStreamWriter; returns the
    scene and the ground-truth poses."""
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence

    scans, poses, ts, scene, _ = generate_sequence(
        num_scans=SLAM_SCANS, lidar=VirtualLidar(num_channels=SLAM_LIDAR[0],
                                                 num_columns=SLAM_LIDAR[1]))
    writer = ScanStreamWriter(root)
    for scan in scans:
        writer.add_scan(scan)
    writer.write_gt(poses, ts)
    return scene, poses, ts


def check_icp_card_against_cpu(dev, dataset: str) -> dict:
    """One real frame pair (scans 0 and 2, the 5 Hz decimation) at 5120 points
    through run_icp_schedule on the card and on the CPU; one dispatch on the
    tracker's kind of stream under torch.cuda.set_sync_debug_mode("error")."""
    from loner_tpu_torch.common.frame import Frame
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
    from loner_tpu_torch.tracking.icp import run_icp_schedule

    reader = ScanStreamReader(dataset)
    tgt, src = (Frame(reader.read_scan(i)).build_point_cloud(scan_duration=0.9, target_points=5000)
                for i in (0, 2))
    schedule = [{"threshold": 1.5, "max_iterations": 10}, {"threshold": 0.125, "max_iterations": 10}]
    stream = torch.cuda.Stream(dev, priority=-1)
    with torch.cuda.stream(stream):
        run_icp_schedule(src, tgt, schedule, pad_size=5120, device=dev).transformation.cpu()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card = run_icp_schedule(src, tgt, schedule, pad_size=5120, device=dev)
            # The tracker's chained velocity init: a device tensor.
            chained = run_icp_schedule(src, tgt, schedule, pad_size=5120, init=card.transformation)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t_card = card.transformation.cpu().numpy()
        chained.transformation.cpu()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run_icp_schedule(src, tgt, schedule, pad_size=5120, device=dev)
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end)
    t_cpu = run_icp_schedule(src, tgt, schedule, pad_size=5120,
                             device=torch.device("cpu")).transformation.numpy()
    err = float(np.abs(t_card - t_cpu).max())
    print(f"ICP card vs CPU, one frame pair at 5120 points: max |dT| {err:.3e} (tolerance "
          f"{ICP_CARD_CPU_TOL}), no host sync in a dispatch; one dispatch {host_ms:.3f} ms on "
          f"the host, {device_ms:.3f} ms on the card (CUDA events)", flush=True)
    if not err <= ICP_CARD_CPU_TOL:
        raise RuntimeError(f"ICP on the card disagrees with the CPU: {err}")
    return {"icp_card_cpu_err": err, "icp_host_ms": host_ms, "icp_device_ms": device_ms}


def check_map_depth(dev, log_dir: str, scene, gt0: np.ndarray) -> int:
    """render_full_map at the first keyframe (the anchored, identity pose of
    the SLAM frame; the ground-truth pose of scan 0 in the scene) through the
    composite and Fourier forward kernels; each kept point's range against the
    analytic raycast along its ray. Returns the composite kernel's launches."""
    from loner_tpu_torch.analysis.render_utils import kf_pose_matrices, load_experiment
    from loner_tpu_torch.analysis.renderer_lidar import render_full_map
    from loner_tpu_torch.ops import composite as cp
    from loner_tpu_torch.ops import fourier_mlp as fm

    model = load_experiment(log_dir, device=dev)
    mats, _ = kf_pose_matrices(model)
    if model.compositor != "pallas":
        raise RuntimeError(f"the SLAM run's config renders with compositor {model.compositor}")
    cp.counts.reset()
    fm.counts.reset()
    cloud = render_full_map(log_dir, skip_step=len(mats), voxel_size=0.02, device=dev)
    launches = {"composite": cp.counts.composite_launches, "fourier_mlp_fwd": fm.counts.fwd_launches}
    if cloud.shape[0] < 1000 or not np.isfinite(cloud).all():
        raise RuntimeError(f"map check: {cloud.shape[0]} points kept")
    # The SLAM frame is the ground truth zeroed at scan 0: scene = gt0 @ SLAM.
    world = cloud @ gt0[:3, :3].T + gt0[:3, 3]
    origin = (gt0 @ mats[0])[:3, 3]
    rng = np.linalg.norm(world - origin, axis=1)
    truth = scene.raycast(np.broadcast_to(origin, world.shape), (world - origin) / rng[:, None])
    err = np.abs(rng - truth)
    med = float(np.median(err))
    print(f"map check: render_full_map at keyframe 0 ({cloud.shape[0]} points kept, variance "
          f"< 1 m^2): |rendered - analytic depth| median {med:.4f} m (bound "
          f"{MAP_DEPTH_MEDIAN_MAX}), mean {float(err.mean()):.4f}, p90 "
          f"{float(np.quantile(err, 0.9)):.4f}; launches {launches}", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise RuntimeError(f"map check: {name} was not launched")
    if not med <= MAP_DEPTH_MEDIAN_MAX:
        raise RuntimeError(f"map check: median depth error {med} m")
    return launches["composite"]


def run_slam(dev) -> dict:
    """Phase 9: the threaded flagship SLAM run through run_trial on ``dev``."""
    import tempfile

    from loner_tpu_torch import run_loner
    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
    from loner_tpu_torch.ops import fourier_mlp as fm

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_slam_") as tmp:
        dataset = os.path.join(tmp, "dataset")
        t0 = time.perf_counter()
        scene, gt_poses, ts = write_slam_dataset(dataset)
        print(f"SLAM dataset: {SLAM_SCANS} scans of {SLAM_LIDAR[0] * SLAM_LIDAR[1]} rays, "
              f"{ts[-1] - ts[0] + 0.1:.1f} s of sequence, written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        icp = check_icp_card_against_cpu(dev, dataset)

        loners = []

        class RecordingLoner(run_loner.Loner):
            def start(self):
                loners.append(self)
                super().start()

        settings = flagship_slam_settings(os.path.join(tmp, "outputs"))
        original, run_loner.Loner = run_loner.Loner, RecordingLoner
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fm.counts.reset()
            t0 = time.perf_counter()
            log_dir = run_loner.run_trial(settings, dataset, experiment_name="smoke_slam",
                                          device=dev)
            wall = time.perf_counter() - t0
            launches = {"fourier_mlp_fwd": fm.counts.fwd_launches,
                        "fourier_mlp_bwd": fm.counts.bwd_launches}
        finally:
            run_loner.Loner = original
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        (loner,) = loners
        opt = loner.mapper.optimizer
        placed = {"field": opt.state.field_params["sigma"]["mlp"]["w0"].device,
                  "proposal": opt.state.occ_grid["w0"].device,
                  "icp": loner.tracker._last_relative_dev.device}
        if any(d != dev for d in placed.values()):
            raise RuntimeError(f"SLAM tensors not on {dev}: {placed}")

        runtime = float(open(os.path.join(log_dir, "runtime.txt")).read().split()[1])
        seq_s = float(ts[-1] - ts[0]) + 0.1
        timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
        track = np.loadtxt(os.path.join(log_dir, "track_times.csv"), delimiter=",", ndmin=2)
        its = int(timing[:, 0].sum())
        boot_ms = 1e3 * timing[0, 1] / timing[0, 0]
        win_ms = 1e3 * timing[1:, 1].sum() / max(timing[1:, 0].sum(), 1)
        print(f"SLAM: {len(timing)} keyframes, {its} mapping iterations; per keyframe "
              "(iterations, s): " + ", ".join(f"({int(n)}, {t:.3f})" for n, t in timing),
              flush=True)
        print(f"SLAM: runtime {runtime:.3f} s for {seq_s:.1f} s of sequence, real-time factor "
              f"{seq_s / runtime:.4f}; ms per mapping iteration: W=1 bootstrap {boot_ms:.3f}, "
              f"W=8 windows {win_ms:.3f}; tracking latency ({len(track)} updates) median "
              f"{1e3 * float(np.median(track[:, 0])):.3f} ms, p95 "
              f"{1e3 * float(np.quantile(track[:, 0], 0.95)):.3f} ms; peak device memory "
              f"{peak_gb:.3f} GB; run_trial {wall:.3f} s; launches {launches}; tensors on "
              f"{sorted({str(d) for d in placed.values()})}", flush=True)
        for name, count in launches.items():
            if count < its:
                raise RuntimeError(f"{name} launched {count} times in {its} mapping iterations")

        ate = {}
        for name in ("estimated_trajectory", "tracking_only"):
            res = evaluate_trajectory_files(
                os.path.join(log_dir, "trajectory", f"{name}.txt"),
                os.path.join(log_dir, "trajectory", "groundtruth.txt"), delta_m=1.0)
            ate[name] = res["ate"]["rmse"]
        print(f"SLAM ATE RMSE: estimated {ate['estimated_trajectory']:.4f} m, tracking only "
              f"{ate['tracking_only']:.4f} m (bound {ATE_MAX})", flush=True)
        if not all(v < ATE_MAX for v in ate.values()):
            raise RuntimeError(f"SLAM ATE above {ATE_MAX} m: {ate}")

        composite = check_map_depth(dev, log_dir, scene, gt_poses[0])
    return {"launches": {**launches, "composite": composite}, **icp}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from loner_tpu_torch.ops import composite as cp
    from loner_tpu_torch.ops import fourier_mlp as fm
    from loner_tpu_torch.ops.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build_all()
    fm._lib()
    cp._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    cfg, field_cfg = flagship_configs()
    kernels = check_kernels(dev, field_cfg)
    launches, field, prop = run_slice(dev, cfg, field_cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    composite = check_composite(dev)
    composite["launches"] = run_render(dev, field, prop, field_cfg)
    kernels.append(composite)
    # The SLAM slice's main path: its launch counts go into the kernels' record.
    slam = run_slam(dev)
    for k in kernels:
        k["launches"] = slam["launches"][k["name"]]

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
