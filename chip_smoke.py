#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (loner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card; imports
nothing of JAX. Phases, each of which raises on failure:

1. Device: no CUDA card, no run. Prints the card's name and power limit.
2. Build: compiles the CUDA sources of loner_tpu_torch/csrc into build/.
3. Kernels: the fused Fourier-MLP forward and backward kernels against their
   plain PyTorch version on the card, at the flagship shapes (2,097,152
   points, 48 frequencies, 99 -> 256 -> 256 -> 1, bf16), each timed with CUDA
   events beside the plain version.
4. Slice: the mapper's joint pose+map iteration at the flagship configuration
   (8 keyframes x 512 rays x 512 samples) through ``make_phase_runner``, with
   the kernels' launch counts; then one iteration's loss and twist gradient
   through the kernels against the plain sigma path, on the same draws.

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

WINDOW = 8  # keyframes in the flagship window


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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from loner_tpu_torch.ops import fourier_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    fm._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    cfg, field_cfg = flagship_configs()
    kernels = check_kernels(dev, field_cfg)
    launches = run_slice(dev, cfg, field_cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
