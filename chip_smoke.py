#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (loner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card; imports
nothing of JAX. Phases, each of which raises on failure:

1. Device: no CUDA card, no run. Prints the card's name and power limit.
2. Build: compiles the CUDA sources of loner_tpu_torch/csrc into build/, one
   nvcc process per source, all started together; prints each kernel's
   ptxas -v report and fails if a hash-grid kernel spills; counts each
   kernel's HGMMA (wgmma) and UBLKCP / UTMALDG (bulk / tensor copies)
   instructions in the built SASS (cuobjdump), and fails if a Fourier-MLP
   kernel has no HGMMA (the composite and hash kernels use none).
3. Kernels: the fused Fourier-MLP forward and backward kernels against their
   plain PyTorch version on the card, at the flagship shapes (2,097,152
   points, 48 frequencies, 99 -> 256 -> 256 -> 1, bf16), each timed with CUDA
   events beside the plain version, the least time the card could take
   (bound_ms) and the library yardstick (library_ms: the same MLP as bf16
   torch.addmm products with PyTorch ops between them, and its
   torch.autograd.grad; a composition, timed here only); then both kernels
   at the W=1 bootstrap's 262,144 points.
4. Slice: the mapper's joint pose+map iteration at the flagship configuration
   (8 keyframes x 512 rays x 512 samples) through ``make_phase_runner``, with
   the kernels' launch counts; then one iteration's loss and twist gradient
   through the kernels against the plain sigma path, on the same draws.
5. Composite kernel: the fused alpha-compositing kernel against its plain
   version (relu, softplus, an opaque wall) at 16384 rays x 1024 and 2048
   samples, at the render chunks' 2048 x 1024 and 2048, and at ragged ray and
   sample counts; two calls must give the same bits. At the first four shapes,
   the kernel alone (back-to-back launches through its C entry), the wrapper
   and the plain version, timed with CUDA events beside the bound.
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
   LiDAR at 10 Hz; written once with its GT map and shared with phase 11)
   through ``loner_tpu_torch.run_loner.run_trial``, threaded,
   on cuda:0, at the flagship SLAM settings (cfg/synthetic/box_room_tpu_rt_r4.yaml
   as a plain dict): the real-time factor, ms per mapping iteration, the
   tracking latency, peak device memory and the kernels' launch counts; ATE of
   both trajectories against the ground truth; the map's depth (one virtual
   scan of ``render_full_map`` at the first keyframe) against the analytic
   raycast of the scene; the ICP of one frame pair on the card against the
   CPU, with no host synchronisation in a dispatch.
10. Hash kernels: the hash-grid encode's forward and backward kernels against
   their plain version at the reference's grid (16 levels x 2 features at
   2^18), features and dpos equal to the bit, in bf16 and f32, with dpos and
   without: at the mapping path's 2,097,152 and 262,144 points in the order a
   mapping iteration gives them (rays of 512 sorted samples) and at random,
   and at the edge cases of the warp-level work (one index for every lane,
   runs across warps and blocks, ragged counts, the unit cube's faces); timed
   at both orders and counts beside the plain version and the bound.
11. SLAM at the reference's configuration: the same sequence and checks at
   cfg/synthetic/box_room.yaml (hash sigma field through the hash kernels, OGM
   sampler), with the hash kernels' launches, the backward's split between its
   variant without dpos (the frozen-pose bootstrap) and the one with dpos.
12. Dispatch, graphs against eager: the flagship's and the reference's
   iterations at W=1 (frozen poses) and W=8 through the captured CUDA graphs
   and through the explicit eager loop (``make_phase_runner(...,
   graphs=False)``), 7 iterations at k = 3 from one seed, the reference from a
   global step that puts the OGM step inside a dispatch: the flagship equal to
   the bit, the reference within DISPATCH_REF_TOL; ms an iteration and the
   device's busy share both ways.
13. Map quality, inside each SLAM run of phases 9 and 11 before its directory
   goes: against the sequence's GT map (``build_gt_map``), the ``eval_map_quality``
   chain on the card (map cloud, masked GT map, F@0.1 m, chamfer, accuracy,
   completion; L1 depth over 25 scans) gated at F_SCORE_MIN, the L1 printed
   beside L1_MEAN_MAX (gated in phase 14: on this 150-scan sequence neither
   configuration meets it, see DRIVE_SCANS); ``get_mesh`` at resolution 256
   through the kernels and through the plain paths, held to MESH_CHAMFER_MAX
   and MESH_VERTEX_SHARE_MAX; the mesh's cloud (``mesh_to_pcd``,
   MESH_PCD_POINTS samples) scored, not gated; the run's ``regression.yaml``;
   each step's launches of the configuration's kernels.
14. Map quality on the JAX package's box-room drive (DRIVE_SCANS scans, the
   cell whose record gives the bars): both configurations' threaded SLAM runs
   with phase 9's checks, then the ``eval_map_quality`` chain and the L1 depth
   gated at F_SCORE_MIN and L1_MEAN_MAX, and the regression record.

The mapping iteration and the ICP schedule run as CUDA graphs wherever the
port runs them (phases 4, 9, 11: ``steps_per_dispatch`` replays a dispatch);
each SLAM run prints its graphs' captures and memory pools, and the ICP check
of phase 9 holds the tracker's ICP graph to the eager dispatch. Launch counts
count replays (``common/cuda_graphs.py``).

Each path sets every launch count to 0 just before it runs and reads them just
after. The second-to-last line of output is a JSON record of the kernels; the
last is ``{"ok": true, "device": {...}}``.
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
# Composite kernel against its plain version, f32 (the block scan multiplies in
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


# Hash-grid encode, kernel against plain version on the card. Both take the same
# rounded f32 operations in the same order (no FMA contraction), so the features
# and the position gradient must agree to the bit. The table gradient is summed by
# float atomics, combined first over the lanes of a warp that share an entry, in an
# order that changes from run to run (up to ~10^4 terms an entry on the coarse
# levels at 2.1 M points): relative L2 1e-5.
HASH_DTABLE_REL_L2 = 1e-5

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): bf16
# tensor cores, f32 outside the tensor cores, and HBM3. bound_ms is the larger of
# operations over the peak of their type and bytes (each input read once, each
# output written once) over the HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from loner_tpu_torch.ops import composite, fourier_mlp, hash_grid

    for module in (composite, fourier_mlp, hash_grid):
        module.counts.reset()


def read_counts() -> dict:
    """Every kernel's launches since the last ``reset_counts``, by name."""
    from loner_tpu_torch.ops import composite, fourier_mlp, hash_grid

    return {"fourier_mlp_fwd": fourier_mlp.counts.fwd_launches,
            "fourier_mlp_bwd": fourier_mlp.counts.bwd_launches,
            "composite": composite.counts.composite_launches,
            "hash_encode_fwd": hash_grid.counts.fwd_launches,
            "hash_encode_bwd": hash_grid.counts.bwd_launches,
            "hash_encode_bwd_no_dpos": hash_grid.counts.bwd_no_dpos_launches}


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


def ptxas_spills() -> None:
    """Prints each built kernel's ptxas -v report (registers, shared memory,
    spills); fails if a hash-grid kernel spills."""
    import re

    from loner_tpu_torch.ops.build import ptxas_report

    for lib in ("fourier_mlp", "composite", "hash_grid"):
        for line in ptxas_report(lib).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas_report("hash_grid"))
    if any(int(b) for b in spills):
        raise RuntimeError("a hash-grid kernel spills registers (ptxas -v above)")


def sass_counts() -> dict:
    """HGMMA and bulk / tensor-copy instructions of each kernel in the built
    libraries (cuobjdump -sass). Fails if a Fourier-MLP kernel has no HGMMA (the
    composite and hash kernels use none, by design)."""
    import re
    import shutil

    from loner_tpu_torch.ops.build import _target

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in ("fourier_mlp", "composite", "hash_grid"):
        sass = subprocess.run([tool, "-sass", str(_target(lib))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        func = None
        for line in sass.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                # The kernel's name and template arguments, e.g. fwd_kernel<256>,
                # composite_kernel<1,8,1>.
                d = re.search(r"(\d+)([a-z_]+kernel)(?:I((?:L[a-z]\d+E)+)E)?", m.group(1))
                args = re.findall(r"L[a-z](\d+)E", d.group(3) or "")
                func = d.group(2) + (f"<{','.join(args)}>" if args else "")
                counts[func] = {"HGMMA": 0, "UBLKCP": 0, "UTMALDG": 0}
                continue
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m and func and m.group(1) in counts[func]:
                counts[func][m.group(1)] += 1
    for name, c in sorted(counts.items()):
        print(f"SASS {name}: HGMMA {c['HGMMA']}, UBLKCP {c['UBLKCP']}, UTMALDG {c['UTMALDG']}",
              flush=True)
    for name, c in counts.items():
        if name.split("<")[0] in ("fwd_kernel", "bwd_tile_kernel", "dw_kernel") and not c["HGMMA"]:
            raise RuntimeError(f"{name} has no HGMMA (wgmma) instruction")
    return counts


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

    again = fm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, bf)
    if not all(torch.equal(a, b) for a, b in zip(dws_k + dbs_k + [dpts_k],
                                                 again[0] + again[1] + [again[2]])):
        raise RuntimeError("backward kernel: two calls differ (it must be deterministic)")

    times = {
        "fwd": cuda_ms(lambda: fm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, bf)),
        "fwd_plain": cuda_ms(lambda: fm.fourier_mlp_fwd_plain(ws, bs, bmat, pts01, bf)),
        "bwd": cuda_ms(lambda: fm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, bf)),
        "bwd_plain": cuda_ms(lambda: fm.fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, bf)),
        **library_ms(ws, bs, bmat, pts01, dout),
    }
    print(f"kernel times at N={n} (median of 5, ms): " + json.dumps(times), flush=True)
    # Every product's multiply-adds (2 FLOP each): the forward once; the backward
    # recomputes it and forms dX and dW of every layer. Bytes: points and dout in,
    # sigma or dpts out, the parameters in (and their gradients out).
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    params = 4 * sum(w.numel() for w in ws) + 4 * sum(b.numel() for b in bs) + bmat.numel() * 4
    fwd_bound = bound(2 * n * macs, 16 * n + params)
    bwd_bound = bound(6 * n * macs, 28 * n + 2 * params)
    for name, b, ms, lib in (("fwd", fwd_bound, times["fwd"], times["fwd_library"]),
                             ("bwd", bwd_bound, times["bwd"], times["bwd_library"])):
        print(f"kernel fourier_mlp_{name}: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
              f"{100 * b[0] / ms:.1f}% of the bound; library composition {lib:.4f} ms", flush=True)
    # The W=1 bootstrap's call size.
    small = 512 * 512
    sub = (pts01[:small].contiguous(), dout[:small].contiguous())
    t_small = {"fwd": cuda_ms(lambda: fm.fourier_mlp_fwd_cuda(ws, bs, bmat, sub[0], bf)),
               "bwd": cuda_ms(lambda: fm.fourier_mlp_bwd_cuda(ws, bs, bmat, sub[0], sub[1], bf))}
    print(f"kernel times at N={small} (median of 5, ms): " + json.dumps(t_small), flush=True)
    src = "loner_tpu_torch/csrc/fourier_mlp.cu"
    return [
        {"name": "fourier_mlp_fwd", "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:52", "launches": 0,
         "max_abs_err": fwd_err, "ms": times["fwd"], "plain_ms": times["fwd_plain"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": times["fwd_library"]},
        {"name": "fourier_mlp_bwd", "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:80", "launches": 0,
         "max_abs_err": bwd_err, "ms": times["bwd"], "plain_ms": times["bwd_plain"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": times["bwd_library"]},
    ]


def library_ms(ws, bs, bmat, pts01, dout) -> dict:
    """The yardstick: the same MLP as bf16 torch.addmm products with sin, cos,
    concatenation and ReLU as PyTorch ops (a composition of library calls; no
    single call computes it), and torch.autograd.grad of it with respect to the
    weights, biases and points. Timed here only; the port never calls it."""
    bf = torch.bfloat16

    def forward(wsb, bsb, pts):
        proj = pts[:, 0:1] * bmat[0] + pts[:, 1:2] * bmat[1] + pts[:, 2:3] * bmat[2]
        h = torch.cat([torch.sin(proj), torch.cos(proj), pts], dim=-1).to(bf)
        for w, b in zip(wsb[:-1], bsb[:-1]):
            h = torch.relu(torch.addmm(b, h, w))
        return torch.addmm(bsb[-1], h, wsb[-1]).float()

    wsb = [w.to(bf).requires_grad_(True) for w in ws]
    bsb = [b.to(bf).requires_grad_(True) for b in bs]
    pts = pts01.clone().requires_grad_(True)
    with torch.no_grad():
        fwd = cuda_ms(lambda: forward(wsb, bsb, pts01))
    times = []
    for _ in range(6):  # the first is a warm-up
        out = forward(wsb, bsb, pts)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, wsb + bsb + [pts], dout)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"fwd_library": fwd, "bwd_library": float(np.median(times[1:]))}


def run_slice(dev, cfg, field_cfg, n_iters: int = 20, w: int = WINDOW) -> dict:
    from dataclasses import replace

    from loner_tpu_torch.common.cuda_graphs import pool_bytes
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
    # The iteration's temporaries live in the graphs' pool, reserved at capture.
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    pool_gb = pool_bytes(run_phase.pool) / 1e9

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
          f"points/iteration, peak device memory {peak_gb:.3f} GB outside the graphs' pool of "
          f"{pool_gb:.3f} GB, launches {launches}, "
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


# Beside ab_compare.COMPOSITE_SHAPES (timed), ragged counts checked but not timed:
# B = 1 and 2047; S = 1, 33 and 1030, not multiples of 4; 5000 over three tiles.
COMPOSITE_RAGGED = ((1, 1024), (2047, 1024), (2047, 1), (2047, 33), (3, 1030), (5, 5000))


def check_composite(dev) -> dict:
    from loner_tpu_torch.analysis.ab_compare import (
        COMPOSITE_SHAPES, composite_bound_ms, composite_inputs, composite_launcher, kernel_ms,
    )
    from loner_tpu_torch.ops import composite as cp

    worst, times = 0.0, {}
    for b, s in COMPOSITE_SHAPES + COMPOSITE_RAGGED:
        z, sigma, far_t, dnorm = composite_inputs(b, s, dev)
        wall = torch.zeros_like(sigma)
        wall[: b // 2, s // 2] = 1e8  # half the rays hit an opaque wall mid-ray
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
                                       f"{b} x {s} {case} {name}, max |err| {err}")
            print(f"kernel composite {b} x {s} {case}: max |kernel - plain| " + ", ".join(errs),
                  flush=True)
        again = cp.composite_cuda(z, sigma, far_t, dnorm, True)
        if not all(torch.equal(x, y) for x, y in zip(again, cp.composite_cuda(z, sigma, far_t,
                                                                               dnorm, True))):
            raise RuntimeError(f"composite kernel: two calls differ at {b} x {s}")
        if (b, s) in COMPOSITE_SHAPES:
            # Kernel alone (back-to-back launches through the C entry), through the
            # wrapper, and the plain version; softplus, as the flagship renders.
            t = {"kernel": kernel_ms(composite_launcher(cp, z, sigma, far_t, dnorm)),
                 "wrapper": cuda_ms(lambda: cp.composite_cuda(z, sigma, far_t, dnorm, True)),
                 "plain": cuda_ms(lambda: cp.composite_plain(z, sigma, far_t, dnorm, True)),
                 "bound": composite_bound_ms(b, s)}
            times[(b, s)] = t
            print(f"kernel composite times at {b} x {s}, softplus (median of 5, ms): kernel "
                  f"alone {t['kernel']:.5f}, wrapper {t['wrapper']:.5f}, plain {t['plain']:.5f}; "
                  f"bound {t['bound']:.5f} (bytes: 12 B/sample + 20 B/ray), kernel alone "
                  f"{100 * t['bound'] / t['kernel']:.1f}% of the bound, wrapper "
                  f"{100 * t['bound'] / t['wrapper']:.1f}%", flush=True)
        del z, sigma, far_t, dnorm, wall
    # No single PyTorch call composites.
    main, chunk = times[(16384, 1024)], times[(2048, 1024)]
    return {"name": "composite", "route": "cuda", "source": "loner_tpu_torch/csrc/composite.cu",
            "replaces": "loner_tpu/ops/pallas/composite.py:27", "launches": 0,
            "max_abs_err": worst, "ms": main["wrapper"], "plain_ms": main["plain"],
            "bound_ms": main["bound"], "bound_by": "bytes", "library_ms": None,
            "kernel_ms": main["kernel"], "render_chunk_ms": chunk["wrapper"],
            "render_chunk_kernel_ms": chunk["kernel"], "render_chunk_bound_ms": chunk["bound"]}


HASH_POINTS = (8 * 512 * 512, 512 * 512)  # a W=8 iteration's field points, the W=1 bootstrap's


def hash_cost(n: int, cfg) -> dict:
    """Operations and bytes of one forward, one backward and one backward without
    dpos at n points: f32 operations counted from csrc/hash_grid.cu per (point,
    level) (corners 25: scale, frac, 1 - frac and the 8 weights; forward 32 more
    for the 8 weighted feature pairs; backward 16 for the atomics' terms and 16
    atomic adds, and with dpos 24 for the corner dot products, 48 for the frac
    gradients and 6 for the level sum); bytes: points, features or their
    gradient, dpos and the table (its gradient) each once; without dpos the
    table is not read."""
    nl, table = n * cfg.n_levels, 8 * cfg.total_table_size
    return {"fwd": (57 * nl, 12 * n + 4 * cfg.output_dim * n + table),
            "bwd": (135 * nl, 12 * n + 4 * cfg.output_dim * n + 12 * n + 2 * table),
            "bwd_no_dpos": (57 * nl, 12 * n + 4 * cfg.output_dim * n + table)}


def check_hash_case(name: str, table, pos, dout, cfg, dtype) -> tuple:
    """The hash kernels against their plain version on one input: features equal
    to the bit, and the same in a second call; the backward's dpos equal to the
    bit and its table gradient within HASH_DTABLE_REL_L2, with dpos and without
    it (the frozen-pose variant, which returns None for dpos). Returns the largest
    |kernel - plain| of the features and of the gradients."""
    from loner_tpu_torch.ops import hash_grid as hg

    out_k = hg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    again = hg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    out_p = hg.hash_encode_fwd_plain(table, pos, cfg, dtype)
    dtab_k, dpos_k = hg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype)
    dtab_n, dpos_n = hg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype, need_dpos=False)
    dtab_p, dpos_p = hg.hash_encode_bwd_plain(table, pos, dout, cfg, dtype)
    torch.cuda.synchronize()
    for label, t in (("features", out_k), ("dtable", dtab_k), ("dpos", dpos_k),
                     ("dtable without dpos", dtab_n)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"hash kernel: non-finite {label} on {name}, {dtype}")
    fwd_err = float((out_k - out_p).abs().max())
    rel_t, rel_n = rel_l2(dtab_k, dtab_p), rel_l2(dtab_n, dtab_p)
    bwd_err = max(float((dtab_k - dtab_p).abs().max()), float((dtab_n - dtab_p).abs().max()),
                  float((dpos_k - dpos_p).abs().max()))
    ok = (torch.equal(out_k, out_p) and torch.equal(again, out_k) and torch.equal(dpos_k, dpos_p)
          and dpos_n is None and rel_t <= HASH_DTABLE_REL_L2 and rel_n <= HASH_DTABLE_REL_L2)
    print(f"kernel hash_encode {name}, {pos.shape[0]} points, {str(dtype)[6:]}: features "
          f"{int((out_k != out_p).sum())} of {out_k.numel()} differ (max {fwd_err:.3e}), second "
          f"call equal {torch.equal(again, out_k)}; dpos {int((dpos_k != dpos_p).sum())} of "
          f"{dpos_k.numel()} differ; dtable rel L2 {rel_t:.3e}, without dpos {rel_n:.3e} "
          f"(tolerance {HASH_DTABLE_REL_L2})", flush=True)
    if not ok:
        raise RuntimeError(f"hash kernels disagree with their plain version on {name}, {dtype}")
    return fwd_err, bwd_err


def check_hash_kernels(dev) -> list:
    """The hash-grid encode kernels against their plain version at the reference's
    grid (16 levels x 2 features at 2^18), in bf16 (training) and f32 (renders):
    at the mapping path's point counts in the order a mapping iteration gives
    them (ab_compare.hash_points: rays of 512 sorted samples) and at random
    points, and at the edge cases of ab_compare.hash_edge_points; each with dpos
    and without. Timed (median of 5 calls, CUDA events) at both orders and both
    counts beside the plain version and the bound. No single PyTorch call
    computes the function: library_ms is null."""
    from loner_tpu_torch.analysis.ab_compare import hash_edge_points, hash_points
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.ops import hash_grid as hg

    cfg, bf = HashEncodingConfig(), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    table = torch.rand((cfg.total_table_size, 2), generator=gen, device=dev) * 2e-2 - 1e-2
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}

    def check(name, points, scale):
        pos = torch.from_numpy(points).to(dev)
        dout = torch.randn((pos.shape[0], cfg.output_dim), generator=gen, device=dev) * scale
        for dtype in (bf, torch.float32):
            errs = check_hash_case(name, table, pos, dout, cfg, dtype)
            worst["fwd"], worst["bwd"] = max(worst["fwd"], errs[0]), max(worst["bwd"], errs[1])
        return pos, dout

    for name, points in hash_edge_points().items():
        check(name, points, 1.0)
    for order in ("ray", "random"):
        for n in HASH_POINTS:
            pos, dout = check(f"{order} order", hash_points(n, order), n ** -0.5)
            t = {"fwd": cuda_ms(lambda: hg.hash_encode_fwd_cuda(table, pos, cfg, bf)),
                 "bwd": cuda_ms(lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg, bf)),
                 "bwd_no_dpos": cuda_ms(lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg, bf,
                                                                        need_dpos=False))}
            if (order, n) == ("random", HASH_POINTS[0]):
                t["fwd_f32"] = cuda_ms(lambda: hg.hash_encode_fwd_cuda(table, pos, cfg,
                                                                       torch.float32))
                t["bwd_f32"] = cuda_ms(lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg,
                                                                       torch.float32))
                t["fwd_plain"] = cuda_ms(lambda: hg.hash_encode_fwd_plain(table, pos, cfg, bf), 3)
                t["bwd_plain"] = cuda_ms(
                    lambda: hg.hash_encode_bwd_plain(table, pos, dout, cfg, bf), 3)
            times[(order, n)] = t
            del pos, dout
            cost = hash_cost(n, cfg)
            shares = {k: bound(*cost[k], peak_flops=PEAK_F32_FLOPS) for k in cost}
            print(f"kernel hash_encode times, {order} order, {n} points, bf16 (ms, median of 5): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + "; bound "
                  + ", ".join(f"{k} {b[0]:.4f} ({b[1]}, {100 * b[0] / t[k]:.1f}%)"
                              for k, b in shares.items()), flush=True)
    big, small = HASH_POINTS
    cost = hash_cost(big, cfg)
    src = "loner_tpu_torch/csrc/hash_grid.cu"
    note = "not a TPU kernel: the JAX package computes this function in XLA"
    records = []
    for name, line in (("fwd", 170), ("bwd", 221)):
        b = bound(*cost[name], peak_flops=PEAK_F32_FLOPS)
        records.append({
            "name": f"hash_encode_{name}", "route": "cuda", "source": src,
            "replaces": f"loner_tpu/models/hash_encoding.py:{line}", "note": note, "launches": 0,
            "max_abs_err": worst[name], "ms": times[("random", big)][name],
            "plain_ms": times[("random", big)][f"{name}_plain"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "f32_ms": times[("random", big)][f"{name}_f32"],
            "bootstrap_ms": times[("random", small)][name],
            "ray_ms": times[("ray", big)][name], "ray_bootstrap_ms": times[("ray", small)][name]})
    nd = "bwd_no_dpos"
    records[1].update({
        "no_dpos_ms": times[("random", big)][nd],
        "no_dpos_bootstrap_ms": times[("random", small)][nd],
        "ray_no_dpos_ms": times[("ray", big)][nd],
        "ray_no_dpos_bootstrap_ms": times[("ray", small)][nd],
        "no_dpos_bound_ms": bound(*cost[nd], peak_flops=PEAK_F32_FLOPS)[0]})
    return records


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
    """Device ms of one 2048-ray x 1024-sample chunk's layers (CUDA events); the
    composite kernel also alone, on the chunk's own z and sigma."""
    from loner_tpu_torch.analysis._render_impl import get_chunk_renderer
    from loner_tpu_torch.analysis.ab_compare import composite_launcher, kernel_ms
    from loner_tpu_torch.analysis.renderer_lidar import build_lidar_ray_directions
    from loner_tpu_torch.mapping.rays import get_far_val
    from loner_tpu_torch.models.field import query_field
    from loner_tpu_torch.models.rendering import make_sampler, pack_rays
    from loner_tpu_torch.ops import composite as cp
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
            "composite_kernel": kernel_ms(composite_launcher(cp, z, sig, far, dn)),
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


def merged(base: dict, changes: dict) -> dict:
    """``base`` with ``changes`` laid over it, key by key (a sequence config's
    ``changes:`` overlay)."""
    out = dict(base)
    for k, v in changes.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def box_room_settings(log_prefix: str) -> dict:
    """cfg/synthetic/box_room.yaml (a bare ``!include ../defaults.yaml``: the
    reference's model, hash sigma field and OGM sampler) as a plain dict (the
    card's machine has no PyYAML). On purpose it differs in the log prefix and
    ``system.precompile`` (kernels built and every program run once before the
    clock starts). tests/test_torch_slam.py holds the rest equal to the YAML."""
    schedule_item = lambda n, **kw: {"num_iterations": n, "freeze_poses": False,  # noqa: E731
                                     **kw, "freeze_rgb_mlp": True}
    sync = {"enabled": True, "min_buffer_size": 2, "max_time_delta": 3}
    icp_stage = lambda t: {"threshold": t, "max_iterations": 10, "relative_fitness": 1e-08,  # noqa: E731
                           "relative_rmse": 1e-08}
    hash_grid = lambda log2: {"base_resolution": 16, "log2_hashmap_size": log2,  # noqa: E731
                              "n_features_per_level": 2, "n_levels": 16, "otype": "HashGrid"}
    mlp = lambda layers: {"activation": "ReLU", "n_hidden_layers": layers,  # noqa: E731
                          "n_neurons": 64, "otype": "MLP", "output_activation": "None"}
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
                "keyframe_selection": {"strategy": "TEMPORAL", "temporal": {"time_diff_seconds": 3},
                                       "motion": {"translation_threshold_m": 0.5,
                                                  "rotation_threshold_deg": 22.5}},
                "window_selection": {"strategy": "HYBRID", "hybrid_settings": {"num_recent_frames": 1},
                                     "window_size": 8},
            },
            "optimizer": {
                "freeze_poses": False, "enabled": True, "seed": 0, "detach_rgb_from_poses": True,
                "detach_rgb_from_sigma": False, "skip_pose_refinement": True,
                "num_samples": {"lidar": 512, "sky": 64, "camera": 0},
                "rays_selection": {"strategy": "RANDOM"},
                "samples_selection": {"strategy": "OGM"},
                "keyframe_schedule": [
                    {"num_keyframes": 1, "iteration_schedule": [
                        {"num_iterations": 1000, "freeze_poses": True, "freeze_sigma_mlp": False,
                         "freeze_rgb_mlp": True}]},
                    {"num_keyframes": -1, "iteration_schedule": [
                        schedule_item(50, latest_kf_only=True, freeze_sigma_mlp=True),
                        schedule_item(50, freeze_sigma_mlp=False)]},
                ],
                "model_config": {
                    "data": {"ray_range": [1, 10]},
                    "model": {
                        "num_colors": 3, "model_type": "nerf_decoupled",
                        "nerf_config": {
                            "enable_view_dependence": True,
                            "dir_encoding_intensity": {"degree": 4, "otype": "SphericalHarmonics"},
                            "intensity_network": mlp(4),
                            "pos_encoding_intensity": hash_grid(19),
                            "pos_encoding_sigma": hash_grid(18),
                            "sigma_network": mlp(1),
                        },
                        "ray_range": [1, 10],
                        "render": {"N_samples_train": 512, "N_samples_test": 2048, "retraw": True,
                                   "lindisp": False, "perturb": 1.0, "white_bkgd": False,
                                   "raw_noise_std": 1.0, "chunk": 16384, "netchunk": 0},
                        "occ_model": {"voxel_size": 100, "lr": 0.0001, "N_iters_acc": 10},
                    },
                    "train": {"lrate_sigma_mlp": 0.01, "lrate_rgb": 0.01, "lrate_pose": 0.001,
                              "encode_impl": "vjp_bf16", "lrate_gamma": 1.0, "decay_rate": 0.001,
                              "pose_lrate_gamma": 1.0, "rgb_weight_decay": 1e-05,
                              "sigma_weight_decay": 0.0},
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
                                "frame_delta_t_sec_tolerance": 0.02, "decimate_on_load": True},
            "icp": {"scan_duration": 0.9, "schedule": [icp_stage(1.5), icp_stage(0.125)],
                    "downsample": {"type": "UNIFORM", "target_uniform_point_count": 5000,
                                   "voxel_downsample_size": 0.1}},
            "motion_compensation": {"enabled": True},
            "compute_sky_rays": False,
        },
    }


def flagship_slam_settings(log_prefix: str) -> dict:
    """cfg/synthetic/box_room_tpu_rt_r4.yaml (box_room_settings with the
    flagship's changes: Fourier field, proposal sampler) as a plain dict. On
    purpose it also differs in the test-render compositor (the fused one, as
    cfg/model_config/tpu_native_model_config.yaml has it; mapping does not read
    it). tests/test_torch_slam.py holds the rest equal to the YAML."""
    ray_range = [0.5, 14.0]
    return merged(box_room_settings(log_prefix), {
        "mapper": {
            "keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 3.0}}},
            "optimizer": {
                "num_samples": {"sky": 0},
                "samples_selection": {"strategy": "PROPOSAL"},
                "model_config": {
                    "data": {"ray_range": ray_range},
                    "model": {
                        "nerf_config": {
                            "encoding_sigma": "fourier", "compute_dtype": "bfloat16",
                            "fourier_sigma": {"n_freqs": 48, "scale": 6.0, "include_input": True},
                            "sigma_network": {"n_hidden_layers": 2, "n_neurons": 256},
                        },
                        "ray_range": ray_range,
                        "render": {"N_samples_test": 1024, "compositor": "pallas"},
                        "occ_model": {"prop_lr": 0.001, "prop_n_ctrl": 33,
                                      "proposal": {"n_freqs": 16, "scale": 3.0, "n_neurons": 64,
                                                   "n_hidden_layers": 2},
                                      "prop_train_subsample": 8},
                    },
                    "train": {"lrate_sigma_mlp": 0.005, "steps_per_dispatch": 3,
                              "max_inflight_dispatches": 1, "point_chunk": 0},
                },
            },
        },
        "tracker": {"frame_synthesis": {"decimate_on_load": False}},
    })


def write_slam_dataset(root: str, num_scans: int = SLAM_SCANS) -> dict:
    """The box-room sequence (``num_scans`` scans on a 270-degree arc) through
    the port's ScanStreamWriter, and its GT map (``build_gt_map``, the reference
    of phases 13 and 14); both configurations' SLAM runs share them."""
    from loner_tpu_torch.analysis.create_lidar_map import build_gt_map
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence

    t0 = time.perf_counter()
    scans, poses, ts, scene, _ = generate_sequence(
        num_scans=num_scans, lidar=VirtualLidar(num_channels=SLAM_LIDAR[0],
                                                 num_columns=SLAM_LIDAR[1]))
    writer = ScanStreamWriter(root)
    for scan in scans:
        writer.add_scan(scan)
    writer.write_gt(poses, ts)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_map = build_gt_map(root)
    print(f"SLAM dataset: {num_scans} scans of {SLAM_LIDAR[0] * SLAM_LIDAR[1]} rays, "
          f"{ts[-1] - ts[0] + 0.1:.1f} s of sequence, written in {written:.2f} s; GT map "
          f"{gt_map.shape[0]} points in {time.perf_counter() - t0:.2f} s", flush=True)
    return {"dataset": root, "scene": scene, "poses": poses, "ts": ts, "gt_map": gt_map}


def check_icp_card_against_cpu(dev, dataset: str) -> dict:
    """One real frame pair (scans 0 and 2, the 5 Hz decimation) at 5120 points
    through run_icp_schedule on the card and on the CPU; one dispatch on the
    tracker's kind of stream under torch.cuda.set_sync_debug_mode("error"); the
    tracker's ICPGraph of the same schedule, captured on that stream, equal to
    the eager dispatch to the bit, with a host init and chained; its time behind
    two kinds of backlog on the default stream, replayed on the tracker's
    high-priority stream and on one of default priority, beside the eager
    dispatch's and the backlog's own."""
    from loner_tpu_torch.common.frame import Frame
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
    from loner_tpu_torch.tracking.icp import ICPGraph, run_icp_schedule

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
        # The tracker's graph of the same schedule: equal to the eager dispatch.
        graph = ICPGraph(dev, schedule, pad_size=5120)
        graph.capture()
        replayed = graph(src, tgt, None)
        chained_graph = graph(src, tgt, replayed.transformation)
        eager = torch.cat([card.transformation.reshape(16), card.fitness.reshape(1),
                           chained.transformation.reshape(16), chained.fitness.reshape(1)])
        graphed = torch.cat([replayed.transformation.reshape(16), replayed.fitness.reshape(1),
                             chained_graph.transformation.reshape(16),
                             chained_graph.fitness.reshape(1)])
        same = torch.equal(eager, graphed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        graph(src, tgt, None)
        end.record()
        graph_host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        graph_device_ms = start.elapsed_time(end)

        # Priority: the ICP behind a backlog on the default stream, of 60 bf16
        # 8192^2 products or of 500 elementwise kernels of many short blocks;
        # the graph replayed on the tracker's high-priority stream and on one
        # of default priority, and the eager dispatch on the high-priority one.
        big = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
        vec = torch.zeros(1 << 26, device=dev)
        backlogs = {"products": lambda: [big @ big for _ in range(60)],
                    "elementwise": lambda: [vec.add_(1.0) for _ in range(500)]}
        low = torch.cuda.Stream(dev, priority=0)
        runs = {"alone": (None, None), "graph high": (stream, lambda: graph(src, tgt, None)),
                "graph default": (low, lambda: graph(src, tgt, None)),
                "eager high": (stream, lambda: run_icp_schedule(src, tgt, schedule,
                                                                pad_size=5120, device=dev))}

        def under_backlog(fill, s, icp) -> float:
            torch.cuda.synchronize()
            with torch.cuda.stream(torch.cuda.default_stream(dev)):
                if icp is None:  # the backlog alone
                    start.record()
                fill()
                if icp is None:
                    end.record()
            if icp is not None:
                with torch.cuda.stream(s):
                    start.record()
                    icp()
                    end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        backlog_ms = {}
        for kind, fill in backlogs.items():
            under_backlog(fill, stream, runs["graph high"][1])  # warm-up
            for name, (s, icp) in runs.items():
                backlog_ms[f"{kind}: {name}"] = under_backlog(fill, s, icp)
        del big, vec
    t_cpu = run_icp_schedule(src, tgt, schedule, pad_size=5120,
                             device=torch.device("cpu")).transformation.numpy()
    err = float(np.abs(t_card - t_cpu).max())
    print(f"ICP card vs CPU, one frame pair at 5120 points: max |dT| {err:.3e} (tolerance "
          f"{ICP_CARD_CPU_TOL}), no host sync in a dispatch; one dispatch {host_ms:.3f} ms on "
          f"the host, {device_ms:.3f} ms on the card (CUDA events); as one CUDA graph "
          f"{graph_host_ms:.3f} / {graph_device_ms:.3f} ms, transform and fitness equal to the "
          f"eager dispatch's (and chained): {same}; behind a backlog on the default stream, "
          f"ms: {json.dumps(backlog_ms)}", flush=True)
    if not err <= ICP_CARD_CPU_TOL:
        raise RuntimeError(f"ICP on the card disagrees with the CPU: {err}")
    if not same:
        raise RuntimeError("the ICP graph disagrees with the eager dispatch")
    return {"icp_card_cpu_err": err, "icp_host_ms": host_ms, "icp_device_ms": device_ms,
            "icp_graph_host_ms": graph_host_ms, "icp_graph_device_ms": graph_device_ms,
            "icp_graph_backlog_ms": backlog_ms}


def check_map_depth(dev, log_dir: str, scene, gt0: np.ndarray, kernels, compositor) -> dict:
    """render_full_map at the first keyframe (the anchored, identity pose of
    the SLAM frame; the ground-truth pose of scan 0 in the scene) through the
    sampler, sigma and compositing of the run's configuration; each kept point's
    range against the analytic raycast along its ray. Returns the launches of
    ``kernels``, each of which must launch."""
    from loner_tpu_torch.analysis.render_utils import kf_pose_matrices, load_experiment
    from loner_tpu_torch.analysis.renderer_lidar import render_full_map

    model = load_experiment(log_dir, device=dev)
    mats, _ = kf_pose_matrices(model)
    if model.compositor != compositor:
        raise RuntimeError(f"the SLAM run's config renders with compositor {model.compositor}")
    reset_counts()
    cloud = render_full_map(log_dir, skip_step=len(mats), voxel_size=0.02, device=dev)
    launches = {k: read_counts()[k] for k in kernels}
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
    return {"map_median_m": med, "launches": launches}


def test_chunk_memory(dev, log_dir: str) -> None:
    """One test-render chunk at the configuration's sizes (model.render: chunk
    rays x N_samples_test samples, 16384 x 2048 = 33.5 M field points at
    box_room.yaml): its device time and peak device memory, the field evaluated
    in blocks of render_rays.POINT_BLOCK points."""
    from loner_tpu_torch.analysis.render_utils import (
        kf_pose_matrices, load_experiment, render_depth_chunked,
    )
    from loner_tpu_torch.analysis.renderer_lidar import build_lidar_ray_directions

    model = load_experiment(log_dir, device=dev)
    render = model.settings.mapper.optimizer.model_config.model.render
    rays, samples = int(render["chunk"]), int(render["N_samples_test"])
    pose = kf_pose_matrices(model)[0][0]
    dirs = build_lidar_ray_directions()[:rays] @ pose[:3, :3].T
    origins = np.broadcast_to(pose[:3, 3], dirs.shape)
    ray_range = tuple(model.settings.mapper.optimizer.model_config["data"]["ray_range"])
    render_depth_chunked(model, origins[:64], dirs[:64], ray_range, n_samples=samples, chunk=64)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = render_depth_chunked(model, origins, dirs, ray_range, n_samples=samples, chunk=rays)
    ms = 1e3 * (time.perf_counter() - t0)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    if not np.isfinite(out["depth"]).all():
        raise RuntimeError("test-render chunk: non-finite depth")
    print(f"test-render chunk: {rays} rays x {samples} samples in one chunk: {ms:.3f} ms, peak "
          f"device memory above the loaded model {peak_gb:.3f} GB", flush=True)


# Phases 13 and 14, map quality. The bars the JAX package's drive of rt_r4 (600
# scans) cleared by a wide margin (F 0.98, L1 0.13-0.16 m;
# artifacts/map_fidelity_r4/README.md:41-42).
F_SCORE_MIN = 0.60  # F@0.1 m of the map cloud against the masked GT map
L1_MEAN_MAX = 0.25  # m, mean |rendered - measured| depth over 25 random scans
# The L1 bar is gated on that drive (phase 14), not on the 150-scan sequence of
# phases 9 and 11, where neither configuration meets it (H100: flagship 0.5145 m,
# hash+OGM 0.3461 m; analysis/l1_breakdown.py): its arc is 4x the drive's speed,
# so the metric's pose provider (keyframes 3 s apart, interpolated) is up to
# 0.4 m off the scans' poses, and its bootstrap keyframe, scan 0, is taken on the
# first obstacle's face and its rays pass through that box, which every later
# scan sees as solid. On the drive both weigh less.
DRIVE_SCANS = 600  # 60 s at 10 Hz, examples/run_loner.py's synthetic drive
# The mesh through the kernels against the mesh through the plain paths (plain
# sigma, plain compositor), resolution 256, level 0.1: the weight grids differ
# where bf16 / f32 summation order moves a sample's weight across the level.
# Measured on an H100 (the 150-scan runs): chamfer 4.7e-7 m flagship, 0 reference;
# equal counts.
MESH_CHAMFER_MAX = 1e-3  # m, symmetric chamfer of the two meshes' vertices
MESH_VERTEX_SHARE_MAX = 0.005  # |V_kernel - V_plain| / V_plain
MESH_PCD_POINTS = 5_000_000  # mesh_to_pcd's points: one batch, cut from its 50 M


def symmetric_chamfer(a: np.ndarray, b: np.ndarray) -> float:
    """Mean nearest-neighbour distance a -> b plus b -> a (metres)."""
    from scipy.spatial import cKDTree

    return float(cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def check_mesh(dev, label: str, log_dir: str, launches: dict) -> dict:
    """Phase 13's mesh of a finished SLAM run: ``get_mesh`` through the kernels
    and through the plain sigma path and plain compositor (phase 8's plain
    model), compared; the kernels' mesh sampled by ``mesh_to_pcd`` and scored
    against the run's masked GT map (not gated). Adds each mesh's launches to
    ``launches``; returns the failures."""
    from dataclasses import replace

    from loner_tpu_torch.analysis.evaluate_lidar_map import evaluate_lidar_map
    from loner_tpu_torch.analysis.mesh_to_pcd import mesh_to_pcd
    from loner_tpu_torch.analysis.mesher import get_mesh
    from loner_tpu_torch.analysis.render_utils import load_experiment
    from loner_tpu_torch.analysis.renderer_lidar import read_pcd

    meshes, mesh_s = {}, {}
    for name in ("kernel", "plain"):
        model = load_experiment(log_dir, device=dev)
        if name == "plain":
            model = replace(model, field_cfg=replace(model.field_cfg, sigma_kernel="plain"),
                            compositor="plain", render_cache={})
        reset_counts()
        mesh_s[name] = {}
        meshes[name] = get_mesh(log_dir, resolution=256, level=0.1, skip_step=4, model=model,
                                out_file=os.path.join(log_dir, "meshing", f"mesh_{name}.ply"),
                                report=mesh_s[name])
        launches[f"mesh {name}"] = read_counts()
    (vk, fk), (vp, fp) = meshes["kernel"], meshes["plain"]
    chamfer = symmetric_chamfer(vk, vp) if len(vk) and len(vp) else float("inf")
    share = abs(len(vk) - len(vp)) / max(len(vp), 1)
    print(f"mesh {label}: resolution 256, level 0.1, skip 4: kernels {len(vk)} vertices, "
          f"{len(fk)} faces, weight grid {mesh_s['kernel']['weight_grid_s']:.3f} s (largest "
          f"weight {mesh_s['kernel']['grid_max']:.4f}, {mesh_s['kernel']['cells_above_level']} "
          f"cells above the level), marching "
          f"{mesh_s['kernel']['marching_s']:.3f} s; plain {len(vp)} vertices, {len(fp)} faces, "
          f"{mesh_s['plain']['weight_grid_s']:.3f} s / {mesh_s['plain']['marching_s']:.3f} s; "
          f"kernels vs plain: symmetric chamfer {chamfer:.3e} m (bound {MESH_CHAMFER_MAX}), "
          f"vertex-count difference {share:.3e} (bound {MESH_VERTEX_SHARE_MAX})", flush=True)

    t0 = time.perf_counter()
    cloud = mesh_to_pcd(os.path.join(log_dir, "meshing", "mesh_kernel.ply"),
                        n_points=MESH_PCD_POINTS)
    pcd_s = time.perf_counter() - t0
    masked = read_pcd(os.path.join(log_dir, "lidar_renders", "gt_map_masked.pcd"))
    mesh_stats = evaluate_lidar_map(cloud, masked, device=dev)
    print(f"mesh {label} cloud: mesh_to_pcd {MESH_PCD_POINTS} samples -> {cloud.shape[0]} points "
          f"({pcd_s:.3f} s); against the masked GT map F@0.1 m {mesh_stats['f_score']:.4f}, "
          f"chamfer {mesh_stats['chamfer']:.4f} m, accuracy {mesh_stats['accuracy']:.4f} m, "
          f"completion {mesh_stats['completion']:.4f} m, precision "
          f"{mesh_stats['precision']:.4f}, recall {mesh_stats['recall']:.4f} (not gated)",
          flush=True)


    failures = []
    if not (chamfer <= MESH_CHAMFER_MAX and share <= MESH_VERTEX_SHARE_MAX):
        failures.append("the mesh through the kernels disagrees with the plain paths")
    if not np.isfinite(vk).all() or len(fk) == 0:
        failures.append("the mesh is empty or non-finite")
    if any(launches["mesh plain"].values()):
        failures.append(f"the plain mesh launched kernels: {launches['mesh plain']}")
    return {"failures": failures}


def check_map_quality(dev, label: str, log_dir: str, dataset: str, gt_map: np.ndarray,
                      field_kernel: str, compositor: str, drive: bool = False) -> dict:
    """Phase 13 on a finished SLAM run: against ``gt_map``, the dataset's GT
    map, the map-quality chain (map cloud, masked GT, F-score, L1) gated at
    F_SCORE_MIN, the mesh through the kernels and through the plain paths, the
    mesh's own cloud scored (not gated), and the regression record; with
    ``drive`` (phase 14) the chain gated at F_SCORE_MIN and L1_MEAN_MAX and the
    record, no mesh. Returns the launches of each step, which must reach the
    configuration's kernels."""
    from loner_tpu_torch.analysis.compute_l1_depth import compute_l1_depth
    from loner_tpu_torch.analysis.eval_map_quality import eval_map_quality
    from loner_tpu_torch.analysis.metrics_pipeline import write_regression_file
    from loner_tpu_torch.common.json_yaml import read_json_yaml

    launches = {}
    reset_counts()
    chain = eval_map_quality(log_dir, gt_map, dataset, device=dev, skip_l1=True)
    launches["map cloud"] = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    l1 = compute_l1_depth(log_dir, dataset, device=dev)
    l1_s = time.perf_counter() - t0
    launches["L1"] = read_counts()
    stats, secs = chain["statistics"], {**chain["seconds"], "l1": l1_s}
    l1_verdict = "met" if l1["mean"] <= L1_MEAN_MAX else "missed"
    print(f"map quality {label}: GT map {chain['gt_points']} points, map cloud "
          f"{chain['rendered_points']} points, masked GT {chain['masked_gt_points']}; "
          f"F@{stats['threshold']} m {stats['f_score']:.4f} (bar {F_SCORE_MIN}), chamfer "
          f"{stats['chamfer']:.4f} m, accuracy {stats['accuracy']:.4f} m, completion "
          f"{stats['completion']:.4f} m, precision {stats['precision']:.4f}, recall "
          f"{stats['recall']:.4f}; L1 mean {l1['mean']:.4f} m (bar {L1_MEAN_MAX}, "
          f"{'gated' if drive else 'gated on the drive in phase 14; here ' + l1_verdict}), RMSE "
          f"{l1['rmse']:.4f} m over {l1['num_rays']} rays; wall s: render {secs['render']:.3f}, "
          f"mask {secs['mask']:.3f}, ICP + NN {secs['evaluate']:.3f}, L1 {secs['l1']:.3f}",
          flush=True)

    mesh = {} if drive else check_mesh(dev, label, log_dir, launches)

    record = write_regression_file(log_dir)
    trial = record["trials"].get(".", {})
    keys = ("ate_rmse", "rpe_trans_rmse", "map_f_score", "map_chamfer", "l1_mean", "l1_rmse")
    missing = [k for k in keys if k not in trial]
    print(f"regression.yaml {label}: {json.dumps(trial)}", flush=True)
    print(f"map quality {label} launches: {json.dumps(launches)}", flush=True)

    failures = []
    if missing or read_json_yaml(os.path.join(log_dir, "regression.yaml")) != record:
        failures.append(f"regression.yaml lacks {missing} or does not read back")
    if not stats["f_score"] >= F_SCORE_MIN:
        failures.append(f"F@0.1 m {stats['f_score']} below {F_SCORE_MIN}")
    if drive and not l1["mean"] <= L1_MEAN_MAX:
        failures.append(f"L1 mean {l1['mean']} m above {L1_MEAN_MAX}")
    failures += mesh.get("failures", [])
    cloud_kernels = (field_kernel, "composite") if compositor == "pallas" else (field_kernel,)
    steps = [("map cloud", cloud_kernels), ("L1", (field_kernel,))]
    steps += [] if drive else [("mesh kernel", (field_kernel,))]
    for step, kernels in steps:
        failures += [f"{step}: {k} was not launched" for k in kernels if launches[step][k] < 1]
    if failures:
        raise RuntimeError(f"map quality {label}: " + "; ".join(failures))
    return {"launches": launches, "f_score": stats["f_score"], "l1_mean": l1["mean"]}


def run_slam(dev, label: str, settings: dict, sequence: dict, train_kernels, map_kernels,
             compositor: str, field_kernel: str, check_icp: bool = False,
             measure_test_chunk: bool = False, drive: bool = False) -> dict:
    """A threaded SLAM run through run_trial on ``dev`` at ``settings`` on the
    dataset of ``sequence`` (``write_slam_dataset``): RTF,
    ms per mapping iteration, tracking latency, peak memory, ATE of both
    trajectories, the map check, and the launches of ``train_kernels`` (each at
    least once per mapping iteration) and of ``map_kernels`` in the map check;
    with ``check_icp`` the ICP card-vs-CPU check, with ``measure_test_chunk`` one
    test-render chunk's time and memory; then phase 13 (with ``drive``, 14), the
    map quality of the run, whose renders reach ``field_kernel``."""
    import tempfile

    from loner_tpu_torch import run_loner
    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files

    dataset, scene, gt_poses, ts = (sequence[k] for k in ("dataset", "scene", "poses", "ts"))
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_slam_") as tmp:
        icp = check_icp_card_against_cpu(dev, dataset) if check_icp else {}

        loners = []

        class RecordingLoner(run_loner.Loner):
            def start(self):
                loners.append(self)
                super().start()

        settings["system"]["log_dir_prefix"] = os.path.join(tmp, "outputs")
        original, run_loner.Loner = run_loner.Loner, RecordingLoner
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            log_dir = run_loner.run_trial(settings, dataset, experiment_name=f"smoke_{label.replace(' ', '_')}",
                                          device=dev)
            wall = time.perf_counter() - t0
            counts = read_counts()
            launches = {k: counts[k] for k in train_kernels}
        finally:
            run_loner.Loner = original
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        (loner,) = loners
        state = loner.mapper.optimizer.state
        sigma = state.field_params["sigma"]
        placed = {"field": sigma["mlp"]["w0"].device,
                  "sampler state": (state.occ_grid["w0"] if isinstance(state.occ_grid, dict)
                                    else state.occ_grid).device,
                  "icp": loner.tracker._last_relative_dev.device}
        if "table" in sigma:
            placed["hash table"] = sigma["table"].device
        if any(d != dev for d in placed.values()):
            raise RuntimeError(f"SLAM tensors not on {dev}: {placed}")

        from loner_tpu_torch.common.cuda_graphs import pool_bytes

        opt = loner.mapper.optimizer
        graphs = {"mapper_captures": opt.graph_captures, "mapper_late_captures": opt.late_captures,
                  "mapper_pool_gb": pool_bytes(opt.graph_pool) / 1e9,
                  "icp_captures": loner.tracker.icp_graph.captures,
                  "icp_pool_gb": pool_bytes(loner.tracker.icp_graph.pool()) / 1e9}
        print(f"SLAM {label} CUDA graphs: {json.dumps(graphs)}", flush=True)

        runtime = float(open(os.path.join(log_dir, "runtime.txt")).read().split()[1])
        seq_s = float(ts[-1] - ts[0]) + 0.1
        timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
        track = np.loadtxt(os.path.join(log_dir, "track_times.csv"), delimiter=",", ndmin=2)
        its = int(timing[:, 0].sum())
        boot_ms = 1e3 * timing[0, 1] / timing[0, 0]
        win_ms = 1e3 * timing[1:, 1].sum() / max(timing[1:, 0].sum(), 1)
        print(f"SLAM {label}: {len(timing)} keyframes, {its} mapping iterations; per keyframe "
              "(iterations, s): " + ", ".join(f"({int(n)}, {t:.3f})" for n, t in timing),
              flush=True)
        print(f"SLAM {label}: runtime {runtime:.3f} s for {seq_s:.1f} s of sequence, real-time "
              f"factor {seq_s / runtime:.4f}; ms per mapping iteration: W=1 bootstrap "
              f"{boot_ms:.3f}, W=8 windows {win_ms:.3f}; tracking latency ({len(track)} updates) "
              f"median {1e3 * float(np.median(track[:, 0])):.3f} ms, p95 "
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
        print(f"SLAM {label} ATE RMSE: estimated {ate['estimated_trajectory']:.4f} m, tracking "
              f"only {ate['tracking_only']:.4f} m (bound {ATE_MAX})", flush=True)
        if not all(v < ATE_MAX for v in ate.values()):
            raise RuntimeError(f"SLAM {label} ATE above {ATE_MAX} m: {ate}")

        mapped = check_map_depth(dev, log_dir, scene, gt_poses[0], map_kernels, compositor)
        if measure_test_chunk:
            test_chunk_memory(dev, log_dir)
        quality = check_map_quality(dev, label, log_dir, dataset, sequence["gt_map"], field_kernel,
                                    compositor, drive=drive)
    return {"launches": launches, "counts": counts, "map_launches": mapped["launches"],
            "eval_launches": quality["launches"],
            "graphs": graphs, "track_p50_ms": 1e3 * float(np.median(track[:, 0])),
            "track_p95_ms": 1e3 * float(np.quantile(track[:, 0], 0.95)), "peak_gb": peak_gb,
            "rtf": seq_s / runtime, "boot_ms": boot_ms, "win_ms": win_ms, "iterations": its,
            "boot_iterations": int(timing[0, 0]), **icp}


DISPATCH_ITERS, DISPATCH_K = 7, 3  # two dispatches of 3 iterations, then one single step
DISPATCH_STEP0 = {"flagship": 0, "reference": 9}  # reference: global steps 9-15, the OGM
# step at 10, the middle of the first dispatch
# Reference, graphs against eager and against graphs again: the largest relative
# difference of a loss or depth_eps, and the relative L2 difference of a
# parameter's update over the phase. The hash table's gradient and the OGM grid's
# are sums of float atomics, in an order that changes from run to run, and Adam
# moves an entry whose gradient nearly cancels by about lr in either direction;
# two runs through graphs differ as much as graphs and eager (on an H100: losses
# 4e-4, depth_eps 9e-4, grid 1.1e-7, MLP 0.016, table 0.14, twists 0.79). The
# bounds are 3-6x those spreads; the twists' update is not held.
DISPATCH_REF_TOL = {"losses": 3e-3, "depth_eps": 3e-3, "OGM grid": 1e-4, "hash table": 0.5,
                    "sigma w0": 0.1, "sigma w1": 0.1}
DISPATCH_TIMED = 30  # iterations timed each way
DISPATCH_PROFILED = 6  # iterations under the profiler each way


def synthetic_window(dev, w: int):
    """A window of ``w`` keyframes of 65,536 unit directions and depths in [1.5,
    9.5] m, and twists, from a seed (the slice's and profile_iteration's)."""
    from loner_tpu_torch.mapping.rays import build_window_buffers

    rng = np.random.default_rng(0)
    dirs, depths = [], []
    for _ in range(w):
        d = rng.normal(size=(3, 65536))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        dirs.append(d.astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, 65536).astype(np.float32))
    buffers = build_window_buffers(dirs, depths, [None] * w, w, device=dev)
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32)).to(dev)
    return buffers, twists


def phase_outputs(out) -> dict:
    """A run_phase result as named tensors."""
    field, occ, twists, losses, eps = out
    named = {"losses": losses, "depth_eps": eps, "twists": twists}
    named.update({f"sigma {k}": v for k, v in field["sigma"]["mlp"].items()})
    if "table" in field["sigma"]:
        named["hash table"] = field["sigma"]["table"]
    if isinstance(occ, dict):
        named.update({f"proposal {k}": v for k, v in occ.items()})
    elif occ is not None:
        named["OGM grid"] = occ
    return named


def profiled_ms(fn, n: int) -> tuple:
    """(device ms an iteration, busy share of the traced wall) of ``fn()``, which
    runs ``n`` iterations, under torch.profiler."""
    from loner_tpu_torch.analysis.profile_iteration import device_events

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = sum(e.device_time_total for e in device_events(prof)) / 1e3
    return device / n, device / wall


def check_dispatch(dev) -> dict:
    """Phase 12: the flagship's and the reference's iterations at W=1 (frozen
    poses, the bootstrap's kind) and W=8 through the captured graphs and
    through the explicit eager loop, from one seed: 7 iterations at k = 3 (two
    dispatches and a single step); the graph runner run twice. The flagship
    must agree to the bit; the reference's hash and grid gradients are summed
    by float atomics, so it is held to DISPATCH_REF_TOL, both against eager and
    against the graphs' second run. Then ms an iteration and the device's busy
    share both ways."""
    from dataclasses import replace

    from loner_tpu_torch.analysis.profile_iteration import configs
    from loner_tpu_torch.mapping.optimizer import Optimizer, PhaseSettings, make_phase_runner

    record, failures = {}, []
    for config in ("flagship", "reference"):
        cfg, field_cfg = configs(config)
        cfg = replace(cfg, steps_per_dispatch=DISPATCH_K)
        step0 = DISPATCH_STEP0[config]
        for w, frozen in ((1, True), (8, False)):
            buffers, twists = synthetic_window(dev, w)
            state = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev).state
            phase = PhaseSettings(freeze_poses=frozen)
            runners = {mode: make_phase_runner(cfg, field_cfg, phase, w, buffers.dirs.shape[1],
                                               buffers.sky_dirs.shape[1], dev,
                                               graphs=mode == "graphs")
                       for mode in ("graphs", "eager")}
            common = (twists, buffers, torch.ones(w, device=dev), torch.tensor(12.0, device=dev),
                      torch.zeros(3, device=dev))

            def run(mode, n, s0=step0, seed=1):
                return runners[mode](state.field_params, state.occ_grid, *common, s0,
                                     torch.Generator(device=dev).manual_seed(seed),
                                     num_iterations=n)

            outs = {"graphs": phase_outputs(run("graphs", DISPATCH_ITERS)),
                    "eager": phase_outputs(run("eager", DISPATCH_ITERS)),
                    "graphs again": phase_outputs(run("graphs", DISPATCH_ITERS))}
            before = phase_outputs((state.field_params, state.occ_grid, twists,
                                    torch.zeros(0, device=dev), torch.zeros(0, device=dev)))
            diffs = {}
            for other in ("eager", "graphs again"):
                for name, t in outs["graphs"].items():
                    u = outs[other][name]
                    if name in ("losses", "depth_eps"):
                        err = float(((t - u).abs() / u.abs().clamp_min(1e-30)).max())
                    else:  # relative L2 of the parameter's update over the phase
                        base = before[name]
                        err = rel_l2(t - base, u - base)
                    diffs.setdefault(other, {})[name] = err
                bits = all(torch.equal(t, outs[other][name]) for name, t in outs["graphs"].items())
                diffs[other]["equal bits"] = bits
            finite = all(bool(torch.isfinite(t).all()) for t in outs["graphs"].values())
            label = f"{config} W={w}{' frozen poses' if frozen else ''}"
            print(f"dispatch {label}: {DISPATCH_ITERS} iterations at k = {DISPATCH_K}, global "
                  f"steps {step0}-{step0 + DISPATCH_ITERS - 1}; graphs vs eager: "
                  f"{json.dumps(diffs['eager'])}; graphs vs graphs: "
                  f"{json.dumps(diffs['graphs again'])}", flush=True)
            if not finite:
                failures.append(f"{label}: non-finite outputs through graphs")
            for other in ("eager", "graphs again"):
                if config == "flagship" and not diffs[other]["equal bits"]:
                    failures.append(f"{label}: graphs and {other} differ")
                for name, tol in DISPATCH_REF_TOL.items():
                    if config == "reference" and not diffs[other][name] <= tol:
                        failures.append(f"{label}: {name} differs by {diffs[other][name]} "
                                        f"(graphs vs {other}, tolerance {tol})")

            timing = {}
            for mode in ("graphs", "eager"):
                run(mode, DISPATCH_K)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(mode, DISPATCH_TIMED)
                torch.cuda.synchronize()
                host = 1e3 * (time.perf_counter() - t0) / DISPATCH_TIMED
                device, busy = profiled_ms(lambda m=mode: run(m, DISPATCH_PROFILED),
                                           DISPATCH_PROFILED)
                timing[mode] = {"host_ms": host, "device_ms": device, "busy": busy}
            print(f"dispatch {label}: ms an iteration (host clock, {DISPATCH_TIMED} "
                  f"iterations) graphs {timing['graphs']['host_ms']:.3f}, eager "
                  f"{timing['eager']['host_ms']:.3f}; device ms (profiler, "
                  f"{DISPATCH_PROFILED} iterations) {timing['graphs']['device_ms']:.3f} / "
                  f"{timing['eager']['device_ms']:.3f}, busy share "
                  f"{timing['graphs']['busy']:.3f} / {timing['eager']['busy']:.3f}; "
                  f"captures {runners['graphs'].captures}", flush=True)
            record[label] = {"diffs": diffs, "timing": timing}
            del runners, outs
            torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("dispatch: " + "; ".join(failures))
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from loner_tpu_torch.ops import composite as cp
    from loner_tpu_torch.ops import fourier_mlp as fm
    from loner_tpu_torch.ops import hash_grid as hg
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
    hg._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas_spills()
    sass_counts()

    cfg, field_cfg = flagship_configs()
    kernels = check_kernels(dev, field_cfg)
    launches, field, prop = run_slice(dev, cfg, field_cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    composite = check_composite(dev)
    composite["launches"] = run_render(dev, field, prop, field_cfg)
    kernels.append(composite)
    # Each SLAM path's launches go into the kernels' record: the flagship run's
    # for the Fourier pair and the composite (its map check), the reference
    # configuration's for the hash pair. Both runs share one dataset.
    import tempfile

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_slam_data_") as data_dir:
        sequence = write_slam_dataset(os.path.join(data_dir, "dataset"))
        slam = run_slam(dev, "flagship", flagship_slam_settings(""), sequence,
                        ("fourier_mlp_fwd", "fourier_mlp_bwd"), ("composite", "fourier_mlp_fwd"),
                        "pallas", "fourier_mlp_fwd", check_icp=True)
        for k in kernels:
            k["launches"] = {**slam["map_launches"], **slam["launches"]}[k["name"]]
        hash_kernels = check_hash_kernels(dev)
        reference = run_slam(dev, "hash+OGM", box_room_settings(""), sequence,
                             ("hash_encode_fwd", "hash_encode_bwd"), ("hash_encode_fwd",), "xla",
                             "hash_encode_fwd", measure_test_chunk=True)
    for k in hash_kernels:
        k["launches"] = reference["launches"][k["name"]]
        k["map_check_launches"] = reference["map_launches"].get(k["name"], 0)
    # The backward's launches split by variant: without dpos in the frozen-pose W=1
    # bootstrap, with dpos in the windows that refine poses.
    bwd = hash_kernels[1]
    bwd["launches_no_dpos"] = reference["counts"]["hash_encode_bwd_no_dpos"]
    bwd["launches_with_dpos"] = bwd["launches"] - bwd["launches_no_dpos"]
    print(f"SLAM hash+OGM: hash backward launches {bwd['launches']}: "
          f"{bwd['launches_no_dpos']} without dpos, {bwd['launches_with_dpos']} with it "
          f"({reference['boot_iterations']} bootstrap iterations of "
          f"{reference['iterations']})", flush=True)
    windows = reference["iterations"] - reference["boot_iterations"]
    if not (bwd["launches_no_dpos"] >= reference["boot_iterations"]
            and bwd["launches_with_dpos"] >= windows):
        raise RuntimeError("the hash backward's launches do not split between the frozen-pose "
                           "bootstrap (without dpos) and the windows (with it)")
    kernels += hash_kernels
    check_dispatch(dev)
    # Phase 14: both configurations on the drive, the cell of the bars.
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_drive_") as data_dir:
        drive = write_slam_dataset(os.path.join(data_dir, "dataset"), DRIVE_SCANS)
        slam_drive = run_slam(dev, "flagship drive", flagship_slam_settings(""), drive,
                              ("fourier_mlp_fwd", "fourier_mlp_bwd"),
                              ("composite", "fourier_mlp_fwd"), "pallas", "fourier_mlp_fwd",
                              drive=True)
        reference_drive = run_slam(dev, "hash+OGM drive", box_room_settings(""), drive,
                                   ("hash_encode_fwd", "hash_encode_bwd"), ("hash_encode_fwd",),
                                   "xla", "hash_encode_fwd", drive=True)
    # Phases 13 and 14's launches, per run and step (map cloud, L1, mesh).
    runs = (("flagship", slam), ("reference", reference), ("flagship drive", slam_drive),
            ("reference drive", reference_drive))
    for k in kernels:
        k["eval_launches"] = {name: {step: counts[k["name"]]
                                     for step, counts in run["eval_launches"].items()}
                              for name, run in runs}

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
