#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (loner_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card; imports
nothing of JAX. Phases, each of which raises on failure:

1. Device: no CUDA card, no run. Prints the card's name and power limit.
2. Build: compiles the CUDA sources of loner_tpu_torch/csrc into build/, one
   nvcc process per source, all started together; prints each kernel's
   ptxas -v report and fails if a hash-grid kernel spills; counts each
   kernel's HGMMA (wgmma), HMMA (mma.sync), UBLKCP / UTMALDG (bulk / tensor
   copies) and LDGSTS (cp.async) instructions in the built SASS (cuobjdump), and
   fails if a bf16 Fourier-MLP kernel has no HGMMA or an f32 one no HMMA (the
   composite and hash kernels use none).
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
   2^18), features, dpos and the fixed-point table gradient equal to the bit, in
   bf16 and f32, with dpos and without: at the mapping path's 2,097,152 and
   262,144 points in the order a mapping iteration gives them (rays of 512
   sorted samples) and at random, and at the edge cases of the warp-level work
   (one index for every lane, runs across warps and blocks, ragged counts, the
   unit cube's faces); at 2,097,152 points the table gradient's int64 sums also
   equal under a permutation of the points and under 2- and 4-way splits; the
   scale S and each sum's readings (magnitude, largest |contribution|, largest
   |entry sum|) printed as headroom; timed at both orders and counts beside the
   plain version and the bound. Phases 11, 14 and 18 print the readings of the
   hash tables' and the OGM grid's sums over their hash SLAM runs.
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
13. Map quality, after each SLAM run of phases 9 and 11 on its directory:
   against the sequence's GT map (``build_gt_map``), the ``eval_map_quality``
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
15. Sky rays: the Fourier pair against its plain version at the sky iteration's
   2,359,296 points (8 x (512 + 64) rays x 512 samples); that iteration through
   the captured graphs, and its loss and twist gradient through the kernels
   against the plain sigma path (phase 4's tolerances); then the open-sky box
   room (no ceiling) through threaded SLAM at cfg/synthetic/box_room_sky.yaml
   and box_room_sky_off.yaml (plain dicts), each with phase 9's checks (ATE
   printed), the map-quality chain gated at F_SCORE_MIN and
   ``analysis/sky_floaters.py``: the sky run's mean sky opacity against
   SKY_OPACITY_RATIO_MAX x the other's and its floater share against the
   other's, on SLAM_SCANS scans printed as met or missed, on DRIVE_SCANS scans
   (the JAX package's sky drive) gated; the drive's opacities also at its last
   keyframe of the first SLAM_SCANS scans, printed.
16. Resume: phase 9's flagship run stopped after RESUME_AT_S seconds of data and
   resumed in place through ``run_trial(resume_from=...)``: graphs captured and
   replayed, keyframes and ``ckpt_<k>`` numbering continued, timestamps strictly
   increasing, the tracking seam within SEAM_SHARE_MAX of the median step; ATE
   printed beside phase 9's.
17. Courtyard: the Fourier pair at cfg/synthetic/courtyard_tpu_r5f.yaml's head
   (96 frequencies: a first layer of 195 rows) against its plain version at
   2,097,152 points, timed; then that configuration (a plain dict) through
   threaded SLAM on the first COURTYARD_SCANS scans of the 64 x 1024 courtyard
   drive (the one cut), with phase 9's checks but for the map quality (ATE
   printed, not gated).
18. Camera: the f32 kernels' fragment self-test (one split-TF32 m16n8k8
   product in each operand form against float64); the Fourier pair at the
   camera rays' 524,288 points; the f32 pair (csrc/fourier_mlp_f32.cu,
   box_room_camera.yaml's head) against its plain version in f32 at its SLAM
   call size (24,576 points) and at a render chunk (2,097,152), with the
   plain version in float64 beside it, timed beside both bounds (CUDA cores
   and split TF32), library_ms, its resident blocks an SM and ptxas's
   registers and spills; the hash pair at the intensity tables; then
   box_room_tpu_camera_r5.yaml and box_room_camera.yaml through SLAM with
   one virtual-camera image a scan, each followed by its PSNR.
19. Real-data drill: the port's bag generator writes DRILL_SECONDS of the box room
   as an Ouster bag at the sensor's width (128 x 1024, 48-byte stride, bz2, u32 ns
   per-point times, epoch-second stamps) and the port's converter turns it into a
   scan stream (seconds and MB/s of each); the host decode (csrc/scan_ops.cpp)
   against its plain version on one sweep; two 2-scan bags in the other stamp
   modes (epoch_f64; zeros with --recompute_timestamps) converted and their
   stamps checked; then cfg/synthetic/box_room_drill.yaml through threaded SLAM
   with phase 9's checks (ATE gated), the mapper's captures after warm-up held
   to phase 9's, and the metrics pipeline on the run against the bag's /tf
   ground truth, its ATE gated at ATE_MAX.
20. Run breadth: (a) the flagship W=8 iteration through the captured graphs
   with the per-iteration debug record, "ray" for one dispatch of
   steps_per_dispatch iterations and "full" for RECORD_FULL_ITERS: parameters,
   twists and losses equal to the bit to the same iterations without it, the
   graphs' records equal to the eager loop's, the records dumped (bytes and
   seconds); (b) threaded SLAM on the first DEBUG_SCANS scans of phase 9's
   sequence at its settings with the six debug flags on (DEBUG_CUT: a keyframe a
   second, 64 rays a slot, 6 + 3 + 3 iterations): a frame cloud a tracked
   frame, each keyframe's ray clouds, loss CSVs, samples and margins, no capture
   after warm-up; (c) phase 6's experiment again: ``render_sequence`` at 512 x
   256 x 2048 samples with peak maps on two poses, one frame against the plain
   sigma path and plain compositor at phase 8's tolerances, ``render_flythrough``
   on 12 poses with its AVI's frame count, frames and JPEG frames a second;
   (d) ``plot_poses``, ``depth_to_warp`` / ``vis_flow`` on (c)'s frames, and
   ``run_loner --num_repeats 2 --trial_workers 2 --gpu_ids 0`` as a child
   process, both trials rc 0, each trial's wall time printed.
21. Mesh (``system.mesh_devices``, ``parallel/mesh.py``): the forward and the
   backward of four W=8 windows (the flagship's 4096 LiDAR rays, its 4608 LiDAR
   and sky rays, the camera configuration's 1024 camera rays, the reference's
   4096 rays through its hash field and OGM sampler) in one batch against 2 and
   4 batches of its rays, op by op (``forward_batch_witness``: the ray build,
   the proposal MLP's products, the row sum, the cumsum, the inverse CDF or the
   OGM sampler, the sigma field, the compositing, the JS score; for camera rays
   the intensity head and the colours; then the per-sample cotangents at sigma
   (and the colours), the transmittance's reversed cumsum, per-point dpos and,
   for the hash field, the cotangent at the encoder's output), in bf16 and f32,
   no ray of an op the port runs differing in any bit; the flagship's W=8 phase
   (3 iterations) with two gloo ranks, four and [2, 2] sharing the card, eagerly
   (each rank runs the Fourier pair on its share), and on four ranks the sky
   window's too, against the same phase without a mesh (MESH_GATE; the CPU
   tests' tolerances printed as met or missed, and held in f32), with a planted
   fault MESH_GATE must refuse; the reference's W=8 on the same meshes:
   iteration 1's hash-table and OGM-grid int64 sums equal to one card's to the
   bit, 3 iterations printed beside MESH_GATE (held to it where they meet it; on
   two ranks with the planted fault too); then a
   one-rank NCCL mesh through the graphs, its collectives captured, equal to the
   bit to the graphs without a mesh, and the Optimizer on it through its
   teardown. Prints cards, ranks and backend. With four cards,
   ``run_mesh_cards`` (called alone, ``python3 -c "import chip_smoke, torch;
   chip_smoke.run_mesh_cards(torch.device('cuda', 0))"``) runs
   ``run_loner``'s SLAM with ``mesh_devices`` 2, 4 (``tracker.icp.device: 1``)
   and [2, 2] against one card, each to a clean exit with every NCCL
   communicator destroyed and each rank's teardown seconds; the device and
   trial pools over the four cards; the W=8 iteration of both configurations
   at 1, 2 and 4 NCCL ranks and on [2, 2] with the gradient all-reduce alone;
   and a follower killed inside a W=8 phase on four NCCL ranks, which rank 0
   must name, leaving no process and no card memory behind.
22. The last ports: (a) each field option no config in cfg/ sets, whose path is
   plain PyTorch (FIELD_OPTIONS: the Fourier encode under ``encode_impl: xla``,
   the MLPs' autograd under ``mlp_grad: xla``, a Fourier head without its input
   features, the hash head in bf16), on the card against the CPU at the CPU
   tests' tolerances; (b) the robustness drill (``robustness_drill.py``):
   courtyard_tpu_r5f.yaml at its full width, threaded, on the first
   ROBUSTNESS_SCANS scans of the static courtyard, ``courtyard_actors``, range
   noise 0.15 m and dropout 0.3 (the phase's one cut), each scored against the
   static GT map; every figure finite, printed beside the JAX package's TPU
   record of the whole drive.
23. Repeat (beside phase 19's bag, on a copy of phase 9's sequence): two
   single-threaded runs of ``python -m loner_tpu_torch.run_loner`` on its first
   60 scans for the reference configuration and two for the flagship, all four
   at once: each configuration's final poses, trajectory files and checkpoint
   tensors equal to the bit between its two runs.

Each phase prints its seconds.

The mapping iteration and the ICP schedule run as CUDA graphs wherever the
port runs them (phases 4, 9, 11, 15-17: ``steps_per_dispatch`` replays a dispatch);
each SLAM run prints its graphs' captures and memory pools, and the ICP check
of phase 9 holds the tracker's ICP graph to the eager dispatch. Launch counts
count replays (``common/cuda_graphs.py``).

Each path sets every launch count to 0 just before it runs and reads them just
after (phase 20: the record runs, the debug SLAM run, render_sequence and
render_flythrough; phase 21: each mesh run, rank 0's launches; phase 22: each
field option, each drill run's drive and its scoring); the kernels' record lists
each path's launches (``launches_by_path``)
and the Fourier pair's times at the sky and courtyard call sizes
(``at_shapes``). The second-to-last line of output is that JSON record; the
last is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
from typing import Optional

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
# The f32 kernels against the plain version in f32: summation order only (a
# ReLU flip at an exact zero is rare in f32).
F32_FWD_MAX_ABS = 1e-3
F32_GRAD_REL_L2 = 1e-4
# One split-TF32 m16n8k8 product of O(1) values against float64: ~1e-6 (eight
# products, each within ~2^-21 of exact); one TF32 product would be off ~1e-3,
# a wrong fragment mapping O(1).
MMA_SELFTEST_MAX_ABS = 1e-5
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

# Hash-grid encode, kernel against plain version on the card. Both take the same
# rounded f32 operations in the same order (no FMA contraction), so the features
# and the position gradient must agree to the bit. The table gradient is a
# fixed-point sum (ops/fixed_point.py): each f32 term rounded to int64 the same way
# in both, summed in int64, so it must agree to the bit too, and equal itself
# under a permutation of the points and when they are split into HASH_SPLITS parts
# whose int64 sums are added.
HASH_SPLITS = (2, 4)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): bf16
# tensor cores, f32 outside the tensor cores, and HBM3. bound_ms is the larger of
# operations over the peak of their type and bytes (each input read once, each
# output written once) over the HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# f32-accurate products either run on the CUDA cores (67 TFLOP/s) or on the TF32
# tensor cores as three products each (split TF32: 495 / 3 = 165 TFLOP/s of
# f32-accurate work): the least time for f32 work is the lesser of the two, so
# a kernel's share stays at or below 100% whichever unit it uses.
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def f32_bound(flops: float, nbytes: float):
    """bound() for f32-accurate work: its operations at the lesser of the CUDA-core
    time and the split-TF32 tensor-core time (PEAK_TF32_FLOPS). Returns (ms, by,
    CUDA-core ms, tensor-core ms)."""
    t_cuda, t_tensor = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * 3 * flops / PEAK_TF32_FLOPS
    ms, by = bound(flops, nbytes, peak_flops=1e3 * flops / min(t_cuda, t_tensor))
    return ms, by, t_cuda, t_tensor


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from loner_tpu_torch.ops import composite, fourier_mlp, hash_grid, sigma_mlp

    for module in (composite, fourier_mlp, hash_grid, sigma_mlp):
        module.counts.reset()


def read_counts() -> dict:
    """Every kernel's launches since the last ``reset_counts``, by name."""
    from loner_tpu_torch.ops import composite, fourier_mlp, hash_grid, sigma_mlp

    return {"fourier_mlp_fwd": fourier_mlp.counts.fwd_launches,
            "fourier_mlp_bwd": fourier_mlp.counts.bwd_launches,
            "fourier_mlp_fwd_f32": fourier_mlp.counts.fwd_f32_launches,
            "fourier_mlp_bwd_f32": fourier_mlp.counts.bwd_f32_launches,
            "composite": composite.counts.composite_launches,
            "hash_encode_fwd": hash_grid.counts.fwd_launches,
            "hash_encode_bwd": hash_grid.counts.bwd_launches,
            "hash_encode_bwd_no_dpos": hash_grid.counts.bwd_no_dpos_launches,
            "sigma_mlp_fwd": sigma_mlp.counts.fwd_launches,
            "sigma_mlp_bwd": sigma_mlp.counts.bwd_launches}


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


def print_ptxas(lib: str, prefix: str = "ptxas") -> None:
    """Each kernel's registers, stack and spills from csrc/<lib>.cu's ptxas -v report."""
    import re

    from loner_tpu_torch.ops.build import ptxas_report

    func = None
    for line in ptxas_report(lib).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = kernel_name(m.group(1))
        elif func and ("Used" in line or "spill" in line):
            print(f"{prefix} {lib} {func}: {line.replace('ptxas info    :', '').strip()}", flush=True)


def ptxas_spills() -> None:
    """Prints each built kernel's ptxas -v report (registers, shared memory,
    spills); fails if a hash-grid kernel spills."""
    import re

    from loner_tpu_torch.ops.build import ptxas_report

    for lib in ("fourier_mlp", "fourier_mlp_f32", "composite", "hash_grid", "sigma_mlp"):
        print_ptxas(lib)
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas_report("hash_grid"))
    if any(int(b) for b in spills):
        raise RuntimeError("a hash-grid kernel spills registers (ptxas -v above)")


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled name, e.g.
    fwd_kernel<256>, composite_kernel<1,8,1>, fwd_f32_kernel<72,128,4>."""
    import re

    found = None
    for m in re.finditer(r"\d+", mangled):
        run = m.group(0)
        for i in range(len(run)):  # "_GLOBAL__N_1" runs into the name's length
            k = int(run[i:])
            name = mangled[m.end() : m.end() + k]
            if len(name) == k and name.endswith("kernel"):
                # The latest start wins: an anonymous namespace's hash may end in
                # digits that read as a longer name ending at the same place.
                found = (m.end(), name)
                break
    if found is None:
        return mangled
    end, name = found
    rest = mangled[end + len(name) :]
    args = re.findall(r"L[a-z](\d+)E", rest[: rest.find("Ev")]) if rest[:1] == "I" else []
    return name + (f"<{','.join(args)}>" if args else "")


def sass_counts() -> dict:
    """HGMMA, HMMA, bulk / tensor-copy and cp.async instructions of each kernel in
    the built libraries (cuobjdump -sass). Fails if a bf16 Fourier-MLP kernel has
    no HGMMA or an f32 one no HMMA (the composite and hash kernels use none)."""
    import re
    import shutil

    from loner_tpu_torch.ops.build import _target

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    ops = ("HGMMA", "HMMA", "UBLKCP", "UTMALDG", "LDGSTS")
    counts = {}
    for lib in ("fourier_mlp", "fourier_mlp_f32", "composite", "hash_grid"):
        sass = subprocess.run([tool, "-sass", str(_target(lib))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        func = None
        for line in sass.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                func = kernel_name(m.group(1))
                counts[func] = dict.fromkeys(ops, 0)
                continue
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m and func and m.group(1) in counts[func]:
                counts[func][m.group(1)] += 1
    for name, c in sorted(counts.items()):
        print(f"SASS {name}: " + ", ".join(f"{op} {c[op]}" for op in ops), flush=True)
    for name, c in counts.items():
        if name.split("<")[0] in ("fwd_kernel", "bwd_tile_kernel", "dw_kernel") and not c["HGMMA"]:
            raise RuntimeError(f"{name} has no HGMMA (wgmma) instruction")
        if name.split("<")[0] in ("fwd_f32_kernel", "bwd_f32_kernel") and not c["HMMA"]:
            raise RuntimeError(f"{name} has no HMMA (mma.sync) instruction")
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


def check_kernels(dev, field_cfg, n: int = 8 * 512 * 512, label: str = "flagship",
                  bootstrap: bool = True) -> list:
    """The Fourier-MLP pair against its plain version at ``n`` points of
    ``field_cfg``'s head, timed beside bound_ms and library_ms (``label`` names
    the shape in the output); with ``bootstrap``, also timed at the W=1
    bootstrap's 262,144 points. A head that computes in float32 takes the f32
    kernels (csrc/fourier_mlp_f32.cu), held to F32_FWD_MAX_ABS and
    F32_GRAD_REL_L2, with the plain version in float64 printed beside them (how
    far f32 summation order alone moves the plain version: ReLU masks flip at
    pre-activations within an f32 rounding of zero), timed beside both bounds
    of f32 work (f32_bound) with its resident blocks an SM."""
    from loner_tpu_torch.models.field import fourier_bmat, init_field_params
    from loner_tpu_torch.ops import fourier_mlp as fm

    f32 = field_cfg.compute_dtype == torch.float32
    fwd_max, grad_rel = (F32_FWD_MAX_ABS, F32_GRAD_REL_L2) if f32 else (FWD_MAX_ABS, GRAD_REL_L2)

    gen = torch.Generator(device=dev).manual_seed(11)
    mlp = init_field_params(gen, field_cfg, dev)["sigma"]["mlp"]
    n_layers = sum(1 for k in mlp if k.startswith("w"))
    ws = [mlp[f"w{i}"] for i in range(n_layers)]
    # Non-zero biases, so the bias adds are checked too.
    bs = [torch.randn(mlp[f"b{i}"].shape, generator=gen, device=dev) * 0.1 for i in range(n_layers)]
    bmat = fourier_bmat(field_cfg.fourier_sigma, dev)
    pts01 = torch.rand((n, 3), generator=gen, device=dev)
    dout = torch.randn((n, 1), generator=gen, device=dev) / n ** 0.5
    bf = field_cfg.compute_dtype

    out_k = fm.fourier_mlp_fwd_cuda_any(ws, bs, bmat, pts01, bf)
    out_p = fm.fourier_mlp_fwd_plain(ws, bs, bmat, pts01, bf)
    torch.cuda.synchronize()
    if out_k.shape != (n, 1) or not torch.isfinite(out_k).all():
        raise RuntimeError("forward kernel: wrong shape or non-finite output")
    fwd_err = float((out_k - out_p).abs().max())
    print(f"kernel fourier_mlp_fwd ({label}, N={n}, F={bmat.shape[1]}): max |kernel - plain| {fwd_err:.3e} "
          f"(tolerance {fwd_max}), sigma range {float(out_p.abs().max()):.3e}", flush=True)
    if not fwd_err <= fwd_max:
        raise RuntimeError(f"forward kernel disagrees with its plain version: {fwd_err}")

    dws_k, dbs_k, dpts_k = fm.fourier_mlp_bwd_cuda_any(ws, bs, bmat, pts01, dout, bf)
    dws_p, dbs_p, dpts_p = fm.fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, bf)
    torch.cuda.synchronize()
    pairs = [(f"dw{i}", a, b) for i, (a, b) in enumerate(zip(dws_k, dws_p))]
    pairs += [(f"db{i}", a, b.reshape(a.shape)) for i, (a, b) in enumerate(zip(dbs_k, dbs_p))]
    pairs.append(("dpts", dpts_k, dpts_p))
    exact = plain_f64(ws, bs, bmat, pts01, dout) if f32 else None
    if f32:
        print(f"kernel fourier_mlp_fwd ({label}): plain f32 against plain f64 max abs "
              f"{float((out_p.double() - exact[0]).abs().max()):.3e}, kernel against plain f64 "
              f"{float((out_k.double() - exact[0]).abs().max()):.3e}", flush=True)
    bwd_err, missed = 0.0, []
    for k, (name, a, b) in enumerate(pairs):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"backward kernel: {name} has the wrong shape or is non-finite")
        err, rel = float((a - b).abs().max()), rel_l2(a, b)
        bwd_err = max(bwd_err, err)
        line = (f"kernel fourier_mlp_bwd ({label}): {name} {tuple(a.shape)} max |err| {err:.3e} "
                f"rel L2 {rel:.3e} (tolerance {grad_rel})")
        if f32:
            e64 = exact[1][k].reshape(a.shape)
            line += (f"; against plain f64: kernel {rel_l2(a, e64):.3e}, plain f32 "
                     f"{rel_l2(b, e64):.3e}")
        print(line, flush=True)
        if not rel <= grad_rel:
            missed.append(f"{name}: {rel}")
    del exact
    if missed:
        raise RuntimeError(f"backward kernel disagrees with its plain version on {missed}")

    again = fm.fourier_mlp_bwd_cuda_any(ws, bs, bmat, pts01, dout, bf)
    if not all(torch.equal(a, b) for a, b in zip(dws_k + dbs_k + [dpts_k],
                                                 again[0] + again[1] + [again[2]])):
        raise RuntimeError("backward kernel: two calls differ (it must be deterministic)")

    times = {
        "fwd": cuda_ms(lambda: fm.fourier_mlp_fwd_cuda_any(ws, bs, bmat, pts01, bf)),
        "fwd_plain": cuda_ms(lambda: fm.fourier_mlp_fwd_plain(ws, bs, bmat, pts01, bf)),
        "bwd": cuda_ms(lambda: fm.fourier_mlp_bwd_cuda_any(ws, bs, bmat, pts01, dout, bf)),
        "bwd_plain": cuda_ms(lambda: fm.fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, bf)),
        **library_ms(ws, bs, bmat, pts01, dout, bf),
    }
    print(f"kernel times ({label}) at N={n} (median of 5, ms): " + json.dumps(times), flush=True)
    # Every product's multiply-adds (2 FLOP each): the forward once; the backward
    # recomputes it and forms dX and dW of every layer. Bytes: points and dout in,
    # sigma or dpts out, the parameters in (and their gradients out).
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    params = 4 * sum(w.numel() for w in ws) + 4 * sum(b.numel() for b in bs) + bmat.numel() * 4
    if f32:
        fwd_bound = f32_bound(2 * n * macs, 16 * n + params)
        bwd_bound = f32_bound(6 * n * macs, 28 * n + 2 * params)
    else:
        fwd_bound = bound(2 * n * macs, 16 * n + params)
        bwd_bound = bound(6 * n * macs, 28 * n + 2 * params)
    for name, b, ms, lib in (("fwd", fwd_bound, times["fwd"], times["fwd_library"]),
                             ("bwd", bwd_bound, times["bwd"], times["bwd_library"])):
        line = (f"kernel fourier_mlp_{name} ({label}): {ms:.4f} ms (plain {times[name + '_plain']:.4f}), "
                f"bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / ms:.1f}% of the bound; library "
                f"composition {lib:.4f} ms")
        if f32:
            blocks = fm.f32_occupancy(bmat.shape[1], ws[0].shape[1], n_layers, name == "bwd", dev)
            line += (f"; bounds: CUDA cores {b[2]:.4f} ms, split TF32 {b[3]:.4f} ms; {blocks} "
                     f"resident block(s) an SM")
        print(line, flush=True)
    if bootstrap:  # the W=1 bootstrap's call size
        small = 512 * 512
        sub = (pts01[:small].contiguous(), dout[:small].contiguous())
        t_small = {"fwd": cuda_ms(lambda: fm.fourier_mlp_fwd_cuda_any(ws, bs, bmat, sub[0], bf)),
                   "bwd": cuda_ms(lambda: fm.fourier_mlp_bwd_cuda_any(ws, bs, bmat, sub[0], sub[1],
                                                                  bf))}
        print(f"kernel times ({label}) at N={small} (median of 5, ms): " + json.dumps(t_small),
              flush=True)
    src = "loner_tpu_torch/csrc/fourier_mlp_f32.cu" if f32 else "loner_tpu_torch/csrc/fourier_mlp.cu"
    suffix = "_f32" if f32 else ""
    return [
        {"name": "fourier_mlp_fwd" + suffix, "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:52", "launches": 0,
         "max_abs_err": fwd_err, "ms": times["fwd"], "plain_ms": times["fwd_plain"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": times["fwd_library"]},
        {"name": "fourier_mlp_bwd" + suffix, "route": "cuda", "source": src,
         "replaces": "loner_tpu/ops/pallas/fourier_mlp.py:80", "launches": 0,
         "max_abs_err": bwd_err, "ms": times["bwd"], "plain_ms": times["bwd_plain"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": times["bwd_library"]},
    ]


def plain_f64(ws, bs, bmat, pts01, dout):
    """The plain version's function in float64 from the same f32 features:
    (sigma, [dW..., db..., dpts]) in the order of check_kernels' pairs."""
    from loner_tpu_torch.ops import fourier_mlp as fm

    f = bmat.shape[1]
    x = fm._features(pts01, bmat, torch.float32).double()
    ws, bs = [w.double() for w in ws], [b.double() for b in bs]
    acts, h = [], x
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(h @ w + b)
        acts.append(h)
    out = h @ ws[-1] + bs[-1]
    n_layers = len(ws)
    dws, dbs = [None] * n_layers, [None] * n_layers
    g = dout.double()
    for i in range(n_layers - 1, 0, -1):
        dws[i], dbs[i] = acts[i - 1].T @ g, g.sum(dim=0)
        g = torch.where(acts[i - 1] > 0, g @ ws[i].T, 0.0)
    del acts
    dws[0], dbs[0] = x.T @ g, g.sum(dim=0)
    dx = g @ ws[0].T
    dproj = dx[:, :f] * x[:, f : 2 * f] - dx[:, f : 2 * f] * x[:, :f]
    return out, dws + dbs + [dx[:, 2 * f :] + dproj @ bmat.double().T]


def library_ms(ws, bs, bmat, pts01, dout, bf=torch.bfloat16) -> dict:
    """The yardstick: the same MLP as torch.addmm products in ``bf`` with sin,
    cos, concatenation and ReLU as PyTorch ops (a composition of library calls;
    no single call computes it), and torch.autograd.grad of it with respect to
    the weights, biases and points. Timed here only; the port never calls it."""
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
    from loner_tpu_torch.models.field import init_field_params
    from loner_tpu_torch.models.proposal import init_proposal_params
    from loner_tpu_torch.ops import fourier_mlp as fm

    buffers, twists = synthetic_window(dev, w)
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


def check_hash_case(name: str, table, pos, dout, cfg, dtype, orders: bool = False) -> tuple:
    """The hash kernels against their plain version on one input: features equal
    to the bit, and the same in a second call; the backward's dpos and table
    gradient equal to the bit, with dpos and without it (the frozen-pose variant,
    which returns None for dpos). With ``orders``, the table gradient's int64
    sums also equal under a seeded permutation of the points and when the points
    are split into each of HASH_SPLITS contiguous parts whose int64 sums are
    added. Returns the largest |kernel - plain| of the features and of the
    gradients (0 where equal) and the sum's readings (ops/fixed_point.py:
    magnitude, largest |contribution|, largest |entry sum|)."""
    from loner_tpu_torch.ops import fixed_point
    from loner_tpu_torch.ops import hash_grid as hg

    out_k = hg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    again = hg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    out_p = hg.hash_encode_fwd_plain(table, pos, cfg, dtype)
    whole = hg.table_sum(table)
    _, dpos_k = hg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype, sink=whole)
    dtab_k = whole.to_float()
    dtab_n, dpos_n = hg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype, need_dpos=False)
    dtab_p, dpos_p = hg.hash_encode_bwd_plain(table, pos, dout, cfg, dtype)
    torch.cuda.synchronize()
    for label, t in (("features", out_k), ("dtable", dtab_k), ("dpos", dpos_k),
                     ("dtable without dpos", dtab_n)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"hash kernel: non-finite {label} on {name}, {dtype}")
    fwd_err = float((out_k - out_p).abs().max())
    bwd_err = max(float((dtab_k - dtab_p).abs().max()), float((dtab_n - dtab_p).abs().max()),
                  float((dpos_k - dpos_p).abs().max()))
    equal = {"dtable": torch.equal(dtab_k, dtab_p), "without dpos": torch.equal(dtab_n, dtab_p)}
    if orders:
        perm = torch.randperm(pos.shape[0], generator=torch.Generator(device=pos.device)
                              .manual_seed(29), device=pos.device)
        permuted = hg.table_sum(table)
        hg.hash_encode_bwd_cuda(table, pos[perm].contiguous(), dout[perm].contiguous(), cfg,
                                dtype, need_dpos=False, sink=permuted)
        equal["permuted"] = torch.equal(permuted.acc, whole.acc)
        for parts in HASH_SPLITS:
            total = torch.zeros_like(whole.acc)
            for rows in torch.arange(pos.shape[0], device=pos.device).chunk(parts):
                part = hg.table_sum(table)
                hg.hash_encode_bwd_cuda(table, pos[rows].contiguous(), dout[rows].contiguous(),
                                        cfg, dtype, sink=part)
                total += part.acc
            equal[f"{parts} parts"] = torch.equal(total, whole.acc)
    readings = [float(v) for v in whole.mag] + [float(dtab_k.abs().max())]
    ok = (torch.equal(out_k, out_p) and torch.equal(again, out_k) and torch.equal(dpos_k, dpos_p)
          and dpos_n is None and all(equal.values()))
    print(f"kernel hash_encode {name}, {pos.shape[0]} points, {str(dtype)[6:]}: features "
          f"{int((out_k != out_p).sum())} of {out_k.numel()} differ (max {fwd_err:.3e}), second "
          f"call equal {torch.equal(again, out_k)}; dpos {int((dpos_k != dpos_p).sum())} of "
          f"{dpos_k.numel()} differ; dtable {int((dtab_k != dtab_p).sum())} of {dtab_k.numel()} "
          f"differ, without dpos {int((dtab_n != dtab_p).sum())}; equal bits "
          + ", ".join(f"{k} {v}" for k, v in equal.items())
          + f"; magnitude {readings[0]:.6e}, largest |contribution| {readings[1]:.6e}, largest "
          f"|entry sum| {readings[2]:.6e}", flush=True)
    if not ok:
        raise RuntimeError(f"hash kernels disagree with their plain version on {name}, {dtype}")
    fixed_point.check(pos.device)  # no sum passed its limit
    return fwd_err, bwd_err, readings


def print_readings(label: str, readings: dict) -> None:
    """``fixed_point.recording``'s readings of a run, one line a scale."""
    from loner_tpu_torch.ops import fixed_point

    names = {fixed_point.HASH_BITS: "hash tables", fixed_point.OGM_BITS: "OGM grid"}
    for bits, r in sorted(readings.items()):
        print(describe_fixed_point(f"{names.get(bits, bits)}, {label}", r, bits), flush=True)


def describe_fixed_point(label: str, readings, bits: int) -> str:
    """The scale and a sum's readings ([magnitude, largest |contribution|, largest
    |entry sum|]) as headroom: bits below the guard's limit and below 2^63."""
    import math

    from loner_tpu_torch.ops import fixed_point

    mag, contrib, entry = readings

    def below(x, top):
        return f"{top - math.log2(x * 2.0 ** bits):.2f}" if x > 0 else "inf"

    return (f"fixed point {label}: S = {bits}; magnitude {mag:.6e} "
            f"({below(mag, fixed_point.LIMIT_BITS)} bits below the guard's "
            f"2^{fixed_point.LIMIT_BITS}), largest |contribution| "
            f"{contrib:.6e} ({below(contrib, 63)} bits below 2^63), largest |entry sum| "
            f"{entry:.6e} ({below(entry, 63)} bits below 2^63)")


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

    from loner_tpu_torch.ops import fixed_point

    cfg, bf = HashEncodingConfig(), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    table = torch.rand((cfg.total_table_size, 2), generator=gen, device=dev) * 2e-2 - 1e-2
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}

    def check(name, points, scale, orders=False):
        pos = torch.from_numpy(points).to(dev)
        dout = torch.randn((pos.shape[0], cfg.output_dim), generator=gen, device=dev) * scale
        for dtype in (bf, torch.float32):
            errs = check_hash_case(name, table, pos, dout, cfg, dtype, orders)
            worst["fwd"], worst["bwd"] = max(worst["fwd"], errs[0]), max(worst["bwd"], errs[1])
            print(describe_fixed_point(f"hash table, {name}, {pos.shape[0]} points", errs[2],
                                       fixed_point.HASH_BITS), flush=True)
        return pos, dout

    for name, points in hash_edge_points().items():
        check(name, points, 1.0)
    for order in ("ray", "random"):
        for n in HASH_POINTS:
            pos, dout = check(f"{order} order", hash_points(n, order), n ** -0.5,
                              orders=n == HASH_POINTS[0])
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


def sigma_mlp_errors(x, w0, w1, g, got) -> list:
    """How far ``got`` (sigma, dx, dW0, dW1 of the hash head's f32 MLP) lies past
    its f32 bounds of float64 (positive is a fault), one number each. The bounds
    are tests/test_torch_sigma_mlp.py's: a sum of k f32 terms may be k ulp of the
    terms' magnitudes from the exact sum (sigma D + H + 2, dx H + 1; the weight
    gradients 2e-4 of their magnitudes); a pre-activation within the rounding of
    zero may take either side of the ReLU, so its point is left out of dx and its
    terms are added to the weight gradients' bounds."""
    eps = 2.0 ** -24
    X, W0, W1, G = (t.double() for t in (x, w0, w1, g))
    d, h = w0.shape
    z, zmag = X @ W0, X.abs() @ W0.abs()
    r, gw1 = torch.relu(z), G @ W1.T
    gz = (z > 0) * gw1
    amb = z.abs() <= 2 * (d + 1) * eps * zmag
    sure = ~amb.any(dim=1)
    exact = (r @ W1, gz @ W0.T, X.T @ gz, r.T @ G)
    tol = ((d + h + 2) * eps * ((r + zmag) @ W1.abs()),
           (h + 1) * eps * (gz.abs() @ W0.abs().T),
           2e-4 * (X.abs().T @ gz.abs()) + X.abs().T @ (amb * gw1.abs()),
           2e-4 * ((r + zmag).T @ G.abs()) + (amb * zmag).T @ G.abs())
    rows = (slice(None), sure, slice(None), slice(None))
    return [float(((a.double() - e).abs() - t)[k].max())
            for a, e, t, k in zip(got, exact, tol, rows)]


def check_sigma_mlp_kernels(dev) -> list:
    """The hash head's f32 MLP pair (csrc/sigma_mlp.cu) against its plain
    version, models/field.py::mlp_apply (cuBLAS's products and PyTorch's
    elementwise passes), at a W=8 iteration's 2,097,152 points, at the
    reference's D = 32 and box_room_tiny's D = 12 (H = 64): sigma, dx, dW0 and dW1
    of each within their f32 bounds of float64 (``sigma_mlp_errors``), and of
    the pair against mlp_apply's (max_abs_err). Timed (median of 5, CUDA events):
    the forward, the backward with its reduce, mlp_apply's forward and its
    backward alone; mlp_apply is the library's products, so library_ms is its
    time too. Bound: f32_bound of each kernel's operations (6 n (D H + H)
    multiply-adds for the pair, recomputation not counted) and bytes (x, g, sigma
    and dx; the pair's own bound reads x once)."""
    from loner_tpu_torch.models.field import mlp_apply
    from loner_tpu_torch.ops import sigma_mlp as sm

    n, h = HASH_POINTS[0], 64
    gen = torch.Generator(device=dev).manual_seed(22)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for d in (32, 12):
        x = torch.randn((n, d), generator=gen, device=dev) * 0.1
        w0 = (torch.rand((d, h), generator=gen, device=dev) * 2 - 1) * (6.0 / d) ** 0.5
        w1 = (torch.rand((h, 1), generator=gen, device=dev) * 2 - 1) * (6.0 / h) ** 0.5
        g = torch.randn((n, 1), generator=gen, device=dev) * n ** -0.5
        sigma = sm.sigma_mlp_fwd_cuda(x, w0, w1)
        pair = (sigma, *sm.sigma_mlp_bwd_cuda(x, w0, w1, g))
        leaves = [t.clone().requires_grad_(True) for t in (x, w0, w1)]
        out = mlp_apply({"w0": leaves[1], "w1": leaves[2]}, leaves[0])
        plain = (out.detach(), *torch.autograd.grad(out, leaves, g, retain_graph=True))
        for label, got in (("pair", pair), ("mlp_apply", plain)):
            over = sigma_mlp_errors(x, w0, w1, g, got)
            print(f"sigma MLP, {n} points, D {d}, {label}: past the f32 bound by "
                  + ", ".join(f"{k} {v:.3e}" for k, v in zip(("sigma", "dx", "dW0", "dW1"), over)),
                  flush=True)
            if max(over) > 0:
                raise RuntimeError(f"the sigma MLP's {label} at D = {d} lies past its f32 bound")
        errs = [float((a - b).abs().max()) for a, b in zip(pair, plain)]
        worst["fwd"], worst["bwd"] = max(worst["fwd"], errs[0]), max(worst["bwd"], *errs[1:])
        t = {"fwd": cuda_ms(lambda: sm.sigma_mlp_fwd_cuda(x, w0, w1)),
             "bwd": cuda_ms(lambda: sm.sigma_mlp_bwd_cuda(x, w0, w1, g))}
        with torch.no_grad():
            t["fwd_plain"] = cuda_ms(lambda: mlp_apply({"w0": w0, "w1": w1}, x))
        t["bwd_plain"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        times[d] = t
        print(f"kernel sigma_mlp times, {n} points, D {d} (ms, median of 5): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
        del x, g, sigma, pair, leaves, out, plain
    macs = n * (32 * h + h)
    cost = {"fwd": (2 * macs, 4 * n * (32 + 1)), "bwd": (4 * macs, 4 * n * (2 * 32 + 1))}
    pair_bound = f32_bound(6 * macs, 4 * n * (2 * 32 + 2))[0]
    src = "loner_tpu_torch/csrc/sigma_mlp.cu"
    note = "not a TPU kernel: the JAX package computes this function in XLA"
    records = []
    for name in ("fwd", "bwd"):
        b = f32_bound(*cost[name])
        records.append({
            "name": f"sigma_mlp_{name}", "route": "cuda", "source": src,
            "replaces": "loner_tpu/models/field.py:310", "note": note, "launches": 0,
            "max_abs_err": worst[name], "ms": times[32][name],
            "plain_ms": times[32][f"{name}_plain"], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": times[32][f"{name}_plain"], "pair_bound_ms": pair_bound,
            "d12_ms": times[12][name], "d12_plain_ms": times[12][f"{name}_plain"]})
    print(f"kernel sigma_mlp bound (ms): fwd {records[0]['bound_ms']:.4f} "
          f"({records[0]['bound_by']}), bwd {records[1]['bound_ms']:.4f} "
          f"({records[1]['bound_by']}), the pair {pair_bound:.4f}", flush=True)
    return records


def write_experiment(log_dir: str, field, prop, field_cfg, seed: int = 3) -> None:
    """An experiment directory as a run of the system leaves it: the flagship
    settings in full_config.pkl and checkpoints/final.tar in Mapper.build_ckpt's
    schema, with WINDOW keyframe poses from a seed inside the world cube."""
    import pickle

    from loner_tpu_torch.common.pose import Pose
    from loner_tpu_torch.common.world_cube import WorldCube
    from loner_tpu_torch.common import yaml_lite
    from loner_tpu_torch.mapping.mapper import build_ckpt, save_checkpoint
    from loner_tpu_torch.models.field import FieldConfig

    nerf = yaml_lite.load_file(os.path.join(REPO, "cfg", "nerf_config", "tpu_fourier.yaml"))
    if FieldConfig.from_settings(nerf, 3) != field_cfg:
        raise RuntimeError("cfg/nerf_config/tpu_fourier.yaml does not parse to the slice's "
                           "field config")
    model_config = {
        "data": {"ray_range": list(RAY_RANGE)},
        "model": {"num_colors": 3, "nerf_config": nerf,
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


def cfg_settings(name: str, log_prefix: str, test_compositor: bool = True,
                 changes: Optional[dict] = None) -> dict:
    """The configuration ``cfg/synthetic/<name>`` as the port's ``run_loner``
    loads it (``load_config``: the port's own YAML reader), with this script's
    deliberate overrides on top: the log prefix, ``system.precompile`` (kernels
    built and every program run once before the clock starts) and, with
    ``test_compositor``, the fused test-render compositor (mapping does not read
    it); then ``changes``. tests/test_torch_slam.py holds each to its YAML."""
    from loner_tpu_torch.common.settings import load_config

    settings, _ = load_config(os.path.join(REPO, "cfg", "synthetic", name))
    settings.augment({"system": {"log_dir_prefix": log_prefix, "precompile": True}})
    if test_compositor:
        settings.augment({"mapper": {"optimizer": {"model_config": {"model": {"render": {
            "compositor": "pallas"}}}}}})
    settings.augment(changes)
    return settings.as_plain_dict()


def box_room_settings(log_prefix: str) -> dict:
    """cfg/synthetic/box_room.yaml (a bare ``!include ../defaults.yaml``: the
    reference's model, hash sigma field and OGM sampler)."""
    return cfg_settings("box_room.yaml", log_prefix, test_compositor=False)


def flagship_slam_settings(log_prefix: str) -> dict:
    """cfg/synthetic/box_room_tpu_rt_r4.yaml: the flagship's Fourier field and
    proposal sampler at 3 iterations a dispatch, 1 in flight."""
    return cfg_settings("box_room_tpu_rt_r4.yaml", log_prefix)


def sky_slam_settings(log_prefix: str, sky: bool) -> dict:
    """cfg/synthetic/box_room_sky.yaml (``sky``: sky segmentation, the tracker's
    sky rays and 64 sky rays a keyframe slot) or box_room_sky_off.yaml."""
    return cfg_settings("box_room_sky.yaml" if sky else "box_room_sky_off.yaml", log_prefix)


def courtyard_slam_settings(log_prefix: str) -> dict:
    """cfg/synthetic/courtyard_tpu_r5f.yaml: ray range 1-50 m, the Fourier field
    at 96 frequencies and scale 16, a 3-stage ICP on 10,000-point clouds, poses
    frozen after the bootstrap."""
    return cfg_settings("courtyard_tpu_r5f.yaml", log_prefix)


def write_slam_dataset(root: str, num_scans: int = SLAM_SCANS, scene=None,
                       camera: bool = False, gt_map: bool = True) -> dict:
    """The box-room sequence (``num_scans`` scans on a 270-degree arc; the room
    of ``scene``, default the closed one) through the port's ScanStreamWriter,
    and its GT map (``build_gt_map``, the reference of phases 13-15; not with
    ``gt_map`` False); both configurations' SLAM runs share them. With
    ``camera``: one virtual-camera image a scan at the scan's start time, and no
    GT map."""
    from loner_tpu_torch.analysis.create_lidar_map import build_gt_map
    from loner_tpu_torch.datasets.synthetic import (
        VirtualCamera, VirtualLidar, generate_sequence, write_sequence,
    )

    t0 = time.perf_counter()
    scans, poses, ts, scene, _ = generate_sequence(
        num_scans=num_scans, scene=scene,
        lidar=VirtualLidar(num_channels=SLAM_LIDAR[0], num_columns=SLAM_LIDAR[1]))
    write_sequence(root, scans, poses, ts, scene=scene,
                   camera=VirtualCamera() if camera else None)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_map = None if camera or not gt_map else build_gt_map(root)
    print(f"SLAM dataset: {num_scans} scans of {SLAM_LIDAR[0] * SLAM_LIDAR[1]} rays"
          + (", one 96 x 64 camera image a scan" if camera else "")
          + f", {ts[-1] - ts[0] + 0.1:.1f} s of sequence, written in {written:.2f} s"
          + ("" if gt_map is None else f"; GT map {gt_map.shape[0]} points in "
             f"{time.perf_counter() - t0:.2f} s"), flush=True)
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


def check_map_quality(dev, label: str, log_dir: str, sequence: dict, field_kernel: str,
                      compositor: str, mesh: bool = False, gate_l1: bool = False) -> dict:
    """Map quality of a finished SLAM run against the GT map of ``sequence``
    (``write_slam_dataset``): the chain (map cloud, masked GT, F-score, L1)
    gated at F_SCORE_MIN and the regression record; with ``mesh`` (phase 13)
    also the mesh through the kernels and through the plain paths and the
    mesh's own cloud scored (not gated); with ``gate_l1`` (phase 14) L1 gated at
    L1_MEAN_MAX. Returns the launches of each step, which must reach the
    configuration's kernels."""
    dataset, gt_map = sequence["dataset"], sequence["gt_map"]
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
          f"{'gated' if gate_l1 else 'gated on the drive in phase 14; here ' + l1_verdict}), RMSE "
          f"{l1['rmse']:.4f} m over {l1['num_rays']} rays; wall s: render {secs['render']:.3f}, "
          f"mask {secs['mask']:.3f}, ICP + NN {secs['evaluate']:.3f}, L1 {secs['l1']:.3f}",
          flush=True)

    meshed = check_mesh(dev, label, log_dir, launches) if mesh else {}

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
    if gate_l1 and not l1["mean"] <= L1_MEAN_MAX:
        failures.append(f"L1 mean {l1['mean']} m above {L1_MEAN_MAX}")
    failures += meshed.get("failures", [])
    cloud_kernels = (field_kernel, "composite") if compositor == "pallas" else (field_kernel,)
    steps = [("map cloud", cloud_kernels), ("L1", (field_kernel,))]
    steps += [("mesh kernel", (field_kernel,))] if mesh else []
    for step, kernels in steps:
        failures += [f"{step}: {k} was not launched" for k in kernels if launches[step][k] < 1]
    if failures:
        raise RuntimeError(f"map quality {label}: " + "; ".join(failures))
    return {"launches": launches, "f_score": stats["f_score"], "l1_mean": l1["mean"]}


def traced_trial(dev, settings: dict, dataset: str, **kwargs) -> tuple:
    """run_trial on ``dev`` with every launch count set to 0 just before and read
    just after. Returns (log_dir, the run's Loner, its launch counts, wall s,
    peak device memory GB)."""
    from loner_tpu_torch import run_loner

    loners = []

    class RecordingLoner(run_loner.Loner):
        def start(self):
            loners.append(self)
            super().start()

    original, run_loner.Loner = run_loner.Loner, RecordingLoner
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        log_dir = run_loner.run_trial(settings, dataset, device=dev, **kwargs)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        run_loner.Loner = original
    (loner,) = loners
    return log_dir, loner, counts, wall, torch.cuda.max_memory_allocated(dev) / 1e9


def run_slam(dev, label: str, settings: dict, sequence: dict, out_dir: str, train_kernels,
             map_kernels, compositor: str, check_icp: bool = False,
             measure_test_chunk: bool = False, ate_max: Optional[float] = ATE_MAX) -> dict:
    """A threaded SLAM run through run_trial on ``dev`` at ``settings`` on the
    dataset of ``sequence`` (``write_slam_dataset``), logged under ``out_dir``:
    RTF, ms per mapping iteration, tracking latency, peak memory, ATE of both
    trajectories (gated at ``ate_max`` unless None), the map check, and the
    launches of ``train_kernels`` (each at least once per mapping iteration) and
    of ``map_kernels`` in the map check; with ``check_icp`` the ICP card-vs-CPU
    check, with ``measure_test_chunk`` one test-render chunk's time and memory.
    The run's directory is returned under "log_dir" for the caller to score."""
    from loner_tpu_torch.mapping.optimizer import sky_rays_per_slot

    dataset, scene, gt_poses, ts = (sequence[k] for k in ("dataset", "scene", "poses", "ts"))
    icp = check_icp_card_against_cpu(dev, dataset) if check_icp else {}
    settings["system"]["log_dir_prefix"] = os.path.join(out_dir, "outputs")
    late0 = late_captures()
    log_dir, loner, counts, wall, peak_gb = traced_trial(
        dev, settings, dataset, experiment_name=f"smoke_{label.replace(' ', '_')}")
    launches = {k: counts[k] for k in train_kernels}
    state = loner.mapper.optimizer.state
    sigma = state.field_params["sigma"]
    placed = {"field": sigma["mlp"]["w0"].device,
              "sampler state": (state.occ_grid["w0"] if isinstance(state.occ_grid, dict)
                                else state.occ_grid).device}
    if loner.tracker._last_relative_dev is not None:  # None after a dropped last frame
        placed["icp"] = loner.tracker._last_relative_dev.device
    if "table" in sigma:
        placed["hash table"] = sigma["table"].device
    icp_dev = placed.pop("icp", loner.tracker._device)
    if any(d != dev for d in placed.values()) or icp_dev != loner.tracker._device:
        raise RuntimeError(f"SLAM tensors not on {dev} (ICP: {loner.tracker._device}): "
                           f"{placed}, ICP on {icp_dev}")
    placed["icp"] = icp_dev

    from loner_tpu_torch.common.cuda_graphs import pool_bytes

    opt = loner.mapper.optimizer
    graphs = {"mapper_captures": opt.graph_captures,
              "mapper_late_captures": late_captures() - late0,
              "mapper_pool_gb": pool_bytes(opt.graph_pool) / 1e9,
              "icp_captures": loner.tracker.icp_graph.captures,
              "icp_pool_gb": pool_bytes(loner.tracker.icp_graph.pool()) / 1e9}
    print(f"SLAM {label} CUDA graphs: {json.dumps(graphs)}", flush=True)

    nums = slam_log_numbers(log_dir, ts)
    timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
    its, ate = nums["iterations"], nums["ate"]
    window = settings["mapper"]["keyframe_manager"]["window_selection"]["window_size"]
    print(f"SLAM {label}: {len(timing)} keyframes, {its} mapping iterations; per keyframe "
          "(iterations, s): " + ", ".join(f"({int(n)}, {t:.3f})" for n, t in timing),
          flush=True)
    print(f"SLAM {label}: runtime {nums['runtime_s']:.3f} s for {nums['seq_s']:.1f} s of "
          f"sequence, real-time factor {nums['rtf']:.4f}; ms per mapping iteration: W=1 "
          f"bootstrap {nums['boot_ms']:.3f}, W={window} windows {nums['win_ms']:.3f}; tracking "
          f"latency ({nums['track_updates']} updates) median {nums['track_p50_ms']:.3f} ms, p95 "
          f"{nums['track_p95_ms']:.3f} ms; peak device memory "
          f"{peak_gb:.3f} GB; run_trial {wall:.3f} s; launches {launches}; tensors on "
          f"{sorted({str(d) for d in placed.values()})}", flush=True)
    for name, count in launches.items():
        if count < its:
            raise RuntimeError(f"{name} launched {count} times in {its} mapping iterations")

    print(f"SLAM {label} ATE RMSE: estimated {ate['estimated_trajectory']:.4f} m, tracking "
          f"only {ate['tracking_only']:.4f} m "
          f"({'bound ' + str(ate_max) if ate_max else 'printed, not gated'})", flush=True)
    if ate_max is not None and not all(v < ate_max for v in ate.values()):
        raise RuntimeError(f"SLAM {label} ATE above {ate_max} m: {ate}")

    mapped = check_map_depth(dev, log_dir, scene, gt_poses[0], map_kernels, compositor)
    if measure_test_chunk:
        test_chunk_memory(dev, log_dir)
    return {"log_dir": log_dir, "launches": launches, "counts": counts,
            "map_launches": mapped["launches"], "sky_rays": sky_rays_per_slot(opt.config),
            "graphs": graphs, "peak_gb": peak_gb, "boot_iterations": int(timing[0, 0]),
            "camera_losses": opt.camera_loss_log, **nums, **icp}


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


def synthetic_window(dev, w: int, sky_dirs: int = 0):
    """A window of ``w`` keyframes of 65,536 unit directions and depths in [1.5,
    9.5] m, and twists, from a seed (the slice's and profile_iteration's); with
    ``sky_dirs``, that many upward sky directions a keyframe, from a second seed."""
    from loner_tpu_torch.mapping.rays import build_window_buffers

    rng = np.random.default_rng(0)
    dirs, depths = [], []
    for _ in range(w):
        d = rng.normal(size=(3, 65536))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        dirs.append(d.astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, 65536).astype(np.float32))
    sky = [None] * w
    if sky_dirs:
        sky_rng = np.random.default_rng(1)
        for i in range(w):
            u = sky_rng.normal(size=(3, sky_dirs))
            u[2] = np.abs(u[2]) + 0.5
            sky[i] = (u / np.linalg.norm(u, axis=0, keepdims=True)).astype(np.float32)
    buffers = build_window_buffers(dirs, depths, sky, w, device=dev)
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


# Phase 15, sky rays. The opacity bar is the JAX package's test of sky
# supervision (tests/test_sky_supervision.py: below 0.6 x without). It is gated
# on the JAX package's 600-scan open-sky drive, the cell of its record
# (artifacts/sky_drive/README.md), and printed on 150 scans, where the sky run,
# with 5 keyframes and a quarter of the iterations, read 0.6735 against 0.9868
# on an H100 80GB HBM3 at 700 W (a ratio of 0.68; floater share 0.0245 against
# 0.0473). The drive's runs read the opacities again at their fifth keyframe,
# after as many iterations as the 150-scan runs.
SKY_RAYS = 64  # sky rays a keyframe slot, cfg/synthetic/box_room_sky.yaml
SKY_OPACITY_RATIO_MAX = 0.6  # mean sky opacity with sky rays / without
SKY_DIRS = 2048  # sky directions a slot of the sky slice's window


def check_sky_slice(dev, cfg, field_cfg) -> dict:
    """Phase 15's slice: the flagship iteration with SKY_RAYS sky rays a slot
    (8 x 576 rays x 512 samples = 2,359,296 field points, the Fourier pair's
    new call size), 6 iterations through the captured graphs with the launches
    counted, then one iteration's loss and twist gradient through the kernels
    against the plain sigma path on the same draws (phase 4's tolerances)."""
    from dataclasses import replace

    from loner_tpu_torch.mapping.optimizer import (
        PhaseSettings, draw_step, iteration_loss, make_phase_runner,
    )
    from loner_tpu_torch.models.field import init_field_params
    from loner_tpu_torch.models.proposal import init_proposal_params

    sky_cfg = replace(cfg, enable_sky=True, n_sky_samples=SKY_RAYS)
    buffers, twists = synthetic_window(dev, WINDOW, SKY_DIRS)
    params = init_field_params(torch.Generator(device=dev).manual_seed(0), field_cfg, dev)
    prop = init_proposal_params(torch.Generator(device=dev).manual_seed(5), cfg.proposal, dev)
    scale, shift = torch.tensor(12.0, device=dev), torch.zeros(3, device=dev)

    n_iters = 6
    run_phase = make_phase_runner(sky_cfg, field_cfg, PhaseSettings(num_iterations=n_iters),
                                  WINDOW, buffers.dirs.shape[1], buffers.sky_dirs.shape[1], dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    run_phase(params, prop, twists, buffers, torch.ones(WINDOW, device=dev), scale, shift, 0,
              gen, num_iterations=2)  # captures
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, _, new_twists, losses, _ = run_phase(params, prop, twists, buffers,
                                            torch.ones(WINDOW, device=dev), scale, shift, 0, gen)
    torch.cuda.synchronize()
    ms_it = 1e3 * (time.perf_counter() - t0) / n_iters
    launches = read_counts()
    points = WINDOW * (cfg.n_lidar_samples + SKY_RAYS) * cfg.n_samples_per_ray
    print(f"sky slice: {n_iters} iterations at {WINDOW} x ({cfg.n_lidar_samples} + {SKY_RAYS}) "
          f"rays x {cfg.n_samples_per_ray} samples = {points} field points an iteration, "
          f"{ms_it:.3f} ms/iteration through the graphs; launches {launches}; losses "
          f"{[round(float(x), 4) for x in losses]}", flush=True)
    if not (torch.isfinite(losses).all() and torch.isfinite(new_twists).all()):
        raise RuntimeError("sky slice: non-finite losses or twists")
    for name in ("fourier_mlp_fwd", "fourier_mlp_bwd"):
        if launches[name] < n_iters:
            raise RuntimeError(f"sky slice: {name} launched {launches[name]} times")

    draws = draw_step(torch.Generator(device=dev).manual_seed(2), sky_cfg, WINDOW, dev)
    if draws.noise.shape[0] * draws.noise.shape[1] != points:
        raise RuntimeError(f"sky slice: draws for {tuple(draws.noise.shape)} samples")
    results = {}
    for name, fc in (("kernel", field_cfg), ("plain", replace(field_cfg, sigma_kernel="plain"))):
        tw = twists.clone().requires_grad_(True)
        total, aux = iteration_loss(sky_cfg, fc, params["sigma"], prop, tw, params["intensity"],
                                    buffers, scale, shift, draws)
        (g,) = torch.autograd.grad(total, tw)
        results[name] = (float(aux["loss"].detach()), g, int(aux["valid"].sum()))
    (loss_k, g_k, valid_k), (loss_p, g_p, _) = results["kernel"], results["plain"]
    loss_rel, grad_rel = abs(loss_k - loss_p) / abs(loss_p), rel_l2(g_k, g_p)
    print(f"sky slice kernel vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, "
          f"tolerance {LOSS_RTOL}); twist grad rel L2 {grad_rel:.2e} (tolerance "
          f"{TWIST_GRAD_REL_L2}); {valid_k} valid rays of {WINDOW * (cfg.n_lidar_samples + SKY_RAYS)}",
          flush=True)
    if not (np.isfinite(loss_k) and loss_rel <= LOSS_RTOL):
        raise RuntimeError("sky slice loss: kernel path disagrees with the plain path")
    if not (torch.isfinite(g_k).all() and grad_rel <= TWIST_GRAD_REL_L2):
        raise RuntimeError("sky slice twist gradient: kernel path disagrees with the plain path")
    return {"launches": launches, "ms_per_iteration": ms_it}


def run_sky_ab(dev, num_scans: int, gated: bool) -> dict:
    """Phase 15's SLAM: the open-sky box room (``num_scans`` scans, the ceiling
    removed) at box_room_sky.yaml and box_room_sky_off.yaml, each through
    run_slam, the map-quality chain gated at F_SCORE_MIN and ``sky_floaters``:
    the sky run's mean sky opacity against SKY_OPACITY_RATIO_MAX x the other's
    and its floater share against the other's, gated where ``gated``, else
    printed as met or missed. Where ``gated`` (the drive) the runs also write a
    full checkpoint at every keyframe, and the opacities are printed at the
    last keyframe of the first SLAM_SCANS scans: the same keyframes and
    iterations as the 150-scan runs, on the drive's data."""
    import tempfile

    from loner_tpu_torch.analysis.sky_floaters import sky_floaters
    from loner_tpu_torch.datasets.synthetic import BoxRoomScene
    from loner_tpu_torch.mapping.mapper import load_checkpoint

    kernels = ("fourier_mlp_fwd", "fourier_mlp_bwd")
    runs, early = {}, {}
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_sky_") as data_dir:
        seq = write_slam_dataset(os.path.join(data_dir, "dataset"), num_scans,
                                 scene=BoxRoomScene(open_top=True))
        for name, sky in (("sky", True), ("sky off", False)):
            label = f"{name} {num_scans}"
            settings = sky_slam_settings("", sky)
            if gated:
                settings["mapper"]["log_level"] = "VERBOSE"
            run = run_slam(dev, label, settings, seq, os.path.join(data_dir, name), kernels,
                           ("composite", "fourier_mlp_fwd"), "pallas", ate_max=None)
            scores = check_map_quality(dev, label, run["log_dir"], seq, "fourier_mlp_fwd",
                                       "pallas")
            run.update(eval_launches=scores["launches"], f_score=scores["f_score"])
            if gated:
                ckpts = os.path.join(run["log_dir"], "checkpoints")
                kf_ts = [p["timestamp"] for p in load_checkpoint(
                    os.path.join(ckpts, "final.tar"))["poses"]]
                k = sum(t < seq["ts"][SLAM_SCANS] for t in kf_ts) - 1
                early[name] = {"keyframe": k, "timestamp": kf_ts[k], **sky_floaters(
                    run["log_dir"], seq["gt_map"], ckpt_name=f"ckpt_{k}.tar", device=dev)}
            reset_counts()
            run["floaters"] = {**sky_floaters(run["log_dir"], seq["gt_map"], device=dev),
                               "launches": read_counts()}
            print(f"sky floaters {label}: {json.dumps(run['floaters'])}", flush=True)
            runs[name] = run
    on, off = runs["sky"]["floaters"], runs["sky off"]["floaters"]
    ratio = on["mean_sky_opacity"] / off["mean_sky_opacity"]
    failures = []
    if runs["sky"]["sky_rays"] != SKY_RAYS or runs["sky off"]["sky_rays"] != 0:
        failures.append(f"sky rays a slot: {runs['sky']['sky_rays']} / {runs['sky off']['sky_rays']}")
    for name in runs:
        if runs[name]["floaters"]["launches"]["fourier_mlp_fwd"] < 1:
            failures.append(f"sky floaters {name}: the Fourier forward was not launched")
    bars = []
    if not ratio < SKY_OPACITY_RATIO_MAX:
        bars.append(f"mean sky opacity {on['mean_sky_opacity']} not below "
                    f"{SKY_OPACITY_RATIO_MAX} x {off['mean_sky_opacity']}")
    if not on["floater_fraction"] < off["floater_fraction"]:
        bars.append(f"floater share {on['floater_fraction']} not below {off['floater_fraction']}")
    verdict = "gated" if gated else ("met" if not bars else "missed") + ", gated on the drive"
    print(f"sky A/B on {num_scans} scans: mean sky opacity {on['mean_sky_opacity']:.4f} with "
          f"sky rays, {off['mean_sky_opacity']:.4f} without, ratio {ratio:.4f} (bar: below "
          f"{SKY_OPACITY_RATIO_MAX}; {verdict}); floater share {on['floater_fraction']:.4f} / "
          f"{off['floater_fraction']:.4f}; F@0.1 m {runs['sky']['f_score']:.4f} / "
          f"{runs['sky off']['f_score']:.4f} (bar {F_SCORE_MIN})", flush=True)
    if early:
        print(f"sky A/B on {num_scans} scans at keyframe {early['sky']['keyframe']} (the last of "
              f"the first {SLAM_SCANS} scans, t = {early['sky']['timestamp']:.1f} s / "
              f"{early['sky off']['timestamp']:.1f} s): mean sky opacity "
              f"{early['sky']['mean_sky_opacity']:.4f} with sky rays, "
              f"{early['sky off']['mean_sky_opacity']:.4f} without, ratio "
              f"{early['sky']['mean_sky_opacity'] / early['sky off']['mean_sky_opacity']:.4f} "
              "(printed, not gated)", flush=True)
    if gated:
        failures += bars
    if failures:
        raise RuntimeError(f"sky A/B on {num_scans} scans: " + "; ".join(failures))
    return {**runs, "ratio": ratio, "early": early}


# Phase 16, resume: the tracking seam's bar of tests/test_resume.py.
RESUME_AT_S = 7.0  # seconds of the 15 s sequence streamed before the interruption
SEAM_SHARE_MAX = 0.25  # |step - median step| / median step, every tracked step


def run_resume(dev, sequence: dict, uninterrupted_ate: dict) -> dict:
    """Phase 16: phase 9's flagship run stopped after RESUME_AT_S seconds of data,
    then resumed in place through run_trial(resume_from=...): the graphs
    captured and replayed in the resumed run, keyframes and ckpt_<k> numbering
    continued, timestamps strictly increasing, every tracking step (the seam's
    too) within SEAM_SHARE_MAX of the median step; ATE printed beside the
    uninterrupted run's."""
    import copy
    import tempfile

    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
    from loner_tpu_torch.common.trajectory import load_tum_trajectory
    from loner_tpu_torch.mapping.mapper import load_checkpoint

    dataset = sequence["dataset"]
    settings = flagship_slam_settings("")
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_resume_") as tmp:
        settings["system"]["log_dir_prefix"] = os.path.join(tmp, "outputs")
        half, _, _, half_wall, _ = traced_trial(dev, copy.deepcopy(settings), dataset,
                                                experiment_name="smoke_resume",
                                                duration=RESUME_AT_S)
        half_kfs = len(load_checkpoint(os.path.join(half, "checkpoints", "final.tar"))["poses"])
        half_its = int(np.loadtxt(os.path.join(half, "timing.csv"), delimiter=",",
                                  ndmin=2)[:, 0].sum())
        late0 = late_captures()
        log_dir, loner, counts, wall, peak_gb = traced_trial(dev, copy.deepcopy(settings),
                                                             dataset, resume_from=half)
        final = load_checkpoint(os.path.join(log_dir, "checkpoints", "final.tar"))
        n_kfs = len(final["poses"])
        missing = [k for k in range(n_kfs)
                   if not os.path.exists(os.path.join(log_dir, "checkpoints", f"ckpt_{k}.tar"))]
        kf_ts = np.asarray([p["timestamp"] for p in final["poses"]])
        its = int(np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",",
                             ndmin=2)[:, 0].sum()) - half_its
        _, est_ts = load_tum_trajectory(os.path.join(log_dir, "trajectory",
                                                     "estimated_trajectory.txt"))
        track, track_ts = load_tum_trajectory(os.path.join(log_dir, "trajectory",
                                                           "tracking_only.txt"))
        steps = np.linalg.norm(np.diff(track[:, :3, 3], axis=0), axis=1)
        seam = float(np.max(np.abs(steps - np.median(steps))) / np.median(steps))
        ate = {name: evaluate_trajectory_files(
            os.path.join(log_dir, "trajectory", f"{name}.txt"),
            os.path.join(log_dir, "trajectory", "groundtruth.txt"), delta_m=1.0)["ate"]["rmse"]
            for name in ("estimated_trajectory", "tracking_only")}
        opt = loner.mapper.optimizer
        graphs = {"captures": opt.graph_captures, "late_captures": late_captures() - late0,
                  "icp_captures": loner.tracker.icp_graph.captures}
    launches = {k: counts[k] for k in ("fourier_mlp_fwd", "fourier_mlp_bwd")}
    print(f"resume: interrupted after {RESUME_AT_S} s of data ({half_kfs} keyframes, {half_its} "
          f"mapping iterations, run_trial {half_wall:.3f} s); resumed in place to {n_kfs} "
          f"keyframes, {its} more iterations, run_trial {wall:.3f} s, peak device memory "
          f"{peak_gb:.3f} GB; graphs {json.dumps(graphs)}; launches {launches}; largest "
          f"|step - median| / median {seam:.4f} (bound {SEAM_SHARE_MAX}); ATE RMSE estimated "
          f"{ate['estimated_trajectory']:.4f} m, tracking only {ate['tracking_only']:.4f} m "
          f"(uninterrupted phase 9: {uninterrupted_ate['estimated_trajectory']:.4f} / "
          f"{uninterrupted_ate['tracking_only']:.4f} m)", flush=True)
    failures = []
    if log_dir != half:
        failures.append(f"resumed into {log_dir}, not {half}")
    if not n_kfs > half_kfs or missing:
        failures.append(f"{n_kfs} keyframes after {half_kfs}, checkpoints missing {missing}")
    if not (np.all(np.diff(kf_ts) > 0) and np.all(np.diff(est_ts) > 0)
            and np.all(np.diff(track_ts) > 0)):
        failures.append("timestamps not strictly increasing")
    if not seam <= SEAM_SHARE_MAX:
        failures.append(f"tracking seam {seam}")
    if graphs["captures"] < 1 or its < 1 or any(v < its for v in launches.values()):
        failures.append(f"the resumed run's graphs or launches: {graphs}, {launches}, {its}")
    if failures:
        raise RuntimeError("resume: " + "; ".join(failures))
    return {"launches": launches, "counts": counts, "ate": ate, "keyframes": (half_kfs, n_kfs)}


# Phase 17, the courtyard: its scan count is the one cut of courtyard_tpu_r5f.yaml.
COURTYARD_SCANS = 150  # 15 s of the 151 s drive (1513 scans at 10 Hz)


def write_courtyard_dataset(root: str) -> dict:
    """The first COURTYARD_SCANS scans of the courtyard drive (64 x 1024 LiDAR),
    with the GT poses of the whole drive, so the world cube is the drive's."""
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import (
        generate_courtyard_sequence, make_courtyard, make_waypoint_trajectory,
    )

    t0 = time.perf_counter()
    scans, poses, ts, scene, lidar = generate_courtyard_sequence(num_scans=COURTYARD_SCANS)
    _, waypoints, speed = make_courtyard()
    all_poses, all_ts = make_waypoint_trajectory(waypoints, speed=speed)
    writer = ScanStreamWriter(root)
    for scan in scans:
        writer.add_scan(scan)
    writer.write_gt(all_poses, all_ts)
    print(f"courtyard dataset: {len(scans)} of {len(all_ts)} scans of "
          f"{lidar.num_channels} x {lidar.num_columns} rays ({np.mean([len(x) for x in scans]):.0f} "
          f"returns a scan), {ts[-1] - ts[0] + 0.1:.1f} s of sequence, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"dataset": root, "scene": scene, "poses": poses, "ts": ts, "gt_map": None}


def run_courtyard(dev, field_cfg) -> dict:
    """Phase 17: the Fourier pair at the courtyard's head (96 frequencies, a first
    layer of K = 195 rows) against its plain version at 2,097,152 points, timed;
    then courtyard_tpu_r5f.yaml through run_slam on the first COURTYARD_SCANS
    scans: RTF, ms an iteration, tracking latency, ATE (printed), peak memory,
    launches and the map check at the first keyframe."""
    import tempfile
    from dataclasses import replace

    from loner_tpu_torch.models.field import FourierConfig

    wide = replace(field_cfg, fourier_sigma=FourierConfig(n_freqs=96, scale=16.0))
    shapes = check_kernels(dev, wide, label="courtyard", bootstrap=False)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_courtyard_") as data_dir:
        seq = write_courtyard_dataset(os.path.join(data_dir, "dataset"))
        run = run_slam(dev, "courtyard", courtyard_slam_settings(""), seq, data_dir,
                       ("fourier_mlp_fwd", "fourier_mlp_bwd"), ("composite", "fourier_mlp_fwd"),
                       "pallas", ate_max=None)
    return {"kernels": shapes, "slam": run}


# Phase 18, the camera branch: box_room_tpu_camera_r5.yaml (threaded, the
# flagship's widths, a Fourier intensity head) and box_room_camera.yaml
# (single-threaded, a hash intensity table, the sigma head in f32), each on the
# SLAM_SCANS-scan box room with one camera image a scan (the one cut).
CAMERA_RAYS = 128  # camera pixels a keyframe slot, num_samples.camera of both configurations
CAMERA_POINTS = WINDOW * CAMERA_RAYS * 512  # 524,288: the r5 camera rays' field points
HASH_CAMERA_POINTS = 3 * CAMERA_RAYS * 64  # 24,576: box_room_camera's (window 3, 64 samples)
PSNR_IMAGES = 25
JAX_TPU_PSNR = ("the JAX package's TPU drive of box_room_tpu_camera_r5.yaml on 600 scans: "
                "22.9-37.3 dB, mean about 30 dB (VERDICT.md:134-136), behaviour, not a bar")


def check_intensity_hash(dev) -> dict:
    """The hash pair at the camera path's intensity tables: box_room_camera.yaml's
    4 levels x 2 at 2^14 at its camera call size (f32: its sigma head is Fourier,
    so the intensity table is encoded in f32) and the default 16 x 2 at 2^19 at
    the r5 camera call size (bf16 and f32), in ray order, each against its plain
    version (check_hash_case) and timed beside the bound."""
    from loner_tpu_torch.analysis.ab_compare import hash_points
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.ops import hash_grid as hg

    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for label, cfg, n, dtypes in (
            ("box_room_camera 4 x 2 at 2^14", HashEncodingConfig(n_levels=4, log2_hashmap_size=14),
             HASH_CAMERA_POINTS, (torch.float32,)),
            ("defaults 16 x 2 at 2^19", HashEncodingConfig(log2_hashmap_size=19), CAMERA_POINTS,
             (torch.bfloat16, torch.float32))):
        table = torch.rand((cfg.total_table_size, 2), generator=gen, device=dev) * 2e-2 - 1e-2
        pos = torch.from_numpy(hash_points(n, "ray")).to(dev)
        dout = torch.randn((n, cfg.output_dim), generator=gen, device=dev) * n ** -0.5
        for dtype in dtypes:
            fwd_err, bwd_err, _ = check_hash_case(f"intensity {label}", table, pos, dout, cfg,
                                                  dtype, orders=n == HASH_CAMERA_POINTS)
            t = {"fwd": cuda_ms(lambda: hg.hash_encode_fwd_cuda(table, pos, cfg, dtype)),
                 "bwd_no_dpos": cuda_ms(lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype,
                                                                        need_dpos=False)),
                 "fwd_plain": cuda_ms(lambda: hg.hash_encode_fwd_plain(table, pos, cfg, dtype), 3),
                 "bwd_plain": cuda_ms(lambda: hg.hash_encode_bwd_plain(table, pos, dout, cfg,
                                                                       dtype), 3)}
            cost = hash_cost(n, cfg)
            b = {k: bound(*cost[k], peak_flops=PEAK_F32_FLOPS) for k in ("fwd", "bwd_no_dpos")}
            key = f"camera: {label}, {n} points, {str(dtype)[6:]}"
            out[key] = {"fwd": {"max_abs_err": fwd_err, "ms": t["fwd"], "plain_ms": t["fwd_plain"],
                                "bound_ms": b["fwd"][0], "bound_by": b["fwd"][1],
                                "library_ms": None},
                        "bwd": {"max_abs_err": bwd_err, "ms": t["bwd_no_dpos"],
                                "plain_ms": t["bwd_plain"], "bound_ms": b["bwd_no_dpos"][0],
                                "bound_by": b["bwd_no_dpos"][1], "library_ms": None,
                                "variant": "without dpos (camera rays are detached from the poses)"}}
            print(f"kernel hash_encode {key}: fwd {t['fwd']:.4f} ms (bound {b['fwd'][0]:.4f}, "
                  f"{b['fwd'][1]}; plain {t['fwd_plain']:.4f}), bwd without dpos "
                  f"{t['bwd_no_dpos']:.4f} ms (bound {b['bwd_no_dpos'][0]:.4f}, "
                  f"{b['bwd_no_dpos'][1]}; plain {t['bwd_plain']:.4f})", flush=True)
        del table, pos, dout
    return out


def check_psnr(dev, label: str, log_dir: str, gated: bool) -> dict:
    """compute_psnr on PSNR_IMAGES images of the run's dataset, with the kernels'
    launches; beside it the PSNR of a constant image at the mean value of the same
    GT images, which the trained head's mean PSNR must beat when ``gated``."""
    from loner_tpu_torch.analysis.compute_psnr import compute_psnr
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
    from loner_tpu_torch.models.losses import img_to_mse, mse_to_psnr

    import pickle

    t0 = time.perf_counter()
    reset_counts()
    result = compute_psnr(log_dir, num_images=PSNR_IMAGES, device=dev)
    launches = {k: v for k, v in read_counts().items() if v}
    wall = time.perf_counter() - t0
    with open(os.path.join(log_dir, "full_config.pkl"), "rb") as f:
        reader = ScanStreamReader(pickle.load(f)["dataset_path"])
    gts = [torch.from_numpy(reader.read_image(r["image"])[0]) for r in result["images"]]
    mean = float(torch.stack(gts).mean())
    const = float(np.mean([float(mse_to_psnr(img_to_mse(torch.full_like(g, mean), g)))
                           for g in gts]))
    print(f"PSNR {label}: {result['num_images']} images, mean {result['mean']:.4f} dB, min "
          f"{result['min']:.4f}, max {result['max']:.4f}; a constant image at the GT mean "
          f"{mean:.4f}: {const:.4f} dB ({'gated: above it' if gated else 'printed'}); "
          f"{JAX_TPU_PSNR}; {wall:.2f} s; launches {launches}", flush=True)
    if gated and not result["mean"] > const:
        raise RuntimeError(f"PSNR {label}: mean {result['mean']} dB is not above the constant "
                           f"image's {const} dB")
    return {"mean": result["mean"], "min": result["min"], "max": result["max"],
            "constant": const, "launches": launches}


def check_mma_selftest(dev) -> None:
    """One split-TF32 m16n8k8 product in each operand form of the f32 kernels (A W,
    A W^T, G^T H) against float64, through their fragment loads and weight image:
    a wrong fragment mapping fails here, before the kernels' own checks."""
    from loner_tpu_torch.ops import fourier_mlp as fm

    gen = torch.Generator().manual_seed(3)
    a, w, g, h = (torch.randn(shape, generator=gen) for shape in ((16, 8), (8, 8), (8, 16), (8, 8)))
    outs = fm.mma_tf32_selftest(*(t.to(dev) for t in (a, w, g, h)))
    torch.cuda.synchronize()
    a, w, g, h = (t.double() for t in (a, w, g, h))
    errs = [float((got.double().cpu() - want).abs().max())
            for got, want in zip(outs, (a @ w, a @ w.T, g.T @ h))]
    print(f"mma split-TF32 fragment self-test, max |err| against float64 (A W, A W^T, G^T H): "
          f"{errs} (tolerance {MMA_SELFTEST_MAX_ABS})", flush=True)
    if not max(errs) <= MMA_SELFTEST_MAX_ABS:
        raise RuntimeError(f"the f32 kernels' mma fragments are wrong: {errs}")


def run_camera(dev, field_cfg) -> dict:
    """Phase 18: the kernels at the camera path's call sizes, then the two camera
    configurations through SLAM, each followed by its PSNR."""
    import tempfile
    from dataclasses import replace

    from loner_tpu_torch.common.settings import Settings
    from loner_tpu_torch.mapping.optimizer import OptimizerConfig
    from loner_tpu_torch.models.field import FieldConfig
    from loner_tpu_torch.ops import fixed_point

    check_mma_selftest(dev)
    print_ptxas("fourier_mlp_f32", prefix="phase 18: ptxas")
    r5 = cfg_settings("box_room_tpu_camera_r5.yaml", "")
    small = cfg_settings("box_room_camera.yaml", "")
    small_field = FieldConfig.from_settings(
        Settings(small).mapper.optimizer.model_config.model.nerf_config)
    kernels = {"fourier": check_kernels(dev, field_cfg, n=CAMERA_POINTS, label="camera",
                                        bootstrap=False),
               "fourier_f32": check_kernels(dev, small_field, n=HASH_CAMERA_POINTS,
                                            label="box_room_camera f32", bootstrap=False),
               "fourier_f32_render": check_kernels(dev, small_field, n=2048 * 1024,
                                                   label="box_room_camera f32 render chunk",
                                                   bootstrap=False),
               # A head of no resident build: the flagship's (48, 256 x 2) in f32.
               "fourier_f32_streamed": check_kernels(
                   dev, replace(field_cfg, compute_dtype=torch.float32), n=HASH_CAMERA_POINTS,
                   label="flagship head f32, streamed", bootstrap=False),
               "hash": check_intensity_hash(dev)}
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_camera_") as data_dir:
        seq = write_slam_dataset(os.path.join(data_dir, "dataset"), camera=True)
        for label, settings, train, field_kernel, gated in (
                ("camera r5", r5, ("fourier_mlp_fwd", "fourier_mlp_bwd"), "fourier_mlp_fwd", True),
                ("camera hash", small, ("fourier_mlp_fwd_f32", "fourier_mlp_bwd_f32",
                                        "hash_encode_fwd", "hash_encode_bwd"),
                 "fourier_mlp_fwd_f32", False)):
            with fixed_point.recording() as readings:
                run = run_slam(dev, label, settings, seq, os.path.join(data_dir, label.split()[1]),
                               train, ("composite", field_kernel), "pallas",
                               ate_max=ATE_MAX if gated else None)
            print_readings(f"SLAM {label}", readings)
            opt_cfg = OptimizerConfig.from_settings(
                Settings(settings).mapper.optimizer, Settings(settings).mapper.optimizer.model_config)
            k = max(int(opt_cfg.steps_per_dispatch), 1)
            losses = np.concatenate(run.pop("camera_losses"))
            run["camera_loss"] = (float(losses[:k].mean()), float(losses[-k:].mean()))
            print(f"SLAM {label}: camera loss {run['camera_loss'][0]:.5f} in the first dispatch "
                  f"({k} iterations), {run['camera_loss'][1]:.5f} in the last; "
                  f"{len(losses)} camera iterations; single-threaded "
                  f"{bool(settings['system']['single_threaded'])}", flush=True)
            if not np.isfinite(losses).all() or len(losses) < run["iterations"]:
                raise RuntimeError(f"SLAM {label}: {len(losses)} finite camera losses in "
                                   f"{run['iterations']} iterations")
            run["psnr"] = check_psnr(dev, label, run["log_dir"], gated)
            runs[label] = run
    return {"kernels": kernels, "runs": runs}


# Phase 19, the real-data drill: the port's bag generator, converter and host
# ops, then box_room_drill.yaml on the converted bag. The bag is the real
# sensor's width (128 x 1024, the 48-byte Ouster stride, bz2, u32 ns per-point
# times, epoch-second header stamps) and DRILL_SECONDS long (the one cut: the JAX
# package's drill writes 60 s).
DRILL_SECONDS = 10.0  # 100 scans at 10 Hz, ~4 keyframes at the drill's 3 s
DRILL_SWEEP = (128, 1024)
STAMP_MODES = (("epoch_f64", [], (0.15, 0.21)),  # 5 Hz: a sweep spans the 0.2 s period
               ("zeros", ["--recompute_timestamps"], (0.05, 0.11)))  # a 0.1 s sweep rebuilt
DRILL_EPOCH = 1.7e9  # synthetic_bag's default --epoch


def check_decode(bag: str) -> None:
    """The host decode (csrc/scan_ops.cpp) on the bag's first sweep at the
    converter's min_range against its plain numpy version: the kept sets equal
    but for points within scan_ops.DECODE_PLAIN_RTOL of min_range, directions
    and ranges within that relative tolerance, times equal; both timed on the
    host."""
    from loner_tpu_torch import convert_rosbag
    from loner_tpu_torch.datasets.rosbag_reader import Bag
    from loner_tpu_torch.ops import scan_ops

    with Bag(bag) as b:
        msg = next(m for topic, m, _ in b.read_messages() if topic != "/tf")
    ox, oy, oz, t_off, t_kind = convert_rosbag.field_layout(msg)
    blob, n, step, min_range = bytes(msg.data), msg.width * msg.height, msg.point_step, 0.3
    out, ms = {}, {}
    for name, fn in (("cpp", scan_ops.decode_point_blob),
                     ("plain", scan_ops.decode_point_blob_plain)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out[name] = fn(blob, n, step, (ox, oy, oz), t_off, t_kind, min_range)
            times.append(1e3 * (time.perf_counter() - t0))
        ms[name] = float(np.median(times))
        # Index mode: each kept point's index in the blob.
        out[name + " index"] = fn(blob, n, step, (ox, oy, oz), 0, 3, min_range)[2]
    i_c, i_p = out["cpp index"], out["plain index"]
    only = np.setxor1d(i_c, i_p).astype(np.int64)
    rec = np.frombuffer(blob, np.uint8).reshape(n, step)
    xyz = np.stack([rec[only, o:o + 4].copy().view(np.float32)[:, 0] for o in (ox, oy, oz)])
    off_edge = np.abs(np.linalg.norm(xyz.astype(np.float64), axis=0) - min_range) > (
        scan_ops.DECODE_PLAIN_RTOL * min_range)
    (d_c, r_c, t_c), (d_p, r_p, t_p) = out["cpp"], out["plain"]
    kc, kp = np.isin(i_c, i_p), np.isin(i_p, i_c)
    err = max(float(np.max(np.abs(d_c[:, kc] - d_p[:, kp]))),
              float(np.max(np.abs(r_c[kc] - r_p[kp]) / r_p[kp])))
    times_equal = np.array_equal(t_c[kc], t_p[kp])
    print(f"host decode (csrc/scan_ops.cpp, not a device kernel), one {msg.height} x "
          f"{msg.width} sweep ({len(blob) / 1e6:.2f} MB, {r_c.shape[0]} points kept at min_range "
          f"{min_range}): {ms['cpp']:.3f} ms ({len(blob) / 1e3 / ms['cpp']:.1f} MB/s), plain "
          f"numpy {ms['plain']:.3f} ms; max relative difference {err:.3g} (bound "
          f"{scan_ops.DECODE_PLAIN_RTOL}), times equal {times_equal}, {only.size} points kept "
          f"by one version only ({int(off_edge.sum())} away from min_range)", flush=True)
    if off_edge.any() or not times_equal or not err <= scan_ops.DECODE_PLAIN_RTOL:
        raise RuntimeError("host decode disagrees with its plain version")


def check_stamp_modes(root: str) -> None:
    """Two 2-scan full-width bags at 5 Hz, epoch_f64 and zeros (converted with
    --recompute_timestamps): every scan's stamps sorted, anchored to its header
    stamp and spanning a sweep (tests/test_rosbag_writer.py's bounds)."""
    from loner_tpu_torch import real_data_drill
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader

    for mode, extra, (lo, hi) in STAMP_MODES:
        bag = os.path.join(root, f"{mode}.bag")
        real_data_drill.generate(bag, 0.4, *DRILL_SWEEP, timestamp_mode=mode,
                                 extra=["--rate", "5"])
        real_data_drill.convert(bag, os.path.join(root, mode), extra)
        reader = ScanStreamReader(os.path.join(root, mode))
        spans = []
        for i in range(len(reader)):
            ts = reader.read_scan(i).timestamps
            spans.append(float(ts[-1] - ts[0]))
            anchored = abs(ts[0] - (DRILL_EPOCH + i / 5.0)) < 0.01
            if not (np.all(np.diff(ts) >= 0) and anchored and lo < spans[-1] < hi):
                raise RuntimeError(f"{mode} scan {i}: sorted {np.all(np.diff(ts) >= 0)}, "
                                   f"first stamp {ts[0]!r}, span {spans[-1]}")
        if len(reader) != 2:
            raise RuntimeError(f"{mode}: {len(reader)} scans converted")
        print(f"stamps, {mode}: 2 scans sorted, anchored to their header stamps, spans "
              f"{[round(x, 6) for x in spans]} s (bounds {lo}-{hi})", flush=True)


def run_drill(dev, box_room: dict) -> dict:
    """Phase 19 (returns run_slam's record of the drill's run): generate the DRILL_SECONDS bag with the port's generator and
    convert it with the port's converter (seconds and MB/s of each); the host
    decode against its plain version and the two other stamp modes; then
    box_room_drill.yaml (loaded from cfg/ through load_config, the dataset
    pointed at the converted bag) through run_slam, threaded, with its checks
    and ATE of both trajectories gated at ATE_MAX; the mapper's captures after
    warm-up held to the box room's (``box_room``: phase 9's run); then the
    drill's metrics (the dataset's poses_gt.tum as the run's ground truth,
    ``metrics_pipeline``), its ATE gated at ATE_MAX."""
    import tempfile

    from loner_tpu_torch import real_data_drill
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
    from loner_tpu_torch.datasets.synthetic import BoxRoomScene

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_drill_") as root:
        bag, dataset = os.path.join(root, "drill.bag"), os.path.join(root, "dataset")
        gen = real_data_drill.generate(bag, DRILL_SECONDS, *DRILL_SWEEP)
        conv = real_data_drill.convert(bag, dataset)
        print(f"drill bag: {gen['scans']} scans of {DRILL_SWEEP[0]} x {DRILL_SWEEP[1]}, "
              f"{gen['bytes'] / 1e6:.1f} MB (bz2): generated in {gen['seconds']:.2f} s "
              f"({gen['mb_per_s']:.2f} MB/s), converted in {conv['seconds']:.2f} s "
              f"({conv['mb_per_s']:.2f} MB/s of bag)", flush=True)
        check_decode(bag)
        check_stamp_modes(root)
        reader = ScanStreamReader(dataset)
        points = [len(reader.read_scan(i)) for i in range(len(reader))]
        seq = {"dataset": dataset, "scene": BoxRoomScene(), "poses": reader.gt_poses(),
               "ts": reader.start_times(), "gt_map": None}
        print(f"drill dataset: {len(reader)} scans, {min(points)}-{max(points)} points a scan, "
              f"first stamp {seq['ts'][0]!r}", flush=True)
        run = run_slam(dev, "drill", cfg_settings("box_room_drill.yaml", ""), seq,
                       os.path.join(root, "run"), ("fourier_mlp_fwd", "fourier_mlp_bwd"),
                       ("composite", "fourier_mlp_fwd"), "pallas")
        late, box_late = (run["graphs"]["mapper_late_captures"],
                          box_room["graphs"]["mapper_late_captures"])
        print(f"drill: mapper captures {run['graphs']['mapper_captures']} at warm-up, "
              f"{late} after it (box room, phase 9: {box_room['graphs']['mapper_captures']}, "
              f"{box_late})", flush=True)
        if late != box_late:
            raise RuntimeError(f"drill: {late} mapper captures after warm-up, the box room "
                               f"{box_late}")
        t0 = time.perf_counter()
        metrics = real_data_drill.score(run["log_dir"], dataset)
        ate = metrics["ate"]["rmse"]
        print(f"drill metrics ({time.perf_counter() - t0:.2f} s): ATE RMSE {ate:.4f} m (bound "
              f"{ATE_MAX}), RPE translation {metrics['rpe_trans']['rmse']:.4f} m, rotation "
              f"{metrics['rpe_rot']['rmse']:.4f} deg (3 m segments)", flush=True)
        if not ate < ATE_MAX:
            raise RuntimeError(f"drill ATE RMSE {ate} m, bound {ATE_MAX} m")
    return run


# Phase 20, run breadth: the debug dumps, the offline tools and the trial pool.
DEBUG_FLAGS = ("log_losses", "write_frame_point_clouds", "write_ray_point_clouds", "store_ray",
               "draw_samples", "draw_rays_eps")
DEBUG_SCANS = 30  # the first 3 s of phase 9's sequence
# The debug run's cut of phase 9's settings: a keyframe a second, 64 rays a
# keyframe slot and a schedule of 6 + 3 + 3 iterations. draw_samples writes every
# iteration's sample points as ASCII on the host (2,097,152 a W=8 iteration at 512
# rays; ~1 s of numpy per 262,144 points), so the widths of a sample stay and the
# counts shrink.
DEBUG_CUT = {"mapper": {
    "keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 1.0}}},
    "optimizer": {"num_samples": {"lidar": 64}, "keyframe_schedule": [
        {"num_keyframes": 1, "iteration_schedule": [
            {"num_iterations": 6, "freeze_poses": True, "freeze_sigma_mlp": False}]},
        {"num_keyframes": -1, "iteration_schedule": [
            {"num_iterations": 3, "freeze_poses": False, "latest_kf_only": True,
             "freeze_sigma_mlp": True},
            {"num_iterations": 3, "freeze_poses": False, "freeze_sigma_mlp": False}]}]}}}
# A further cut to a CPU size, for the import-boundary test.
CPU_SLAM_CUT = {
    "system": {"single_threaded": True},
    "tracker": {"frame_synthesis": {"frame_decimation_rate_hz": 2.5},
                "icp": {"downsample": {"target_uniform_point_count": 500}}},
    "mapper": {"keyframe_manager": {"window_selection": {"window_size": 2}},
               "optimizer": {"num_samples": {"lidar": 16}, "model_config": {"model": {
                   "render": {"N_samples_train": 16},
                   "nerf_config": {"fourier_sigma": {"n_freqs": 8},
                                   "sigma_network": {"n_neurons": 32}},
                   "occ_model": {"prop_n_ctrl": 5,
                                 "proposal": {"n_freqs": 8, "n_neurons": 16}}}}}}}
RECORD_FULL_ITERS = 2  # iterations of the "full" record ("ray": one dispatch of k)
SEQUENCE_SKIP = 4  # render_sequence on 2 of phase 6's 8 keyframe poses
FRAME = (512, 256)  # width x height of the panoramas of render_sequence and the flythrough
SEQUENCE_SAMPLES = 2048  # render_sequence's samples a ray (the flythrough's default: 512)
FLYTHROUGH = {"steps_between": 1, "spin_every": 3, "spin_steps": 2}  # 12 poses from 8
POOL_SECONDS = 2.0  # of the debug run's sequence, for each trial of the pool
POOL_CONFIG = os.path.join("cfg", "synthetic", "box_room_tpu_rt_r4.yaml")  # phase 9's


def debug_slam_settings(log_prefix: str) -> dict:
    """Phase 9's flagship settings with the six debug flags on, cut by DEBUG_CUT."""
    settings = cfg_settings("box_room_tpu_rt_r4.yaml", log_prefix, changes=DEBUG_CUT)
    settings["debug"]["flags"].update({flag: True for flag in DEBUG_FLAGS})
    return settings


def check_debug_dumps(log_dir: str) -> dict:
    """The debug files of a run with every flag on: a frame cloud for each tracked
    frame (``tracking_only.txt``'s rows), and for each keyframe optimisation
    (``timing.csv``'s rows) its ray batch, store_ray cloud and arrays, loss CSVs
    and the first iteration's samples and margins. Returns the counts and bytes."""
    def present(*parts):
        path = os.path.join(log_dir, *parts)
        if not os.path.exists(path):
            raise RuntimeError(f"debug dumps: {path} is missing")
        return path

    tracked = len(np.loadtxt(present("trajectory", "tracking_only.txt"), ndmin=2))
    clouds = [f for f in os.listdir(present("frames")) if not f.endswith("_sky.pcd")]
    if len(clouds) != tracked:
        raise RuntimeError(f"debug dumps: {len(clouds)} frame clouds for {tracked} tracked frames")
    keyframes = len(np.loadtxt(present("timing.csv"), delimiter=",", ndmin=2))
    for k in range(keyframes):
        for parts in (("rays", f"kf_{k}_rays.pcd"), ("rays", f"kf_{k}_origins.pcd"),
                      ("rays", "lidar", f"kf_{k}.pcd"), ("losses", f"keyframe_{k}", "phase_0.csv"),
                      ("depth_eps", f"keyframe_{k}", "phase_0.csv"),
                      ("samples", f"samples_kf{k}_it0.pcd"), ("samples", f"samples_kf{k}_it0_gt.pcd"),
                      ("rays_eps", f"rays_kf{k}_it0.pcd"), ("rays_eps", f"origins_kf{k}_it0.pcd")) + tuple(
                          ("rays", name, f"kf_{k}.npy") for name in ("sky_mask", "curr_mask", "std", "js")):
            present(*parts)
    files = [os.path.join(d, f) for sub in ("frames", "rays", "losses", "depth_eps", "samples",
                                             "rays_eps") for d, _, fs in os.walk(os.path.join(log_dir, sub))
             for f in fs]
    return {"frames": tracked, "keyframes": keyframes, "files": len(files),
            "bytes": sum(os.path.getsize(f) for f in files)}


def check_debug_record(dev, cfg, field_cfg) -> dict:
    """Phase 20 (a): the flagship W=8 iteration through the captured graphs with
    the per-iteration record, ``"ray"`` for one dispatch of ``steps_per_dispatch``
    iterations and ``"full"`` for RECORD_FULL_ITERS, from one seed: parameters,
    twists and losses equal to the bit to the same iterations without the
    record, and the graphs' records equal to the eager loop's; then the records
    through ``IterationRayRecordDumper`` (store_ray, draw_rays_eps). Returns the
    launches of the record runs through the graphs."""
    import tempfile

    from loner_tpu_torch.mapping.optimizer import Optimizer, PhaseSettings, make_phase_runner
    from loner_tpu_torch.runtime.debug_artifacts import IterationRayRecordDumper

    buffers, twists = synthetic_window(dev, WINDOW)
    state = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev).state
    common = (twists, buffers, torch.ones(WINDOW, device=dev), torch.tensor(12.0, device=dev),
              torch.zeros(3, device=dev))

    def run(mode, graphs, n):
        runner = make_phase_runner(cfg, field_cfg, PhaseSettings(), WINDOW, buffers.dirs.shape[1],
                                   buffers.sky_dirs.shape[1], dev, extras_mode=mode,
                                   graphs=graphs)
        log = [] if mode != "none" else None
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = runner(state.field_params, state.occ_grid, *common, 0,
                     torch.Generator(device=dev).manual_seed(1), num_iterations=n,
                     extras_log=log)
        torch.cuda.synchronize()
        secs, counts = time.perf_counter() - t0, read_counts()
        del runner
        torch.cuda.empty_cache()
        return phase_outputs(out), log, counts, secs

    launches, failures = {}, []
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_record_") as root:
        for mode, n in (("ray", cfg.steps_per_dispatch), ("full", RECORD_FULL_ITERS)):
            plain_out, _, _, _ = run("none", True, n)
            graph_out, graph_log, counts, secs = run(mode, True, n)
            eager_out, eager_log, _, _ = run(mode, False, n)
            same = all(torch.equal(graph_out[k], plain_out[k]) for k in plain_out)
            same_eager = all(torch.equal(eager_out[k], plain_out[k]) for k in plain_out)
            names = sorted(graph_log[0])
            records_equal = len(graph_log) == len(eager_log) and all(
                np.array_equal(a[k], b[k]) for a, b in zip(graph_log, eager_log) for k in names)
            stacked = [tuple(rec["rays"].shape) for rec in graph_log]
            t0 = time.perf_counter()
            out_dir = os.path.join(root, mode)
            dumper = IterationRayRecordDumper(
                out_dir, 0, n_lidar=cfg.n_lidar_samples, n_sky=0, window_slots=WINDOW,
                num_kfs=WINDOW, world_scale=12.0, world_shift=np.zeros(3, np.float32),
                eps_min=cfg.loss.min_depth_eps, js_alpha=cfg.loss.js_alpha,
                max_js_score=cfg.loss.max_js_score, store_ray=mode == "ray",
                draw_rays_eps=mode == "full")
            for rec in graph_log:
                dumper.append(rec)
            dumper.finish()
            dump_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir)
                         for f in fs)
            print(f"debug record {mode!r}: {n} W={WINDOW} iterations through the graphs in "
                  f"{secs:.3f} s, records {stacked} of {names}; parameters, twists and losses "
                  f"equal to the bit to the run without the record: {same} (eager: "
                  f"{same_eager}); the graphs' records equal the eager loop's: {records_equal}; "
                  f"launches {counts}; dumped {nbytes} bytes in {dump_s:.3f} s", flush=True)
            launches[f"debug record {mode}"] = counts
            if not (same and same_eager and records_equal):
                failures.append(mode)
            if min(counts["fourier_mlp_fwd"], counts["fourier_mlp_bwd"]) < n:
                failures.append(f"{mode}: the Fourier pair launched {counts} for {n} iterations")
    if failures:
        raise RuntimeError(f"debug record: {failures}")
    return launches


def run_breadth(dev, cfg, field_cfg, field, prop) -> dict:
    """Phase 20: (a) the record on the card (``check_debug_record``); (b) a
    threaded SLAM run of the first DEBUG_SCANS scans with the six debug flags
    (``debug_slam_settings``), its dumps checked and no capture after warm-up;
    (c) phase 6's experiment written again: ``render_sequence`` at 512 x 256 x
    2048 samples with peak maps on two poses, one frame held to the plain sigma
    path and plain compositor at phase 8's tolerances, and ``render_flythrough``
    on 12 poses, its AVI's frame count checked; (d) ``plot_poses`` on (b)'s run,
    ``depth_to_warp`` / ``vis_flow`` on (c)'s two frames, and ``run_loner`` with
    ``--num_repeats 2 --trial_workers 2 --gpu_ids 0`` as a child process on
    POOL_SECONDS of (b)'s sequence, both trials rc 0. Returns each path's
    launches."""
    import tempfile
    from dataclasses import replace

    from loner_tpu_torch.analysis.plot_poses import plot_poses
    from loner_tpu_torch.analysis.raster_plot import read_plot
    from loner_tpu_torch.analysis.render_utils import kf_pose_matrices, load_experiment
    from loner_tpu_torch.analysis.renderer import (
        render_dataset_frame, render_flythrough, render_sequence, spherical_ray_directions,
    )
    from loner_tpu_torch.analysis.image_io import read_png
    from loner_tpu_torch.analysis.video import encode_jpeg, read_avi_frame_count
    from loner_tpu_torch.analysis.warp import depth_to_warp, vis_flow

    launches = check_debug_record(dev, cfg, field_cfg)
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_breadth_") as root:
        # (b) the debug SLAM run.
        sequence = write_slam_dataset(os.path.join(root, "dataset"), DEBUG_SCANS)
        settings = debug_slam_settings(os.path.join(root, "slam") + "/")
        late0 = late_captures()
        log_dir, loner, counts, wall, _ = traced_trial(dev, settings, sequence["dataset"],
                                                        experiment_name="smoke_debug")
        opt = loner.mapper.optimizer
        late = late_captures() - late0
        found = check_debug_dumps(log_dir)
        print(f"debug SLAM: {DEBUG_SCANS} scans, all six debug flags, run_trial {wall:.3f} s; "
              f"{found['frames']} tracked frames, {found['keyframes']} keyframes, "
              f"{found['files']} files of {found['bytes']} bytes; mapper captures "
              f"{opt.graph_captures} at warm-up, {late} after it; launches "
              f"{counts}", flush=True)
        if late or min(counts["fourier_mlp_fwd"], counts["fourier_mlp_bwd"]) == 0:
            raise RuntimeError(f"debug SLAM: {late} late captures, launches {counts}")
        launches["debug SLAM"] = counts

        # (c) renders of phase 6's experiment.
        exp = os.path.join(root, "experiment")
        write_experiment(exp, field, prop, field_cfg)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        seq_dir = render_sequence(exp, width=FRAME[0], height=FRAME[1],
                                  n_samples=SEQUENCE_SAMPLES, with_peak=True,
                                  skip_step=SEQUENCE_SKIP, device=dev)
        seq_s = time.perf_counter() - t0
        launches["render_sequence"] = counts = read_counts()
        n_seq = len([f for f in os.listdir(seq_dir) if f.startswith("depth_") and f.endswith(".npy")])
        model = load_experiment(exp, device=dev)
        pose0 = kf_pose_matrices(model)[0][0]
        plain = replace(model, field_cfg=replace(model.field_cfg, sigma_kernel="plain"),
                        compositor="plain", render_cache={})
        frame_p = render_dataset_frame(plain, pose0, spherical_ray_directions(*FRAME),
                                       FRAME[::-1], n_samples=SEQUENCE_SAMPLES)
        dk, dp = np.load(os.path.join(seq_dir, "depth_0000.npy")), frame_p["depth"]
        ok = np.isfinite(dk) & np.isfinite(dp) & (dp >= RAY_RANGE[0]) & (dp <= RAY_RANGE[1])
        rel = np.abs(dk - dp)[ok] / (RAY_RANGE[1] - RAY_RANGE[0])
        med, p99 = float(np.median(rel)), float(np.quantile(rel, 0.99))
        print(f"render_sequence: {n_seq} frames of {FRAME[0]} x {FRAME[1]} x {SEQUENCE_SAMPLES} "
              f"samples with peak maps in "
              f"{seq_s:.3f} s ({n_seq / seq_s:.3f} frames/s), launches {counts}; frame 0 against "
              f"the plain path ({int(ok.sum())} of {ok.size} rays finite and in range): "
              f"|ddepth|/range median {med:.3e} (tolerance {RENDER_DEPTH_MEDIAN}), p99 "
              f"{p99:.3e} (tolerance {RENDER_DEPTH_P99})", flush=True)
        if (n_seq != 2 or ok.mean() < 0.99 or not (med <= RENDER_DEPTH_MEDIAN
                                                  and p99 <= RENDER_DEPTH_P99)
                or min(counts["composite"], counts["fourier_mlp_fwd"]) == 0):
            raise RuntimeError("render_sequence: wrong frames, launches or disagreement")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fly_dir = render_flythrough(exp, width=FRAME[0], height=FRAME[1], device=dev,
                                    **FLYTHROUGH)
        fly_s = time.perf_counter() - t0
        launches["render_flythrough"] = counts = read_counts()
        frames = open(os.path.join(fly_dir, "frames.txt")).read().split()
        n_avi, shape, fps = read_avi_frame_count(os.path.join(fly_dir, "flythrough.avi"))
        pngs = [read_png(os.path.join(fly_dir, f))[0] for f in frames]
        t0 = time.perf_counter()
        for px in pngs:
            encode_jpeg(px)
        jpeg_fps = len(pngs) / (time.perf_counter() - t0)
        print(f"render_flythrough: {len(frames)} frames of {FRAME[0]} x {FRAME[1]} x 512 "
              f"samples in "
              f"{fly_s:.3f} s ({len(frames) / fly_s:.3f} frames/s, PNGs and the AVI included), "
              f"AVI {n_avi} frames {shape} at {fps} fps; JPEG encoder {jpeg_fps:.2f} frames/s at "
              f"{FRAME[0]} x {FRAME[1]} on the host; launches {counts}", flush=True)
        if (len(frames) != 12 or n_avi != len(frames)
                or min(counts["composite"], counts["fourier_mlp_fwd"]) == 0):
            raise RuntimeError("render_flythrough: wrong frames or launches")

        # (d) small tools and the trial pool.
        _, meta = read_plot(plot_poses(log_dir))
        labels = [s["label"] for s in meta["Series"]]
        mats = kf_pose_matrices(model)[0][::SEQUENCE_SKIP]
        d0, d1 = (np.load(os.path.join(seq_dir, f"depth_{i:04d}.npy")) for i in (0, 1))
        w, h = FRAME
        k = np.array([[w / 2, 0, (w - 1) / 2], [0, w / 2, (h - 1) / 2], [0, 0, 1]])
        warp, mask = depth_to_warp(d0, d1, k, np.linalg.inv(mats[1]) @ mats[0], k)
        flow = vis_flow(warp)
        print(f"plot_poses: series {labels}; warp of the two frames: {warp.shape}, "
              f"{float(mask.mean()):.4f} consistent, flow colours finite "
              f"{bool(np.isfinite(flow).all())}", flush=True)
        if not labels or not np.isfinite(warp).all() or flow.shape != (h, w, 3):
            raise RuntimeError("plot_poses / warp: wrong output")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        pool = subprocess.run(
            [sys.executable, "-m", "loner_tpu_torch.run_loner", sequence["dataset"],
             os.path.join(REPO, POOL_CONFIG),
             "--num_repeats", "2", "--trial_workers", "2", "--gpu_ids", "0", "--duration",
             str(POOL_SECONDS), "--experiment_name", "pool", "--device", str(dev)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        pool_s = time.perf_counter() - t0
        walls = [line for line in pool.stdout.splitlines() if line.startswith("trial ")
                 and "rc=" in line]
        print(f"trial pool: rc {pool.returncode} in {pool_s:.3f} s; " + "; ".join(walls),
              flush=True)
        if pool.returncode != 0 or len(walls) != 2 or not all("rc=0" in w for w in walls):
            raise RuntimeError("trial pool failed: " + pool.stdout[-2000:] + pool.stderr[-2000:])
    return launches


# Phase 21, the mesh (system.mesh_devices, parallel/mesh.py). The W=8 phase of
# profile_iteration's configurations on every rank, one process a rank: the
# sharded program computes the one-card optimisation up to float summation
# order. MESH_TOL are the CPU tests' tolerances (tests/test_torch_multidevice.py,
# from tests/test_mesh_sharding.py): the f32 runs are held to them. In bf16 a
# rank's Fourier backward sums its own points' weight gradients, and where one
# nearly cancels, Adam turns the other order of summation into a step of up to
# ~lr (two ranks on an H100: sigma w0 5.0e-5, twists 4.9e-6 after 3 iterations).
# The gate holds losses and depth_eps to MESH_TOL, and reads, for twists and
# each parameter, the relative L2 of its difference to one card over its own
# change in the phase (MESH_GATE). Each limit lies above every sound reading and
# below every fault's, and every run reads a planted fault (the last rank's
# gradients left out of the all-reduce) again and fails unless the gate refuses
# it. On an H100: two ranks twists 4.5e-4, parameters 7.2e-5 at most (the
# Optimizer's run 3.7e-4, 5.0e-5); one card with its window's slots permuted or
# its rays shuffled (no mesh: the same function summed in another order) up to
# 3.4e-4 and 1.2e-4, sigma w0 beyond MESH_TOL in bf16 as on two ranks, f32
# within it; four ranks ([4] and [2, 2]) twists 4.3e-4 and parameters 8.0e-5 at
# most, f32 within MESH_TOL, now that each ray's forward has the same bits in a
# rank's quarter of the window as in all of it (``forward_batch_witness``; the
# proposal MLP's last product, one column, summed each row in an order that
# depended on the row count: 1.3e-3 and 8.2e-4 before); the planted fault 0.47
# and 0.26 at least. A one-rank NCCL mesh, whose collectives
# are captured in the graphs and sum one term, must equal the run without a mesh
# to the bit, through the phase runner and through the Optimizer (warm_up, a
# window, restore, a window, close). The reference's hash table and grid
# gradients are float atomics in another order on each run (phase 12), so its
# comparisons are printed only.
MESH_TOL = {"losses": (2e-5, 2e-6), "twists": (2e-4, 1e-7), "params": (2e-4, 2e-6)}
MESH_GATE = {"twists": 1e-3, "params": 5e-4}
MESH_ITERS = 3  # one dispatch of 3, from global step 0
MESH_TIMED = 30  # iterations through the graphs, timed after the compared phase
MESH_TRACED = 5  # then traced, for the all-reduce's time inside the graphs
MESH_ALLREDUCE_REPS = 20
MESH_SCAN_POINTS = 16384  # points of each keyframe of the Optimizer's windows
MESH_OPT_SCHEDULE = [{"num_keyframes": -1, "iteration_schedule": [
    {"num_iterations": MESH_ITERS, "freeze_poses": False, "freeze_sigma_mlp": False}]}]
# The mesh SLAM runs through run_loner's command line, each a child process:
# (label, system.mesh_devices, tracker.icp.device or None for the run's card).
MESH_SLAM = (("mesh2", 2, None), ("mesh4 icp1", 4, 1), ("mesh2x2", [2, 2], None))
MESH_SLAM_SECONDS = 240  # a child's limit: dataset read, warm-up, SLAM and teardown
# The follower-death stage: four NCCL ranks run one W=8 phase of MESH_DEATH
# ["iterations"] through the Optimizer, joined with a collective timeout of
# MESH_DEATH["timeout_s"]; rank MESH_DEATH["rank"] is killed MESH_DEATH["after_s"]
# into the phase, and rank 0 must raise naming it within the timeout plus
# MESH_DEATH["margin_s"], leaving no process of the run and no card memory.
MESH_DEATH = {"rank": 2, "after_s": 3.0, "iterations": 4000, "timeout_s": 60.0,
              "margin_s": 10.0}
MESH_DEATH_SECONDS = 180  # the stage's child process limit
MESH_LEFT_BYTES = 64 << 20  # card memory the stage may leave (allocation granularity)
WITNESS_PARTS = (2, 4)  # the window's rays in 2 and in 4 batches: a rank's share on [2], [4]
# The witness's windows at W=8: the flagship's 4096 LiDAR rays, its 4608 LiDAR
# and sky rays (SKY_RAYS a slot), the camera configuration's 1024 camera rays, the
# reference's 4096 LiDAR rays (hash field in f32, OGM sampler: read once, as run).
WITNESS_WINDOWS = ("lidar", "sky", "camera", "reference")


def mesh_configs(config: str, f32: bool = False, plain: bool = False):
    """profile_iteration's ``config`` at k = 3, one dispatch in flight (``sky``:
    the flagship with SKY_RAYS sky rays a slot); ``f32``:
    the field in f32 (the f32 Fourier pair); ``plain``: the sigma field's plain
    PyTorch version in place of its kernels."""
    from dataclasses import replace

    from loner_tpu_torch.analysis.profile_iteration import configs

    cfg, field_cfg = configs("flagship" if config == "sky" else config)
    cfg = replace(cfg, steps_per_dispatch=3, max_inflight_dispatches=1)
    if config == "sky":
        cfg = replace(cfg, enable_sky=True, n_sky_samples=SKY_RAYS)
    if f32:
        field_cfg = replace(field_cfg, compute_dtype=torch.float32)
    if plain:
        field_cfg = replace(field_cfg, sigma_kernel="plain")
    return cfg, field_cfg


def _leave_out_gradients(mesh) -> None:
    """The planted fault: this rank's gradients are zeroed before the flat f32
    all-reduce (the 3-float count reductions and the loss record pass) and its
    fixed-point sums (the hash tables' and the OGM grid's) before the int64 one."""
    reduce = mesh.all_reduce_

    def all_reduce_(t):
        if t.dtype == torch.int64:
            t.zero_()
        elif t.numel() > 3:
            t[:-3].zero_()
        return reduce(t)

    mesh.all_reduce_ = all_reduce_


def mesh_phase(mesh, config: str, graphs: bool, timed: int = 0, dev=None, f32: bool = False,
               fault: bool = False, plain: bool = False, iters: int = MESH_ITERS) -> dict:
    """The W=8 phase of ``config`` (``mesh_configs``) on this rank (``mesh``
    None: on ``dev`` alone): ``iters`` iterations from one seed, their outputs
    as numpy, and the last iteration's fixed-point sums (``fixed``: the hash
    table's and, in an OGM step, the grid's int64 sums, all-reduced under a mesh;
    ``fixed_sizes``: the table's and the grid's lengths); ``fault``: with the
    last rank's gradients left out; ``plain``: through the sigma field's plain
    version. With
    ``timed``, ms an iteration through the program over ``timed`` more, the
    device ms of MESH_TRACED more under torch.profiler (rank 0) with the share of
    NCCL's kernels, and the flat gradient all-reduce alone (its size, eager,
    MESH_ALLREDUCE_REPS times)."""
    from loner_tpu_torch.analysis.profile_iteration import device_events
    from loner_tpu_torch.mapping.optimizer import Optimizer, PhaseSettings, make_phase_runner

    dev = mesh.device if mesh is not None else dev
    cfg, field_cfg = mesh_configs(config, f32, plain)
    buffers, twists = synthetic_window(dev, WINDOW, SKY_DIRS if config == "sky" else 0)
    state = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev).state
    if fault and mesh is not None and mesh.rank == mesh.spec.size - 1:
        _leave_out_gradients(mesh)
    try:
        run = make_phase_runner(cfg, field_cfg, PhaseSettings(), WINDOW, buffers.dirs.shape[1],
                                buffers.sky_dirs.shape[1], dev, graphs=graphs, mesh=mesh)
        args = (twists, buffers, torch.ones(WINDOW, device=dev), torch.tensor(12.0, device=dev),
                torch.zeros(3, device=dev))
        gen = torch.Generator(device=dev).manual_seed(1)
        before = phase_outputs((state.field_params, state.occ_grid, twists, torch.zeros(0),
                                torch.zeros(0)))
        out = phase_outputs(run(state.field_params, state.occ_grid, *args, 0, gen,
                                num_iterations=iters))
    finally:
        if mesh is not None:
            vars(mesh).pop("all_reduce_", None)
    res = {"outputs": {k: v.detach().cpu().numpy() for k, v in out.items()},
           "before": {k: v.detach().cpu().numpy() for k, v in before.items()},
           "fixed": run.fixed.cpu().numpy(),
           "fixed_sizes": [sum(acc.acc.numel() for acc in run.table_sums),
                           0 if run.grid_sum is None else run.grid_sum.acc.numel()]}
    if timed:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(state.field_params, state.occ_grid, *args, MESH_ITERS, gen, num_iterations=timed)
        torch.cuda.synchronize(dev)
        res["ms"] = 1e3 * (time.perf_counter() - t0) / timed

        def traced():
            run(state.field_params, state.occ_grid, *args, MESH_ITERS + timed, gen,
                num_iterations=MESH_TRACED)

        if mesh is None or mesh.rank == 0:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                traced()
                torch.cuda.synchronize(dev)
            events = device_events(prof)
            res["device_ms"] = sum(e.device_time_total for e in events) / 1e3 / MESH_TRACED
            res["nccl_ms"] = sum(e.device_time_total for e in events
                                 if "nccl" in e.name.lower()) / 1e3 / MESH_TRACED
        else:
            traced()
        numel = sum(p.numel() for p in run.params) + 3
        res["allreduce_numel"] = numel
        if mesh is not None:
            flat = torch.ones(numel, device=dev)
            mesh.all_reduce_(flat)
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MESH_ALLREDUCE_REPS):
                mesh.all_reduce_(flat)
            end.record()
            torch.cuda.synchronize(dev)
            res["allreduce_ms"] = start.elapsed_time(end) / MESH_ALLREDUCE_REPS
    del run
    torch.cuda.empty_cache()
    return res


def _mesh_follower(mesh, jobs) -> None:
    """A follower rank of ``run_mesh_jobs``: the same jobs as rank 0, then its stop."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for job in jobs:
        mesh_phase(mesh, **job)
    mesh.receive()


def run_mesh_jobs(spec, jobs) -> list:
    """``mesh_phase`` of each job on every rank of a fresh mesh (this process rank
    0); rank 0's results, each with its launch counts."""
    from loner_tpu_torch.parallel.mesh import launch

    mesh = launch(spec, _mesh_follower, (jobs,))
    try:
        out = []
        for job in jobs:
            torch.cuda.synchronize()
            reset_counts()
            res = mesh_phase(mesh, **job)
            torch.cuda.synchronize()
            res["counts"] = read_counts()
            out.append(res)
        return out
    finally:
        mesh.close()


def _rel_l2(diff: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(diff.ravel()) / max(np.linalg.norm(ref.ravel()), 1e-30))


def mesh_diffs(got: dict, want: dict, before: dict) -> dict:
    """Per output: the largest |got - want|, equal bits, whether MESH_TOL holds,
    the relative L2 of the difference (over the output's change ``want -
    before`` for twists and parameters, over ``want`` for losses and
    depth_eps), and the gate's verdict: MESH_TOL for losses and depth_eps,
    MESH_GATE's limit on that relative L2 for twists and parameters."""
    out = {}
    for name, w in want.items():
        kind = name.split()[0] if name.split()[0] in ("losses", "depth_eps", "twists") else "params"
        diff = np.abs(got[name] - w)
        rtol, atol = MESH_TOL["losses" if kind == "depth_eps" else kind]
        rel = _rel_l2(diff, w if kind in ("losses", "depth_eps") else w - before[name])
        equal = bool(np.array_equal(got[name], w))
        cpu_tol = bool((diff <= atol + rtol * np.abs(w)).all())
        out[name] = {"max_abs": float(diff.max()), "equal": equal, "rel_l2": rel,
                     "cpu_tol": cpu_tol,
                     "gate": cpu_tol if kind in ("losses", "depth_eps") else
                     equal or rel <= MESH_GATE[kind]}
    return out


def describe_diffs(diffs: dict) -> str:
    missed = [k for k, d in diffs.items() if not d["cpu_tol"]]
    refused = [k for k, d in diffs.items() if not d["gate"]]
    return (", ".join(f"{k} {d['max_abs']:.3e} (rel L2 {d['rel_l2']:.2e})"
                      for k, d in diffs.items())
            + f"; CPU tolerances {'met' if not missed else 'missed by ' + str(missed)}"
            + f"; MESH_GATE {'met' if not refused else 'refuses ' + str(refused)}")


def gate_failures(label: str, diffs: dict, fault: Optional[dict] = None) -> list:
    """A sound run beyond MESH_GATE, or a planted fault within it, as failures."""
    failures = []
    bad = [k for k, d in diffs.items() if not d["gate"]]
    if bad:
        failures.append(f"{label}: beyond MESH_GATE in {bad}")
    if fault is not None and all(d["gate"] for d in fault.values()):
        failures.append(f"{label}: the planted fault passes MESH_GATE")
    return failures


def order_witness(dev, f32: bool = False, order: Optional[list] = None,
                  ray_seed: Optional[int] = None, config: str = "flagship") -> dict:
    """One card, no mesh: ``config``'s W=8 phase eagerly from one set of draws,
    then again with the window's slots in ``order`` (default reversed; buffers,
    twists and every draw's slot or ray rows) and, with ``ray_seed``, each
    slot's LiDAR rays shuffled (their ``ray_u`` columns and draw rows): the same
    function with its sums over the rays taken in another order. Returns the
    second run's diffs against the first (``mesh_diffs``)."""
    import dataclasses

    from loner_tpu_torch.mapping.optimizer import (
        Optimizer, PhaseSettings, draw_step, make_phase_runner, sky_rays_per_slot,
    )
    from loner_tpu_torch.mapping.rays import WindowBuffers
    from loner_tpu_torch.parallel.mesh import SLOT_DRAWS

    cfg, field_cfg = mesh_configs(config, f32)
    buffers, twists = synthetic_window(dev, WINDOW)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [draw_step(gen, cfg, WINDOW, dev) for _ in range(MESH_ITERS)]
    n, per = cfg.n_lidar_samples, cfg.n_lidar_samples + sky_rays_per_slot(cfg)
    slots = torch.tensor(order if order is not None else list(range(WINDOW - 1, -1, -1)),
                         device=dev)
    cols = torch.arange(n).expand(WINDOW, n)
    if ray_seed is not None:
        shuffle = torch.Generator().manual_seed(ray_seed)
        cols = torch.stack([torch.randperm(n, generator=shuffle) for _ in range(WINDOW)])
    cols = torch.cat([cols, torch.arange(n, per).expand(WINDOW, per - n)], 1).to(dev)[slots]
    rays = (slots[:, None] * per + cols).reshape(-1)

    def moved(name, t):
        if name not in SLOT_DRAWS:
            return t[rays]
        return torch.gather(t[slots], 1, cols[:, :n]) if name == "ray_u" else t[slots]

    runs = []
    for perm in (None, slots):
        state = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev).state
        run = make_phase_runner(cfg, field_cfg, PhaseSettings(), WINDOW, buffers.dirs.shape[1],
                                buffers.sky_dirs.shape[1], dev, graphs=False)
        b, tw, ds = buffers, twists, draws
        if perm is not None:
            b = WindowBuffers(*(getattr(buffers, f.name)[perm]
                                for f in dataclasses.fields(WindowBuffers)))
            tw = twists[perm]
            ds = [dataclasses.replace(d, **{
                f.name: moved(f.name, getattr(d, f.name))
                for f in dataclasses.fields(d) if getattr(d, f.name) is not None}) for d in draws]
        out = phase_outputs(run(state.field_params, state.occ_grid, tw, b,
                                torch.ones(WINDOW, device=dev), torch.tensor(12.0, device=dev),
                                torch.zeros(3, device=dev), 0, None, num_iterations=MESH_ITERS,
                                draws=ds))
        if perm is not None:
            out["twists"] = out["twists"][torch.argsort(perm)]
        runs.append({k: v.detach().cpu().numpy() for k, v in out.items()})
        if perm is None:
            before = phase_outputs((state.field_params, state.occ_grid, twists, torch.zeros(0),
                                    torch.zeros(0)))
            before = {k: v.detach().cpu().numpy() for k, v in before.items()}
        del run
    return mesh_diffs(runs[1], runs[0], before)


def _rows_differ(a: torch.Tensor, b: torch.Tensor, rays: int) -> tuple:
    """Rays (``rays`` rows of ``a`` and ``b`` reshaped) with any bit different, NaN
    equal to NaN; and the largest difference."""
    a, b = a.reshape(rays, -1), b.reshape(rays, -1)
    differ = (a != b) & ~(a.isnan() & b.isnan())
    diff = (a - b).abs().nan_to_num(0.0)
    return int(differ.any(dim=1).sum()), float(diff.max()) if diff.numel() else 0.0


def witness_configs(window: str, f32: bool):
    """The configurations of ``forward_batch_witness``'s windows: the flagship
    (``lidar``), the flagship with SKY_RAYS sky rays a slot (``sky``),
    cfg/synthetic/box_room_tpu_camera_r5.yaml (``camera``) and the reference
    (``reference``: hash sigma field, OGM sampler); ``f32``: the field in f32."""
    from dataclasses import replace

    from loner_tpu_torch.analysis.profile_iteration import configs

    if window == "reference":
        return mesh_configs("reference", f32)
    if window != "camera":
        return mesh_configs("sky" if window == "sky" else "flagship", f32)
    cfg, field_cfg = configs("camera")
    return cfg, replace(field_cfg, compute_dtype=torch.float32) if f32 else field_cfg


def forward_batch_witness(dev, parts: int = 4, f32: bool = False, window: str = "lidar") -> dict:
    """One card, no mesh: the first iteration's forward of a W=8 window
    (``witness_configs``: the flagship's LiDAR rays, its LiDAR and sky rays, or
    the camera configuration's camera rays) in one batch and in ``parts``
    contiguous batches of its rays (what each rank of a ``parts``-rank mesh
    computes), from the same draws and state.

    ``ops``, op by op: each op of the forward, given the one-batch run's input to
    it, on the whole batch and on each part (rows split evenly: slots, rays or
    points); the rays whose output differs in any bit and the largest
    difference. The ray build (``sample_and_build_rays`` or
    ``sample_and_build_camera_rays`` on the parts' slots); the proposal
    sampler's ops, its MLP's last product (one output column) twice: as one
    product (``x @ w``, a gemv; ``port`` False) and in the blocks of RAY_BLOCK
    rays that ``proposal_logits`` computes; the sigma field; the compositing's
    transmittance twice, as one ``torch.cumprod`` (``port`` False: CUDA's scan
    shares a row among more threads when there are fewer rows) and in the blocks
    of SCAN_ROWS rays that ``raw2outputs`` computes; the compositing;
    for LiDAR and sky rays the JS score, for camera rays the intensity head's
    Fourier features, its products as ``_MLPFunction`` runs them and
    ``query_intensity``, then the colours. Then the whole forward
    (``compute_lidar_loss``, ``compute_camera_loss``) in one batch and in
    parts: how many rays' outputs differ (sample depths and JS scores, with the
    rays on the two sides of the JS threshold; colours and squared errors).
    ``first``: the first op whose output differs; ``port_first``: the first of
    the ops the port runs."""
    from loner_tpu_torch.analysis.profile_iteration import camera_window
    from loner_tpu_torch.mapping.loss import compute_camera_loss, compute_lidar_loss, js_scores
    from loner_tpu_torch.mapping.optimizer import (
        Optimizer, _camera_rays, draw_step, sky_rays_per_slot,
    )
    from loner_tpu_torch.mapping.rays import WindowBuffers, sample_and_build_rays
    from loner_tpu_torch.mapping.optimizer import training_field_cfg
    from loner_tpu_torch.models.field import (
        _round, _RowBlockedProduct, encode_fourier, field_mlp, hash_sigma_mlp, query_field,
        query_intensity,
    )
    from loner_tpu_torch.models.proposal import RAY_BLOCK, _OneColumnProduct, proposal_logits
    from loner_tpu_torch.ops.hash_grid import hash_encode
    from loner_tpu_torch.models.rendering import (
        OccGridRaySampler, ProposalRaySampler, _inverse_cdf, _PositiveCumprod, raw2outputs,
    )
    from loner_tpu_torch.models.sh_encoding import sh_encode

    cfg, field_cfg = witness_configs(window, f32)
    field_cfg = training_field_cfg(cfg, field_cfg)  # the hash encode's training dtype
    buffers, twists = synthetic_window(dev, WINDOW, SKY_DIRS if window == "sky" else 0)
    params = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), [], dev).state
    camera, reference = window == "camera", window == "reference"
    d = draw_step(torch.Generator(device=dev).manual_seed(1), cfg, WINDOW, dev, camera=camera)
    scale, shift = torch.tensor(12.0, device=dev), torch.zeros(3, device=dev)
    prop, n = params.occ_grid, cfg.n_samples_per_ray
    sampler = ProposalRaySampler(n_ctrl=cfg.prop_n_ctrl or None)
    if reference:  # the OGM grid at logits in [0.5, 4] (a fresh grid is all 0)
        prop = torch.rand(prop.shape, generator=torch.Generator(device=dev).manual_seed(2),
                          device=dev) * 3.5 + 0.5
        sampler = OccGridRaySampler()
    ops = []
    with torch.no_grad():
        if camera:
            cam = camera_window(WINDOW, field_cfg.num_colors, dev)
            rays_of = lambda tw, intens, has, valid, u: _camera_rays(  # noqa: E731
                cfg, type(cam)(cam.cam_dirs, intens, has, cam.lidar_to_camera), tw, scale, shift,
                valid, u)
            slot_inputs = (twists, cam.intensities, cam.has_image, buffers.slot_valid, d.cam_u)
            jitter, pdf_u = d.cam_jitter, d.cam_pdf_u
        else:
            rays_of = lambda tw, di, de, co, sd, sc, sv, u, su: sample_and_build_rays(  # noqa: E731
                WindowBuffers(di, de, co, sd, sc, sv), tw, scale, shift, cfg.ray_range,
                cfg.n_lidar_samples, sky_rays_per_slot(cfg), u=u, sky_u=su)
            slot_inputs = (twists, buffers.dirs, buffers.depths, buffers.counts, buffers.sky_dirs,
                           buffers.sky_counts, buffers.slot_valid, d.ray_u, d.sky_u)
            if d.sky_u is None:
                slot_inputs = slot_inputs[:-1]
                rays_of = (lambda f: lambda *a: f(*a, None))(rays_of)
            jitter, pdf_u = d.jitter, d.pdf_u
        rays, depths, valid = rays_of(*slot_inputs)
        b = rays.shape[0]

        def op(name: str, fn, *inputs, port: bool = True):
            """``fn`` on the whole of ``inputs`` and on each part of their rows."""
            whole = fn(*inputs)
            pieces = [fn(*(t[i * (t.shape[0] // parts):(i + 1) * (t.shape[0] // parts)]
                           for t in inputs)) for i in range(parts)]
            n_rays, max_abs = _rows_differ(whole, torch.cat(pieces), b)
            ops.append({"op": name, "port": port, "rays_differ": n_rays, "max_abs": max_abs})
            return whole

        op("camera rays (sample_and_build_camera_rays)" if camera else
           "rays (sample_and_build_rays)", lambda *a: rays_of(*a)[0], *slot_inputs)
        near, far = rays[:, 9:10], rays[:, 10:11]
        if not reference:
            # The proposal sampler (models/rendering.py::ProposalRaySampler.get_samples).
            n_ctrl = cfg.prop_n_ctrl or n // 2
            steps = torch.linspace(0.0, 1.0, n_ctrl, dtype=rays.dtype, device=dev)
            z_ctrl = near * (1.0 - steps) + far * steps
            pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z_ctrl[..., None]
            flat = pts.reshape(-1, 3)
            proj = op("bmat projection", lambda x: x @ prop["bmat"], flat)
            h = torch.cat([torch.sin(proj), torch.cos(proj), flat], dim=-1)
            last = sum(1 for key in prop if key.startswith("w")) - 1
            for i in range(last):
                h = torch.relu(op(f"proposal product {i}", lambda x, w=prop[f"w{i}"]: x @ w, h))
            w_last = prop[f"w{last}"]
            op(f"proposal product {last}, one column", lambda x: x @ w_last, h, port=False)
            op(f"proposal product {last}, in blocks of RAY_BLOCK rays",
               lambda x: _OneColumnProduct.apply(x, w_last, RAY_BLOCK * n_ctrl), h)
            logits = op("proposal_logits", lambda x: proposal_logits(prop, x), pts)
            probs = 2.0 * (torch.clamp(torch.sigmoid(logits), 0.5, 1.0) - 0.5)
            occ_w = 0.5 * (probs[:, :-1] + probs[:, 1:]) + 1e-5
            total = op("row sum", lambda x: x.sum(dim=-1, keepdim=True), occ_w)
            w = 0.5 / (n_ctrl - 1) + 0.5 * (occ_w / total)
            cdf = op("cumsum", lambda x: torch.cumsum(x, dim=-1), w)
            cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
            q = torch.arange(n, dtype=rays.dtype, device=dev)
            u = torch.minimum((q[None, :] + jitter) / n, cdf[:, -1:])
            op("_inverse_cdf",
               lambda c, z, uu, lo, hi: _inverse_cdf(c, z, uu, edges=(lo, hi, steps)),
               cdf, z_ctrl, u, near, far)
            z = op("sampler (get_samples)",
                   lambda r, j: sampler.get_samples(r, n, cfg.perturb, prop, j), rays, jitter)
        else:
            z = op("OGM sampler (get_samples)", lambda r, j, u: sampler.get_samples(
                r, n, cfg.perturb, prop, j, u), rays, jitter, pdf_u)
        # The field, the compositing and the loss terms on the sampler's depths.
        points = (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)
        raw = op("sigma field (query_field)",
                 lambda x: query_field(params.field_params, x, None, field_cfg, sigma_only=True),
                 points)
        softplus = field_cfg.density_activation == "softplus"
        # raw2outputs' transmittance: one scan of each ray's 1 - alpha (the LiDAR
        # rays' sigma with its noise).
        sigma = raw.reshape(b, n)
        if not camera and cfg.raw_noise_std > 0:
            sigma = sigma + d.noise * cfg.raw_noise_std
        deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
        deltas = deltas * torch.linalg.norm(rays[:, 3:6], dim=-1, keepdim=True)
        act = torch.nn.functional.softplus(sigma) if softplus else torch.relu(sigma)
        alphas = 1.0 - torch.exp(-deltas * act)
        scan_in = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1)
        op("transmittance, one cumprod", lambda x: torch.cumprod(x, dim=-1), scan_in, port=False)
        op("transmittance in blocks of SCAN_ROWS rays", _PositiveCumprod.apply, scan_in)
        if camera:
            view = rays[:, None, 6:9].expand(b, n, 3).reshape(-1, 3)
            intensity = params.field_params["intensity"]
            pos01 = (points + 1.0) * 0.5
            h = op("intensity Fourier features",
                   lambda x: encode_fourier(x, field_cfg.fourier_intensity, field_cfg), pos01)
            if field_cfg.enable_view_dependence:
                h = torch.cat([h, op("SH encode", lambda v: sh_encode((v + 1.0) * 0.5,
                                                                      field_cfg.sh_degree),
                                     view)], dim=-1)
            mlp = intensity["mlp"]
            n_layers = sum(1 for key in mlp if key.startswith("w"))
            dtype = field_cfg.compute_dtype
            h = _round(h, dtype)
            for i in range(n_layers):
                h = op(f"intensity product {i}", lambda x, wi=_round(mlp[f"w{i}"], dtype): x @ wi, h)
                if i < n_layers - 1:
                    h = _round(h, dtype)
                    if f"b{i}" in mlp:
                        h = _round(h + _round(mlp[f"b{i}"], dtype), dtype)
                    h = torch.relu(h)
            rgb = op("intensity head (query_intensity)",
                     lambda x, v: query_intensity(params.field_params, x, v, field_cfg),
                     points, view)
            raw_c = torch.cat([rgb, raw], dim=-1)
            weights = op("compositing, weights (raw2outputs)", lambda r, zz, dd, ff: raw2outputs(
                r.reshape(zz.shape[0], n, 1), zz, dd, softplus=softplus, far=ff)["weights"],
                raw, z, rays[:, 3:6], far)
            op("colour sum over the samples", lambda ww, cc: (ww[..., None] * cc).sum(dim=-2),
               weights, rgb.reshape(b, n, -1))
            op("compositing, colours (raw2outputs)", lambda r, zz, dd, ff: raw2outputs(
                r.reshape(zz.shape[0], n, -1), zz, dd, softplus=softplus, far=ff,
                sigma_only=False, num_colors=field_cfg.num_colors)["rgb"],
               raw_c, z, rays[:, 3:6], far)

            def forward(rows):
                rows_of = (lambda t: None if t is None else t[rows])
                mse, rgb_out = compute_camera_loss(
                    rays[rows], cam_i[rows], valid[rows], params.field_params, field_cfg,
                    sampler, prop, n, cfg.perturb, detach_sigma=cfg.detach_rgb_from_sigma,
                    jitter=rows_of(jitter), pdf_u=rows_of(pdf_u))
                return rgb_out, (rgb_out - cam_i[rows]) ** 2

            cam_i = rays_of(*slot_inputs)[1]
        else:
            weights = op("compositing (raw2outputs)", lambda r, zz, dd, nn, ff: raw2outputs(
                r.reshape(zz.shape[0], n, 1), zz, dd, noise=nn, raw_noise_std=cfg.raw_noise_std,
                softplus=softplus, far=ff)["weights"], raw, z, rays[:, 3:6], d.noise, far)
            op("depth (raw2outputs)", lambda r, zz, dd, nn, ff: raw2outputs(
                r.reshape(zz.shape[0], n, 1), zz, dd, noise=nn, raw_noise_std=cfg.raw_noise_std,
                softplus=softplus, far=ff)["depth"], raw, z, rays[:, 3:6], d.noise, far)
            op("JS score", lambda zz, ww, dd: js_scores(zz, ww, dd, cfg.loss.min_depth_eps)[0],
               z * scale, weights, depths * scale)

            def forward(rows):
                rows_of = (lambda t: None if t is None else t[rows])
                _, aux = compute_lidar_loss(
                    rays[rows], depths[rows], valid[rows], params.field_params, field_cfg,
                    sampler, prop, cfg.loss, scale, n, cfg.perturb, cfg.raw_noise_std, 0.0, 0.0,
                    jitter=rows_of(jitter), noise=rows_of(d.noise), pdf_u=rows_of(pdf_u))
                return aux["js_score"], aux["z_m"]

        # The backward, op by op, from seeded upstream cotangents, each given the
        # one-batch run's inputs: the per-sample cotangent at sigma (raw2outputs'
        # backward from the depth or colours and the weights), the transmittance's
        # (its reversed cumsum in blocks of SCAN_ROWS rays; as one cumsum, port
        # False), then the field's backward from that cotangent: per-point dpos and,
        # for the hash field, the cotangent at the encoder's output.
        up = torch.Generator(device=dev).manual_seed(7)
        u_out = torch.randn((b, field_cfg.num_colors if camera else 1), generator=up, device=dev)
        u_w = torch.randn((b, n), generator=up, device=dev)

        def vjp(fn, x, cotangents):
            with torch.enable_grad():
                leaf = x.detach().requires_grad_(True)
                total = sum((o * c).sum() for o, c in zip(fn(leaf), cotangents))
                return torch.autograd.grad(total, leaf)[0]

        if camera:
            d_raw = op("backward: cotangent at the colours and sigma (raw2outputs)",
                       lambda r, zz, dd, ff, uo, uw: vjp(
                           lambda x: (lambda o: (o["rgb"], o["weights"]))(raw2outputs(
                               x.reshape(zz.shape[0], n, -1), zz, dd, softplus=softplus, far=ff,
                               sigma_only=False, num_colors=field_cfg.num_colors)),
                           r, [uo, uw]), raw_c, z, rays[:, 3:6], far, u_out, u_w)
            d_sigma = d_raw[:, -1:]
        else:
            d_sigma = op("backward: cotangent at sigma (raw2outputs)",
                         lambda r, zz, dd, nn, ff, uo, uw: vjp(lambda x: (lambda o: (
                             o["depth"], o["weights"]))(raw2outputs(
                                 x.reshape(zz.shape[0], n, 1), zz, dd, noise=nn,
                                 raw_noise_std=cfg.raw_noise_std, softplus=softplus, far=ff)),
                             r, [uo[:, 0], uw]), raw, z, rays[:, 3:6], d.noise, far, u_out, u_w)
        u_t = torch.randn(scan_in.shape, generator=up, device=dev)
        t_out = _PositiveCumprod.apply(scan_in)
        op("backward: transmittance, one reversed cumsum",
           lambda x, o, g: (o * g).flip(-1).cumsum(-1).flip(-1).div(x), scan_in, t_out, u_t,
           port=False)
        op("backward: transmittance in blocks of SCAN_ROWS rays",
           lambda x, g: vjp(lambda a: (_PositiveCumprod.apply(a),), x, [g]), scan_in, u_t)
        op("backward: dpos (query_field)", lambda x, g: vjp(lambda a: (query_field(
            params.field_params, a, None, field_cfg, sigma_only=True),), x, [g]), points, d_sigma)
        if reference:
            sig = params.field_params["sigma"]
            feats = hash_encode(sig["table"], (points + 1.0) * 0.5, field_cfg.pos_encoding_sigma,
                                field_cfg.hash_encode_dtype)
            head = ((lambda f: hash_sigma_mlp(sig["mlp"], f, field_cfg))
                    if field_cfg.compute_dtype == torch.float32
                    else (lambda f: field_mlp(sig["mlp"], f, field_cfg)))
            op("backward: cotangent at the encoder's output (the sigma MLP)",
               lambda f, g: vjp(lambda a: (head(a),), f, [g]), feats, d_sigma)
            # The MLP's first input-gradient product (64 -> 32 columns), from a seeded
            # cotangent at its output: as one product, and in blocks of MLP_GRAD_ROWS.
            w0 = sig["mlp"]["w0"]
            u_h = torch.randn((feats.shape[0], w0.shape[1]), generator=up, device=dev)
            op("backward: sigma MLP input-gradient product, one call",
               lambda g: g @ w0.t(), u_h, port=False)
            op("backward: sigma MLP input-gradient product in blocks of MLP_GRAD_ROWS rows",
               lambda f, g: vjp(lambda a: (_RowBlockedProduct.apply(a, w0),), f, [g]), feats, u_h)
        if camera:
            op("backward: dpos (query_intensity)", lambda x, v, g: vjp(lambda a: (query_intensity(
                params.field_params, a, v, field_cfg),), x, [g]), points, view, d_raw[:, :-1])

        k = b // parts
        whole = forward(slice(None))
        pieces = [forward(slice(i * k, (i + 1) * k)) for i in range(parts)]
    out_a, out_b = (_rows_differ(w_, torch.cat([p[j] for p in pieces]), b)
                    for j, w_ in enumerate(whole))
    differing = [o["op"] for o in ops if o["rays_differ"]]
    port_differing = [o["op"] for o in ops if o["rays_differ"] and o["port"]]
    res = {"window": window, "rays": b, "parts": parts, "f32": f32, "ops": ops,
           "first": differing[0] if differing else None,
           "port_first": port_differing[0] if port_differing else None,
           "whole_rays_differ": out_a[0] + out_b[0]}
    if camera:
        res.update({"rgb_rays_differ": out_a[0], "rgb_max_abs": out_a[1],
                    "err_rays_differ": out_b[0], "err_max_abs": out_b[1]})
    else:
        js, js_p = whole[0], torch.cat([p[0] for p in pieces])
        threshold = cfg.loss.min_js_score
        res.update({"js_rays_differ": out_a[0], "js_max_abs": out_a[1],
                    "z_rays_differ": out_b[0], "z_max_abs": out_b[1],
                    "threshold_crossings": int(((js < threshold) != (js_p < threshold)).sum())})
    return res


def describe_witness(res: dict) -> str:
    whole = (f"colours of {res['rgb_rays_differ']} rays ({res['rgb_max_abs']:.3e}), squared "
             f"errors of {res['err_rays_differ']} ({res['err_max_abs']:.3e})"
             if res["window"] == "camera" else
             f"sample depths of {res['z_rays_differ']} rays ({res['z_max_abs']:.3e} m), JS scores "
             f"of {res['js_rays_differ']} ({res['js_max_abs']:.3e}), "
             f"{res['threshold_crossings']} across the JS threshold")
    return (f"{res['window']} window, {res['rays']} rays in 1 batch against {res['parts']} "
            f"batches, {'f32' if res['f32'] else 'bf16'}: "
            + "; ".join(f"{o['op']} {o['rays_differ']} rays ({o['max_abs']:.3e})"
                        for o in res["ops"])
            + f"; first op that differs: {res['first']}; first the port runs: "
            f"{res['port_first']}; whole forward: {whole}")


def mesh_keyframes(n: int) -> list:
    """``n`` keyframes of MESH_SCAN_POINTS unit directions at depths in [1.5,
    9.5] m and small poses, from a seed."""
    from loner_tpu_torch.common.frame import Frame
    from loner_tpu_torch.common.pose import Pose
    from loner_tpu_torch.common.sensors import LidarScan
    from loner_tpu_torch.mapping.keyframe import KeyFrame

    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        d = rng.normal(size=(3, MESH_SCAN_POINTS))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        frame = Frame(LidarScan(d.astype(np.float32),
                                rng.uniform(1.5, 9.5, MESH_SCAN_POINTS).astype(np.float32),
                                100.0 + 0.1 * i + np.linspace(0.0, 0.1, MESH_SCAN_POINTS)))
        frame._lidar_pose = Pose.from_twist(rng.normal(0.0, 0.02, 6))
        out.append(KeyFrame(frame))
    return out


def mesh_optimizer_run(dev, spec, ckpt) -> dict:
    """The Optimizer as the mapper drives it, under ``spec`` (None: no mesh):
    warm_up, a window of WINDOW keyframes, restore(``ckpt``), the window again,
    close. Returns each window's losses, depth_eps and twists, the state after
    the restore ("before") and at the end, and the late captures."""
    from loner_tpu_torch.mapping.optimizer import Optimizer

    cfg, field_cfg = mesh_configs("flagship")
    late0 = late_captures()
    opt = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), MESH_OPT_SCHEDULE, dev, seed=5,
                    skip_pose_refinement=False, mesh=spec)
    out, before = {}, {}
    try:
        opt.warm_up(MESH_SCAN_POINTS)
        for n in (1, 2):
            if n == 2:
                opt.restore(ckpt["network_state_dict"], ckpt["occ_model_state_dict"], 40, 1)
            kfs = mesh_keyframes(WINDOW)
            before[f"twists {n}"] = np.stack([kf.pose_twist() for kf in kfs])
            state = {k: v.detach().cpu().numpy() for k, v in phase_outputs(
                (opt.state.field_params, opt.state.occ_grid, torch.zeros(0), torch.zeros(0),
                 torch.zeros(0))).items()}
            opt.iterate_optimizer(kfs)
            out[f"losses {n}"] = opt.last_losses.copy()
            out[f"depth_eps {n}"] = opt.last_depth_eps.copy()
            out[f"twists {n}"] = np.stack([kf.pose_twist() for kf in kfs]).astype(np.float32)
        for name, v in phase_outputs((opt.state.field_params, opt.state.occ_grid, torch.zeros(0),
                                      torch.zeros(0), torch.zeros(0))).items():
            if name not in ("losses", "depth_eps", "twists"):
                out[name] = v.detach().cpu().numpy()
                before[name] = state[name]
        late = late_captures() - late0
    finally:
        opt.close()
    return {"outputs": out, "before": before, "late": late}


def reference_on_mesh(name: str, results: list, ones: dict) -> tuple:
    """The reference's jobs of ``mesh_on_one_card`` (REFERENCE_JOBS, then
    REFERENCE_FAULT where it ran) against one card: iteration 1's fixed-point
    sums (the hash table's and the OGM grid's) equal to the bit; the 3-iteration
    phase printed beside MESH_GATE, and held to it where the sound readings meet
    it (then a planted fault that ran must be refused). Returns (readings,
    failures)."""
    first, sound = results[:2]
    want = ones["reference 1"]
    n_table = want["fixed_sizes"][0]
    equal = {"table": bool(np.array_equal(first["fixed"][:n_table], want["fixed"][:n_table])),
             "grid": bool(np.array_equal(first["fixed"][n_table:], want["fixed"][n_table:]))}
    diffs = mesh_diffs(sound["outputs"], ones["reference"]["outputs"], ones["reference"]["before"])
    planted = None if len(results) < 3 else mesh_diffs(
        results[2]["outputs"], ones["reference"]["outputs"], ones["reference"]["before"])
    print(f"mesh: {name} on one card, eager; reference W={WINDOW} (hash+OGM): iteration 1's "
          f"int64 sums against one card's: table ({n_table}) equal bits {equal['table']}, OGM "
          f"grid ({want['fixed_sizes'][1]}) equal bits {equal['grid']}; {MESH_ITERS} iterations: "
          f"{describe_diffs(diffs)}"
          + ("" if planted is None else f"; with the planted fault: {describe_diffs(planted)}")
          + f"; launches {first['counts']}", flush=True)
    failures = [f"{name} reference: iteration 1's {k} sums differ from one card's"
                for k, ok in equal.items() if not ok]
    # Where the sound readings meet MESH_GATE the reference joins the gate, and its
    # planted fault must be refused; beyond it they are printed only.
    if all(d["gate"] for d in diffs.values()):
        failures += gate_failures(f"{name} reference", diffs, planted)
    else:
        print(f"mesh: {name} reference after {MESH_ITERS} iterations: beyond MESH_GATE in "
              f"{[k for k, d in diffs.items() if not d['gate']]}, printed only", flush=True)
    if min(first["counts"]["hash_encode_fwd"], first["counts"]["hash_encode_bwd"]) < 1:
        failures.append(f"{name} reference: launches {first['counts']}")
    return {"iteration 1 equal": equal, "diffs": diffs, "fault": planted}, failures


def reference_drift(dev) -> dict:
    """Where the reference's W=8 phase on a mesh leaves one card's, iteration by
    iteration (not part of ``main``; a call of its own: ``python3 -c "import torch,
    chip_smoke as c; from loner_tpu_torch.ops.build import build_all; build_all();
    c.reference_drift(torch.device('cuda', 0))"``).
    Gloo meshes [2], [4] and [2, 2] sharing ``dev`` run 1, 2 and MESH_ITERS
    iterations: each run's last iteration's table sums against one card's bits,
    and its outputs (losses, twists, parameters) against one card's
    (``mesh_diffs``). Then the sound spread on one card: the same phase with the
    window's slots reversed, with each slot's rays shuffled, and both
    (``order_witness``). Prints one JSON line a reading; returns them."""
    from loner_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    dev = torch.device(dev.type, torch.cuda.current_device() if dev.index is None else dev.index)
    iters = (1, 2, MESH_ITERS)
    ones = {i: mesh_phase(None, "reference", False, dev=dev, iters=i) for i in iters}
    n_table = ones[1]["fixed_sizes"][0]
    out = {}
    for name, spec in (("[2]", make_mesh(2, devices=[dev] * 2)),
                       ("[4]", make_mesh(4, devices=[dev] * 4)),
                       ("[2, 2]", make_mesh_2d(2, 2, devices=[dev] * 4))):
        results = run_mesh_jobs(spec, [{"config": "reference", "graphs": False, "iters": i}
                                       for i in iters])
        for i, res in zip(iters, results):
            diffs = mesh_diffs(res["outputs"], ones[i]["outputs"], ones[i]["before"])
            got, want = res["fixed"][:n_table], ones[i]["fixed"][:n_table]
            differ = got != want
            reading = {
                "mesh": name, "iterations": i,
                "last_table_sums_equal": bool(not differ.any()),
                "table_entries_differing": int(differ.sum()),
                "table_sums_rel_l2": _rel_l2((got - want).astype(np.float64),
                                             want.astype(np.float64)),
                "outputs_equal": sorted(k for k, d in diffs.items() if d["equal"]),
                "outputs_differ": {k: {"max_abs": d["max_abs"], "rel_l2": d["rel_l2"],
                                       "gate": d["gate"]}
                                   for k, d in diffs.items() if not d["equal"]}}
            out[f"{name} {i}"] = reading
            print("reference drift: " + json.dumps(reading), flush=True)
    for label, kwargs in (("slots reversed", {}), ("rays shuffled", {"order": list(range(WINDOW)),
                                                                     "ray_seed": 3}),
                          ("slots reversed, rays shuffled", {"ray_seed": 3})):
        diffs = order_witness(dev, config="reference", **kwargs)
        reading = {"one card": label, "iterations": MESH_ITERS,
                   "outputs_equal": sorted(k for k, d in diffs.items() if d["equal"]),
                   "outputs_differ": {k: {"max_abs": d["max_abs"], "rel_l2": d["rel_l2"],
                                          "gate": d["gate"]}
                                      for k, d in diffs.items() if not d["equal"]}}
        out[label] = reading
        print("reference drift: " + json.dumps(reading), flush=True)
    return out


# The reference's jobs on each gloo mesh of one card: one iteration (its OGM step),
# then MESH_ITERS; on two ranks also MESH_ITERS with the planted fault.
REFERENCE_JOBS = [{"config": "reference", "graphs": False, "iters": 1},
                  {"config": "reference", "graphs": False}]
REFERENCE_FAULT = {"config": "reference", "graphs": False, "fault": True}


def mesh_on_one_card(dev, specs) -> tuple:
    """Gloo meshes of ``specs`` whose ranks all share ``dev``: the flagship's W=8
    phase eagerly on each, in bf16 held to MESH_GATE, in f32 to MESH_TOL, and
    with the planted fault, which the gate must refuse; the reference's
    (``reference_on_mesh``: iteration 1's table and grid sums equal to one card's
    bits, MESH_ITERS iterations beside MESH_GATE, on two ranks with the planted
    fault too); on
    four ranks also the sky window's phase (``mesh_configs("sky")``: the window's
    LiDAR and sky rays over the ranks) in bf16 and with the planted fault.
    Returns ({"readings", "launches"}, failures)."""
    readings, launches, failures = {}, {}, []
    jobs = [{"config": "flagship", "graphs": False},
            {"config": "flagship", "graphs": False, "f32": True},
            {"config": "flagship", "graphs": False, "fault": True}]
    sky_jobs = [{"config": "sky", "graphs": False}, {"config": "sky", "graphs": False, "fault": True}]
    ones = {"bf16": mesh_phase(None, dev=dev, **jobs[0]), "f32": mesh_phase(None, dev=dev, **jobs[1]),
            "sky": mesh_phase(None, dev=dev, **sky_jobs[0]),
            "reference 1": mesh_phase(None, dev=dev, **REFERENCE_JOBS[0]),
            "reference": mesh_phase(None, dev=dev, **REFERENCE_JOBS[1])}
    for spec in specs:
        name = f"gloo {spec.size} ranks" + (f" {list(spec.shape)}" if spec.two_axes else "")
        t0 = time.perf_counter()
        with_sky = spec.size == 4
        ref_jobs = REFERENCE_JOBS + ([REFERENCE_FAULT] if spec.size == 2 else [])
        results = run_mesh_jobs(spec, jobs + ref_jobs + (sky_jobs if with_sky else []))
        labelled = [("flagship bf16", "bf16"), ("flagship f32", "f32"),
                    ("flagship bf16, planted fault", "bf16"), ("sky bf16", "sky"),
                    ("sky bf16, planted fault", "sky")]
        ref_results = results[len(jobs):len(jobs) + len(ref_jobs)]
        results = results[:len(jobs)] + results[len(jobs) + len(ref_jobs):]
        for (label, one), res in zip(labelled, results):
            diffs = mesh_diffs(res["outputs"], ones[one]["outputs"], ones[one]["before"])
            readings[f"{name} {label}"] = diffs
            print(f"mesh: cards {torch.cuda.device_count()}, {name} on one card, eager; "
                  f"W={WINDOW} {label}, {MESH_ITERS} iterations; against one card: "
                  f"{describe_diffs(diffs)}; launches {res['counts']}", flush=True)
        readings[f"{name} reference"], more = reference_on_mesh(name, ref_results, ones)
        failures += more
        launches[f"mesh {name}, one card, reference"] = ref_results[0]["counts"]
        print(f"mesh: {name}: {len(results) + len(ref_results)} jobs in "
              f"{time.perf_counter() - t0:.3f} s with the spawn", flush=True)
        for window in ("flagship", "sky") if with_sky else ("flagship",):
            failures += gate_failures(f"{name} {window} bf16", readings[f"{name} {window} bf16"],
                                      readings[f"{name} {window} bf16, planted fault"])
        if not all(d["cpu_tol"] for d in readings[f"{name} flagship f32"].values()):
            failures.append(f"{name} f32: beyond the CPU tests' tolerances")
        launches[f"mesh {name}, one card"] = results[0]["counts"]
        launches[f"mesh {name}, one card, f32"] = results[1]["counts"]
        if with_sky:
            launches[f"mesh {name}, one card, sky"] = results[3]["counts"]
        for label, res, kernel in (("bf16", results[0], "fourier_mlp_fwd"),
                                   ("f32", results[1], "fourier_mlp_fwd_f32")) + (
                (("sky", results[3], "fourier_mlp_fwd"),) if with_sky else ()):
            if min(res["counts"][kernel], res["counts"][kernel.replace("fwd", "bwd")]) < MESH_ITERS:
                failures.append(f"{name} {label}: launches {res['counts']}")
    return {"readings": readings, "launches": launches}, failures


def run_mesh(dev) -> dict:
    """Phase 21 on one card: (a) the forward and the backward of each of
    WITNESS_WINDOWS in one batch against WITNESS_PARTS batches, op by op
    (``forward_batch_witness``), in bf16 and f32 (the reference as it runs): no
    ray of an op the port runs, and none of the whole forward's outputs, may
    differ in any bit; then two gloo ranks, four and [2, 2] sharing the card run
    the flagship's W=8 phase eagerly (each rank's Fourier pair on its share of the
    window), and four ranks the sky window's: in bf16 held to MESH_GATE, in f32 to
    MESH_TOL, and with the planted fault, which the gate must refuse; and the
    reference's, iteration 1's table and grid sums equal to one card's bits
    (``mesh_on_one_card``); (b) the
    slot-reversed witness on one card;
    (c) a one-rank NCCL mesh through the graphs, its collectives captured, equal
    to the bit to the graphs without a mesh; (d) the Optimizer on that one-rank
    mesh, equal to the bit to the Optimizer without one, and on the two gloo
    ranks (spawned by the Optimizer, eagerly), held to MESH_GATE. Returns each
    path's launches and the readings."""
    from loner_tpu_torch.common.world_cube import WorldCube
    from loner_tpu_torch.mapping.mapper import build_ckpt
    from loner_tpu_torch.mapping.optimizer import Optimizer
    from loner_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    launches, failures, readings = {}, [], {}
    cards = torch.cuda.device_count()
    gloo, nccl = make_mesh(2, devices=[dev, dev]), make_mesh(1, dev)

    for window in WITNESS_WINDOWS:
        for parts in WITNESS_PARTS:
            for f32_witness in (False,) if window == "reference" else (False, True):
                t0 = time.perf_counter()
                res = forward_batch_witness(dev, parts, f32_witness, window)
                label = f"{window} forward in {parts} batches, {'f32' if f32_witness else 'bf16'}"
                readings[label] = res
                print(f"mesh witness: one card, no mesh, W={WINDOW}: {describe_witness(res)} "
                      f"({time.perf_counter() - t0:.2f} s)", flush=True)
                if res["port_first"] or res["whole_rays_differ"]:
                    failures.append(f"{label}: {res['port_first']} differs from one batch")

    shared, more = mesh_on_one_card(dev, [gloo, make_mesh(4, devices=[dev] * 4),
                                          make_mesh_2d(2, 2, devices=[dev] * 4)])
    readings.update(shared["readings"])
    launches.update(shared["launches"])
    failures += more

    for label, f32_witness in (("bf16", False), ("f32", True)):
        diffs = order_witness(dev, f32_witness)
        readings[f"one card, slots reversed, {label}"] = diffs
        print(f"mesh witness: one card, no mesh, flagship W={WINDOW} {label} with the window's "
              f"slots reversed, against the window in order: {describe_diffs(diffs)}", flush=True)

    job = {"config": "flagship", "graphs": True}
    one = mesh_phase(None, dev=dev, **job)
    (res,) = run_mesh_jobs(nccl, [job])
    diffs = mesh_diffs(res["outputs"], one["outputs"], one["before"])
    bits = all(d["equal"] for d in diffs.values())
    print(f"mesh: cards {cards}, ranks {nccl.size}, backend {nccl.backend}, graphs; flagship "
          f"W={WINDOW}, {MESH_ITERS} iterations; against one card: equal bits {bits}; launches "
          f"{res['counts']}", flush=True)
    if not bits:
        failures.append(f"nccl 1 rank: differs from one card in "
                        f"{[k for k, d in diffs.items() if not d['equal']]}")
    if min(res["counts"]["fourier_mlp_fwd"], res["counts"]["fourier_mlp_bwd"]) < MESH_ITERS:
        failures.append(f"nccl 1 rank: launches {res['counts']}")
    launches["mesh nccl 1 rank"] = res["counts"]

    cfg, field_cfg = mesh_configs("flagship")
    src = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), MESH_OPT_SCHEDULE, dev, seed=9)
    ckpt = build_ckpt(src.state.field_params, src.state.occ_grid, [],
                      WorldCube(scale_factor=12.0, shift=np.zeros(3)), 40)
    del src
    alone = mesh_optimizer_run(dev, None, ckpt)
    for label, spec in (("nccl 1 rank", nccl), ("gloo 2 ranks", gloo)):
        t0 = time.perf_counter()
        reset_counts()
        res = mesh_optimizer_run(dev, spec, ckpt)
        torch.cuda.synchronize()
        counts = read_counts()
        diffs = mesh_diffs(res["outputs"], alone["outputs"], alone["before"])
        bits = all(d["equal"] for d in diffs.values())
        readings[f"Optimizer {label}"] = diffs
        print(f"mesh Optimizer: {label} ({spec.backend}), warm_up, window, restore, window, "
              f"close in {time.perf_counter() - t0:.3f} s; against no mesh: equal bits {bits}, "
              f"{describe_diffs(diffs)}; late captures {res['late']}; launches on rank 0 "
              f"{counts}", flush=True)
        launches[f"mesh Optimizer {label}"] = counts
        if spec.size == 1 and not bits:
            failures.append(f"Optimizer {label}: differs from no mesh in "
                            f"{[k for k, d in diffs.items() if not d['equal']]}")
        if spec.size > 1:
            failures += gate_failures(f"Optimizer {label}", diffs)
        if res["late"] or min(counts["fourier_mlp_fwd"], counts["fourier_mlp_bwd"]) < 2 * MESH_ITERS:
            failures.append(f"Optimizer {label}: late captures {res['late']}, launches {counts}")
    if failures:
        raise RuntimeError("mesh: " + "; ".join(failures))
    return {"launches": launches, "readings": readings}


def topology() -> str:
    """Every card's name and power limit, ``nvidia-smi topo -m`` and ``nvlink
    --status`` (or why they failed), and which cards can reach each other's
    memory."""
    out = []
    for args in (["--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                 ["topo", "-m"], ["nvlink", "--status"]):
        try:
            run = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                                 timeout=60)
            out.append(f"nvidia-smi {' '.join(args)} (rc {run.returncode}):\n"
                       + (run.stdout + run.stderr).strip())
        except (OSError, subprocess.SubprocessError) as e:
            out.append(f"nvidia-smi {' '.join(args)} failed: {e}")
    n = torch.cuda.device_count()
    return "\n".join(out) + "\npeer access: " + " ".join(
        f"{i}->{j} {int(torch.cuda.can_device_access_peer(i, j))}"
        for i in range(n) for j in range(n) if i != j)


def mesh_iterations(dev) -> tuple:
    """Four cards, (c): the W=8 phase through the graphs on 1 card (no mesh), 2
    and 4 NCCL ranks and [2, 2]: both configurations timed (ms an iteration,
    the device ms traced and NCCL's kernels in it, the gradient all-reduce's ms
    alone), and the flagship also in f32 (held to MESH_TOL) and with the planted
    fault (which MESH_GATE must refuse); the outputs against one card, the
    flagship's bf16 gated. Each mesh's teardown prints every rank's seconds.
    Returns (record, failures)."""
    from loner_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    timed = [{"config": c, "graphs": True, "timed": MESH_TIMED} for c in ("flagship", "reference")]
    checks = [{"config": "flagship", "graphs": True, "f32": True},
              {"config": "flagship", "graphs": True, "fault": True}]
    ones = {"flagship": mesh_phase(None, dev=dev, **timed[0]),
            "reference": mesh_phase(None, dev=dev, **timed[1]),
            "flagship f32": mesh_phase(None, dev=dev, **checks[0])}
    record, failures = {}, []
    for config in ("flagship", "reference"):
        one = ones[config]
        record[f"{config} 1 card"] = {k: one[k] for k in ("ms", "device_ms", "allreduce_numel")}
        print(f"mesh {config}: 1 card, no mesh: {one['ms']:.3f} ms an iteration through the "
              f"graphs ({MESH_TIMED} iterations), device {one['device_ms']:.3f} ms traced",
              flush=True)
    for label, spec in (("2 ranks", make_mesh(2, dev)), ("4 ranks", make_mesh(4, dev)),
                        ("[2, 2]", make_mesh_2d(2, 2, dev))):
        jobs = timed + checks
        t0 = time.perf_counter()
        results = run_mesh_jobs(spec, jobs)
        print(f"mesh {label}: {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s with the spawn "
              "and the teardown", flush=True)
        for job, res in zip(jobs, results):
            name = job["config"] + (" f32" if job.get("f32") else "") + (
                " planted fault" if job.get("fault") else "")
            one = ones[job["config"] + (" f32" if job.get("f32") else "")]
            diffs = mesh_diffs(res["outputs"], one["outputs"], one["before"])
            rec = {"counts": res["counts"], "diffs": diffs}
            line = f"mesh {name}: {label} ({spec.backend})"
            if "ms" in res:
                rec.update({k: res[k] for k in ("ms", "device_ms", "nccl_ms", "allreduce_ms",
                                                "allreduce_numel")})
                line += (f": {res['ms']:.3f} ms an iteration through the graphs (1 card "
                         f"{one['ms']:.3f}); traced on rank 0: device {res['device_ms']:.3f} ms, "
                         f"NCCL kernels {res['nccl_ms']:.4f} ms; gradient all-reduce of "
                         f"{res['allreduce_numel']} floats {res['allreduce_ms']:.4f} ms alone")
            print(f"{line}; against one card: {describe_diffs(diffs)}; launches on rank 0 "
                  f"{res['counts']}", flush=True)
            record[f"{name} {label}"] = rec
        fault = record.get(f"flagship planted fault {label}")
        failures += gate_failures(f"flagship {label}", record[f"flagship {label}"]["diffs"],
                                  fault["diffs"] if fault else None)
        f32 = record.get(f"flagship f32 {label}")
        if f32 and not all(d["cpu_tol"] for d in f32["diffs"].values()):
            failures.append(f"flagship f32 {label}: beyond the CPU tests' tolerances")
    return record, failures


def run_child(args: list, seconds: float, log_path: Optional[str] = None, **kwargs) -> dict:
    """``args`` as a child process in a process group of its own, its output read
    line by line with the time each arrived; at ``seconds`` every process of the
    group is killed. Returns rc (None if killed), the lines and their times
    (seconds from the start); the whole output goes to ``log_path`` if given."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            process_group=0, **kwargs)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        rc = None
    try:  # what the child left in its group (a mesh's followers, if it failed)
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    reader.join(timeout=10)
    if log_path is not None:
        with open(log_path, "w") as f:
            f.write("\n".join(f"[{t:9.3f}] {line}" for t, line in lines) + "\n")
    return {"rc": rc, "lines": lines, "s": time.perf_counter() - t0}


def nccl_comms(lines) -> dict:
    """Every NCCL communicator in NCCL_DEBUG=INFO output, by (process, comm):
    its rank, ranks, and whether its init and its destroy completed."""
    import re

    comms = {}
    pattern = re.compile(r":(\d+):\d+ \[\d+\] NCCL INFO (?:ncclCommInitRankConfig )?comm "
                         r"(0x[0-9a-f]+) rank (\d+) nranks (\d+).* - (Init|Destroy) COMPLETE")
    for _, line in lines:
        m = pattern.search(line)
        if m:
            c = comms.setdefault((m.group(1), m.group(2)), {"rank": int(m.group(3)),
                                                            "nranks": int(m.group(4))})
            c[m.group(5).lower()] = True
    return comms


def late_captures() -> int:
    """The mapper's captures after warm-up so far in this process (the port's
    counter ``captures.late``); a run's are the difference over it."""
    from loner_tpu_torch.runtime import profiling

    return profiling.counters()["captures.late"]


def slam_log_numbers(log_dir: str, ts: np.ndarray) -> dict:
    """A SLAM run's numbers from its log directory: RTF, ms a mapping iteration
    (the W=1 or bootstrap keyframe, the windows), tracking latency p50 / p95 (the
    tracker's ``tracker.frame`` spans in ``spans.json``: one scan's update
    without the throttle's wait) and the ATE RMSE of both trajectories."""
    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
    from loner_tpu_torch.runtime.profiling import read_spans

    runtime = float(open(os.path.join(log_dir, "runtime.txt")).read().split()[1])
    timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
    track = np.array([[e["dur"] / 1e6, e["args"]["frames"]]
                      for e in read_spans(os.path.join(log_dir, "spans.json"), "tracker.frame")])
    ate = {name: evaluate_trajectory_files(
        os.path.join(log_dir, "trajectory", f"{name}.txt"),
        os.path.join(log_dir, "trajectory", "groundtruth.txt"), delta_m=1.0)["ate"]["rmse"]
        for name in ("estimated_trajectory", "tracking_only")}
    seq_s = float(ts[-1] - ts[0]) + 0.1
    return {"rtf": seq_s / runtime, "runtime_s": runtime, "seq_s": seq_s,
            "keyframes": len(timing), "iterations": int(timing[:, 0].sum()),
            "boot_ms": 1e3 * timing[0, 1] / timing[0, 0],
            "win_ms": 1e3 * timing[1:, 1].sum() / max(timing[1:, 0].sum(), 1),
            "track_updates": len(track), "track_p50_ms": 1e3 * float(np.median(track[:, 0])),
            "track_p95_ms": 1e3 * float(np.quantile(track[:, 0], 0.95)), "ate": ate}


def mesh_slam_cli(dev, root: str, sequence: dict, label: str, mesh_devices, icp_device,
                  log_dir: Optional[str] = None) -> dict:
    """``python -m loner_tpu_torch.run_loner`` on ``sequence`` at the flagship's
    settings with ``system.mesh_devices`` (and ``tracker.icp.device``), a child
    process under NCCL_DEBUG=INFO with MESH_SLAM_SECONDS: rc 0, every NCCL
    communicator it made destroyed, each rank's teardown seconds (the mesh's
    "Mesh teardown" line) and the seconds from "Mapping Done." to the exit, and
    the run's numbers (ATE gated at ATE_MAX). Raises on any miss."""
    from loner_tpu_torch.common.json_yaml import write_json_yaml

    out = os.path.join(root, label.replace(" ", "_"))
    os.makedirs(out, exist_ok=True)
    settings = flagship_slam_settings(os.path.join(out, "outputs"))
    settings["system"]["mesh_devices"] = mesh_devices
    if icp_device is not None:
        settings["tracker"]["icp"]["device"] = icp_device
    config = os.path.join(out, "config.yaml")
    write_json_yaml(config, settings)
    env = dict(os.environ, NCCL_DEBUG="INFO",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    run = run_child([sys.executable, "-m", "loner_tpu_torch.run_loner", sequence["dataset"],
                     config, "--experiment_name", f"smoke_{label.replace(' ', '_')}",
                     "--device", str(dev)], MESH_SLAM_SECONDS,
                    None if log_dir is None else os.path.join(log_dir, f"mesh_slam_{label.replace(' ', '_')}.log"),
                    cwd=out, env=env)
    lines = run["lines"]
    mapped = [t for t, line in lines if line.strip() == "Mapping Done."]
    teardown = [json.loads(line.split(": ", 1)[1]) for _, line in lines
                if line.startswith("Mesh teardown, ")]
    comms = nccl_comms(lines)
    undestroyed = sorted((c["rank"], c["nranks"]) for c in comms.values() if not c.get("destroy"))
    res = {"rc": run["rc"], "wall_s": run["s"], "comms": len(comms), "undestroyed": undestroyed,
           "teardown": teardown[-1] if teardown else None,
           "exit_after_mapping_s": run["s"] - mapped[-1] if mapped else None}
    print(f"SLAM flagship {label} (run_loner, mesh_devices {mesh_devices}, icp.device "
          f"{icp_device}): rc {run['rc']} in {run['s']:.1f} s; NCCL communicators {len(comms)}, "
          f"not destroyed {undestroyed}; 'Mapping Done.' to the exit "
          + (f"{res['exit_after_mapping_s']:.3f} s" if mapped else "never mapped")
          + "; teardown s per rank "
          + (", ".join(f"{r}: {t['total']:.3f}" for r, t in res["teardown"].items()
                       if r.isdigit() and t) + f"; close {res['teardown']['close']:.3f}"
             if res["teardown"] else "not reported"), flush=True)
    if run["rc"] != 0 or undestroyed or not comms or res["teardown"] is None:
        raise RuntimeError(f"SLAM {label}: rc {run['rc']}, undestroyed {undestroyed}; last lines:\n"
                           + "\n".join(line for _, line in lines[-40:]))
    log_line = [line for _, line in lines if line.startswith("Finished. Logs in ")][-1]
    res.update(slam_log_numbers(log_line.split("Finished. Logs in ", 1)[1], sequence["ts"]))
    print(f"SLAM flagship {label}: RTF {res['rtf']:.4f}, ms per mapping iteration W=8 "
          f"{res['win_ms']:.3f} (first keyframe {res['boot_ms']:.3f}), tracking p50 "
          f"{res['track_p50_ms']:.3f} / p95 {res['track_p95_ms']:.3f} ms, ATE estimated "
          f"{res['ate']['estimated_trajectory']:.4f} m, tracking only "
          f"{res['ate']['tracking_only']:.4f} m (bound {ATE_MAX})", flush=True)
    if not all(v < ATE_MAX for v in res["ate"].values()):
        raise RuntimeError(f"SLAM {label}: ATE above {ATE_MAX} m: {res['ate']}")
    return res


def mesh_slam(dev, root: str, sequence: dict, log_dir: Optional[str] = None) -> tuple:
    """Four cards, (a): threaded SLAM at the flagship's settings on ``sequence`` on
    one card (run_slam's checks, ATE gated), then each of MESH_SLAM through
    run_loner's command line (``mesh_slam_cli``). Returns (record, failures)."""
    import traceback

    record, failures = {}, []
    t0 = time.perf_counter()
    slam = run_slam(dev, "flagship 1card", flagship_slam_settings(""), sequence,
                    os.path.join(root, "1card"), ("fourier_mlp_fwd", "fourier_mlp_bwd"),
                    ("composite", "fourier_mlp_fwd"), "pallas")
    record["1 card"] = {k: slam[k] for k in ("rtf", "boot_ms", "win_ms", "track_p50_ms",
                                             "track_p95_ms", "ate", "graphs", "counts")}
    print(f"SLAM flagship 1card: {time.perf_counter() - t0:.1f} s with its checks", flush=True)
    for label, mesh_devices, icp_device in MESH_SLAM:
        try:
            record[label] = mesh_slam_cli(dev, root, sequence, label, mesh_devices, icp_device,
                                          log_dir)
        except Exception as e:  # the other runs still run; raised at the end
            traceback.print_exc()
            failures.append(f"SLAM {label}: {str(e)[:3000]}")
    return record, failures


def follower_death_rank0() -> None:
    """Rank 0 of the follower-death stage, as a process of its own (``python -c``):
    the Optimizer on four NCCL ranks joined with MESH_DEATH's timeout, warmed
    up, then one W=8 window of MESH_DEATH["iterations"]; a thread kills rank
    MESH_DEATH["rank"] MESH_DEATH["after_s"] into it. Prints one JSON line
    "follower death: {...}": the error rank 0 raised, the seconds from the kill
    to the raise, the followers' pids and what ``close`` then did."""
    import signal
    import threading
    from datetime import timedelta

    from loner_tpu_torch.mapping.optimizer import Optimizer, serve_replica
    from loner_tpu_torch.parallel.mesh import launch, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg, field_cfg = mesh_configs("flagship")
    schedule = [{"num_keyframes": -1, "iteration_schedule": [
        {"num_iterations": MESH_DEATH["iterations"], "freeze_poses": False,
         "freeze_sigma_mlp": False}]}]
    replica = dict(cfg=cfg, field_cfg=field_cfg, world_scale=12.0,
                   world_shift=np.zeros(3, np.float32), keyframe_schedule=schedule,
                   skip_pose_refinement=False, use_gt_poses=False, freeze_poses=False, seed=5,
                   camera_rays=None)
    mesh = launch(make_mesh(4, dev), serve_replica, (replica,),
                  timeout=timedelta(seconds=MESH_DEATH["timeout_s"]))
    opt = Optimizer(cfg, field_cfg, 12.0, np.zeros(3), schedule, dev, seed=5,
                    skip_pose_refinement=False, mesh=mesh)
    opt.warm_up(MESH_SCAN_POINTS)
    pids = [p.pid for p in mesh._processes]
    victim = mesh._processes[MESH_DEATH["rank"] - 1]
    killed = {}

    def kill():
        time.sleep(MESH_DEATH["after_s"])
        killed["at"] = time.monotonic()
        os.kill(victim.pid, signal.SIGKILL)

    threading.Thread(target=kill, daemon=True).start()
    t0 = time.monotonic()
    error = None
    try:
        opt.iterate_optimizer(mesh_keyframes(WINDOW))
    except Exception as e:  # what rank 0 raised is the stage's result
        error = f"{type(e).__name__}: {e}"
    raised = time.monotonic()
    t1 = time.perf_counter()
    close_error = None
    try:
        opt.close()
    except Exception as e:  # reported, and failed by the stage
        close_error = f"{type(e).__name__}: {e}"
    print("follower death: " + json.dumps({
        "error": error, "phase_s": raised - t0,
        "kill_to_raise_s": raised - killed["at"] if "at" in killed else None,
        "close_s": time.perf_counter() - t1, "close_error": close_error, "pids": pids,
        "exitcodes": [p.exitcode for p in mesh._processes]}), flush=True)


def mesh_follower_death(log_dir: Optional[str] = None) -> tuple:
    """Four cards, (d): ``follower_death_rank0`` as a child process; then no process
    of it may be left and no card may hold more memory than before it
    (``torch.cuda.mem_get_info`` of each card, within MESH_LEFT_BYTES). Returns
    (record, failures)."""
    n = torch.cuda.device_count()
    used = lambda: [(lambda f, t: t - f)(*torch.cuda.mem_get_info(i)) for i in range(n)]  # noqa: E731
    before = used()
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            "chip_smoke.follower_death_rank0()")
    run = run_child([sys.executable, "-c", code], MESH_DEATH_SECONDS,
                    None if log_dir is None else os.path.join(log_dir, "mesh_death.log"),
                    cwd=REPO, env=dict(os.environ, NCCL_DEBUG="WARN"))
    time.sleep(2.0)  # a killed process's card memory is freed as it is reaped
    after = used()
    lines = [line for _, line in run["lines"] if line.startswith("follower death: ")]
    res = json.loads(lines[-1].split(": ", 1)[1]) if lines else {}
    alive = []
    for pid in res.get("pids", []):
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    res.update({"rc": run["rc"], "wall_s": run["s"], "alive": alive,
                "left_bytes": [a - b for a, b in zip(after, before)]})
    bound = MESH_DEATH["timeout_s"] + MESH_DEATH["margin_s"]
    print(f"mesh follower death: rank {MESH_DEATH['rank']} of 4 NCCL ranks killed "
          f"{MESH_DEATH['after_s']} s into a W={WINDOW} phase; rank 0 raised "
          f"{res.get('error')!r} {res.get('kill_to_raise_s')} s after the kill (bound {bound} s: "
          f"the collective timeout {MESH_DEATH['timeout_s']} s + {MESH_DEATH['margin_s']} s); "
          f"close {res.get('close_s')} s ({res.get('close_error')}); child rc {run['rc']} in "
          f"{run['s']:.1f} s; followers left alive {alive}; card memory left "
          f"{res['left_bytes']} bytes", flush=True)
    failures = []
    named = f"rank {MESH_DEATH['rank']} exited"
    if (run["rc"] != 0 or res.get("error") is None or named not in res["error"]
            or res.get("kill_to_raise_s") is None or res["kill_to_raise_s"] > bound
            or res.get("close_error") or alive
            or any(b > MESH_LEFT_BYTES for b in res["left_bytes"])):
        failures.append("follower death: " + json.dumps(res)[:2000] + "\n" + "\n".join(
            line for _, line in run["lines"][-30:]))
    return res, failures


def mesh_pools(dev, root: str, sequence: dict) -> tuple:
    """Four cards, (b): ``run_loner --num_repeats 4 --trial_workers 4 --gpu_ids 0 1
    2 3`` on POOL_SECONDS of ``sequence`` (each child's wall), then
    ``render_flythrough`` of a 4-iteration slice's field over every card.
    Returns (record, failures)."""
    from loner_tpu_torch.analysis.renderer import render_flythrough

    record, failures = {}, []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    pool = subprocess.run(
        [sys.executable, "-m", "loner_tpu_torch.run_loner", sequence["dataset"],
         os.path.join(REPO, POOL_CONFIG), "--num_repeats", "4", "--trial_workers", "4",
         "--gpu_ids", "0", "1", "2", "3", "--duration", str(POOL_SECONDS),
         "--experiment_name", "pool4", "--device", str(dev)],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    walls = [line for line in pool.stdout.splitlines()
             if line.startswith("trial ") and "rc=" in line]
    record["trial pool"] = {"rc": pool.returncode, "s": time.perf_counter() - t0, "children": walls}
    print(f"trial pool on 4 cards: rc {pool.returncode} in {record['trial pool']['s']:.3f} s; "
          + "; ".join(walls), flush=True)
    if pool.returncode != 0 or len(walls) != 4 or not all("rc=0" in w for w in walls):
        failures.append("trial pool: " + pool.stdout[-1500:] + pool.stderr[-1500:])
    cfg, field_cfg = flagship_configs()
    _, field, prop = run_slice(dev, cfg, field_cfg, n_iters=4)
    exp = os.path.join(root, "experiment")
    write_experiment(exp, field, prop, field_cfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fly_dir = render_flythrough(exp, width=FRAME[0], height=FRAME[1], device=dev, **FLYTHROUGH)
    fly_s = time.perf_counter() - t0
    frames = open(os.path.join(fly_dir, "frames.txt")).read().split()
    record["flythrough"] = {"frames": len(frames), "s": fly_s, "counts": read_counts()}
    print(f"render_flythrough over {torch.cuda.device_count()} cards: {len(frames)} frames "
          f"of {FRAME[0]} x {FRAME[1]} x 512 samples in {fly_s:.3f} s "
          f"({len(frames) / fly_s:.3f} frames/s), launches {record['flythrough']['counts']}",
          flush=True)
    if len(frames) != 12:
        failures.append(f"render_flythrough: {len(frames)} frames")
    return record, failures


def run_mesh_cards(dev, slam_scans: int = SLAM_SCANS,
                   stages=("slam", "pools", "iterations", "death"),
                   log_dir: Optional[str] = None) -> dict:
    """The mesh on four cards: the topology, then of ``stages`` ``mesh_slam``,
    ``mesh_pools``, ``mesh_iterations`` and ``mesh_follower_death``, in that
    order; the children's whole output goes under ``log_dir`` if given. Every
    stage runs; the record is printed as one JSON line and the stages' failures
    are raised at the end."""
    import tempfile
    import traceback

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"run_mesh_cards needs 4 cards, found {torch.cuda.device_count()}")
    print("topology:\n" + topology(), flush=True)
    record, failures = {}, []

    def stage(name: str, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # the later stages still run; raised at the end
            traceback.print_exc()
            failures.append(f"{name}: {e}")
            return None
        finally:
            print(f"mesh cards: stage {name} {time.perf_counter() - t0:.1f} s", flush=True)
        record[name], more = out
        failures.extend(more)
        return out

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_mesh_") as root:
        if "slam" in stages or "pools" in stages:
            sequence = write_slam_dataset(os.path.join(root, "dataset"), slam_scans)
        if "slam" in stages:
            stage("slam", lambda: mesh_slam(dev, root, sequence, log_dir))
        if "pools" in stages:
            stage("pools", lambda: mesh_pools(dev, root, sequence))
    if "iterations" in stages:
        stage("iterations", lambda: mesh_iterations(dev))
    if "death" in stages:
        stage("death", lambda: mesh_follower_death(log_dir))
    print(json.dumps({"mesh_cards": record}, default=str), flush=True)
    if failures:
        raise RuntimeError("mesh on four cards: " + "; ".join(failures))
    return record


# Phase 23: two single-threaded runs of run_loner on the first REPEAT_SECONDS of
# phase 9's sequence (its first 60 scans), for the reference and the flagship
# configurations, all four child processes at once on the card, beside phase 19's
# bag: final poses, trajectories and checkpoint tensors equal to the bit
# between a configuration's two runs (the hash tables' and the OGM grid's
# gradients are fixed-point sums).
REPEAT_SECONDS = 5.95  # scans are 0.1 s apart: the 60 with start time - first's <= 5.95
REPEAT_CHILD_SECONDS = 420


def _tree_arrays(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_arrays(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_arrays(v, prefix + (str(i),))
    elif isinstance(tree, (torch.Tensor, np.ndarray, float, int)):
        yield "/".join(prefix), np.asarray(tree)


def start_repeat(dev, root: str) -> dict:
    """Phase 23's dataset (phase 9's sequence, without its GT map) in ``root`` and
    its four ``run_loner`` children, started; ``finish_repeat`` joins them."""
    import threading

    from loner_tpu_torch.common.json_yaml import write_json_yaml

    sequence = write_slam_dataset(os.path.join(root, "dataset"), gt_map=False)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    runs, threads = {}, []
    for config, settings_of in (("reference", box_room_settings),
                                ("flagship", flagship_slam_settings)):
        for i in (0, 1):
            out = os.path.join(root, f"repeat_{config}_{i}")
            os.makedirs(out, exist_ok=True)
            settings = settings_of(os.path.join(out, "outputs"))
            settings["system"]["single_threaded"] = True
            write_json_yaml(os.path.join(out, "config.yaml"), settings)
            args = [sys.executable, "-m", "loner_tpu_torch.run_loner", sequence["dataset"],
                    os.path.join(out, "config.yaml"), "--experiment_name",
                    f"repeat_{config}_{i}", "--duration", str(REPEAT_SECONDS), "--device",
                    str(dev)]

            def one(key=(config, i), args=args, out=out):
                runs[key] = run_child(args, REPEAT_CHILD_SECONDS, cwd=out, env=env)

            threads.append(threading.Thread(target=one))
            threads[-1].start()
    return {"sequence": sequence, "runs": runs, "threads": threads, "t0": time.perf_counter()}


def finish_repeat(started: dict) -> dict:
    """Phase 23 (see REPEAT_SECONDS), after ``start_repeat``: returns, by
    configuration, the runs' walls, keyframes and RTF, and each compared file or
    tensor's equality; raises if a run failed or any of them differ."""
    from loner_tpu_torch.mapping.mapper import load_checkpoint

    for t in started["threads"]:
        t.join()
    runs, sequence = started["runs"], started["sequence"]
    print(f"repeat: the four runs ended {time.perf_counter() - started['t0']:.1f} s after they "
          "started", flush=True)
    failures, res = [], {}
    for config in ("reference", "flagship"):
        logs = []
        for i in (0, 1):
            run = runs[(config, i)]
            done = [line for _, line in run["lines"] if line.startswith("Finished. Logs in ")]
            if run["rc"] != 0 or not done:
                raise RuntimeError(f"repeat {config} run {i}: rc {run['rc']}; last lines:\n"
                                   + "\n".join(line for _, line in run["lines"][-30:]))
            logs.append(done[-1].split("Finished. Logs in ", 1)[1])
        equal = {}
        for name in sorted(os.listdir(os.path.join(logs[0], "trajectory"))):
            a, b = (np.loadtxt(os.path.join(d, "trajectory", name), ndmin=2) for d in logs)
            equal[f"trajectory/{name}"] = a.shape == b.shape and bool(np.array_equal(a, b))
        tensors = [dict(_tree_arrays(load_checkpoint(os.path.join(d, "checkpoints", "final.tar"))))
                   for d in logs]
        if tensors[0].keys() != tensors[1].keys():
            failures.append(f"{config}: the checkpoints hold other tensors")
        differ = [k for k in tensors[0] if k in tensors[1] and not (
            tensors[0][k].shape == tensors[1][k].shape
            and np.array_equal(tensors[0][k], tensors[1][k], equal_nan=True))]
        equal["final.tar tensors"] = not differ
        numbers = [slam_log_numbers(d, sequence["ts"][sequence["ts"] - sequence["ts"][0]
                                                       <= REPEAT_SECONDS]) for d in logs]
        res[config] = {"equal": equal, "tensors": len(tensors[0]), "differ": differ[:10],
                       "walls_s": [runs[(config, i)]["s"] for i in (0, 1)],
                       "keyframes": [n["keyframes"] for n in numbers],
                       "rtf": [n["rtf"] for n in numbers]}
        print(f"repeat {config}: two single-threaded run_loner runs of {REPEAT_SECONDS} s "
              f"({numbers[0]['keyframes']} / {numbers[1]['keyframes']} keyframes, walls "
              + ", ".join(f"{w:.1f}" for w in res[config]["walls_s"]) + " s, RTF "
              + ", ".join(f"{r:.4f}" for r in res[config]["rtf"]) + f"); {len(tensors[0])} "
              f"checkpoint tensors, {len(differ)} differ {differ[:10]}; equal bits "
              + ", ".join(f"{k} {v}" for k, v in equal.items()), flush=True)
        if not all(equal.values()):
            failures.append(f"{config}: {[k for k, v in equal.items() if not v]} differ")
    if failures:
        raise RuntimeError("repeat: " + "; ".join(failures))
    return res


# Phase 22 (a): the field options no config in cfg/ sets, whose paths are plain
# PyTorch (models/field.py): each on the card against the same code on the CPU,
# at the widths and the tolerances of the CPU tests that hold them to the JAX
# package (tests/test_torch_field_options.py: over each array's largest
# magnitude, bf16 forward 1e-3, gradients 8e-3, bias gradients under mlp_grad:
# xla 4e-2), on FIELD_OPTION_POINTS points.
FIELD_OPTION_POINTS = 8192
FIELD_OPTION_TOL = {"forward": 1e-3, "gradients": 8e-3, "xla biases": 4e-2}
FIELD_OPTIONS = (  # (label, sigma encoding, options)
    ("Fourier sigma head, encode_impl xla", "fourier", {"encode_impl": "xla"}),
    ("Fourier sigma head, mlp_grad xla", "fourier", {"mlp_grad": "xla"}),
    ("Fourier sigma head without its input features", "fourier", {"include_input": False}),
    ("hash sigma head in bf16, mlp_grad vjp", "hash", {}),
    ("hash sigma head in bf16, mlp_grad xla", "hash", {"mlp_grad": "xla"}),
    ("Fourier intensity head, encode_impl xla and mlp_grad xla", "fourier",
     {"intensity_encode_impl": "xla", "mlp_grad": "xla"}),
)


def field_option_settings(encoding: str, **opts) -> dict:
    """A bf16 nerf config dict at the CPU test's widths (Fourier sigma head F 8,
    32 x 2; hash 4 levels at 2^10; Fourier intensity head F 12, 16 x 2)."""
    cfg = {
        "encoding_sigma": encoding, "compute_dtype": "bfloat16",
        "sigma_network": {"n_neurons": 32, "n_hidden_layers": 2},
        "intensity_network": {"n_neurons": 16, "n_hidden_layers": 2},
        "pos_encoding_sigma": {"n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 4},
        "pos_encoding_intensity": {"n_levels": 2, "log2_hashmap_size": 10,
                                   "base_resolution": 4},
        "dir_encoding_intensity": {"degree": 2},
        "fourier_sigma": {"n_freqs": 8, "scale": 3.0,
                          "include_input": opts.pop("include_input", True),
                          "encode_impl": opts.pop("encode_impl", "vjp")},
    }
    if "intensity_encode_impl" in opts:
        cfg["encoding_intensity"] = "fourier"
        cfg["fourier_intensity"] = {"n_freqs": 12, "scale": 2.0,
                                    "encode_impl": opts.pop("intensity_encode_impl")}
    cfg.update(opts)
    return cfg


def _field_option_run(nerf: dict, dev, pos: np.ndarray, dirs: np.ndarray, g: np.ndarray,
                      sigma_only: bool) -> dict:
    """query_field's output and the gradients of sum(out * g), as numpy, on ``dev``."""
    from loner_tpu_torch.models.field import FieldConfig, init_field_params, query_field

    cfg = FieldConfig.from_settings(nerf)
    params = init_field_params(torch.Generator().manual_seed(11), cfg, torch.device("cpu"))
    leaves = {f"{head}.{part}.{k}": v.to(dev).requires_grad_(True)
              for head, tree in params.items() for part, sub in tree.items()
              for k, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}
    tree = {head: {part: ({k: leaves[f"{head}.{part}.{k}"] for k in sub}
                          if isinstance(sub, dict) else leaves[f"{head}.{part}."])
                   for part, sub in t.items()} for head, t in params.items()}
    x = torch.tensor(pos, device=dev, requires_grad=True)
    out = query_field(tree, x, torch.tensor(dirs, device=dev), cfg, sigma_only=sigma_only)
    (out * torch.tensor(g, device=dev)).sum().backward()
    res = {"forward": out.detach().cpu().numpy(), "dpos": x.grad.cpu().numpy()}
    res.update({f"d{k}": v.grad.cpu().numpy() for k, v in leaves.items() if v.grad is not None})
    return res, cfg


def check_field_options(dev) -> dict:
    """Phase 22 (a): each of FIELD_OPTIONS on the card against the CPU (one
    thread) at FIELD_OPTION_TOL, FIELD_OPTION_POINTS points from a seed; none
    takes the Fourier kernels (the hash head takes its kernels). Returns each
    check's largest differences and launches; raises on a miss."""
    rng = np.random.default_rng(12)
    pos = rng.uniform(-0.9, 0.9, (FIELD_OPTION_POINTS, 3)).astype(np.float32)
    dirs = rng.normal(size=(FIELD_OPTION_POINTS, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    record, failures = {}, []
    for label, encoding, changes in FIELD_OPTIONS:
        nerf = field_option_settings(encoding, **changes)
        sigma_only = "fourier_intensity" not in nerf
        g = rng.normal(size=(FIELD_OPTION_POINTS, 1 if sigma_only else 4)).astype(np.float32)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_counts()
        card, cfg = _field_option_run(nerf, dev, pos, dirs, g, sigma_only)
        torch.cuda.synchronize()
        counts = read_counts()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the CPU reference in one thread's order, each run alike
        try:
            cpu, _ = _field_option_run(nerf, torch.device("cpu"), pos, dirs, g, sigma_only)
        finally:
            torch.set_num_threads(threads)
        worst = {}
        for key, want in cpu.items():
            tol = FIELD_OPTION_TOL["forward" if key == "forward" else "gradients"]
            if cfg.mlp_grad == "xla" and key.split(".")[-1].startswith("b"):
                tol = FIELD_OPTION_TOL["xla biases"]
            diff = float(np.abs(card[key] - want).max() / max(np.abs(want).max(), 1.0))
            worst[key] = diff
            if not diff <= tol:
                failures.append(f"{label}: {key} {diff:.3e} beyond {tol:g}")
        record[label] = {"largest": worst, "launches": counts, "fused": cfg.fused_fourier}
        print(f"field option on the card against the CPU: {label} ("
              f"{FIELD_OPTION_POINTS} points, fused function {cfg.fused_fourier}): forward "
              f"{worst['forward']:.3e}, gradients up to {max(v for k, v in worst.items() if k != 'forward'):.3e} "
              f"of their scale; launches {counts}; {time.perf_counter() - t0:.2f} s", flush=True)
        if cfg.fused_fourier or counts["fourier_mlp_fwd"] or counts["fourier_mlp_fwd_f32"]:
            failures.append(f"{label}: took the fused function ({counts})")
    if failures:
        raise RuntimeError("field options: " + "; ".join(failures))
    return record


# Phase 22 (b): the robustness drill (loner_tpu_torch/robustness_drill.py) at
# courtyard_tpu_r5f.yaml's full width on the first ROBUSTNESS_SCANS scans of each
# of ROBUSTNESS_RUNS (the phase's one cut: the whole drill, six runs over 1513
# scans, takes a chip call of its own).
ROBUSTNESS_SCANS = 80  # 8 s of the 151 s drive: three keyframes at 3 s
ROBUSTNESS_RUNS = ("static", "actors", "noise_0.15m", "dropout_30pct")
JAX_TPU_ROBUSTNESS = ("the JAX package's TPU drill, the whole drive "
                      "(artifacts/scale_drive_r5/robustness.yaml): static ATE 0.3097 m, "
                      "F 0.5755; actors 0.8024 / 0.2491; noise 0.15 m 1.9474 / 0.0631")


def run_robustness(dev) -> dict:
    """Phase 22 (b): ``robustness_drill``'s datasets (written together), its GT map,
    then each run of ROBUSTNESS_RUNS driven (threaded SLAM at courtyard_tpu_r5f.yaml
    with --precompile) and scored as the module scores it, on the card. Prints
    each row, the launches of its drive and of its scoring; raises unless every
    figure is finite and each drive launched the Fourier pair."""
    import tempfile

    from loner_tpu_torch import robustness_drill as drill

    variants = drill.select([f"{label}={label}_{ROBUSTNESS_SCANS}"
                             for label in ROBUSTNESS_RUNS], ROBUSTNESS_SCANS)
    table, launches, failures = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_robustness_") as root:
        t0 = time.perf_counter()
        data = drill.datasets(variants, root, ROBUSTNESS_SCANS)
        gt = drill.gt_map(root, ROBUSTNESS_SCANS)
        print(f"robustness drill: {len(variants)} datasets of {ROBUSTNESS_SCANS} scans and the "
              f"static GT map in {time.perf_counter() - t0:.2f} s", flush=True)
        for v, path in zip(variants, data):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            reset_counts()
            log_dir = drill.drive(v, path, drill.CONFIG, root, str(dev))
            torch.cuda.synchronize()
            drive_counts = read_counts()
            t1 = time.perf_counter()
            reset_counts()
            row = drill.score(log_dir, path, gt, str(dev))
            torch.cuda.synchronize()
            score_counts = read_counts()
            table[v.label] = row
            launches[f"robustness {v.label}"] = drive_counts
            launches[f"robustness {v.label} scoring"] = score_counts
            print(f"robustness drill {v.label}: {row}; drive {t1 - t0:.2f} s, scoring "
                  f"{time.perf_counter() - t1:.2f} s; launches: drive {drive_counts}, scoring "
                  f"{score_counts}", flush=True)
            if not all(np.isfinite(x) for x in row.values()):
                failures.append(f"{v.label}: {row}")
            if min(drive_counts["fourier_mlp_fwd"], drive_counts["fourier_mlp_bwd"]) < 1:
                failures.append(f"{v.label}: the drive launched {drive_counts}")
    print(f"robustness drill, static ATE {table['static']['ate_rmse_m']} m over "
          f"{ROBUSTNESS_SCANS} scans; {JAX_TPU_ROBUSTNESS}", flush=True)
    if failures:
        raise RuntimeError("robustness drill: " + "; ".join(failures))
    return {"table": table, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from loner_tpu_torch.ops import composite as cp
    from loner_tpu_torch.ops import fourier_mlp as fm
    from loner_tpu_torch.ops import fixed_point
    from loner_tpu_torch.ops import hash_grid as hg
    from loner_tpu_torch.ops.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    clock = {"t": time.perf_counter()}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - clock['t']:.2f} s", flush=True)
        clock["t"] = now

    build_all()
    fm._lib()
    cp._lib()
    hg._lib()
    ptxas_spills()
    sass_counts()
    phase_done("1-2 (device, build)")

    cfg, field_cfg = flagship_configs()
    kernels = check_kernels(dev, field_cfg)
    launches, field, prop = run_slice(dev, cfg, field_cfg)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    composite = check_composite(dev)
    composite["launches"] = run_render(dev, field, prop, field_cfg)
    kernels.append(composite)
    phase_done("3-8 (kernels, slice, composite, render)")
    # Each SLAM path's launches go into the kernels' record: the flagship run's
    # for the Fourier pair and the composite (its map check), the reference
    # configuration's for the hash pair. Both runs share one dataset.
    import tempfile

    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_slam_data_") as data_dir:
        sequence = write_slam_dataset(os.path.join(data_dir, "dataset"))
        slam = run_slam(dev, "flagship", flagship_slam_settings(""), sequence,
                        os.path.join(data_dir, "flagship"), ("fourier_mlp_fwd", "fourier_mlp_bwd"),
                        ("composite", "fourier_mlp_fwd"), "pallas", check_icp=True)
        slam["eval_launches"] = check_map_quality(dev, "flagship", slam["log_dir"], sequence,
                                                  "fourier_mlp_fwd", "pallas", mesh=True)["launches"]
        for k in kernels:
            k["launches"] = {**slam["map_launches"], **slam["launches"]}[k["name"]]
        if slam["counts"]["sigma_mlp_fwd"] or slam["counts"]["sigma_mlp_bwd"]:
            raise RuntimeError(f"the flagship's Fourier field ran the hash head's MLP pair: "
                               f"{slam['counts']}")
        phase_done("9 + 13 (flagship SLAM, map quality)")
        hash_kernels = check_hash_kernels(dev)
        sigma_kernels = check_sigma_mlp_kernels(dev)
        with fixed_point.recording() as readings:
            reference = run_slam(dev, "hash+OGM", box_room_settings(""), sequence,
                                 os.path.join(data_dir, "reference"),
                                 ("hash_encode_fwd", "hash_encode_bwd", "sigma_mlp_fwd",
                                  "sigma_mlp_bwd"), ("hash_encode_fwd",),
                                 "xla", measure_test_chunk=True)
        print_readings(f"SLAM hash+OGM, {SLAM_SCANS} scans", readings)
        reference["eval_launches"] = check_map_quality(
            dev, "hash+OGM", reference["log_dir"], sequence, "hash_encode_fwd", "xla",
            mesh=True)["launches"]
        phase_done("10-11 + 13 (hash and sigma-MLP kernels, reference SLAM, map quality)")
        # Phase 16 on phase 9's sequence.
        resume = run_resume(dev, sequence, slam["ate"])
        phase_done("16 (resume)")
    for k in hash_kernels + sigma_kernels:
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
    kernels += hash_kernels + sigma_kernels
    check_dispatch(dev)
    phase_done("12 (dispatch)")
    # Phase 14: both configurations on the drive, the cell of the bars.
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_drive_") as data_dir:
        drive = write_slam_dataset(os.path.join(data_dir, "dataset"), DRIVE_SCANS)
        slam_drive = run_slam(dev, "flagship drive", flagship_slam_settings(""), drive,
                              os.path.join(data_dir, "flagship"),
                              ("fourier_mlp_fwd", "fourier_mlp_bwd"),
                              ("composite", "fourier_mlp_fwd"), "pallas")
        slam_drive["eval_launches"] = check_map_quality(
            dev, "flagship drive", slam_drive["log_dir"], drive, "fourier_mlp_fwd", "pallas",
            gate_l1=True)["launches"]
        with fixed_point.recording() as readings:
            reference_drive = run_slam(dev, "hash+OGM drive", box_room_settings(""), drive,
                                       os.path.join(data_dir, "reference"),
                                       ("hash_encode_fwd", "hash_encode_bwd", "sigma_mlp_fwd",
                                        "sigma_mlp_bwd"), ("hash_encode_fwd",), "xla")
        print_readings(f"SLAM hash+OGM drive, {DRIVE_SCANS} scans", readings)
        reference_drive["eval_launches"] = check_map_quality(
            dev, "hash+OGM drive", reference_drive["log_dir"], drive, "hash_encode_fwd", "xla",
            gate_l1=True)["launches"]
    phase_done("14 (the drive)")
    # Phase 15: sky rays, the slice at the Fourier pair's sky call size, then SLAM.
    sky_kernels = check_kernels(dev, field_cfg, n=WINDOW * (512 + SKY_RAYS) * 512, label="sky",
                                bootstrap=False)
    sky_slice = check_sky_slice(dev, cfg, field_cfg)
    torch.cuda.empty_cache()
    sky_short = run_sky_ab(dev, SLAM_SCANS, gated=False)
    sky = run_sky_ab(dev, DRIVE_SCANS, gated=True)
    phase_done("15 (sky rays)")
    courtyard = run_courtyard(dev, field_cfg)
    phase_done("17 (courtyard)")
    camera = run_camera(dev, field_cfg)
    phase_done("18 (camera)")
    # Phase 23's four SLAM children run beside the drill's bag, which one host core
    # writes and converts (the repeat checks bits, not time).
    with tempfile.TemporaryDirectory(prefix="loner_tpu_torch_repeat_") as repeat_dir:
        started = start_repeat(dev, repeat_dir)
        drill = run_drill(dev, slam)
        finish_repeat(started)
    phase_done("19 + 23 (real-data drill; the two-run repeat beside its bag)")
    breadth = run_breadth(dev, cfg, field_cfg, field, prop)
    phase_done("20 (run breadth)")
    mesh = run_mesh(dev)
    phase_done("21 (mesh)")
    options = check_field_options(dev)
    robustness = run_robustness(dev)
    phase_done("22 (field options, robustness drill)")
    # The f32 pair's record: checked at box_room_camera's render chunk, launched on
    # its SLAM path.
    f32_kernels = camera["kernels"]["fourier_f32_render"]
    for k in f32_kernels:
        k["launches"] = camera["runs"]["camera hash"]["counts"][k["name"]]
        k["at_shapes"] = {"box_room_camera: 24,576 points, F 32, 3 x 128, f32": {
            key: rec[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}
            for rec in camera["kernels"]["fourier_f32"] if rec["name"] == k["name"]}
    kernels += f32_kernels

    # Phases 13 and 14's launches, per run and step (map cloud, L1, mesh).
    runs = (("flagship", slam), ("reference", reference), ("flagship drive", slam_drive),
            ("reference drive", reference_drive))
    for k in kernels:
        k["eval_launches"] = {name: {step: counts[k["name"]]
                                     for step, counts in run["eval_launches"].items()}
                              for name, run in runs}
    # Phases 15-19's launches by path: the SLAM runs (training and the map check;
    # the drill's under "drill"), the sky slice's 6 iterations, the floater probe;
    # the Fourier pair's checks at the sky and the courtyard call sizes.
    paths = {"sky slice": sky_slice["launches"], "resume": resume["counts"]}
    for name, run in camera["runs"].items():
        paths[f"{name} PSNR"] = camera["runs"][name]["psnr"]["launches"]
    for name, run in (("sky SLAM", sky["sky"]), ("sky off SLAM", sky["sky off"]),
                      ("sky SLAM 150", sky_short["sky"]), ("sky off SLAM 150", sky_short["sky off"]),
                      ("courtyard SLAM", courtyard["slam"]),
                      ("camera r5 SLAM", camera["runs"]["camera r5"]),
                      ("camera hash SLAM", camera["runs"]["camera hash"]), ("drill", drill)):
        paths[name] = {**run["counts"], **{f"{k} (map check)": v
                                           for k, v in run["map_launches"].items()}}
        if "eval_launches" in run:
            paths[name + " eval"] = {step: c for step, c in run["eval_launches"].items()}
    paths.update(breadth)
    paths.update(mesh["launches"])
    paths.update(robustness["launches"])
    paths.update({f"field option: {label}": rec["launches"] for label, rec in options.items()})
    for name in ("sky", "sky off"):
        paths[f"{name} floaters"] = sky[name]["floaters"]["launches"]
        paths[f"{name} floaters 150"] = sky_short[name]["floaters"]["launches"]
    for k in kernels:
        k["launches_by_path"] = {
            path: ({step: c[k["name"]] for step, c in counts.items()} if path.endswith("eval")
                   else {key: v for key, v in counts.items() if key.split(" ")[0] == k["name"]})
            for path, counts in paths.items()}
    for k, at_sky, at_court, at_cam in zip(kernels[:2], sky_kernels, courtyard["kernels"],
                                           camera["kernels"]["fourier"]):
        k["at_shapes"] = {
            label: {key: rec[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
            for label, rec in (("sky: 2,359,296 points, F 48", at_sky),
                               ("courtyard: 2,097,152 points, F 96", at_court),
                               ("camera: 524,288 points, F 48", at_cam))}
    for k in kernels:
        if k["name"] in ("hash_encode_fwd", "hash_encode_bwd"):
            k.setdefault("at_shapes", {}).update(
                {label: rec[k["name"].split("_")[-1]]
                 for label, rec in camera["kernels"]["hash"].items()})

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
