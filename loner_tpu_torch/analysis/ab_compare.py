"""A/B of two checkouts of this repository on one CUDA card, in turns.

    python3 -m loner_tpu_torch.analysis.ab_compare --other <dir> [--iteration] [--slam]
        [--slam-profile] [--no-kernels] [--smoke] [--out <dir>]

``<dir>`` is another checkout (for example a ``git archive`` of the parent commit
unpacked into a directory that ``.gitignore`` lists). Each measurement runs in its
own process with the checkout's directory first on ``sys.path``, so each side
builds and imports its own ``loner_tpu_torch``; the turns are other, this, this,
other, so drift on the card shows as a difference between the two runs of a side.

* Kernels: the Fourier-MLP forward and backward wrappers (``fourier_mlp_fwd_cuda``,
  ``fourier_mlp_bwd_cuda``, whose signatures both sides share) at the flagship
  shapes (F = 48, 99 -> 256 -> 256 -> 1, bf16) and N = 2,097,152 and 262,144
  points: median of 5 by CUDA events after a warm-up, and the kernels' own time
  from ``torch.profiler`` (no host packing). The composite kernel at
  ``COMPOSITE_SHAPES`` (softplus): the kernel alone through the side's C entry
  (``kernel_ms``) and the wrapper ``composite_cuda`` (median of 5 by CUDA
  events), beside the HBM bound. The hash-grid encode (``hash_encode_fwd_cuda``,
  ``hash_encode_bwd_cuda``) at the reference's grid, bf16, at ``SIZES`` points
  in the order a mapping iteration gives them (``hash_points``: rays of 512
  sorted samples) and at random points, by back-to-back calls (``kernel_ms``);
  the backward also without dpos where the side has that variant (else its full
  backward stands in). The OGM step's grid gradient (``occ_grid_grad``) at a W=8
  iteration's 2,097,152 points on the 100^3 grid. One JSON line per run.
* ``--iteration``: ``profile_iteration.profile`` of this checkout, run against
  each side's package, at the reference and the flagship configurations: the W=8
  iteration and the W=1 bootstrap's (frozen poses); at the sky and the camera
  configurations the W=8 iteration; each through the eager loop and, on a side
  that has them, through CUDA graphs (k replays a dispatch).
* ``--slam``: each side's ``chip_smoke.run_slam`` of the reference
  configuration (cfg/synthetic/box_room.yaml) and of the flagship
  (box_room_tpu_rt_r4.yaml), threaded, on one 150-scan box-room sequence that
  this checkout writes once: RTF, ms a mapping iteration, tracking latency, ATE.
* ``--slam-profile``: each side's reference SLAM on that sequence threaded,
  single-threaded, and single-threaded with its W=8 keyframes under
  torch.profiler (``time_slam_profile``): seconds a keyframe, device ms an
  iteration by kernel. ``--no-kernels`` skips the kernel turns.
* ``--smoke``: each side's ``chip_smoke.py``, whole; the logs go to ``--out``.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import re
import subprocess
import sys

SIZES = (2_097_152, 262_144)
# (rays, samples): the kernel table's two shapes, then a virtual scan's render chunk
# and a depth frame's.
COMPOSITE_SHAPES = ((16384, 1024), (16384, 2048), (2048, 1024), (2048, 2048))
PEAK_HBM_BYTES = 3.35e12  # H100 SXM, NVIDIA's data sheet


def composite_bound_ms(b: int, s: int) -> float:
    """z and sigma in, weights out (12 B a sample); far and |d| in, depth, opacity
    and variance out (20 B a ray), over the HBM rate."""
    return 1e3 * (12 * b * s + 20 * b) / PEAK_HBM_BYTES


def kernel_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device ms of one launch of ``fn``: the median over ``reps`` of CUDA events
    around ``n`` back-to-back launches, divided by ``n``. A spin kernel
    (``torch.cuda._sleep``) holds the card while the host enqueues them, so the
    host's time per launch does not show."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(4_000_000)  # ~2 ms at the H100's clock
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def wrapper_ms(fn, reps: int = 5) -> float:
    """Median ms of one call of ``fn`` by CUDA events, after a warm-up."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def composite_inputs(b: int, s: int, dev, seed: int = 21):
    """Sorted z in the flagship's cube-scaled range, raw sigma ~ 3 N(0, 1), far and |d|."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    near, far = 1.0 / 12.0, 10.0 / 12.0
    z = torch.sort(near + (far - near) * torch.rand((b, s), generator=gen, device=dev), dim=1).values
    sigma = 3.0 * torch.randn((b, s), generator=gen, device=dev)
    far_t = torch.full((b,), far, device=dev)
    dnorm = 0.9 + 0.2 * torch.rand((b,), generator=gen, device=dev)
    return z, sigma, far_t, dnorm


def composite_launcher(cp, z, sigma, far, dnorm):
    """A function that launches the side's composite kernel once (softplus) through
    its C entry, into outputs made here; no allocation or operand checks in the call.
    ``cp`` is the side's ``loner_tpu_torch.ops.composite``; a checkout whose wrapper
    has no launch plan (no ``launch``) has the older C entry lt_composite(z, sigma,
    far, dnorm, B, S, softplus, depth, opacity, var, weights, stream)."""
    import torch

    b, s = z.shape
    outs = [torch.empty((b,), device=z.device) for _ in range(3)] + [torch.empty_like(z)]
    if hasattr(cp, "launch"):
        return lambda: cp.launch(z, sigma, far, dnorm, True, *outs)
    lib = cp._lib()
    ins = [ctypes.c_void_p(t.data_ptr()) for t in (z, sigma, far, dnorm)]
    outp = [ctypes.c_void_p(t.data_ptr()) for t in outs]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        if lib.lt_composite(*ins, b, s, 1, *outp, stream) != 0:
            raise RuntimeError("lt_composite failed")
    return run


def time_composite() -> dict:
    """Runs inside a side's process: its composite kernel at COMPOSITE_SHAPES."""
    import torch

    from loner_tpu_torch.ops import composite as cp

    dev = torch.device("cuda", 0)
    out = {}
    for b, s in COMPOSITE_SHAPES:
        z, sigma, far, dnorm = composite_inputs(b, s, dev)
        row = {"bound_ms": composite_bound_ms(b, s),
               "kernel_ms": kernel_ms(composite_launcher(cp, z, sigma, far, dnorm)),
               "wrapper_ms": wrapper_ms(lambda: cp.composite_cuda(z, sigma, far, dnorm, True))}
        out[f"composite_{b}x{s}"] = row
        del z, sigma, far, dnorm
    return out


RAY_SAMPLES = 512  # samples a ray in a mapping iteration (N_samples_train)
RAY_RANGE = (1.0, 10.0)  # metres, cfg/defaults.yaml


def hash_points(n: int, order: str, seed: int = 21):
    """(n, 3) f32 points in the hash encode's [0, 1] coordinates, as numpy.

    ``random``: uniform over [-0.01, 1.01]^3, the first 64 at exactly 0 and the
    next 64 at exactly 1. ``ray``: the order a mapping iteration gives the
    encode, ray-major with each ray's samples sorted along it: rays of
    ``RAY_SAMPLES`` samples from poses of the box room's trajectory in random
    directions, spaced as the OGM sampler spaces them, half stratified over the
    ray range and half within one occupancy voxel (1/100 of the world cube) of
    the wall the ray hits, in the world cube that the SLAM run computes."""
    import numpy as np

    from loner_tpu_torch.common.world_cube import compute_world_cube
    from loner_tpu_torch.datasets.synthetic import BoxRoomScene, make_trajectory

    rng = np.random.default_rng(seed)
    if order == "random":
        pos = rng.uniform(-0.01, 1.01, (n, 3)).astype(np.float32)
        pos[:64], pos[64:128] = 0.0, 1.0
        return pos
    if order != "ray":
        raise ValueError(f"order is 'ray' or 'random', not {order!r}")
    scene = BoxRoomScene()
    poses, _ = make_trajectory(scene, 150)
    cube = compute_world_cube(None, None, None, poses, RAY_RANGE)
    to_slam = np.linalg.inv(poses[0])  # the cube's frame: poses zeroed at the first
    n_rays, half = -(-n // RAY_SAMPLES), RAY_SAMPLES // 2
    o = poses[rng.integers(0, len(poses), n_rays), :3, 3]
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near, far = RAY_RANGE
    hit = np.clip(scene.raycast(o, d), near, far)
    strat = near + (far - near) * (np.arange(half) + rng.uniform(size=(n_rays, half))) / half
    voxel = 2.0 * cube.scale_factor / 100.0
    imp = np.clip(hit[:, None] + voxel * rng.uniform(-1.0, 1.0, (n_rays, half)), near, far)
    z = np.sort(np.concatenate([strat, imp], axis=1), axis=1)
    world = o[:, None, :] + d[:, None, :] * z[..., None]
    slam = world @ to_slam[:3, :3].T + to_slam[:3, 3]
    pos = 0.5 * (cube.to_cube(slam) + 1.0)
    return pos.reshape(-1, 3)[:n].astype(np.float32)


def hash_edge_points() -> dict:
    """Edge cases of the hash kernels' warp-level work, name -> (n, 3) f32 points:
    every lane of every warp on one index; runs of equal points across a warp
    boundary (lanes 16-47) and a block boundary (points 100-163) inside
    ray-ordered points; point counts that are no multiple of 32 or of a block;
    coordinates at exactly 0 and 1, next to them and outside the unit cube."""
    import numpy as np

    runs = hash_points(4096, "ray", seed=3)
    runs[16:48] = runs[16]
    runs[100:164] = runs[100]
    vals = np.array([-0.5, 0.0, 1e-7, 0.5, 1.0 - 6e-8, 1.0, 1.5], np.float32)
    faces = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), axis=-1).reshape(-1, 3)
    return {"one_index": np.tile(np.array([[0.3, 0.6, 0.2]], np.float32), (1000, 1)),
            "runs_across_warps_and_blocks": runs,
            "ragged_4133_random": hash_points(4133, "random", seed=4),
            "ragged_1": hash_points(1, "ray", seed=6), "ragged_31": hash_points(31, "ray", seed=7),
            "ragged_129": hash_points(129, "ray", seed=8), "faces_and_outside": faces}


def time_hash() -> dict:
    """Runs inside a side's process: its hash-grid encode wrappers, bf16, at the
    reference's grid, at both point orders and ``SIZES``."""
    import numpy as np
    import torch

    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
    from loner_tpu_torch.ops import hash_grid as hg

    dev = torch.device("cuda", 0)
    cfg, bf = HashEncodingConfig(), torch.bfloat16
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.uniform(-1e-2, 1e-2, (cfg.total_table_size, 2)).astype(np.float32),
                         device=dev)
    no_dpos = "need_dpos" in inspect.signature(hg.hash_encode_bwd_cuda).parameters
    out = {}
    for order in ("ray", "random"):
        for n in SIZES:
            pos = torch.tensor(hash_points(n, order), device=dev)
            dout = rng.normal(size=(n, cfg.output_dim)) / n ** 0.5
            dout = torch.tensor(dout.astype(np.float32), device=dev)
            row = {"fwd_ms": kernel_ms(lambda: hg.hash_encode_fwd_cuda(table, pos, cfg, bf)),
                   "fwd_f32_ms": kernel_ms(
                       lambda: hg.hash_encode_fwd_cuda(table, pos, cfg, torch.float32)),
                   "bwd_ms": kernel_ms(lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg, bf))}
            row["bwd_no_dpos_ms"] = kernel_ms(
                lambda: hg.hash_encode_bwd_cuda(table, pos, dout, cfg, bf, need_dpos=False)
            ) if no_dpos else row["bwd_ms"]
            row["bwd_no_dpos_variant"] = no_dpos
            out[f"hash_{order}_{n}"] = row
            del pos, dout
    return out


def time_ogm() -> dict:
    """Runs inside a side's process: its ``occ_grid_grad`` at the first of
    ``SIZES`` points on the 100^3 grid."""
    import torch

    from loner_tpu_torch.models.occupancy_grid import occ_grid_grad

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    grid = torch.randn((100, 100, 100), generator=gen, device=dev)
    pts = torch.rand((SIZES[0], 3), generator=gen, device=dev) * 2.0 - 1.0
    g = torch.randn((SIZES[0],), generator=gen, device=dev) * 1e-3
    return {f"ogm_grad_{SIZES[0]}_ms": kernel_ms(lambda: occ_grid_grad(grid, pts, g))}


def time_slam(sequence_path: str, out_dir: str) -> dict:
    """Runs inside a side's process: its ``chip_smoke.run_slam`` of the reference
    and the flagship on the pickled sequence, threaded."""
    import pickle

    import torch

    import chip_smoke
    from loner_tpu_torch.ops.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    with open(sequence_path, "rb") as f:
        sequence = pickle.load(f)
    dev = torch.device("cuda", 0)
    runs = {"reference": (chip_smoke.box_room_settings(""), ("hash_encode_fwd", "hash_encode_bwd"),
                          ("hash_encode_fwd",), "xla"),
            "flagship": (chip_smoke.flagship_slam_settings(""),
                         ("fourier_mlp_fwd", "fourier_mlp_bwd"), ("composite", "fourier_mlp_fwd"),
                         "pallas")}
    out = {}
    for name, (settings, train, mapped, compositor) in runs.items():
        res = chip_smoke.run_slam(dev, name, settings, sequence, os.path.join(out_dir, name),
                                  train, mapped, compositor)
        out[name] = {k: res[k] for k in ("rtf", "win_ms", "boot_ms", "track_p50_ms",
                                         "track_p95_ms", "runtime_s", "ate", "iterations")}
    return out


def time_slam_profile(sequence_path: str, out_dir: str) -> dict:
    """Runs inside a side's process: the reference's SLAM (cfg/synthetic/box_room.yaml)
    on the pickled sequence, threaded, single-threaded, and single-threaded with
    each keyframe after the first (the W=8 windows) under torch.profiler: each run's
    (iterations, seconds) a keyframe (``timing.csv``) and, for the profiled
    keyframes, the device ms an iteration in all and of the ``top`` kernels."""
    import pickle
    import time

    import numpy as np
    import torch

    import chip_smoke
    from loner_tpu_torch import run_loner
    from loner_tpu_torch.analysis.profile_iteration import device_events
    from loner_tpu_torch.mapping.optimizer import Optimizer
    from loner_tpu_torch.ops.build import build_all

    top = 8
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    with open(sequence_path, "rb") as f:
        sequence = pickle.load(f)
    dev = torch.device("cuda", 0)
    profiled = []
    original = Optimizer.iterate_optimizer

    def iterate_profiled(self, window, *args, **kwargs):
        if len(window) == 1:  # the W=1 bootstrap
            return original(self, window, *args, **kwargs)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            loss = original(self, window, *args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict = {}
        for e in device_events(prof):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        profiled.append((wall, by_name))
        return loss

    out = {}
    for run, single, hook in (("threaded", False, False), ("single", True, False),
                              ("single profiled", True, True)):
        settings = chip_smoke.box_room_settings(os.path.join(out_dir, run.replace(" ", "_")))
        settings["system"]["single_threaded"] = single
        Optimizer.iterate_optimizer = iterate_profiled if hook else original
        try:
            log_dir = run_loner.run_trial(settings, sequence["dataset"], device=dev,
                                          experiment_name=run.replace(" ", "_"))
        finally:
            Optimizer.iterate_optimizer = original
        timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
        out[run] = [[int(n), round(float(t), 4)] for n, t in timing]
    its = [int(n) for n, _ in out["single profiled"][1:]]
    out["profiled keyframes"] = [
        {"wall_s": wall, "iterations": n,
         "device_ms_an_iteration": sum(by_name.values()) / n,
         "top_ms_an_iteration": {k: v / n for k, v in sorted(
             by_name.items(), key=lambda kv: -kv[1])[:top]}}
        for (wall, by_name), n in zip(profiled, its)]
    return out


def time_iteration() -> dict:
    """Runs inside a side's process: this checkout's profile_iteration.profile on
    the side's package, both configurations, W=8 and the W=1 bootstrap, through
    the eager loop and, where the side has them, through CUDA graphs."""
    import runpy

    from loner_tpu_torch.mapping.optimizer import make_phase_runner

    here = os.path.dirname(os.path.abspath(__file__))
    prof = runpy.run_path(os.path.join(here, "profile_iteration.py"))["profile"]
    modes = ("eager", "graphs") if "graphs" in inspect.signature(
        make_phase_runner).parameters else ("eager",)
    out = {}
    for config in ("reference", "flagship", "sky", "camera"):
        for name, w, frozen in (("w8", 8, False), ("w1_bootstrap", 1, True)):
            if name != "w8" and config in ("sky", "camera"):
                continue
            for mode in modes:
                out[f"{config}_{name}_{mode}"] = prof(config, w, freeze_poses=frozen,
                                                      graphs=mode == "graphs")
    return out


def time_kernels() -> dict:
    """Runs inside a side's process: that side's wrappers, timed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from loner_tpu_torch.ops import fourier_mlp as fm

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    f, h = 48, 256
    dims = [2 * f + 3, h, h, 1]
    ws = [torch.tensor((rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32), device=dev)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor((rng.normal(size=b) * 0.1).astype(np.float32), device=dev) for b in dims[1:]]
    bmat = torch.tensor((rng.normal(size=(3, f)) * 6.0 * 2 * np.pi).astype(np.float32), device=dev)
    bf = torch.bfloat16
    out = {}
    for n in SIZES:
        pts = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
        dout = torch.tensor((rng.normal(size=(n, 1)) / n ** 0.5).astype(np.float32), device=dev)
        calls = {"fwd": lambda: fm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, bf),
                 "bwd": lambda: fm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, bf)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                m = re.search(r"anonymous namespace\)::(\w+(?:<\d+>)?)\(", e.key)
                if m:
                    kernels[m.group(1)] = kernels.get(m.group(1), 0.0) + e.device_time_total / 3e3
            out[f"{name}_{n}"] = {"ms": float(np.median(times)), "kernels_ms": kernels}
        torch.cuda.synchronize()
        out[f"peak_gb_{n}"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    out.update(time_composite())
    out.update(time_hash())
    out.update(time_ogm())
    return out


def _side(root: str, args: list, log: str = None) -> str:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True,
                          text=True, check=False)
    if log:
        with open(log, "w") as fh:
            fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{args} in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="the other checkout's root")
    parser.add_argument("--iteration", action="store_true",
                        help="also profile the W=8 and W=1 iterations on each side, eager "
                        "and through graphs")
    parser.add_argument("--slam", action="store_true",
                        help="also run each side's reference and flagship SLAM on 150 scans")
    parser.add_argument("--slam-profile", action="store_true",
                        help="also run each side's reference SLAM threaded, single-threaded "
                        "and single-threaded with its W=8 keyframes profiled")
    parser.add_argument("--no-kernels", action="store_true", help="skip the kernel turns")
    parser.add_argument("--smoke", action="store_true", help="also run each side's chip_smoke.py")
    parser.add_argument("--out", default="outputs/ab_compare", help="directory for the smoke logs")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_compare: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    other = os.path.abspath(args.other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    script = os.path.abspath(__file__)
    turns = [("other", other), ("this", here), ("this", here), ("other", other)]
    for i, (name, root) in enumerate([] if args.no_kernels else turns):
        code = (f"import sys; sys.path.insert(0, {root!r}); import json, runpy; "
                f"m = runpy.run_path({script!r}); print(json.dumps(m['time_kernels']()))")
        line = _side(root, ["-c", code]).strip().splitlines()[-1]
        print(json.dumps({"turn": i, "side": name, "kernels": json.loads(line)}), flush=True)
    if args.iteration:
        for i, (name, root) in enumerate(turns):
            code = (f"import sys; sys.path.insert(0, {root!r}); import json, runpy; "
                    f"m = runpy.run_path({script!r}); print(json.dumps(m['time_iteration']()))")
            line = _side(root, ["-c", code]).strip().splitlines()[-1]
            print(json.dumps({"turn": i, "side": name, "iteration": json.loads(line)}), flush=True)
    slam = [(key, fn) for key, fn, on in (("slam", "time_slam", args.slam),
                                          ("slam_profile", "time_slam_profile", args.slam_profile))
            if on]
    if slam:
        import pickle
        import tempfile

        sys.path.insert(0, here)
        import chip_smoke

        with tempfile.TemporaryDirectory(prefix="ab_compare_slam_") as tmp:
            path = os.path.join(tmp, "sequence.pkl")
            with open(path, "wb") as f:
                pickle.dump(chip_smoke.write_slam_dataset(os.path.join(tmp, "dataset")), f)
            for key, fn in slam:
                for i, (name, root) in enumerate(turns):
                    out = os.path.join(tmp, f"{key}_turn_{i}")
                    code = (f"import sys; sys.path.insert(0, {root!r}); import json, runpy; "
                            f"m = runpy.run_path({script!r}); "
                            f"print(json.dumps(m[{fn!r}]({path!r}, {out!r})))")
                    line = _side(root, ["-c", code]).strip().splitlines()[-1]
                    print(json.dumps({"turn": i, "side": name, key: json.loads(line)}),
                          flush=True)
    if args.smoke:
        os.makedirs(args.out, exist_ok=True)
        for i, (name, root) in enumerate(turns):
            log = os.path.join(os.path.abspath(args.out), f"smoke_{i}_{name}.log")
            _side(root, ["chip_smoke.py"], log)
            print(f"smoke turn {i} ({name}): {log}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
