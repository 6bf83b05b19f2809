"""A/B of two checkouts of this repository on one CUDA card, in turns.

    python3 -m loner_tpu_torch.analysis.ab_compare --other <dir> [--smoke] [--out <dir>]

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
  events), beside the HBM bound. One JSON line per run.
* ``--smoke``: each side's ``chip_smoke.py``, whole; the logs go to ``--out``.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
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
    for i, (name, root) in enumerate(turns):
        code = (f"import sys; sys.path.insert(0, {root!r}); import json, runpy; "
                f"m = runpy.run_path({script!r}); print(json.dumps(m['time_kernels']()))")
        line = _side(root, ["-c", code]).strip().splitlines()[-1]
        print(json.dumps({"turn": i, "side": name, "kernels": json.loads(line)}), flush=True)
    if args.smoke:
        os.makedirs(args.out, exist_ok=True)
        for i, (name, root) in enumerate(turns):
            log = os.path.join(os.path.abspath(args.out), f"smoke_{i}_{name}.log")
            _side(root, ["chip_smoke.py"], log)
            print(f"smoke turn {i} ({name}): {log}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
