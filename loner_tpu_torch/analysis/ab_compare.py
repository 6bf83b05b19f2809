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
  from ``torch.profiler`` (no host packing). One JSON line per run.
* ``--smoke``: each side's ``chip_smoke.py``, whole; the logs go to ``--out``.

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SIZES = (2_097_152, 262_144)


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
