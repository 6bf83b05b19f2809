"""Where the f32 Fourier-MLP kernels' time goes, by ablation, on the card.

    python3 -m loner_tpu_torch.analysis.f32_breakdown [--points 24576 2097152]
        [--head F H HIDDEN]

Builds text variants of ``csrc/fourier_mlp_f32.cu`` side by side (one nvcc
each, in parallel) with the package's nvcc flags, each with one piece of work
taken out or changed, and times each variant's forward and backward through
the wrappers at one head (default box_room_camera.yaml's, F 32, 3 x 128: the
resident kernels; a head of no resident build, such as 48 256 2, times the
streamed ones) on the same inputs. A variant computes a wrong result on
purpose: only its time means anything. The differences against ``as built``
are the pieces' costs:

- ``one product``: one TF32 product (hi hi) in place of three;
- ``lo unrounded``: lo = x - hi handed to the tensor cores as it is;
- ``no dW``: the resident backward's weight-gradient products skipped;
- ``no x recompute``: the resident backward's second feature pass skipped;
- ``no dW stores``: the streamed backward's dW read-modify-writes skipped;
- ``no chunk staging``: the streamed kernels' weight chunks not copied.

Prints the card's name and power limit, then one JSON line a variant and size
(times in ms, median of CUDA-event timings of 10 calls each).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from loner_tpu_torch.ops import build
from loner_tpu_torch.ops import fourier_mlp as fm

VARIANTS = {
    "as built": [],
    "one product": [(
        "  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);\n"
        "  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);\n", "")],
    "lo unrounded": [(
        "return {hi, tf32_rna(__float_as_uint(x - __uint_as_float(hi)))};",
        "return {hi, __float_as_uint(x - __uint_as_float(hi))};")],
    "no dW": [(
        "  accumulate_dw<H, I>(acc, gi, below, g.stride, mt * 16, r, r == 0, db + I * H::kHP);\n",
        "")],
    "no x recompute": [(
        "    features(g, pts, n, p0, sm + g.bm_off, act_buf(g, sm, 1));\n", "")],
    "no dW stores": [("        if (at[b][e] >= 0) dw[at[b][e]] = old[b][e] + part[e];\n",
                      "        (void)part[e];\n")],
    "no chunk staging": [(
        "  stage_image(params + w_offset(i, g.k0, g.h) + static_cast<long long>(r0) * g.h + c0,\n"
        "              min(nr, rows - r0), min(nc, g.h - c0), nr, nc, g.h, chunk);\n", "")],
}


def build_variant(name: str, edits, out_dir: Path) -> ctypes.CDLL:
    src = (build.CSRC / "fourier_mlp_f32.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its edit no longer matches the source")
        src = src.replace(old, new)
    path = out_dir / (name.replace(" ", "_") + ".cu")
    path.write_text(src)
    lib = path.with_suffix(".so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)], check=True,
                   capture_output=True, text=True)
    return lib


def median_ms(fn, reps: int = 10) -> float:
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


def operands(n: int, dev: torch.device, f: int = 32, h: int = 128, n_hidden: int = 3):
    rng = np.random.default_rng(4)
    dims = [2 * f + 3] + [h] * n_hidden + [1]
    ws = [torch.tensor((rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32),
                       device=dev) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor((rng.normal(size=b) * 0.1).astype(np.float32), device=dev) for b in dims[1:]]
    bmat = torch.tensor((rng.normal(size=(3, f)) * 6.0 * 2 * np.pi).astype(np.float32), device=dev)
    pts = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
    dout = torch.tensor((rng.normal(size=(n, 1)) / np.sqrt(n)).astype(np.float32), device=dev)
    return ws, bs, bmat, pts, dout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[24576, 2097152])
    ap.add_argument("--head", type=int, nargs=3, default=[32, 128, 3],
                    metavar=("F", "H", "HIDDEN"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent if build.BUILD_DIR.parent.exists()
                                     else None) as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            paths = list(pool.map(lambda item: build_variant(*item, Path(tmp)), VARIANTS.items()))
        libs = {name: fm._bind_f32(ctypes.CDLL(str(path))) for name, path in zip(VARIANTS, paths)}
        built = fm._lib_f32
        try:
            for n in args.points:
                ws, bs, bmat, pts, dout = operands(n, dev, *args.head)
                for name, lib in libs.items():
                    fm._lib_f32 = lambda lib=lib: lib
                    fm.f32_occupancy.cache_clear()
                    print(json.dumps({
                        "variant": name, "points": n, "head": args.head,
                        "fwd_ms": median_ms(lambda: fm.fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts)),
                        "bwd_ms": median_ms(lambda: fm.fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts,
                                                                                 dout))}),
                          flush=True)
        finally:
            fm._lib_f32 = built
            fm.f32_occupancy.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
