"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/loner_tpu_torch/<name>-<hash>.so`` at the repository root, the first time
a process asks for it, and loaded with ``ctypes``. The hash covers the source and
the flags, so an edited source builds anew and an unchanged one is reused. The
sources have a plain C interface and include no PyTorch header: ``nvcc`` takes
seconds for them. ``build_all`` starts one ``nvcc`` for each source, all at once.
``ptxas -v`` reports each kernel's registers, shared memory and spills; the
report is kept beside the library (``ptxas_report``).

Host C++ (``csrc/<name>.cpp``, the ingest's ``scan_ops``) is built the same way
by the host compiler (``load_host_library``), with the JAX package's flags for
its copy of the same source; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loner_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# loner_tpu/ops/native/__init__.py's flags; no -march=native (see csrc/scan_ops.cpp).
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of loner_tpu_torch build only on a "
            "machine with the CUDA toolkit"
        )
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when ``csrc/<name>.cu`` was built."""
    return _target(name).with_suffix(".ptxas.txt").read_text()


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process each, all started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{stdout}\n{stderr}")
        else:
            out.with_suffix(".ptxas.txt").write_text(stdout + stderr)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))


def _host_target(name: str) -> Path:
    src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(HOST_CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-host-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with the host compiler (``c++``) if needed
    and return the loaded library; raises when there is no compiler or the
    build fails."""
    out = _host_target(name)
    if not out.exists():
        cxx = shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no host C++ compiler (c++) to build csrc/{name}.cpp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_CXX_FLAGS, str(CSRC / f"{name}.cpp"), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"c++ failed on csrc/{name}.cpp:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
