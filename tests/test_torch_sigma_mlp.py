"""The hash field's f32 sigma MLP as the kernel pair of ``csrc/sigma_mlp.cu``.

This file imports neither JAX nor the JAX package at module level, so it also
runs on a machine that has only PyTorch and the CUDA toolkit (the comparisons
with the JAX package's ``_apply_mlp`` import it inside the test and skip where
it is absent):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_sigma_mlp.py

Anywhere: which heads take the kernel path (``models/field.py::sigma_mlp_engages``)
and which keep ``mlp_apply``; the wrapper's guards and the widths the library
takes; the launch counters; and the kernel source itself, compiled by the host
C++ compiler against a header that runs each block's 256 threads as host threads
(``__syncthreads`` a barrier, the warp shuffle an exchange through the block),
against float64 and the JAX package at ragged point counts and several widths,
split and repeated to the bit.

On a card (``-m cuda``): the pair against ``mlp_apply`` and float64 at 1, 127,
65,537 and 2,097,152 points and at every width built; two calls equal to the
bit; one launch each way a field call; a head of widths the kernels do not take
raises. Tolerances, elementwise against float64: the kernels and cuBLAS add
the same f32 terms in other orders, so each result may differ from the exact sum
by the f32 rounding of its sums: a sum of k terms by at most k ulp of the sum of
the terms' magnitudes (k = D + H + 2 for sigma, H + 1 for the features'
gradient; for the weight gradients the longest chain a kernel block adds, 2,112
at 2,097,152 points, set at 2e-4 of the magnitudes). Where an exact
pre-activation lies within that rounding of zero (``_ambiguous``) its ReLU mask
may take either side: such points are left out of the per-point gradient's
comparison, and their terms are added to the weight gradients' bound.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
from loner_tpu_torch.ops import sigma_mlp as tsm
from loner_tpu_torch.ops.build import CSRC

torch.set_num_threads(1)

EPS = 2.0 ** -24
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _head(d: int = 32, h: int = 64, out: int = 1, hidden: int = 1, bias: bool = False,
          device=CPU) -> dict:
    dims = [d] + [h] * hidden + [out]
    gen = torch.Generator().manual_seed(d * 1000 + h)
    mlp = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        mlp[f"w{i}"] = ((torch.rand((a, b), generator=gen) * 2 - 1) * (6.0 / a) ** 0.5).to(device)
        if bias:
            mlp[f"b{i}"] = torch.zeros((b,), device=device)
    return mlp


def _operands(n: int, d: int = 32, seed: int = 0, device=CPU):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=device)
    g = torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32, device=device)
    mlp = _head(d, device=device)
    return x, mlp["w0"], mlp["w1"], g


# -- when the kernel path engages ------------------------------------------------------
REFERENCE = tfield.FieldConfig()  # cfg/defaults.yaml's hash head: 16 x 2 features, 64, f32

ENGAGE_CASES = [
    # (id, config, head keywords, device, takes the kernels)
    ("reference on the card", REFERENCE, {}, CUDA, True),
    ("reference on the CPU", REFERENCE, {}, CPU, False),
    ("sigma_kernel plain", tfield.FieldConfig(sigma_kernel="plain"), {}, CUDA, False),
    ("bf16 compute", tfield.FieldConfig(compute_dtype=torch.bfloat16), {}, CUDA, False),
    ("Fourier encoding", tfield.FieldConfig(encoding_sigma="fourier"), {}, CUDA, False),
    ("biased head", REFERENCE, {"bias": True}, CUDA, False),
    ("two hidden layers", REFERENCE, {"hidden": 2}, CUDA, False),
    ("the intensity head's shape", REFERENCE, {"d": 32 + 16, "hidden": 4, "out": 3}, CUDA, False),
    ("two output columns", REFERENCE, {"out": 2}, CUDA, False),
    # The kernels' function at widths they do not take: the kernel path, which
    # raises (test_guards_raise_before_any_launch), never mlp_apply on the card.
    ("H = 128", REFERENCE, {"h": 128}, CUDA, True),
    ("D = 30", REFERENCE, {"d": 30}, CUDA, True),
    ("D = 68", REFERENCE, {"d": 68}, CUDA, True),
    ("D = 12 (box_room_tiny)", REFERENCE, {"d": 12}, CUDA, True),
    ("D = 16, a count no configuration takes", REFERENCE, {"d": 16}, CUDA, True),
]


@pytest.mark.parametrize("cfg,head,device,takes", [c[1:] for c in ENGAGE_CASES],
                         ids=[c[0] for c in ENGAGE_CASES])
def test_which_heads_take_the_kernels(cfg, head, device, takes):
    assert tfield.sigma_mlp_engages(_head(**head), cfg, device) is takes


def test_the_cpu_and_the_intensity_head_keep_mlp_apply():
    """On CPU tensors ``query_sigma`` computes ``mlp_apply``'s bits and launches
    nothing; the intensity head goes through ``field_mlp`` and never reaches the
    hash head's path."""
    cfg = tfield.FieldConfig(
        pos_encoding_sigma=HashEncodingConfig(n_levels=6, log2_hashmap_size=12),
        pos_encoding_intensity=HashEncodingConfig(n_levels=6, log2_hashmap_size=12),
        sigma_mlp=tfield.MLPConfig(64, 1, 1))
    params = tfield.init_field_params(torch.Generator().manual_seed(3), cfg, CPU)
    for head in params.values():
        for t in [head["table"], *head["mlp"].values()]:
            t.requires_grad_(True)
    pos = torch.rand((100, 3), generator=torch.Generator().manual_seed(4)) * 2 - 1
    tsm.counts.reset()
    feats = tfield.hash_encode(params["sigma"]["table"], (pos + 1) * 0.5, cfg.pos_encoding_sigma)
    assert torch.equal(tfield.query_sigma(params, pos, cfg),
                       tfield.mlp_apply(params["sigma"]["mlp"], feats))
    out = tfield.query_field(params, pos, pos / pos.norm(dim=1, keepdim=True), cfg)
    out.sum().backward()
    assert (tsm.counts.fwd_launches, tsm.counts.bwd_launches) == (0, 0)


# -- the wrapper's guards ----------------------------------------------------------------
def _guard_case(name: str):
    x, w0, w1, g = _operands(256)
    if name == "float64 features":
        x = x.double()
    elif name == "bf16 weights":
        w0 = w0.bfloat16()
    elif name == "w0 of other rows":
        w0 = torch.zeros((31, 64))
    elif name == "w1 of two columns":
        w1 = torch.zeros((64, 2))
    elif name == "H = 32":
        w0, w1 = torch.zeros((32, 32)), torch.zeros((32, 1))
    elif name == "D = 30":
        x, w0 = x[:, :30].contiguous(), w0[:30].contiguous()
    elif name == "D = 68":
        x, w0 = torch.zeros((256, 68)), torch.zeros((68, 64))
    elif name == "features not contiguous":
        x = torch.zeros((32, 256)).t()
        g = torch.zeros((256, 1))
    elif name == "weights not contiguous":
        w0 = torch.zeros((64, 32)).t()
    elif name == "features not 16-byte aligned":
        x = torch.zeros(256 * 32 + 1)[1:].view(256, 32)
    elif name == "g of other rows":
        g = torch.zeros((255, 1))
    elif name == "CPU tensors":
        pass
    return x, w0, w1, g


GUARDS = [("float64 features", "x must be float32"), ("bf16 weights", "w0 must be float32"),
          ("w0 of other rows", "w0 must be"), ("w1 of two columns", "w1 \\(H, 1\\)"),
          ("H = 32", "do not take D = 32, H = 32"), ("D = 30", "do not take D = 30, H = 64"),
          ("D = 68", "do not take D = 68, H = 64"),
          ("features not contiguous", "x must be contiguous"),
          ("weights not contiguous", "w0 must be contiguous"),
          ("features not 16-byte aligned", "16-byte aligned"),
          ("g of other rows", "g must be \\(256, 1\\)"),
          ("CPU tensors", "CUDA device")]


@pytest.mark.parametrize("name,message", GUARDS, ids=[c[0] for c in GUARDS])
def test_guards_raise_before_any_launch(host_library, name, message):
    x, w0, w1, g = _guard_case(name)
    tsm.counts.reset()
    with pytest.raises(ValueError, match=message):
        tsm.sigma_mlp_bwd_cuda(x, w0, w1, g)
    if name != "g of other rows":
        with pytest.raises(ValueError, match=message):
            tsm.sigma_mlp_fwd_cuda(x, w0, w1)
    assert (tsm.counts.fwd_launches, tsm.counts.bwd_launches) == (0, 0)


def test_graph_replays_count_the_pair():
    """``CountedGraph`` adds a capture's launches again at every replay: the
    pair's counters are among those it moves."""
    from loner_tpu_torch.common import cuda_graphs

    tsm.counts.reset()
    cuda_graphs.add_launch_counts({("sigma_mlp", "fwd_launches"): 1,
                                   ("sigma_mlp", "bwd_launches"): 1}, times=50)
    counts = cuda_graphs.launch_counts()
    assert counts[("sigma_mlp", "fwd_launches")] == counts[("sigma_mlp", "bwd_launches")] == 50
    tsm.counts.reset()


# -- the kernel source on the host -------------------------------------------------------
EMULATION_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(x)
#define __launch_bounds__(...)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local float* emu_dynamic;
thread_local float* emu_static;
thread_local float* emu_exchange;
thread_local std::barrier<>* emu_barrier;
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu_exchange[threadIdx.x] = v;
  emu_barrier->arrive_and_wait();
  const float r = emu_exchange[threadIdx.x ^ m];
  emu_barrier->arrive_and_wait();
  return r;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class K, class... A>
void emu_launch(K kernel, long long grid, int block, int smem_bytes, cudaStream_t, A... args) {
  for (long long b = 0; b < grid; ++b) {
    std::vector<float> dyn(smem_bytes / 4 + 4, NAN), sta(4096, NAN), ex(block);
    std::barrier<> bar(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = unsigned(b); blockDim.x = block; gridDim.x = unsigned(grid);
        emu_dynamic = dyn.data(); emu_static = sta.data(); emu_exchange = ex.data();
        emu_barrier = &bar;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
"""

# The backward's grid cut from 528 blocks to 3, so that a few hundred points give
# every block a range of several tiles.
EMU_BWD_BLOCKS = 3


def _host_source(src: str) -> str:
    import re

    swaps = [("#include <cuda_runtime.h>", '#include "emulation.h"'),
             ("extern __shared__ __align__(16) float smem[];", "float* smem = emu_dynamic;"),
             ("__shared__ float sums[kSlices][32];",
              "auto& sums = *reinterpret_cast<float(*)[kSlices][32]>(emu_static);")]
    for a, b in swaps:
        assert a in src, a
        src = src.replace(a, b)
    return re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel source on the host")
    out = tmp_path_factory.mktemp("sigma_mlp_host")
    (out / "emulation.h").write_text(EMULATION_HEADER)
    (out / "kernels.cpp").write_text(_host_source((CSRC / "sigma_mlp.cu").read_text()))
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
                           "-fPIC", "-Wno-unknown-pragmas",
                           f"-DLT_SIGMA_MLP_BWD_BLOCKS={EMU_BWD_BLOCKS}", "-o", str(out / "k.so"),
                           str(out / "kernels.cpp")], capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the host compiler has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return tsm.bind(ctypes.CDLL(str(out / "k.so")))


@pytest.fixture
def host_library(host_kernels, monkeypatch):
    """The wrapper's library is the host build of the source, so that the
    wrapper's questions to it (``supported``) are answered without a card."""
    monkeypatch.setattr(tsm, "_lib", lambda: host_kernels)
    return host_kernels


def test_the_library_takes_every_multiple_of_4_up_to_64(host_library):
    """``supported`` is the library's answer: D a multiple of 4 from 4 to 64
    (a row read as float4; the backward's shared memory at 64 is 103 KB), H = 64."""
    taken = [d for d in range(0, 129) if tsm.supported(d, 64)]
    assert taken == list(range(4, 65, 4))
    assert not any(tsm.supported(32, h) for h in (0, 16, 32, 63, 65, 128))


def _host_run(lib, x, w0, w1, g):
    """sigma, dx, dW0, dW1 from the kernel source on the host (CPU tensors)."""
    n, d = x.shape
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    sigma = torch.full((n, 1), float("nan"))
    assert lib.lt_sigma_mlp_fwd(ptr(x), ptr(w0), ptr(w1), n, d, 64, ptr(sigma), None) == 0
    dx = torch.full((n, d), float("nan"))
    partial = torch.full((lib.lt_sigma_mlp_bwd_grid(n), d * 64 + 64), float("nan"))
    grads = torch.full((d * 64 + 64,), float("nan"))
    assert lib.lt_sigma_mlp_bwd(ptr(x), ptr(w0), ptr(w1), ptr(g), n, d, 64, ptr(dx),
                                ptr(partial), ptr(grads), None) == 0
    return sigma, dx, grads[:d * 64].view(d, 64), grads[d * 64:].view(64, 1)


def _exact(x, w0, w1, g):
    """float64 sigma, dx, dW0, dW1 and the magnitudes their f32 sums add."""
    X, W0, W1, G = (t.double() for t in (x, w0, w1, g))
    z = X @ W0
    zmag = X.abs() @ W0.abs()
    r = torch.relu(z)
    gz = (z > 0) * (G @ W1.T)
    return {"z": z, "zmag": zmag, "sigma": r @ W1, "dx": gz @ W0.T, "dw0": X.T @ gz,
            "dw1": r.T @ G, "sigma_mag": (r + zmag) @ W1.abs(), "dx_mag": gz.abs() @ W0.abs().T,
            "dw0_mag": X.abs().T @ gz.abs(), "dw1_mag": (r + zmag).T @ G.abs(),
            "gw1": (G @ W1.T).abs(), "X": X, "G": G}


def _ambiguous(ref: dict, d: int) -> torch.Tensor:
    """(N, H): pre-activations within the f32 rounding of a D-term sum of zero."""
    return ref["z"].abs() <= 2 * (d + 1) * EPS * ref["zmag"]


def _assert_close(got, ref: dict, d: int, dw_terms: float, against=None) -> None:
    """``got`` within its f32 bounds of float64 (``ref``), or, given ``against``
    (another f32 result of the same function), within twice them of that: each
    of the two may lie its bound away from the exact sum, on either side."""
    sigma, dx, dw0, dw1 = (t.double() for t in got)
    exact = [ref[k] for k in ("sigma", "dx", "dw0", "dw1")]
    if against is not None:
        exact = [t.double().to(sigma.device) for t in against]
    amb = _ambiguous(ref, d)
    flip_dw0 = ref["X"].abs().T @ (amb * ref["gw1"])
    flip_dw1 = (amb * ref["zmag"]).T @ ref["G"].abs()
    sure = ~amb.any(dim=1)
    sides = 1 if against is None else 2
    checks = [("sigma", sigma, exact[0], (d + 64 + 2) * EPS * ref["sigma_mag"], slice(None)),
              ("dx", dx, exact[1], (64 + 1) * EPS * ref["dx_mag"], sure),
              ("dw0", dw0, exact[2], dw_terms * ref["dw0_mag"] + flip_dw0, slice(None)),
              ("dw1", dw1, exact[3], dw_terms * ref["dw1_mag"] + flip_dw1, slice(None))]
    for name, a, b, tol, rows in checks:
        over = ((a - b).abs() - sides * tol)[rows]
        assert over.max() <= 0, f"{name}: {float(over.max()):.3e} past its bound"


def _jax_pair(x, w0, w1, g):
    """sigma, dx, dW0 and dW1 of the JAX package's f32 head
    (``loner_tpu/models/field.py::_apply_mlp`` and its VJP), on the host CPU at
    full f32 precision: where this is JAX's first import, it is kept off the
    card (no TF32 products, no memory taken from PyTorch)."""
    import os

    if "jax" not in sys.modules:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax", reason="the comparison with the JAX package needs JAX")
    import jax.numpy as jnp
    from loner_tpu.models.field import _apply_mlp

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        host = lambda t: jnp.asarray(t.detach().cpu().numpy())  # noqa: E731
        sigma, vjp = jax.vjp(lambda p, a: _apply_mlp(p, a, jnp.float32),
                             {"w0": host(w0), "w1": host(w1)}, host(x))
        dp, dx = vjp(host(g))
    return tuple(torch.from_numpy(np.array(t)) for t in (sigma, dx, dp["w0"], dp["w1"]))


@pytest.mark.parametrize("d,n", [(32, 1), (32, 127), (32, 129), (32, 700), (12, 385), (4, 300),
                                 (20, 257), (64, 257)])
def test_kernel_source_on_the_host_matches_float64(host_kernels, d, n):
    x, w0, w1, g = _operands(n, d, seed=n)
    got = _host_run(host_kernels, x, w0, w1, g)
    _assert_close(got, _exact(x, w0, w1, g), d, dw_terms=2e-4)


def test_kernel_source_on_the_host_is_batch_invariant_and_repeats(host_kernels):
    """A point's sigma and dx have the same bits in two ragged parts as in one
    batch, and two calls give every output to the bit."""
    x, w0, w1, g = _operands(700, 32, seed=5)
    whole = _host_run(host_kernels, x, w0, w1, g)
    again = _host_run(host_kernels, x, w0, w1, g)
    assert all(torch.equal(a, b) for a, b in zip(whole, again))
    parts = [_host_run(host_kernels, x[s].contiguous(), w0, w1, g[s].contiguous())
             for s in (slice(0, 261), slice(261, 700))]
    assert torch.equal(torch.cat([p[0] for p in parts]), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts]), whole[1])


def test_kernel_source_on_the_host_matches_mlp_apply(host_kernels):
    """Against ``mlp_apply``'s autograd on the CPU, within the same bounds."""
    x, w0, w1, g = _operands(300, 32, seed=9)
    leaves = [t.clone().requires_grad_(True) for t in (x, w0, w1)]
    sigma = tfield.mlp_apply({"w0": leaves[1], "w1": leaves[2]}, leaves[0])
    dx, dw0, dw1 = torch.autograd.grad(sigma, leaves, g)
    ref = _exact(x, w0, w1, g)
    _assert_close((sigma.detach(), dx, dw0, dw1), ref, 32, dw_terms=2e-4)
    _assert_close(_host_run(host_kernels, x, w0, w1, g), ref, 32, dw_terms=2e-4)


@pytest.mark.parametrize("d", [12, 32])
def test_kernel_source_on_the_host_matches_the_jax_package(host_kernels, d):
    """The kernel source against the JAX package's own f32 head and its VJP on
    the same operands, within twice the f32 bounds of float64 (both sides round)."""
    x, w0, w1, g = _operands(300, d, seed=11)
    ref = _exact(x, w0, w1, g)
    theirs = _jax_pair(x, w0, w1, g)
    _assert_close(theirs, ref, d, dw_terms=2e-4)
    _assert_close(_host_run(host_kernels, x, w0, w1, g), ref, d, dw_terms=2e-4, against=theirs)


# -- on the card ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sigma-MLP kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CUDA


def _card_pair(x, w0, w1, g):
    leaves = [t.clone().requires_grad_(True) for t in (x, w0, w1)]
    sigma = tsm.sigma_mlp({"w0": leaves[1], "w1": leaves[2]}, leaves[0])
    return (sigma.detach(), *torch.autograd.grad(sigma, leaves, g))


def _card_plain(x, w0, w1, g):
    leaves = [t.clone().requires_grad_(True) for t in (x, w0, w1)]
    sigma = tfield.mlp_apply({"w0": leaves[1], "w1": leaves[2]}, leaves[0])
    return (sigma.detach(), *torch.autograd.grad(sigma, leaves, g))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 65537, 2097152])
def test_pair_matches_mlp_apply_and_float64(cuda_device, n):
    x, w0, w1, g = _operands(n, 32, seed=n, device=cuda_device)
    ref = _exact(x, w0, w1, g)
    # 2,112 terms: the longest chain a block of the backward adds at 2,097,152 points.
    _assert_close(_card_pair(x, w0, w1, g), ref, 32, dw_terms=2e-4)
    _assert_close(_card_plain(x, w0, w1, g), ref, 32, dw_terms=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(4, 65, 4)))
def test_pair_matches_float64_at_every_width_built(cuda_device, d):
    x, w0, w1, g = _operands(65537, d, seed=d, device=cuda_device)
    _assert_close(_card_pair(x, w0, w1, g), _exact(x, w0, w1, g), d, dw_terms=2e-4)


@pytest.mark.cuda
def test_pair_matches_the_jax_package(cuda_device):
    """The pair on the card against the JAX package's f32 head and its VJP,
    computed on the host from the same operands (skips where JAX is absent)."""
    x, w0, w1, g = _operands(65537, 32, seed=13, device=cuda_device)
    theirs = _jax_pair(x, w0, w1, g)
    _assert_close(_card_pair(x, w0, w1, g), _exact(x, w0, w1, g), 32, dw_terms=2e-4,
                  against=theirs)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h", [(30, 64), (68, 64), (32, 32)])
def test_a_head_the_kernels_do_not_take_raises(cuda_device, d, h):
    """The kernels' function at widths they do not take raises on the card: it
    never falls back to ``mlp_apply`` there."""
    mlp = _head(d, h, device=cuda_device)
    x = torch.zeros((256, d), device=cuda_device)
    assert tfield.sigma_mlp_engages(mlp, REFERENCE, x.device)
    tsm.counts.reset()
    with pytest.raises(ValueError, match=f"do not take D = {d}, H = {h}"):
        tfield.hash_sigma_mlp(mlp, x, REFERENCE)
    assert (tsm.counts.fwd_launches, tsm.counts.bwd_launches) == (0, 0)


@pytest.mark.cuda
def test_two_calls_are_equal_to_the_bit(cuda_device):
    x, w0, w1, g = _operands(300001, 32, seed=2, device=cuda_device)
    first, again = _card_pair(x, w0, w1, g), _card_pair(x, w0, w1, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_one_launch_each_way_a_field_call(cuda_device):
    """The reference's hash head: one forward and one backward launch a
    ``query_sigma`` call; the flagship's Fourier head: none."""
    for cfg, want in ((REFERENCE, (1, 1)),
                      (tfield.FieldConfig(encoding_sigma="fourier", sigma_mlp_bias=True,
                                          density_activation="softplus",
                                          compute_dtype=torch.bfloat16,
                                          fourier_sigma_impl="pallas"), (0, 0))):
        params = tfield.init_field_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                                          cuda_device)
        for v in params["sigma"]["mlp"].values():
            v.requires_grad_(True)
        pos = torch.rand((4096, 3), device=cuda_device) * 2 - 1
        tsm.counts.reset()
        tfield.query_sigma(params, pos, cfg).sum().backward()
        assert (tsm.counts.fwd_launches, tsm.counts.bwd_launches) == want
