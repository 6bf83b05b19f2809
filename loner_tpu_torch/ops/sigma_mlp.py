"""The hash field's sigma MLP in f32 as one hand-written CUDA kernel pair.

The head of ``cfg/nerf_config/default_nerf_hash.yaml``: D hash features, one
hidden layer of H = 64 with ReLU, one output column, no biases, in float32.
Its plain version is ``models/field.py::mlp_apply`` (PyTorch's products); on the
card the pair of ``csrc/sigma_mlp.cu`` computes the same function without
writing any (N, H) array:

  forward   sigma = relu(x W0) w1                                  (N, 1)
  backward  gz = (x W0 > 0) g w1^T; dx = gz W0^T                  (N, D)
            dW0 = x^T gz, dW1 = relu(x W0)^T g

Every product is an f32 FMA chain on the CUDA cores, summed in another order than
cuBLAS's: sigma, dx, dW0 and dW1 differ from the plain version by f32 rounding of
sums of D or H terms (dW: of N terms), and a ReLU mask can flip where a
pre-activation lies within that rounding of zero. Each point's sigma and dx come
from an order that does not depend on N or on the point's place in the batch, so
they have the same bits in any split of the points; the weight gradients are
summed without float atomics in an order fixed by N, so two calls agree to the
bit.

``supported`` asks the built library which heads the kernels take (D a multiple
of 4 up to 64, H = 64); ``models/field.py::sigma_mlp_engages`` says when the field
takes this path, and a head of this function that the kernels do not take raises
there rather than falling back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

class LaunchCounts:
    """Launches made by this module's wrappers: one forward a call, and one
    backward a call (the backward kernel with its reduce)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0


counts = LaunchCounts()


def supported(d: int, h: int) -> bool:
    """Whether the kernels take a head of ``d`` features and ``h`` hidden units
    (``csrc/sigma_mlp.cu::lt_sigma_mlp_supported``)."""
    return bool(_lib().lt_sigma_mlp_supported(d, h))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from loner_tpu_torch.ops.build import load_library

    return bind(load_library("sigma_mlp"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/sigma_mlp.cu) with its C signatures declared."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lt_sigma_mlp_supported.argtypes = [i, i]
    lib.lt_sigma_mlp_supported.restype = i
    lib.lt_sigma_mlp_bwd_grid.argtypes = [ll]
    lib.lt_sigma_mlp_bwd_grid.restype = ll
    lib.lt_sigma_mlp_fwd.argtypes = [p, p, p, ll, i, i, p, p]
    lib.lt_sigma_mlp_fwd.restype = i
    lib.lt_sigma_mlp_bwd.argtypes = [p, p, p, p, ll, i, i, p, p, p, p]
    lib.lt_sigma_mlp_bwd.restype = i
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def check_operands(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                   g: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """Raise ValueError, before any launch, on what the kernels do not take:
    x (N, D), w0 (D, H), w1 (H, 1) and g (N, 1), all float32, contiguous and on
    one CUDA device, x 16-byte aligned (the kernels read its rows as float4),
    with D and H ``supported``. Returns (N, D)."""
    if x.dim() != 2 or w0.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"x, w0 and w1 must be matrices, got {tuple(x.shape)}, "
                         f"{tuple(w0.shape)}, {tuple(w1.shape)}")
    n, d = x.shape
    if tuple(w0.shape) != (d, w0.shape[1]) or tuple(w1.shape) != (w0.shape[1], 1):
        raise ValueError(f"w0 must be ({d}, H) and w1 (H, 1) for x of {d} features, got "
                         f"{tuple(w0.shape)} and {tuple(w1.shape)}")
    if not supported(d, w0.shape[1]):
        raise ValueError(f"the sigma-MLP kernels do not take D = {d}, H = {w0.shape[1]} "
                         f"(csrc/sigma_mlp.cu::LT_SIGMA_MLP_DS lists the D built, and H is 64)")
    named = [("x", x), ("w0", w0), ("w1", w1)] + ([("g", g)] if g is not None else [])
    if g is not None and tuple(g.shape) != (n, 1):
        raise ValueError(f"g must be ({n}, 1), got {tuple(g.shape)}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    for name, t in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device, got {t.device}")
    return n, d


def sigma_mlp_fwd_cuda(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The forward kernel: (N, D) features -> (N, 1) f32 sigma."""
    n, d = check_operands(x, w0, w1)
    out = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().lt_sigma_mlp_fwd(_ptr(x), _ptr(w0), _ptr(w1), n, d, w0.shape[1], _ptr(out),
                                       ctypes.c_void_p(stream)), "lt_sigma_mlp_fwd")
    counts.fwd_launches += 1
    return out


def sigma_mlp_bwd_cuda(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: (dx (N, D), dW0 (D, H), dW1 (H, 1)). The blocks'
    partials of the weight gradients go to a workspace of
    ``lt_sigma_mlp_bwd_grid(N)`` x (D H + H) floats."""
    n, d = check_operands(x, w0, w1, g)
    h, dev = w0.shape[1], x.device
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    grads = torch.empty((d * h + h,), dtype=torch.float32, device=dev)
    if n == 0:
        grads.zero_()
    else:
        lib = _lib()
        partial = torch.empty((lib.lt_sigma_mlp_bwd_grid(n), d * h + h), dtype=torch.float32,
                              device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            _check(lib.lt_sigma_mlp_bwd(_ptr(x), _ptr(w0), _ptr(w1), _ptr(g), n, d, h, _ptr(dx),
                                        _ptr(partial), _ptr(grads), ctypes.c_void_p(stream)),
                   "lt_sigma_mlp_bwd")
        counts.bwd_launches += 1
    return dx, grads[:d * h].view(d, h), grads[d * h:].view(h, 1)


class SigmaMLPFunction(torch.autograd.Function):
    """Residuals are the features and the weights: the backward recomputes the
    pre-activations with the forward's code."""

    @staticmethod
    def forward(ctx, x, w0, w1):
        ctx.save_for_backward(x, w0, w1)
        return sigma_mlp_fwd_cuda(x, w0, w1)

    @staticmethod
    def backward(ctx, g):
        x, w0, w1 = ctx.saved_tensors
        grads = sigma_mlp_bwd_cuda(x, w0, w1, g.to(torch.float32).contiguous())
        return tuple(t if need else None for t, need in zip(grads, ctx.needs_input_grad))


def sigma_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The head ``{"w0": (D, H), "w1": (H, 1)}`` on (N, D) f32 features on the
    card: (N, 1) f32 sigma, differentiable in the features and the weights."""
    return SigmaMLPFunction.apply(x, params["w0"], params["w1"])
