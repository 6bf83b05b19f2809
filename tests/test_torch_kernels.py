"""The port's CUDA kernels against their plain PyTorch version, on a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a card every test skips. Tolerances (bf16, kernel and plain version
differ only in f32 summation order): forward max abs 5e-2 on O(1)-O(10) sigma;
gradients relative L2 1e-2, since a rare flipped ReLU mask moves single points'
gradients.
"""
import numpy as np
import pytest
import torch

from loner_tpu_torch.ops import fourier_mlp as tfm

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Fourier-MLP kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(f: int, h: int, n_hidden: int, n: int, device):
    rng = np.random.default_rng(4)
    dims = [2 * f + 3] + [h] * n_hidden + [1]
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append(torch.tensor((rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32),
                               device=device))
        bs.append(torch.tensor((rng.normal(size=b) * 0.1).astype(np.float32), device=device))
    bmat = torch.tensor((rng.normal(size=(3, f)) * 6.0 * 2 * np.pi).astype(np.float32),
                        device=device)
    pts = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=device)
    dout = torch.tensor(rng.normal(size=(n, 1)).astype(np.float32), device=device)
    return ws, bs, bmat, pts, dout


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_hidden,n", [(8, 32, 2, 300), (16, 64, 1, 777), (48, 256, 2, 5000)])
def test_fourier_mlp_kernels_match_plain(cuda_device, f, h, n_hidden, n):
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, n, cuda_device)
    bf = torch.bfloat16
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    out_k = tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, bf)
    out_p = tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, bf)
    assert float((out_k - out_p).abs().max()) <= 5e-2
    dws_k, dbs_k, dpts_k = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, bf)
    dws_p, dbs_p, dpts_p = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, bf)
    for a, b in zip(dws_k + dbs_k + [dpts_k], dws_p + dbs_p + [dpts_p]):
        b = b.reshape(a.shape)
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-2
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == (before[0] + 1, before[1] + 1)
    # Deterministic: the dW partials are summed in a fixed order, no atomics.
    again = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, bf)
    assert all(torch.equal(x, y) for x, y in zip(dws_k + dbs_k, again[0] + again[1]))


@pytest.mark.cuda
def test_autograd_through_the_kernels(cuda_device):
    ws, bs, bmat, pts, dout = _operands(8, 32, 2, 300, cuda_device)
    mlp = {**{f"w{i}": w.requires_grad_(True) for i, w in enumerate(ws)},
           **{f"b{i}": b.requires_grad_(True) for i, b in enumerate(bs)}}
    pts.requires_grad_(True)
    before = tfm.counts.bwd_launches
    tfm.fourier_sigma_fused(mlp, pts, bmat).backward(dout)
    assert tfm.counts.bwd_launches == before + 1
    with torch.no_grad():
        _, _, dpts_p = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, torch.bfloat16)
    assert float(torch.linalg.norm(pts.grad - dpts_p) / torch.linalg.norm(dpts_p)) <= 1e-2
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in mlp.values())


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    ws, bs, bmat, pts, _ = _operands(8, 32, 2, 64, cuda_device)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, torch.float32)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda([ws[0][:-3]] + ws[1:], bs, bmat, pts, torch.bfloat16)


def test_cpu_tensors_take_the_plain_version():
    ws, bs, bmat, pts, dout = _operands(8, 32, 2, 64, torch.device("cpu"))
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    mlp = {**{f"w{i}": w for i, w in enumerate(ws)}, **{f"b{i}": b for i, b in enumerate(bs)}}
    out = tfm.fourier_sigma_fused(mlp, pts, bmat)
    torch.testing.assert_close(out, tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, torch.bfloat16))
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == before
