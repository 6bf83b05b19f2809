"""The PyTorch port's Fourier sigma field against the JAX package's.

- The fused Fourier-MLP (plain PyTorch version, which the CPU runs) against
  the Pallas kernel in interpret mode, forward and gradients, in f32 and bf16.
  Tolerances: f32 differs only in summation order (atol 1e-5 of O(1) values,
  gradients 5e-5 of their scale); bf16 adds a rare bf16 rounding flip where the
  f32 sums differ (atol 1e-3 of their scale).
- ``query_field`` against the JAX package's XLA sigma path (f32, 1e-5).
- The ``fourier_bmats.npz`` fixture: bit-equal to JAX's draws, and complete
  for every configuration under cfg/.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from loner_tpu.models import field as jfield
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.ops.pallas.fourier_mlp import fourier_sigma_fused as j_fused
from loner_tpu_torch import convert
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.ops import fourier_mlp as tfm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (1e-3, 1e-3)}  # (forward atol, grad atol / scale)


def _mlp(f: int, h: int, n_hidden: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    dims = [2 * f + 3] + [h] * n_hidden + [1]
    mlp = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        mlp[f"w{i}"] = (rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32)
        mlp[f"b{i}"] = (rng.normal(size=b) * 0.1).astype(np.float32)
    return mlp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f,h,n_hidden", [(8, 32, 2), (16, 64, 1)])
def test_fourier_mlp_plain_matches_pallas_interpret(dtype, f, h, n_hidden):
    _check_plain_against_interpret(dtype, f, h, n_hidden)


def test_fourier_mlp_plain_matches_pallas_interpret_at_the_courtyard_width():
    """cfg/synthetic/courtyard_tpu_r5f.yaml's head (96 frequencies, K = 195, 256 x 2)
    in f32. In bf16 at this width the f32 sums of 195 and 256 products in another
    order flip bf16 roundings of hidden activations (forward up to 4e-3 on 8 of
    300 points), beyond the small widths' 1e-3; the card holds the kernel to the
    plain version there (tests/test_torch_kernels.py, chip_smoke.py phase 17)."""
    _check_plain_against_interpret("float32", 96, 256, 2)


def _check_plain_against_interpret(dtype, f, h, n_hidden):
    jdt, tdt = DTYPES[dtype]
    fwd_tol, grad_tol = TOL[dtype]
    rng = np.random.default_rng(1)
    mlp = _mlp(f, h, n_hidden)
    bmat = (rng.normal(size=(3, f)) * 6.0 * 2 * np.pi).astype(np.float32)
    n = 300  # not a multiple of any tile: exercises padding in the Pallas kernel
    pts01 = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    dout = rng.normal(size=(n, 1)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda m, p: j_fused(m, p, jnp.asarray(bmat), compute_dtype=jdt, interpret=True),
        {k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(pts01),
    )
    g_mlp_j, g_pts_j = vjp(jnp.asarray(dout))

    mlp_t = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    pts_t = torch.tensor(pts01, requires_grad=True)
    out_t = tfm.fourier_sigma_fused(mlp_t, pts_t, torch.tensor(bmat), compute_dtype=tdt)
    out_t.backward(torch.tensor(dout))

    assert out_t.shape == (n, 1) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=fwd_tol)
    for k in mlp:
        ref = np.asarray(g_mlp_j[k])
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(mlp_t[k].grad.numpy() / scale, ref / scale,
                                   atol=grad_tol, err_msg=k)
    ref = np.asarray(g_pts_j)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(pts_t.grad.numpy() / scale, ref / scale, atol=grad_tol)


def _field_cfgs(f=8, h=32):
    common = dict(encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True)
    jcfg = jfield.FieldConfig(
        fourier_sigma=jfield.FourierConfig(n_freqs=f, scale=6.0),
        sigma_mlp=jfield.MLPConfig(n_neurons=h, n_hidden_layers=2, output_dim=1),
        compute_dtype=jnp.float32, sigma_kernel="xla",
        pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10), **common,
    )
    tcfg = tfield.FieldConfig(
        fourier_sigma=tfield.FourierConfig(n_freqs=f, scale=6.0),
        sigma_mlp=tfield.MLPConfig(n_neurons=h, n_hidden_layers=2, output_dim=1),
        compute_dtype=torch.float32,
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        **common,
    )
    return jcfg, tcfg


def test_query_field_matches_xla_sigma_path():
    jcfg, tcfg = _field_cfgs()
    params = jfield.init_field_params(jax.random.key(0), jcfg)
    params_t = convert.field_params_from_jax(jax.tree.map(np.asarray, params), CPU)
    pos = np.random.default_rng(2).uniform(-0.9, 0.9, (257, 3)).astype(np.float32)

    def loss_j(p, x):
        return (jfield.query_field(p, x, None, jcfg, sigma_only=True) ** 2).sum()

    val_j, (g_p, g_x) = jax.value_and_grad(loss_j, argnums=(0, 1))(params, jnp.asarray(pos))
    sigma_j = jfield.query_field(params, jnp.asarray(pos), None, jcfg, sigma_only=True)

    mlp_t = {k: v.requires_grad_(True) for k, v in params_t["sigma"]["mlp"].items()}
    pos_t = torch.tensor(pos, requires_grad=True)
    sigma_t = tfield.query_field(params_t, pos_t, None, tcfg, sigma_only=True)
    (sigma_t ** 2).sum().backward()

    np.testing.assert_allclose(sigma_t.detach().numpy(), np.asarray(sigma_j), atol=1e-5)
    for k, v in mlp_t.items():
        ref = np.asarray(g_p["sigma"]["mlp"][k])
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(v.grad.numpy() / scale, ref / scale, atol=5e-5, err_msg=k)
    scale = max(np.abs(np.asarray(g_x)).max(), 1.0)
    np.testing.assert_allclose(pos_t.grad.numpy() / scale, np.asarray(g_x) / scale, atol=5e-5)


def test_init_field_params_shapes_match_jax():
    jcfg, tcfg = _field_cfgs()
    jp = jax.tree.map(np.shape, jfield.init_field_params(jax.random.key(0), jcfg))
    tp = tfield.init_field_params(torch.Generator().manual_seed(0), tcfg, CPU)
    for k, v in jp["sigma"]["mlp"].items():
        assert tuple(tp["sigma"]["mlp"][k].shape) == v, k
    for k, v in jp["intensity"]["mlp"].items():
        assert tuple(tp["intensity"]["mlp"][k].shape) == v, k
    assert tuple(tp["intensity"]["table"].shape) == jp["intensity"]["table"]
    bound = np.sqrt(6.0 / tcfg.sigma_input_dim)
    assert float(tp["sigma"]["mlp"]["w0"].abs().max()) <= bound
    assert float(tp["sigma"]["mlp"]["b0"].abs().max()) == 0.0


def test_query_field_clamps_non_finite_sigma():
    _, tcfg = _field_cfgs()
    params = tfield.init_field_params(torch.Generator().manual_seed(0), tcfg, CPU)
    params["sigma"]["mlp"]["b2"] = torch.tensor([float("inf")])
    sigma = tfield.query_field(params, torch.zeros((4, 3)), None, tcfg, sigma_only=True)
    assert torch.all(sigma == torch.finfo(torch.float32).max)


def _fixture_keys():
    with np.load(tfield.BMAT_FIXTURE) as z:
        return sorted(z.files)


@pytest.mark.parametrize("key", _fixture_keys())
def test_bmat_fixture_is_bit_equal_to_jax(key):
    seed, n_freqs = (int(x) for x in key.split("_"))
    ref = np.asarray(jax.random.normal(jax.random.key(seed), (3, n_freqs), jnp.float32))
    np.testing.assert_array_equal(tfield._unscaled_bmat(seed, n_freqs), ref)
    cfg_j = jfield.FourierConfig(n_freqs=n_freqs, scale=6.0, seed=seed)
    cfg_t = tfield.FourierConfig(n_freqs=n_freqs, scale=6.0, seed=seed)
    np.testing.assert_array_equal(
        tfield.fourier_bmat(cfg_t, CPU).numpy(), np.asarray(jfield.fourier_bmat(cfg_j))
    )


class _IncludeAsText(yaml.SafeLoader):
    """Parses one YAML file on its own: ``!include`` tags stay unresolved (the
    included files are walked separately)."""


_IncludeAsText.add_constructor("!include", lambda loader, node: loader.construct_scalar(node))


def _fourier_sections(node, found):
    if isinstance(node, dict):
        for key, value in node.items():
            if key in ("fourier_sigma", "fourier_intensity") and isinstance(value, dict):
                # Sweep files (ablations, capacity studies) list candidate values.
                seeds = value.get("seed", 1234 if key == "fourier_sigma" else 4321)
                freqs = value.get("n_freqs", 64)
                for seed in seeds if isinstance(seeds, list) else [seeds]:
                    for n_freqs in freqs if isinstance(freqs, list) else [freqs]:
                        found.add((int(seed), int(n_freqs)))
            _fourier_sections(value, found)
    elif isinstance(node, list):
        for value in node:
            _fourier_sections(value, found)


def test_bmat_fixture_covers_every_config():
    found = {(1234, 64), (4321, 64)}  # FourierConfig's defaults
    files = sorted((REPO / "cfg").rglob("*.yaml"))
    assert files
    for path in files:
        _fourier_sections(yaml.load(path.read_text(), Loader=_IncludeAsText), found)
    have = {tuple(int(x) for x in k.split("_")) for k in _fixture_keys()}
    assert found <= have, f"missing from fourier_bmats.npz: {sorted(found - have)}"
    with pytest.raises(KeyError):
        tfield._unscaled_bmat(1234, 7)
