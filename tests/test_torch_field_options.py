"""The field options no config in cfg/ sets, against the JAX package's
``query_field`` on the CPU.

Every combination of the JAX package's ``sigma_kernel`` word (xla, auto,
pallas), ``fourier_sigma.encode_impl`` (vjp, xla), ``mlp_grad`` (vjp, xla) and
``include_input`` on a bf16 Fourier sigma head; the hash sigma head in f32 and
bf16 under both ``mlp_grad`` values; the Fourier intensity head under both
``encode_impl`` and ``mlp_grad`` values. Each config is read from one settings
dict by both packages' ``FieldConfig.from_settings``, the parameters are the JAX
package's (``convert.field_params_from_jax``), and the inputs come from a numpy
seed. Forward values and the gradients of ``sum(out * g)`` with respect to every
parameter and the positions are compared.

Tolerances (absolute, over each array's largest magnitude, at least 1):
- f32: 1e-5 forward, 5e-5 gradients: the two packages differ in the order of
  f32 summation only (tests/test_torch_field.py's).
- bf16: 1e-3 forward (tests/test_torch_field.py's), 8e-3 gradients: a hidden
  activation is rounded to bf16 after an f32 sum whose order differs between the
  packages, so a value within an f32 rounding of a bf16 tie rounds the other way,
  and the fused function's position gradient reads 3.2e-3 at most here.
- The bias gradients under ``mlp_grad: xla`` in bf16, 4e-2: the JAX package's
  autodiff sums each bias's cotangent over the points with a bf16 accumulator
  (XLA's reduce in the cotangent's dtype), the port's autograd with an f32 one;
  1.6e-2 at most over these 193 points (the weight gradients are equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.models import field as jfield
from loner_tpu_torch import convert
from loner_tpu_torch.common import yaml_lite
from loner_tpu_torch.common.settings import load_config
from loner_tpu_torch.models import field as tfield

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 193  # points: not a multiple of the fused kernel's tiles
F_SIGMA, F_INTENSITY, HIDDEN = 8, 12, 32


def _nerf_settings(encoding: str, dtype: str, **opts) -> dict:
    """A nerf config dict of small widths, as cfg/nerf_config/*.yaml spell it."""
    cfg = {
        "encoding_sigma": encoding,
        "compute_dtype": dtype,
        "sigma_network": {"n_neurons": HIDDEN, "n_hidden_layers": 2},
        "intensity_network": {"n_neurons": 16, "n_hidden_layers": 2},
        "pos_encoding_sigma": {"n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 4},
        "pos_encoding_intensity": {"n_levels": 2, "log2_hashmap_size": 10,
                                   "base_resolution": 4},
        "dir_encoding_intensity": {"degree": 2},
        "fourier_sigma": {"n_freqs": F_SIGMA, "scale": 3.0,
                          "include_input": opts.pop("include_input", True),
                          "encode_impl": opts.pop("encode_impl", "vjp")},
    }
    if "intensity_encode_impl" in opts:
        cfg["encoding_intensity"] = "fourier"
        cfg["fourier_intensity"] = {"n_freqs": F_INTENSITY, "scale": 2.0,
                                    "encode_impl": opts.pop("intensity_encode_impl")}
    cfg.update(opts)
    return cfg


def _tolerances(tcfg, leaf: str) -> tuple:
    """(forward, gradient) tolerances of the module docstring."""
    if tcfg.compute_dtype == torch.float32:
        return 1e-5, 5e-5
    return 1e-3, 4e-2 if tcfg.mlp_grad == "xla" and leaf.startswith("b") else 8e-3


def _close(got: np.ndarray, want: np.ndarray, atol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=what)


def _check(settings: dict, sigma_only: bool = True) -> None:
    jcfg = jfield.FieldConfig.from_settings(settings)
    tcfg = tfield.FieldConfig.from_settings(settings)
    params = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    dirs = rng.normal(size=(N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    g = rng.normal(size=(N, 1 if sigma_only else 4)).astype(np.float32)

    def loss_j(p, x):
        out = jfield.query_field(p, x, jnp.asarray(dirs), jcfg, sigma_only=sigma_only)
        return (out * jnp.asarray(g)).sum(), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pos))

    params_t = convert.field_params_from_jax(params, CPU)
    leaves = {(head, part, k): v.requires_grad_(True)
              for head, tree in params_t.items() for part, sub in tree.items()
              for k, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}
    pos_t = torch.tensor(pos, requires_grad=True)
    out_t = tfield.query_field(params_t, pos_t, torch.tensor(dirs), tcfg, sigma_only=sigma_only)
    (out_t * torch.tensor(g)).sum().backward()

    fwd, grad = _tolerances(tcfg, "")
    _close(out_t.detach().numpy(), np.asarray(out_j), fwd, "forward")
    for (head, part, k), v in leaves.items():
        ref = gp_j[head][part] if k == "" else gp_j[head][part][k]
        got = np.zeros_like(np.asarray(ref)) if v.grad is None else v.grad.numpy()
        _close(got, np.asarray(ref), _tolerances(tcfg, k)[1], f"d{head}.{part}.{k}")
    _close(pos_t.grad.numpy(), np.asarray(gx_j), grad, "dpos")


@pytest.mark.parametrize("include_input", [True, False], ids=["input", "no_input"])
@pytest.mark.parametrize("mlp_grad", ["vjp", "xla"])
@pytest.mark.parametrize("encode_impl", ["vjp", "xla"])
@pytest.mark.parametrize("sigma_kernel", ["xla", "auto", "pallas"])
def test_fourier_sigma_head_matches_jax(sigma_kernel, encode_impl, mlp_grad, include_input):
    settings = _nerf_settings("fourier", "bfloat16", sigma_kernel=sigma_kernel,
                              encode_impl=encode_impl, mlp_grad=mlp_grad,
                              include_input=include_input)
    tcfg = tfield.FieldConfig.from_settings(settings)
    # The fused function where the JAX package fuses, or where its unfused path
    # computes the same function; "auto" fuses only on a TPU.
    assert tcfg.fused_fourier == (include_input and (
        sigma_kernel == "pallas" or (encode_impl == "vjp" and mlp_grad == "vjp")))
    _check(settings)


@pytest.mark.parametrize("mlp_grad", ["vjp", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_sigma_head_matches_jax(dtype, mlp_grad):
    _check(_nerf_settings("hash", dtype, mlp_grad=mlp_grad))


@pytest.mark.parametrize("mlp_grad", ["vjp", "xla"])
@pytest.mark.parametrize("encode_impl", ["vjp", "xla"])
def test_fourier_intensity_head_matches_jax(encode_impl, mlp_grad):
    _check(_nerf_settings("fourier", "bfloat16", mlp_grad=mlp_grad,
                          intensity_encode_impl=encode_impl), sigma_only=False)


@pytest.mark.parametrize("key,value,jax_raises", [
    ("encode_impl", "pallas", True),
    ("mlp_grad", "autodiff", False),
    ("sigma_kernel", "triton", False),
])
def test_unknown_option_values_raise(key, value, jax_raises):
    """The port raises ValueError where the JAX package does, and also where it
    takes an unknown word silently as "xla"."""
    settings = _nerf_settings("fourier", "bfloat16", **{key: value})
    if jax_raises:
        with pytest.raises(ValueError):
            jfield.FieldConfig.from_settings(settings)
    else:
        jfield.FieldConfig.from_settings(settings)
    with pytest.raises(ValueError, match=key):
        tfield.FieldConfig.from_settings(settings)


def test_every_fourier_config_keeps_the_fused_kernels():
    """Every config under cfg/ with a Fourier sigma head computes the fused
    function, the CUDA kernels' on the card."""
    import glob
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    fourier = []
    for path in sorted(glob.glob(str(repo / "cfg" / "**" / "*.yaml"), recursive=True)):
        raw = yaml_lite.load_file(path)
        if not isinstance(raw, dict) or not ("mapper" in raw or "baseline" in raw):
            continue  # an overrides file or a sub-config (a nerf or model config)
        settings, _ = load_config(path)
        try:
            nerf = settings["mapper"]["optimizer"]["model_config"]["model"]["nerf_config"]
        except (KeyError, TypeError):
            continue
        cfg = tfield.FieldConfig.from_settings(nerf)
        if cfg.encoding_sigma == "fourier":
            fourier.append(path)
            assert cfg.fused_fourier, path
    assert len(fourier) >= 10
