"""Operations of the camera branch, counted from a configuration's shapes (the
yardstick's arithmetic for a cell whose phases train the intensity head from
camera rays, beside ``costs.py``'s LiDAR path)."""
from __future__ import annotations

from typing import List

from portbench import costs


def intensity_dims(field: dict) -> List[int]:
    """The intensity MLP's widths, input first: the Fourier features [sin, cos(,
    p)] of the position, then the SH view encoding's degree^2 values where the
    head is view dependent."""
    if field["encoding_intensity"] != "fourier":
        raise NotImplementedError("a hash-grid intensity head")
    f = field["fourier_intensity"]
    d_in = 2 * f["n_freqs"] + (3 if f["include_input"] else 0)
    if field["enable_view_dependence"]:
        d_in += field["sh_degree"] ** 2
    mlp = field["intensity_mlp"]
    return [d_in] + [mlp["n_neurons"]] * mlp["n_hidden_layers"] + [mlp["output_dim"]]


def intensity_macs(field: dict) -> int:
    """The intensity MLP's multiply-adds a point (no biases)."""
    dims = intensity_dims(field)
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def camera_flops_per_iteration(config: dict, traffic: dict) -> float:
    """The camera branch's operations in one joint iteration of the whole
    window (2 a multiply-add), counting the backward only where the
    configuration's detach flags let it reach: at n_c = W x n_camera x S points,
    the sigma MLP forward (2 n_c MACs) and, unless ``detach_rgb_from_sigma``,
    its backward (4 more); the intensity MLP forward and backward (6 n_c MACs);
    each Fourier encode's projection forward (6 F a point; the sigma and
    intensity heads are both Fourier: ``intensity_dims``) and, unless
    ``detach_rgb_from_poses``, its two backward products (12 F more); the
    proposal MLP's forward at the camera rays' control points (the camera loss
    does not train it)."""
    opt, field = config["optimizer"], config["field"]
    rays = traffic["window"] * opt["n_camera_samples"]
    n = rays * opt["n_samples_per_ray"]
    total = (2 if opt["detach_rgb_from_sigma"] else 6) * n * costs.sigma_macs(field)
    total += 6 * n * intensity_macs(field)
    per_freq = 6 if opt["detach_rgb_from_poses"] else 18
    for name in ("fourier_sigma", "fourier_intensity"):
        total += per_freq * field[name]["n_freqs"] * n
    if opt["samples_strategy"] == "PROPOSAL":
        pm, pf = costs.proposal_macs(opt), opt["proposal"]["n_freqs"]
        total += (2 * pm + 6 * pf) * rays * (opt["prop_n_ctrl"] or opt["n_samples_per_ray"] // 2)
    return float(total)


def flops_per_iteration(config: dict, traffic: dict) -> float:
    """``costs.flops_per_iteration``'s LiDAR path plus the camera branch."""
    return costs.flops_per_iteration(config, traffic) + camera_flops_per_iteration(config, traffic)
