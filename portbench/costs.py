"""Operations and bytes counted from a configuration's shapes (the yardstick's
arithmetic, shared by the per-layer metrics)."""
from __future__ import annotations

from typing import List, Tuple


def mlp_shapes(in_dim: int, mlp: dict) -> List[Tuple[int, int]]:
    dims = [in_dim] + [mlp["n_neurons"]] * mlp["n_hidden_layers"] + [mlp["output_dim"]]
    return list(zip(dims[:-1], dims[1:]))


def sigma_in_dim(field: dict) -> int:
    if field["encoding_sigma"] == "fourier":
        return 2 * field["fourier_sigma"]["n_freqs"] + 3
    enc = field["pos_encoding_sigma"]
    return enc["n_levels"] * enc["n_features_per_level"]


def sigma_macs(field: dict) -> int:
    """The sigma MLP's multiply-adds a point."""
    return sum(a * b for a, b in mlp_shapes(sigma_in_dim(field), field["sigma_mlp"]))


def fourier_param_bytes(field: dict) -> int:
    """f32 bytes of the Fourier sigma head's weights, biases and projection."""
    shapes = mlp_shapes(sigma_in_dim(field), field["sigma_mlp"])
    return 4 * (sum(a * b for a, b in shapes) + sum(b for _, b in shapes)
                + 3 * field["fourier_sigma"]["n_freqs"])


def proposal_macs(opt: dict) -> int:
    pc = opt["proposal"]
    dims = [2 * pc["n_freqs"] + 3] + [pc["n_neurons"]] * pc["n_hidden_layers"] + [1]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def hash_table_entries(enc: dict) -> int:
    sizes = []
    for level in range(enc["n_levels"]):
        res = int(enc["base_resolution"] * enc["per_level_scale"] ** level // 1)
        sizes.append(min((res + 1) ** 3, 2 ** enc["log2_hashmap_size"]))
    return sum(sizes)


def hash_cost(n: float, enc: dict) -> dict:
    """Operations and bytes of one forward, one backward and one backward
    without dpos at n points: f32 operations counted from csrc/hash_grid.cu per
    (point, level) (corners 25: scale, frac, 1 - frac and the 8 weights; forward
    32 more for the 8 weighted feature pairs; backward 16 for the atomics' terms
    and 16 atomic adds, and with dpos 24 for the corner dot products, 48 for the
    frac gradients and 6 for the level sum); bytes: points, features or their
    gradient, dpos and the table (its f32 gradient) each once; without dpos the
    table is not read."""
    nl = n * enc["n_levels"]
    table = 4 * enc["n_features_per_level"] * hash_table_entries(enc)
    out_dim = enc["n_levels"] * enc["n_features_per_level"]
    return {"fwd": (57 * nl, 12 * n + 4 * out_dim * n + table),
            "bwd": (135 * nl, 12 * n + 4 * out_dim * n + 12 * n + 2 * table),
            "bwd_no_dpos": (57 * nl, 12 * n + 4 * out_dim * n + table)}


def flops_per_iteration(config: dict, traffic: dict) -> float:
    """The model's operations (2 a multiply-add) in one joint iteration of the
    whole window, counted from the shapes without recomputation: the sigma
    MLP's forward and backward (6 n MACs at n field points); its encoding's
    (Fourier: the projection's product forward and its two backward, 18 F a
    point; hash: ``hash_cost``'s forward and backward); the proposal MLP's
    forward at its control points and its forward and backward at the trained
    subset of the samples, with its projection."""
    opt, field = config["optimizer"], config["field"]
    rays = traffic["window"] * opt["n_lidar_samples"]
    n = rays * opt["n_samples_per_ray"]
    total = 6 * n * sigma_macs(field)
    if field["encoding_sigma"] == "fourier":
        total += 18 * field["fourier_sigma"]["n_freqs"] * n
    else:
        cost = hash_cost(n, field["pos_encoding_sigma"])
        total += cost["fwd"][0] + cost["bwd"][0]
    if opt["samples_strategy"] == "PROPOSAL":
        pm, pf = proposal_macs(opt), opt["proposal"]["n_freqs"]
        ctrl = rays * (opt["prop_n_ctrl"] or opt["n_samples_per_ray"] // 2)
        trained = rays * -(-opt["n_samples_per_ray"] // max(int(opt["prop_train_subsample"]), 1))
        total += (2 * pm + 6 * pf) * ctrl + (6 * pm + 18 * pf) * trained
    return float(total)
