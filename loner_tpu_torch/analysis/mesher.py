"""Mesher: extract a triangle mesh from the trained field.

Counterpart of ``loner_tpu/analysis/mesher.py``: not SDF marching. Virtual
scans are rendered from every ``skip_step``-th keyframe pose, each ray's
per-sample rendering weights are splatted into a uniform grid with a max-reduce
(``scatter_reduce_``), and marching tetrahedra (``ops/marching.py``) run at
``level`` on that weight grid, rescaled out of the world cube. The grid, the
splat and the marching stay on the model's device; the vertices come to the host
for the back-mapping and the PLY file.

    python -m loner_tpu_torch.analysis.mesher <experiment_directory> [--device cpu]
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.render_utils import LoadedModel, kf_pose_matrices, load_experiment
from loner_tpu_torch.analysis.renderer_lidar import build_lidar_ray_directions
from loner_tpu_torch.mapping.rays import get_far_val
from loner_tpu_torch.models.rendering import pack_rays
from loner_tpu_torch.ops.marching import marching_tetrahedra


def splat_weights_max(
    grid: torch.Tensor,  # (V, V, V), updated in place
    points: torch.Tensor,  # (N, 3) in cube coords
    weights: torch.Tensor,  # (N,)
    lo: torch.Tensor,  # (3,) grid lower corner, cube coords
    hi: torch.Tensor,  # (3,) grid upper corner, cube coords
) -> torch.Tensor:
    """Max-reduce sample weights into the voxel grid, in place; returns the grid.
    Samples outside [lo, hi] clamp onto the boundary cells."""
    v = grid.shape[0]
    frac = (points - lo) / (hi - lo)
    ijk = torch.clamp((frac * v).to(torch.int32), 0, v - 1).to(torch.int64)
    flat = ijk[:, 0] * v * v + ijk[:, 1] * v + ijk[:, 2]
    grid.view(-1).scatter_reduce_(0, flat, weights, "amax", include_self=True)
    return grid


def build_weight_grid(
    model: LoadedModel,
    pose_mats: np.ndarray,
    ray_range: Tuple[float, float],
    resolution: int = 256,
    n_samples: int = 512,
    num_channels: int = 64,
    num_columns: int = 512,
    chunk: int = 8192,
    vertical_fov: Tuple[float, float] = (-22.5, 22.5),
    bound: Optional[np.ndarray] = None,  # (2, 3) lo/hi in cube coords
) -> torch.Tensor:
    """The (resolution,)^3 max-splatted weight grid, on the model's device."""
    from loner_tpu_torch.analysis._render_impl import get_chunk_renderer

    cube, dev = model.world_cube, model.device
    if bound is None:
        bound = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    lo = torch.tensor(bound[0], dtype=torch.float32, device=dev)
    hi = torch.tensor(bound[1], dtype=torch.float32, device=dev)
    render_chunk = get_chunk_renderer(model, n_samples, ret_var=False, use_occ=True)
    dirs_sensor = build_lidar_ray_directions(num_channels, num_columns, vertical_fov)
    grid = torch.zeros((resolution,) * 3, dtype=torch.float32, device=dev)

    with torch.inference_mode():
        for pose in pose_mats:
            dirs_world = torch.from_numpy((dirs_sensor @ pose[:3, :3].T).astype(np.float32)).to(dev)
            o_cube = torch.tensor(cube.to_cube(pose[:3, 3]), dtype=torch.float32, device=dev)
            for i in range(0, dirs_world.shape[0], chunk):
                d = dirs_world[i : i + chunk]
                o = o_cube.expand(d.shape)
                near = torch.full((d.shape[0],), ray_range[0] / cube.scale_factor,
                                  dtype=torch.float32, device=dev)
                far = torch.clamp(get_far_val(o, d), max=ray_range[1] / cube.scale_factor)
                out = render_chunk(pack_rays(o, d, near, far), model.field_params, model.occ_grid)
                splat_weights_max(grid, out["points"].reshape(-1, 3), out["weights"].reshape(-1),
                                  lo, hi)
    return grid


def mesh_bound(model: LoadedModel) -> np.ndarray:
    """(2, 3) lo/hi of the marching grid in cube coords: the sequence config's
    ``meshing_bounding_box`` (world meters) clipped to the cube, else the cube."""
    bbox = model.settings.get("meshing_bounding_box")
    if bbox is None:
        return np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    lo_w = np.array([bbox["x"][0], bbox["y"][0], bbox["z"][0]], np.float32)
    hi_w = np.array([bbox["x"][1], bbox["y"][1], bbox["z"][1]], np.float32)
    bound = np.stack([model.world_cube.to_cube(lo_w), model.world_cube.to_cube(hi_w)])
    # Stay inside the cube: the field is untrained outside it.
    return np.clip(bound.astype(np.float32), -1.0, 1.0)


def get_mesh(
    log_dir: str,
    ckpt_name: str = "final.tar",
    resolution: int = 256,
    level: float = 0.1,
    skip_step: int = 4,
    use_gt_poses: bool = False,
    out_file: Optional[str] = None,
    vertical_fov: Optional[Tuple[float, float]] = None,
    device: Union[torch.device, str, None] = None,
    model: Optional[LoadedModel] = None,
    report: Optional[dict] = None,
):
    """Extract and save the mesh as .ply; returns (verts, faces) as numpy arrays.

    The virtual-scan vertical FOV defaults to the experiment config's
    ``lidar_vertical_fov``. ``device`` defaults to ``cuda`` and raises without a
    card (pass ``device="cpu"``). ``model`` meshes an already loaded model of
    ``log_dir`` instead of loading the checkpoint; ``report``, when given,
    receives the seconds of the weight grid and of the marching, the grid's
    largest weight and its count of cells above ``level``."""
    if model is None:
        model = load_experiment(log_dir, ckpt_name, device=device)
    mats, _ = kf_pose_matrices(model, use_gt=use_gt_poses)
    ray_range = tuple(
        float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"])
    if vertical_fov is None:
        vertical_fov = tuple(
            float(x) for x in model.settings.get("lidar_vertical_fov", (-22.5, 22.5)))
    bound = mesh_bound(model)
    t0 = time.perf_counter()
    grid = build_weight_grid(model, mats[::skip_step], ray_range, resolution=resolution,
                             vertical_fov=vertical_fov, bound=bound)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    t1 = time.perf_counter()
    verts, faces = marching_tetrahedra(grid, level)
    verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
    if report is not None:
        report.update(weight_grid_s=t1 - t0, marching_s=time.perf_counter() - t1,
                      grid_max=float(grid.max()), cells_above_level=int((grid > level).sum()))
    # Grid index -> cube coords -> world meters.
    verts = bound[0] + (verts / resolution) * (bound[1] - bound[0])
    verts = model.world_cube.from_cube(verts)

    out_file = out_file or os.path.join(log_dir, "meshing", "mesh.ply")
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    write_ply(verts, faces, out_file)
    return verts, faces


def write_ply(verts: np.ndarray, faces: np.ndarray, fname: str) -> None:
    with open(fname, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        np.savetxt(f, verts, fmt="%.6f")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply_vertices(fname: str) -> np.ndarray:
    with open(fname) as f:
        lines = f.readlines()
    n_verts = next(int(line.split()[-1]) for line in lines if line.startswith("element vertex"))
    start = next(i for i, line in enumerate(lines) if line.startswith("end_header")) + 1
    return np.loadtxt(lines[start : start + n_verts], dtype=np.float32)


def sample_mesh_points(
    verts: np.ndarray, faces: np.ndarray, n_points: int, seed: int = 0
) -> np.ndarray:
    """Uniform, area-weighted surface sampling on the host; numpy's
    ``default_rng(seed)`` draws the same points as the JAX package's."""
    rng = np.random.default_rng(seed)
    tri = verts[faces]  # (F, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    probs = areas / areas.sum()
    face_idx = rng.choice(len(faces), n_points, p=probs)
    u, v = rng.uniform(size=(2, n_points))
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[face_idx]
    return (
        t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (t[:, 2] - t[:, 0])
    ).astype(np.float32)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Marching-tetrahedra mesh from a checkpoint")
    p.add_argument("experiment_directory")
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--level", type=float, default=0.1)
    p.add_argument("--skip_step", type=int, default=4)
    p.add_argument("--use_gt_poses", action="store_true")
    p.add_argument(
        "--vertical_fov", type=float, nargs=2, default=None,
        help="virtual-scan vertical FOV in degrees "
        "(default: the experiment config's lidar_vertical_fov)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    verts, faces = get_mesh(
        args.experiment_directory,
        ckpt,
        resolution=args.resolution,
        level=args.level,
        skip_step=args.skip_step,
        use_gt_poses=args.use_gt_poses,
        vertical_fov=args.vertical_fov,
        device=args.device,
    )
    print(f"mesh: {len(verts)} vertices, {len(faces)} faces")
