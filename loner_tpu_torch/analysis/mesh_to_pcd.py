"""Mesh -> sampled point cloud (map-metrics preprocessing).

Counterpart of ``loner_tpu/analysis/mesh_to_pcd.py``, on the host (numpy):
uniformly samples points on a mesh surface (area-weighted) in batches of at
most 5 M, voxel-downsampling each batch and then the union, each batch drawn
from the next seed; the cloud is what ``evaluate_lidar_map`` consumes.

    python -m loner_tpu_torch.analysis.mesh_to_pcd <mesh.ply> <out.pcd|.npy>
"""
from __future__ import annotations

import numpy as np

from loner_tpu_torch.analysis.mesher import sample_mesh_points
from loner_tpu_torch.analysis.renderer_lidar import write_pcd
from loner_tpu_torch.ops.voxel import voxel_downsample


def read_ply(fname: str):
    """Read ASCII PLY (as written by mesher.write_ply): (verts, faces)."""
    with open(fname) as f:
        lines = f.readlines()
    n_verts = next(int(line.split()[-1]) for line in lines if line.startswith("element vertex"))
    n_faces = next(int(line.split()[-1]) for line in lines if line.startswith("element face"))
    start = next(i for i, line in enumerate(lines) if line.startswith("end_header")) + 1
    verts = np.loadtxt(lines[start : start + n_verts], dtype=np.float32)
    faces = np.asarray(
        [line.split()[1:4] for line in lines[start + n_verts : start + n_verts + n_faces]],
        dtype=np.int64,
    )
    return verts, faces


def mesh_to_pcd(
    mesh_file: str, n_points: int = 50_000_000, voxel_size: float = 0.05, seed: int = 0
) -> np.ndarray:
    verts, faces = read_ply(mesh_file)
    # Sample in manageable batches to bound memory, downsampling as we go.
    batch = min(n_points, 5_000_000)
    clouds = []
    remaining = n_points
    while remaining > 0:
        pts = sample_mesh_points(verts, faces, min(batch, remaining), seed=seed)
        clouds.append(voxel_downsample(pts, voxel_size))
        seed += 1
        remaining -= batch
    return voxel_downsample(np.concatenate(clouds, axis=0), voxel_size)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Sample a mesh into a map cloud")
    p.add_argument("mesh_file")
    p.add_argument("out_file", help=".pcd or .npy")
    p.add_argument("--n_points", type=int, default=50_000_000)
    p.add_argument("--voxel_size", type=float, default=0.05)
    args = p.parse_args()
    pts = mesh_to_pcd(args.mesh_file, args.n_points, args.voxel_size)
    if args.out_file.endswith(".npy"):
        np.save(args.out_file, pts)
    else:
        write_pcd(pts, args.out_file)
    print(f"{pts.shape[0]} points -> {args.out_file}")
