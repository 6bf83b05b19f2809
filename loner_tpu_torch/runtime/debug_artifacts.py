"""Debug dumps: point clouds, rays, loss curves and loss plots.

Counterpart of ``loner_tpu/runtime/debug_artifacts.py``, writing the same files
under the same names: the tracker's frame clouds (``write_frame_point_clouds``),
one sampled ray batch a keyframe (``write_ray_point_clouds``), per-phase loss
CSVs (``log_losses``), the per-iteration ray record of ``store_ray``,
``draw_samples`` and ``draw_rays_eps`` (``IterationRayRecordDumper``) and one
ray's weight plot (``visualize_loss``, drawn by ``analysis/raster_plot.py``).
The writers are numpy and ASCII; given the same arrays, every file is the JAX
package's byte for byte.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from loner_tpu_torch.analysis.renderer_lidar import write_pcd


def write_pcd_xyz(points: np.ndarray, fname: str) -> None:
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    write_pcd(np.asarray(points, np.float32).reshape(-1, 3), fname)


def write_pcd_xyz_intensity(points: np.ndarray, intensity: np.ndarray, fname: str) -> None:
    """ASCII PCD with an intensity column."""
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    inten = np.asarray(intensity, np.float32).reshape(-1, 1)
    data = np.hstack([pts, inten])
    with open(fname, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n")
        f.write("TYPE F F F F\nCOUNT 1 1 1 1\n")
        f.write(f"WIDTH {data.shape[0]}\nHEIGHT 1\n")
        f.write("VIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {data.shape[0]}\nDATA ascii\n")
        np.savetxt(f, data, fmt="%.6f")


def rays_to_points(rays: np.ndarray, depths: np.ndarray, world_cube=None) -> np.ndarray:
    """Rays in the LONER layout (origin, direction, ...) and depths -> end points,
    in world meters when ``world_cube`` is given."""
    origins, dirs = rays[:, :3], rays[:, 3:6]
    pts = origins + dirs * depths[:, None]
    if world_cube is not None:
        pts = pts * world_cube.scale_factor - world_cube.shift
    return pts


def dump_frame_point_cloud(frame, log_directory: str, frame_idx: int) -> None:
    """A tracked frame's cloud as ``frames/cloud_<i>.pcd``, and its sky
    directions at 100 m as ``cloud_<i>_sky.pcd`` when it has any."""
    pts = frame.build_point_cloud()
    write_pcd_xyz(pts, os.path.join(log_directory, "frames", f"cloud_{frame_idx}.pcd"))
    if frame.lidar_points.sky_rays is not None and frame.lidar_points.sky_rays.size:
        sky = frame.lidar_points.get_sky_scan(100.0)
        write_pcd_xyz(sky.end_points(),
                      os.path.join(log_directory, "frames", f"cloud_{frame_idx}_sky.pcd"))


def dump_ray_point_cloud(rays: np.ndarray, depths: np.ndarray, log_directory: str, tag: str,
                         world_cube=None) -> None:
    """One ray batch's end points and origins, ``rays/<tag>_{rays,origins}.pcd``."""
    pts = rays_to_points(rays, depths, world_cube)
    write_pcd_xyz(pts, os.path.join(log_directory, "rays", f"{tag}_rays.pcd"))
    write_pcd_xyz(rays[:, :3], os.path.join(log_directory, "rays", f"{tag}_origins.pcd"))


class IterationRayRecordDumper:
    """The per-iteration ray record of one keyframe's optimisation, streamed.

    * ``store_ray``: the sampled rays of every iteration -> ``rays/lidar/kf_<k>.pcd``,
      with per-ray sky and current-keyframe masks and the std / JS records as
      ``rays/{sky_mask,curr_mask,std,js}/kf_<k>.npy``, written by ``finish``.
    * ``draw_samples``: each iteration's sample points whose predicted (target)
      weight exceeds 1e-5 -> ``samples/samples_kf<k>_it<i>[_gt].pcd``.
    * ``draw_rays_eps``: each iteration's ray end points with their dynamic
      margin over its largest value -> ``rays_eps/{rays,origins}_kf<k>_it<i>.pcd``.

    ``append`` takes one dispatch's record (arrays with a leading iteration
    axis) and writes the per-iteration files at once, keeping only the small
    ``store_ray`` fields until ``finish``. Iterations are numbered across the
    keyframe's phases.
    """

    def __init__(self, log_directory: str, keyframe_count: int, n_lidar: int, n_sky: int,
                 window_slots: int, num_kfs: int, world_scale: float, world_shift: np.ndarray,
                 eps_min: float, js_alpha: float, max_js_score: float, store_ray: bool = False,
                 draw_samples: bool = False, draw_rays_eps: bool = False) -> None:
        self._dir = log_directory
        self._kf = keyframe_count
        self._n_lidar = n_lidar
        self._n_sky = n_sky
        self._num_kfs = num_kfs
        self._scale = world_scale
        self._shift = world_shift
        self._eps_max = eps_min * (1.0 + js_alpha * max_js_score) + 1e-5
        self._store_ray = store_ray
        self._draw_samples = draw_samples
        self._draw_rays_eps = draw_rays_eps
        self._it = 0
        self._ray_acc: list = []  # (rays, depths, std, js, valid) of each dispatch

    def append(self, rec: dict) -> None:
        rays = np.asarray(rec["rays"])  # (T, B, 11)
        depths = np.asarray(rec["depths_cube"])
        valid = np.asarray(rec["valid"]).astype(bool)
        t = depths.shape[0]
        if self._store_ray:
            self._ray_acc.append((rays, depths, np.asarray(rec["std"]), np.asarray(rec["js"]),
                                  valid))
        if self._draw_samples and "points" in rec:
            points = np.asarray(rec["points"])  # (T, B, S, 3)
            w_pred, w_gt = np.asarray(rec["w_pred"]), np.asarray(rec["w_gt"])  # (T, B, S)
            samples_dir = os.path.join(self._dir, "samples")
            for i in range(t):
                pts_w = points[i].reshape(-1, 3) * self._scale - self._shift
                for suffix, w in (("", w_pred[i].reshape(-1)), ("_gt", w_gt[i].reshape(-1))):
                    keep = w > 1e-5
                    write_pcd_xyz_intensity(pts_w[keep], w[keep], os.path.join(
                        samples_dir, f"samples_kf{self._kf}_it{self._it + i}{suffix}.pcd"))
        if self._draw_rays_eps and "per_ray_eps" in rec:
            eps = np.asarray(rec["per_ray_eps"])  # (T, B)
            rays_eps_dir = os.path.join(self._dir, "rays_eps")
            for i in range(t):
                v = valid[i]
                pts = rays_to_points(rays[i, v], depths[i, v]) * self._scale - self._shift
                write_pcd_xyz_intensity(pts, eps[i, v] / self._eps_max, os.path.join(
                    rays_eps_dir, f"rays_kf{self._kf}_it{self._it + i}.pcd"))
                write_pcd_xyz(rays[i, v, :3] * self._scale - self._shift, os.path.join(
                    rays_eps_dir, f"origins_kf{self._kf}_it{self._it + i}.pcd"))
        self._it += t

    def finish(self) -> None:
        if not self._store_ray or not self._ray_acc:
            return
        rays, depths, std, js, valid = (np.concatenate(parts) for parts in zip(*self._ray_acc))
        t, b = depths.shape
        # The batch: window_slots chunks of (n_lidar + n_sky) rays.
        per_slot = self._n_lidar + self._n_sky
        slot, in_slot = np.arange(b) // per_slot, np.arange(b) % per_slot
        sky_mask = np.broadcast_to(in_slot >= self._n_lidar, (t, b))
        curr_mask = np.broadcast_to(slot == self._num_kfs - 1, (t, b))
        v = valid.reshape(-1)
        pts = rays_to_points(rays.reshape(-1, 11)[v], depths.reshape(-1)[v])
        write_pcd_xyz(pts * self._scale - self._shift,
                      os.path.join(self._dir, "rays", "lidar", f"kf_{self._kf}.pcd"))
        for name, arr in (("sky_mask", sky_mask), ("curr_mask", curr_mask), ("std", std),
                          ("js", js)):
            d = os.path.join(self._dir, "rays", name)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"kf_{self._kf}.npy"), arr.reshape(-1)[v])


def dump_iteration_ray_record(extras_log: list, *args, **kwargs) -> None:
    """``IterationRayRecordDumper`` over a list of records already held."""
    dumper = IterationRayRecordDumper(*args, **kwargs)
    for rec in extras_log:
        dumper.append(rec)
    dumper.finish()


def log_losses(losses: np.ndarray, depth_eps: np.ndarray, log_directory: str,
               keyframe_count: int, phase_idx: int) -> None:
    """One phase's losses and mean margins, ``{losses,depth_eps}/keyframe_<k>/phase_<n>.csv``."""
    for name, values in (("losses", losses), ("depth_eps", depth_eps)):
        d = os.path.join(log_directory, name, f"keyframe_{keyframe_count}")
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, f"phase_{phase_idx}.csv"), np.asarray(values))


# visualize_loss's series, in its drawing order: (label, colour, style).
LOSS_SERIES = (("LOS target (eps={eps:.2f})", "#ef8600", "line"),
               ("goal (eps_min)", "#00b050", "line"),
               ("predicted weights", "#0070c0", "."),
               ("target weights", "#7d2dc8", "x"))


def visualize_loss(z_vals_m: np.ndarray, weights_pred: np.ndarray, weights_gt: np.ndarray,
                   depth_gt_m: float, eps: float, eps_min: float, log_directory: str,
                   global_step: int, ray_idx: int = 0) -> Optional[str]:
    """One ray's predicted and target weights against the Gaussian target at
    ``eps`` and at ``eps_min``, as ``viz_loss/iter_<step>.png``. The labels, colours
    and data of each series are in the PNG's text chunks (``raster_plot``)."""
    from scipy.stats import norm

    from loner_tpu_torch.analysis.raster_plot import Series, render_plot

    x = np.asarray(z_vals_m[ray_idx])
    y = np.asarray(weights_pred[ray_idx])
    x_axis = np.linspace(x.min(), x.max(), 400)

    def normed(pdf):
        m = pdf.max()
        return pdf / m if m > 1 else pdf

    data = ((x_axis, normed(norm.pdf(x_axis, depth_gt_m, eps))),
            (x_axis, normed(norm.pdf(x_axis, depth_gt_m, eps_min))),
            (x, y), (x, np.asarray(weights_gt[ray_idx])))
    series = [Series(label.format(eps=eps), color, sx, sy, style,
                     width=3 if n == 0 else 2)
              for n, ((label, color, style), (sx, sy)) in enumerate(zip(LOSS_SERIES, data))]
    out_dir = os.path.join(log_directory, "viz_loss")
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"iter_{global_step}.png")
    render_plot(series, fname, size=(1000, 600), ylim=(0.0, 1.0), vlines=(depth_gt_m,),
                xlabel="Dist. (m)", ylabel="Weight")
    return fname
