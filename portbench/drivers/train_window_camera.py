"""The mapper's joint phase with its camera branch, on a window drawn from the
seed (traffic ``train_window_camera``).

``train_window``'s window, start, phases, trace and check (its ``Session`` and
``measure``), in a phase that trains the intensity head from camera rays: the
program holds static camera buffers (``mapping/rays.py::CameraWindowBuffers``),
the pixel directions and the LiDAR-to-camera extrinsic computed from the
configuration's ``camera`` calibration, and one image a slot whose pixels are
uniform in ``image_range``, drawn on the device from the seed's own stream
(``subseed(seed, 2)``), so that a seed's LiDAR window and start are
``train_window``'s; the intensity head's weights are He-uniform from that stream
too. ``train_rays_per_s`` stays the LiDAR rays of the window's iterations over
its seconds: the camera branch shows as fewer iterations a second.

The check compares every trained leaf, the intensity head's among them
(``intensity.w<i>``), by ``reference/compare.py``'s readings against
``reference/plain_camera.py``, and adds one reading of its own,
``camera_loss_gap``: ``loss_gap``'s formula over the steps' camera MSE.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import costs_camera, portcfg
from portbench.drivers.train_window import (
    Session, first_gradient, flat_start, he_uniform, measure, program_leaves, returned_leaves,
)
from portbench.harness import Outcome, Run, subseed
from portbench.reference import plain_camera

CAMERA_FIELDS = ("cam_dirs", "intensities", "has_image", "lidar_to_camera")
CAMERA_STREAM = 2  # subseed stream of the images and the intensity weights


def camera_loss_gap(program: List[float], reference: List[float]) -> float:
    """``compare.readings``' ``loss_gap`` over the steps' camera MSE."""
    if len(program) != len(reference):
        raise ValueError(f"{len(program)} program camera losses, {len(reference)} reference")
    return max(abs(a - b) / abs(b) for a, b in zip(program, reference))


def intensity_leaves(head: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"intensity.{k}": v for k, v in head.items()}


class CameraSession(Session):
    """``Session`` whose program trains the camera branch from the window's
    static camera buffers (``camera``), seated with the window."""

    def __init__(self, config: dict, traffic: dict, device) -> None:
        super().__init__(config, traffic, device)
        from loner_tpu_torch.common.camera import get_ray_directions
        from loner_tpu_torch.common.pose import Pose
        from loner_tpu_torch.mapping.optimizer import make_phase_runner
        from loner_tpu_torch.mapping.rays import CameraWindowBuffers

        cal = config["camera"]
        dirs, _, _ = get_ray_directions(int(cal["height"]), int(cal["width"]),
                                        np.asarray(cal["k"], np.float64))
        l2c = np.asarray(Pose.from_settings(cal["lidar_to_camera"]).matrix, np.float32)
        dev, colours = self.dev, int(config["field"]["num_colors"])
        self.camera = CameraWindowBuffers(
            torch.from_numpy(dirs).to(dev), torch.zeros((self.w, dirs.shape[0], colours), device=dev),
            torch.zeros((self.w,), dtype=torch.bool, device=dev), torch.from_numpy(l2c).to(dev))
        _, field_cfg, _ = portcfg.build(config)
        self.prog = make_phase_runner(self.cfg, field_cfg, self.phase, self.w,
                                      traffic["points_per_slot"], traffic["sky_pad"], dev,
                                      window=self.local, camera=self.camera)
        self.camera_losses: Dict[str, List[float]] = {}

    def seat(self, seed: int) -> None:
        super().seat(seed)
        gen = torch.Generator(device=self.dev).manual_seed(subseed(seed, CAMERA_STREAM))
        lo, hi = self.traffic["image_range"]
        with torch.no_grad():
            pixels = self.camera.intensities
            pixels.copy_(torch.rand(pixels.shape, generator=gen, device=self.dev) * (hi - lo) + lo)
            self.camera.has_image.fill_(True)
        dims = costs_camera.intensity_dims(self.config["field"])
        self.start["intensity"] = {f"w{i}": w for i, w in enumerate(he_uniform(gen, dims, self.dev))}
        self.state[0]["intensity"] = {"mlp": dict(self.start["intensity"])}

    def warm_up(self) -> None:
        self.prog.warm_up(*self.state, *self.common, self.gen, camera=self.camera)

    def phase_call(self, step0: int, num_iterations=None):
        return self.prog(*self.state, *self.common, step0, self.gen,
                         num_iterations=num_iterations, camera=self.camera)

    def flat_start(self) -> Dict[str, torch.Tensor]:
        return {**flat_start(self.start), **intensity_leaves(self.start["intensity"])}

    def program_steps(self, draw_seed: int, n_steps: int) -> dict:
        """``Session.program_steps`` with the intensity leaves and the steps'
        camera losses."""
        self.gen.manual_seed(draw_seed)
        self.phase_call(0, 1)
        leaves = {**program_leaves(self.prog), **intensity_leaves(self.prog.intensity["mlp"])}
        grads = {k: first_gradient(self.prog.adam, v) for k, v in leaves.items()}
        self.gen.manual_seed(draw_seed)
        field, occ, twists, losses, _ = self.phase_call(0, n_steps)
        camera_losses = [float(x) for x in self.prog.last_camera_losses.tolist()]
        self.camera_losses["program"] = camera_losses
        return {"losses": [float(x) for x in losses.tolist()], "grads": grads,
                "start": self.flat_start(), "camera_losses": camera_losses,
                "end": {**returned_leaves(field, occ, twists),
                        **intensity_leaves(field["intensity"]["mlp"])}}

    def reference_steps(self, draw_seed: int, n_steps: int, lower: bool = False) -> dict:
        """The plain reference with the camera branch from the same start and
        draws (``lower``: the control's precision)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        camera = {name: getattr(self.camera, name) for name in CAMERA_FIELDS}
        trainer = plain_camera.PlainCameraTrainer(
            self.config, self.window, camera, self.start, float(self.traffic["world_scale_m"]),
            lower=lower, step0=0)
        gen = torch.Generator(device=self.dev).manual_seed(draw_seed)
        opt = self.config["optimizer"]
        losses = [trainer.step(plain_camera.draw(gen, opt, self.w, self.dev))
                  for _ in range(n_steps)]
        if not lower:
            self.camera_losses["reference"] = trainer.camera_losses
        return {"losses": losses, "grads": trainer.first_grads, "start": self.flat_start(),
                "end": trainer.state(), "camera_losses": trainer.camera_losses}


def camera_counts(iterations: int) -> Dict[str, Any]:
    """The port's camera counters an iteration while tracing (None where the
    port has none)."""
    from loner_tpu_torch.runtime import profiling

    counted = profiling.counters(traced=True)
    return {name: (counted[name] / iterations if name in counted and iterations else None)
            for name in ("camera.rays", "camera.points")}


def drive(run: Run) -> Outcome:
    marks = {"imports": time.perf_counter() - run.t_start}
    s = CameraSession(run.config, run.traffic, run.device)
    outcome = measure(run, s, marks)
    gap = camera_loss_gap(s.camera_losses["program"], s.camera_losses["reference"])
    if "camera_loss_gap" in run.limits:
        outcome.compared.append(("camera_loss_gap", gap, float(run.limits["camera_loss_gap"])))
    else:
        outcome.layer["not_compared"]["camera_loss_gap"] = gap
    outcome.layer["losses"].update({"camera_program": s.camera_losses["program"],
                                    "camera_reference": s.camera_losses["reference"]})
    if run.trace:
        print("camera counters an iteration: "
              + str(camera_counts(outcome.layer.get("traced_iterations", 0))), file=sys.stderr)
    return outcome
