"""The plain reference of the mapper's joint iteration with its camera branch.

Plain PyTorch, eager, and independent of the port: it imports nothing of
``loner_tpu_torch`` (nor JAX, nor the JAX package), only ``plain.py``, whose
LiDAR iteration it extends. Written out again from the configuration file and
the port's camera path (``mapping/rays.py::sample_and_build_camera_rays``,
``mapping/loss.py::compute_camera_loss``, ``models/field.py::query_intensity``,
``models/sh_encoding.py``, ``models/rendering.py::raw2outputs``):

* the draws: ``plain.draw``'s, then the camera's in the port's ``draw_step``
  order: the pixel picks (W, n_camera) and the sampler's jitter (W n_camera, S);
* the camera rays: each picked pixel's camera-frame direction rotated by the
  slot's pose (the twist as a 4 x 4 transform, detached under
  ``detach_rgb_from_poses``) times the LiDAR-to-camera extrinsic, normalised,
  from the camera's centre in the cube; near ``ray_range[0]`` over the scale,
  far the cube's exit; view directions the rays' reverse; a ray is valid where
  its slot is valid and has an image and its origin lies in the cube;
* their samples: the LiDAR rays' proposal sampler, without sigma noise;
* sigma at their points (``plain.sigma_field``), its gradient reaching the
  sigma parameters unless ``detach_rgb_from_sigma``;
* the intensity head: Fourier features [sin, cos, p] of the position in [0, 1]
  (the projection from ``plain.fourier_bmat`` at the intensity's seed) beside
  the degree-``sh_degree`` spherical harmonics of the view direction, a
  bias-free ReLU MLP in the configuration's dtype (its input, weights and hidden
  products rounded, the last product in float32; the backward's cotangents
  rounded, float32 weight gradients) and a sigmoid;
* the colours composited with the LiDAR rays' weights (``plain.composite``), the
  MSE over the valid rays' colours times ``cameraloss_lambda`` added to the
  loss; the unweighted MSE is the step's camera loss;
* Adam on the intensity weights at ``lr_rgb``, decayed by ``lr_gamma`` as the
  sigma and pose rates are.

``lower=True`` is ``plain.py``'s control: float8 e4m3 where bfloat16 is stated,
TF32 operands where float32 is.

Departures from the port's plain path, none of which changes a value the port
computes: the transmittance's product is one ``torch.cumprod`` over all rays
(the port's runs in blocks of 1024 rays, as for the LiDAR rays); the intensity
MLP's backward forms the input's gradient only where autograd asks for it (the
camera points carry no gradient); the Fourier encode has no backward of its own
(nothing differentiates the points). The occupancy-grid sampler at camera rays,
a hash-grid intensity head, Fourier features without the input and the ``xla``
encode or MLP backward are not written out: they raise.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import plain


# -- draws ---------------------------------------------------------------------

def draw(generator: torch.Generator, opt: dict, window: int, device) -> Dict[str, torch.Tensor]:
    """One iteration's draws: ``plain.draw``'s, then the camera branch's."""
    if opt["samples_strategy"] != "PROPOSAL":
        raise NotImplementedError("camera rays behind the " + opt["samples_strategy"] + " sampler")
    out = plain.draw(generator, opt, window, device)
    n = opt["n_camera_samples"]
    shapes = [("cam_u", (window, n))]
    if opt["perturb"] > 0:
        shapes.append(("cam_jitter", (window * n, opt["n_samples_per_ray"])))
    for name, shape in shapes:
        t = torch.empty(shape, device=device)
        t.uniform_(generator=generator)
        out[name] = t
    return out


# -- rays ----------------------------------------------------------------------

def twist_to_matrix(twists: torch.Tensor) -> torch.Tensor:
    """(W, 6) [t, axis-angle] -> (W, 4, 4)."""
    rot = plain.axis_angle_to_matrix(twists[:, 3:])
    top = torch.cat([rot, twists[:, :3, None]], dim=-1)
    bottom = torch.eye(4, dtype=twists.dtype, device=twists.device)[3:].expand(
        twists.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def camera_rays(camera: Dict[str, torch.Tensor], twists: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, ray_range, n_camera: int, slot_valid: torch.Tensor,
                u: torch.Tensor):
    """(rays (B, 11) in cube coordinates, pixel values (B, C), valid (B,)),
    B = W n_camera; ``twists`` as the caller lets the gradient reach them."""
    w = twists.shape[0]
    hw = camera["cam_dirs"].shape[0]
    idx = torch.clamp(torch.floor(u * hw).long(), max=hw - 1)
    dirs_c = camera["cam_dirs"][idx.reshape(-1)].reshape(w, n_camera, 3)
    pixels = torch.gather(camera["intensities"], 1,
                          idx[..., None].expand(w, n_camera, camera["intensities"].shape[-1]))
    cam_mats = twist_to_matrix(twists) @ camera["lidar_to_camera"][None]
    dirs_w = (cam_mats[:, None, :3, :3] * dirs_c[:, :, None, :]).sum(dim=-1)
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    origins = ((cam_mats[:, None, :3, 3] + shift) / scale).expand(dirs_w.shape)
    b = w * n_camera
    origins, dirs_w = origins.reshape(b, 3), dirs_w.reshape(b, 3)
    near = torch.full((b,), ray_range[0], dtype=origins.dtype, device=origins.device) / scale
    far = plain.far_value(origins, dirs_w)
    valid = (slot_valid & camera["has_image"])[:, None].expand(w, n_camera).reshape(b)
    valid = valid & (origins.abs().max(dim=-1).values <= 1.0)
    rays = torch.cat([origins, dirs_w, -dirs_w, near[:, None], far[:, None]], dim=-1)
    return rays, pixels.reshape(b, -1), valid


# -- the intensity head ------------------------------------------------------------

def sh_encode(dirs01: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, 3) directions in [0, 1] -> (N, degree^2) real spherical harmonics,
    the hard-coded expansion of tiny-cuda-nn (degree 1 to 4)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree {degree}")
    d = dirs01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2)]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)


class _BiasFreeMLP(torch.autograd.Function):
    """A bias-free ReLU MLP in ``dtype``: the input, the weights and each hidden
    product rounded, the last product in float32; the backward rounds the
    incoming cotangent and each propagated one to ``dtype`` (the ReLU mask from
    the saved activations) and forms float32 weight gradients."""

    @staticmethod
    def forward(ctx, x, dtype, prec, n, *ws):
        h = prec.reduced(x, dtype)
        acts = [h]
        for i, w in enumerate(ws):
            h = h @ prec.reduced(w, dtype)
            if i < n - 1:
                h = torch.relu(prec.reduced(h, dtype))
                acts.append(h)
        ctx.save_for_backward(*acts, *ws)
        ctx.meta = (dtype, prec, n)
        return h

    @staticmethod
    def backward(ctx, g):
        dtype, prec, n = ctx.meta
        saved = ctx.saved_tensors
        acts, ws = saved[:n], saved[n:]
        dws = [None] * n
        gx = None
        gz = prec.reduced(g, dtype)
        for i in range(n - 1, -1, -1):
            dws[i] = acts[i].t() @ gz
            if i == 0 and not ctx.needs_input_grad[0]:
                break
            gh = prec.reduced(gz @ prec.reduced(ws[i], dtype).t(), dtype)
            if i > 0:
                gz = torch.where(acts[i] > 0, gh, 0.0)
            else:
                gx = gh
        return (gx, None, None, None, *dws)


def intensity(params: Dict[str, torch.Tensor], pos: torch.Tensor, viewdirs: torch.Tensor,
              config: dict, prec: plain.Precision, bmat: torch.Tensor) -> torch.Tensor:
    """Colours (N, C) in (0, 1) at cube points (N, 3) seen along the unit view
    directions (N, 3)."""
    fcfg = config["field"]
    f = fcfg["fourier_intensity"]
    if (fcfg["encoding_intensity"] != "fourier" or not f["include_input"]
            or f["encode_impl"] != "vjp" or fcfg["mlp_grad"] != "vjp"):
        raise NotImplementedError("the intensity head of this configuration")
    dtype = plain.dtype_of(fcfg["compute_dtype"])
    h = plain._fourier_features((pos + 1.0) * 0.5, bmat, dtype, prec)
    if fcfg["enable_view_dependence"]:
        h = torch.cat([h, sh_encode((viewdirs + 1.0) * 0.5, fcfg["sh_degree"])], dim=-1)
    n = sum(1 for k in params if k.startswith("w"))
    return torch.sigmoid(_BiasFreeMLP.apply(h, dtype, prec, n,
                                            *(params[f"w{i}"] for i in range(n))))


# -- the iteration ------------------------------------------------------------------

class PlainCameraTrainer(plain.PlainTrainer):
    """``plain.PlainTrainer`` with the camera branch. ``camera``: the window's
    camera buffers (``cam_dirs`` (H W, 3), ``intensities`` (W, H W, C),
    ``has_image`` (W,), ``lidar_to_camera`` (4, 4)); ``state`` adds
    ``"intensity": {"w0", ...}``. ``camera_losses``: each step's camera MSE."""

    def __init__(self, config: dict, window: Dict[str, torch.Tensor],
                 camera: Dict[str, torch.Tensor], state: Dict, scale: float,
                 lower: bool = False, step0: int = 0) -> None:
        super().__init__(config, window, state, scale, lower=lower, step0=step0)
        for k, v in state["intensity"].items():
            self._leaf(f"intensity.{k}", v, self.opt["lr_rgb"])
            self.moments[f"intensity.{k}"] = (torch.zeros_like(v), torch.zeros_like(v))
        self.camera = camera
        f = config["field"]["fourier_intensity"]
        self.intensity_bmat = plain.fourier_bmat(config, f["seed"], f["n_freqs"], f["scale"]).to(
            window["dirs"].device)
        self.camera_losses = []
        self._camera_mse = None

    def camera_mse(self, d: Dict[str, torch.Tensor]) -> torch.Tensor:
        opt, prec = self.opt, self.prec
        twists = self.leaves["twists"]
        if opt["detach_rgb_from_poses"]:
            twists = twists.detach()
        rays, pixels, valid = camera_rays(self.camera, twists, self.scale, self.shift,
                                          opt["ray_range"], opt["n_camera_samples"],
                                          self.window["slot_valid"], d["cam_u"])
        s = opt["n_samples_per_ray"]
        prop = {k.split(".", 1)[1]: v for k, v in self.leaves.items() if k.startswith("proposal.")}
        prop["bmat"] = self.prop_bmat
        z = plain.proposal_samples(rays, s, opt["perturb"], prop, opt["prop_n_ctrl"] or s // 2,
                                   d.get("cam_jitter"), prec)
        o, dirs, far = rays[:, 0:3], rays[:, 3:6], rays[:, 10:11]
        pts = (o[:, None, :] + dirs[:, None, :] * z[..., None]).reshape(-1, 3)
        viewdirs = rays[:, None, 6:9].expand(rays.shape[0], s, 3).reshape(-1, 3)
        sigma = {k.split(".", 1)[1]: v.detach() if opt["detach_rgb_from_sigma"] else v
                 for k, v in self.leaves.items() if k.startswith("sigma.")}
        raw = plain.sigma_field(sigma, pts, self.config, prec, self.bmat)
        head = {k.split(".", 1)[1]: v for k, v in self.leaves.items()
                if k.startswith("intensity.")}
        colours = intensity(head, pts, viewdirs, self.config, prec, self.intensity_bmat)
        softplus = self.config["field"]["density_activation"] == "softplus"
        _, weights, _ = plain.composite(raw.reshape(rays.shape[0], s, 1), z, dirs, None, 0.0,
                                        softplus, far)
        rgb = (weights[..., None] * colours.reshape(rays.shape[0], s, -1)).sum(dim=-2)
        err = (rgb - pixels) ** 2
        return plain.masked_mean(err, valid[:, None].expand(err.shape))

    def loss(self, d: Dict[str, torch.Tensor]):
        total, mapping, aux = super().loss(d)
        self._camera_mse = self.camera_mse(d)
        return total + self.opt["cameraloss_lambda"] * self._camera_mse, mapping, aux

    def step(self, d: Dict[str, torch.Tensor]) -> float:
        mapping = super().step(d)
        self.camera_losses.append(float(self._camera_mse.detach()))
        return mapping
