"""The port's camera data path and YAML reader against the JAX package's.

- ``common/yaml_lite.py``: every file under ``cfg/`` loads equal (values and
  types, alias objects shared) to PyYAML's SafeLoader with ``!include``
  resolved relative to the file; what it does not read raises with the file
  and line.
- ``sh_encode`` at degrees 1-4: f32, 1e-6 (the same polynomials in one order).
- ``common/camera.py``: the cases of ``tests/test_camera.py`` (undistortion,
  principal ray, rays in the cube) on the port, and its pixel directions, its
  undistortion and its rays equal to JAX's (f32 rays atol 1e-6).
- ``VirtualCamera.render``: bit-equal images for the same scene and poses.
- Images written by one package's ``ScanStreamWriter`` read by the other's
  reader, bit-equal, with their timestamps.
- Frame synthesis in camera mode: the three matching cases of
  ``tests/test_camera_pipeline.py``.
- ``sample_and_build_camera_rays`` on JAX's pixel draws: rays, intensities and
  masks (atol 1e-6 on cube coordinates), and with poses attached the twist
  gradient (1e-5 of scale); detached, none.
"""
import glob
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from loner_tpu.common import camera as jcam
from loner_tpu.common.pose import Pose as JPose
from loner_tpu.common.sensors import Image as JImage, LidarScan as JScan
from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.datasets import scan_stream as jss
from loner_tpu.datasets import synthetic as jsyn
from loner_tpu.mapping import rays as jrays
from loner_tpu.models.sh_encoding import sh_encode as jsh
from loner_tpu.tracking.frame_synthesis import FrameSynthesis as JFrameSynthesis
from loner_tpu_torch.common import camera as tcam
from loner_tpu_torch.common import yaml_lite
from loner_tpu_torch.common.pose import Pose as TPose
from loner_tpu_torch.common.sensors import Image as TImage, LidarScan as TScan
from loner_tpu_torch.common.settings import Settings as TSettings, load_config
from loner_tpu_torch.common.world_cube import WorldCube as TCube
from loner_tpu_torch.datasets import scan_stream as tss
from loner_tpu_torch.datasets import synthetic as tsyn
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.models.sh_encoding import sh_encode as tsh
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis as TFrameSynthesis

REPO = Path(__file__).resolve().parents[1]
CFG_FILES = sorted(glob.glob(str(REPO / "cfg" / "**" / "*.yaml"), recursive=True))
K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])


# -- the YAML reader ------------------------------------------------------------

def _pyyaml_load(path: str):
    class IncludeLoader(yaml.SafeLoader):
        pass

    def include(loader, node):
        root = os.path.dirname(getattr(loader.stream, "name", "."))
        return _pyyaml_load(os.path.join(root, loader.construct_scalar(node)))

    IncludeLoader.add_constructor("!include", include)
    with open(path) as f:
        return yaml.load(f, IncludeLoader)


def _same(a, b) -> bool:
    """Equal values of equal types (True is not 1, 1.0 is not 1)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_cfg_holds_the_files_this_reader_is_held_to():
    assert len(CFG_FILES) >= 30
    assert str(REPO / "cfg/synthetic/box_room_camera.yaml") in CFG_FILES


@pytest.mark.parametrize("path", CFG_FILES, ids=lambda p: os.path.relpath(p, REPO / "cfg"))
def test_yaml_reader_loads_every_cfg_file_as_pyyaml(path):
    assert _same(yaml_lite.load_file(path), _pyyaml_load(path))


def test_yaml_reader_scalars_flows_and_aliases_as_pyyaml():
    text = """
a: &x {k: [1, 2.5, [3, "s"]], e: 1e-3, f: 1.e-3, g: .inf, h: -.5, i: -0, j: .nan}
b: *x
c:
- ~
- null
- TRUE
- false
- 'it''s'
- "tab\\there"
- - 1
  - 2
- k: v
  l: [ ]
d: -1_000
"""
    ours, theirs = yaml_lite.loads(text), yaml.safe_load(text)
    assert _same(ours, theirs)
    assert ours["a"] is ours["b"]
    assert ours["a"]["e"] == "1e-3" and ours["a"]["f"] == 0.001


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: |\n  text\n", 2),
    ("a: 1\nb: !!str 3\n", 2),
    ("a:\n  <<: {x: 1}\n", 2),
    ("a: 1\nb: [1,\n  2\n", 2),
    ("a: x\n  y\n", 2),
    ("a: 1\n\tb: 2\n", 2),
    ("---\na: 1\n", 1),
    ("a: *nope\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a: 1\nb: yes\n", 2),
    ("a: [0x1f]\n", 1),
    ("a: 017\n", 1),
])
def test_yaml_reader_raises_on_what_it_does_not_read(text, line):
    with pytest.raises(yaml_lite.YamlError, match=rf"^cfg\.yaml:{line}: "):
        yaml_lite.loads(text, "cfg.yaml")


def test_load_config_reads_camera_configs_from_cfg():
    for name in ("box_room_camera.yaml", "box_room_tpu_camera_r5.yaml"):
        settings, dataset = load_config(str(REPO / "cfg/synthetic" / name))
        assert settings.system.lidar_only is False
        assert settings.mapper.optimizer.num_samples.camera == 128
        assert settings.calibration.camera_intrinsic.width == 96
        assert settings.calibration.camera_intrinsic.k[0] == [68.5511043236215, 0.0, 48.0]
        assert dataset.startswith("./outputs/")


# -- SH encoding, camera geometry ------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    d = np.random.default_rng(degree).normal(size=(257, 3))
    d01 = ((d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5).astype(np.float32)
    out_t = tsh(torch.from_numpy(d01), degree).numpy()
    out_j = np.asarray(jsh(jnp.asarray(d01), degree))
    assert out_t.shape == (257, degree ** 2)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)


def test_undistort_identity_and_inverse():
    pts = np.array([[100.0, 50.0], [320.0, 240.0]])
    np.testing.assert_allclose(tcam.undistort_points(pts, K, np.zeros(5)), pts, atol=1e-9)
    dist = np.array([-0.2, 0.05, 0.001, -0.002, 0.0])
    k1, k2, p1, p2, _ = dist
    x, y = 0.3, -0.2
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    pix = np.array([[xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]]])
    out = tcam.undistort_points(pix, K, dist)
    norm = np.array([(out[0, 0] - K[0, 2]) / K[0, 0], (out[0, 1] - K[1, 2]) / K[1, 1]])
    np.testing.assert_allclose(norm, [x, y], atol=1e-6)
    grid = np.random.default_rng(0).uniform(0, 480, (64, 2))
    np.testing.assert_array_equal(tcam.undistort_points(grid, K, dist, new_k=K * 0.9),
                                  jcam.undistort_points(grid, K, dist, new_k=K * 0.9))


@pytest.mark.parametrize("dist", [None, np.array([-0.2, 0.05, 0.001, -0.002, 0.01])])
def test_ray_directions_match_jax(dist):
    out_t = tcam.get_ray_directions(48, 64, K * 0.1 + np.diag([0, 0, 0.9]), dist, k=K * 0.1 +
                                    np.diag([0, 0, 0.9]))
    out_j = jcam.get_ray_directions(48, 64, K * 0.1 + np.diag([0, 0, 0.9]), dist, k=K * 0.1 +
                                    np.diag([0, 0, 0.9]))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    dirs, _, _ = tcam.get_ray_directions(480, 640, K)
    np.testing.assert_allclose(dirs[240 * 640 + 320], [0, 0, 1], atol=1e-6)


def test_build_rays_in_cube_matches_jax():
    intr = {"k": K, "new_k": None, "distortion": None, "width": 64, "height": 48}
    crd_t = tcam.CameraRayDirections(TSettings({"camera_intrinsic": intr}), chunk_size=512)
    crd_j = jcam.CameraRayDirections(JSettings({"camera_intrinsic": intr}), chunk_size=512)
    assert len(crd_t) == 64 * 48 and crd_t.num_chunks == crd_j.num_chunks == 6
    rays = crd_t.fetch_chunk_rays(0, TPose.identity(), TCube(10.0, np.zeros(3)), (1.0, 8.0))
    assert rays.shape == (512, 11)
    np.testing.assert_allclose(np.linalg.norm(rays[:, 3:6], axis=-1), 1.0, atol=1e-5)
    assert np.all(rays[:, 10] <= np.sqrt(3) + 1e-5)
    mat = np.eye(4)
    mat[:3, :3] = jsyn.LIDAR_TO_CAMERA_ROT
    mat[:3, 3] = [1.0, -2.0, 0.5]
    shift = np.array([0.3, 0.1, -0.2])
    img = np.random.default_rng(1).uniform(size=(48, 64, 3)).astype(np.float32)
    pix = np.arange(0, 64 * 48, 7)
    rays_t, int_t = crd_t.build_rays(pix, TPose(mat), img, TCube(12.0, shift), (1.0, 8.0))
    from loner_tpu.common.world_cube import WorldCube as JCube

    rays_j, int_j = crd_j.build_rays(pix, JPose(mat), img, JCube(12.0, shift), (1.0, 8.0))
    np.testing.assert_allclose(rays_t, rays_j, atol=1e-6)
    np.testing.assert_array_equal(int_t, int_j)


def test_virtual_camera_images_are_bit_equal_to_jax():
    scans, poses, ts, _, _ = tsyn.generate_sequence(num_scans=6, lidar=tsyn.VirtualLidar(4, 16))
    cam_t, cam_j = tsyn.VirtualCamera(), jsyn.VirtualCamera()
    np.testing.assert_array_equal(cam_t.k, cam_j.k)
    np.testing.assert_array_equal(tsyn.LIDAR_TO_CAMERA_ROT, jsyn.LIDAR_TO_CAMERA_ROT)
    np.testing.assert_array_equal(cam_t.lidar_to_camera().matrix, cam_j.lidar_to_camera().matrix)
    for scene_t, scene_j in ((tsyn.BoxRoomScene(), jsyn.BoxRoomScene()),
                             (tsyn.BoxRoomScene(open_top=True), jsyn.BoxRoomScene(open_top=True))):
        for i in (0, 3, 5):
            img_t = cam_t.render(scene_t, TPose(poses[i]))
            img_j = cam_j.render(scene_j, JPose(poses[i]))
            assert img_t.shape == (64, 96, 3) and img_t.dtype == np.float32
            np.testing.assert_array_equal(img_t, img_j)
    pts = np.random.default_rng(2).normal(size=(100, 3)) * 5
    np.testing.assert_array_equal(tsyn.surface_intensity(pts), jsyn.surface_intensity(pts))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_images_cross_the_packages(tmp_path, writer):
    rng = np.random.default_rng(3)
    scans, poses, ts, scene, _ = tsyn.generate_sequence(num_scans=3, lidar=tsyn.VirtualLidar(4, 16))
    images = [rng.uniform(size=(8, 12, 3)).astype(np.float32) for _ in range(3)]
    stamps = [s.get_start_time() + 0.01 for s in scans]
    if writer == "port":
        tsyn.write_sequence(str(tmp_path), scans, poses, ts, meta={"sensor": "synthetic"})
        w = tss.ScanStreamWriter(str(tmp_path))
        for img, t in zip(images, stamps):
            w.add_image(img, t)
    else:
        w = jss.ScanStreamWriter(str(tmp_path), meta={"sensor": "synthetic"})
        for s in scans:
            w.add_scan(JScan(s.ray_directions, s.distances, s.timestamps))
        w.write_gt(poses, ts)
        for img, t in zip(images, stamps):
            w.add_image(img, t)
    for reader in (tss.ScanStreamReader(str(tmp_path)), jss.ScanStreamReader(str(tmp_path))):
        assert reader.meta == {"sensor": "synthetic"}
        assert len(reader.image_files()) == 3
        for i in range(3):
            img, t = reader.read_image(i)
            np.testing.assert_array_equal(img, images[i])
            assert t == stamps[i] == reader.read_image_timestamp(i)
    assert tss.ScanStreamReader(str(tmp_path)).has_images()


def test_write_sequence_adds_one_image_a_scan_as_the_jax_example(tmp_path):
    scans, poses, ts, scene, _ = tsyn.generate_sequence(num_scans=4, lidar=tsyn.VirtualLidar(4, 16))
    tsyn.write_sequence(str(tmp_path), scans, poses, ts, scene=scene, camera=tsyn.VirtualCamera())
    reader = jss.ScanStreamReader(str(tmp_path))
    assert len(reader) == 4 and len(reader.image_files()) == 4
    cam = jsyn.VirtualCamera()
    for i in range(4):
        img, t = reader.read_image(i)
        assert t == scans[i].get_start_time()
        np.testing.assert_array_equal(img, cam.render(jsyn.BoxRoomScene(), JPose(poses[i])))


# -- frame synthesis ------------------------------------------------------------

def _fs_settings(settings_cls):
    return settings_cls({"frame_decimation_rate_hz": 5, "frame_match_tolerance": 0.01,
                         "frame_delta_t_sec_tolerance": 0.02, "decimate_on_load": False})


def _run_matching(case: str, fs_cls, scan_cls, image_cls, pose_cls, settings_cls):
    def scan(t0, n=16):
        return scan_cls(np.ones((3, n), np.float32) / np.sqrt(3), np.ones(n, np.float32),
                        np.linspace(t0, t0 + 0.09, n))

    fs = fs_cls(_fs_settings(settings_cls), pose_cls.identity(), lidar_only=False)
    seen = []
    if case == "covering":
        fs.process_image(image_cls(np.zeros((4, 4, 3), np.float32), timestamp=1.05))
        seen.append(fs.has_frame())
        fs.process_lidar(scan(1.0), pose_cls.identity())
    elif case == "before":
        fs.process_image(image_cls(np.zeros((2, 2, 3), np.float32), timestamp=0.5))
        fs.process_lidar(scan(2.0), pose_cls.identity())
    else:
        fs.process_lidar(scan(1.0), pose_cls.identity())
        fs.process_image(image_cls(np.zeros((2, 2, 3), np.float32), timestamp=2.05))
        seen.append(fs.has_frame())
        fs.process_lidar(scan(2.0), pose_cls.identity())
    seen.append(fs.has_frame())
    frame = fs.pop_frame()
    if frame is not None:
        seen += [frame.image.timestamp, len(frame.lidar_points),
                 float(frame.lidar_points.get_start_time())]
    return seen


@pytest.mark.parametrize("case,expected", [
    ("covering", [False, True, 1.05, 16, 1.0]),
    ("before", [False]),
    ("waits", [False, True, 2.05, 16, 2.0]),
])
def test_frame_synthesis_matches_images_as_jax(case, expected):
    got_t = _run_matching(case, TFrameSynthesis, TScan, TImage, TPose, TSettings)
    got_j = _run_matching(case, JFrameSynthesis, JScan, JImage, JPose, JSettings)
    assert got_t == got_j == expected


# -- camera rays --------------------------------------------------------------------

@pytest.mark.parametrize("detach_poses", [True, False])
def test_camera_rays_match_jax(detach_poses):
    rng = np.random.default_rng(6)
    w, n_cam, h, wd = 3, 24, 6, 8
    cam_dirs, _, _ = tcam.get_ray_directions(h, wd, np.array([[6.0, 0, 4], [0, 6.0, 3], [0, 0, 1]]))
    l2c = tsyn.VirtualCamera().lidar_to_camera().matrix.astype(np.float32)
    images = [rng.uniform(size=(h, wd, 3)).astype(np.float32), None,
              rng.uniform(size=(h, wd, 1)).astype(np.float32)]
    twists = rng.normal(0, 0.2, (w, 6)).astype(np.float32)
    twists[2, :3] = [9.0, 0.0, 0.0]  # its origin leaves the cube: masked
    slot_valid = np.array([True, True, False])
    shift = np.array([0.3, -0.1, 0.2], np.float32)
    key = jax.random.key(11)
    cj = jrays.build_camera_window_buffers(images, cam_dirs, l2c, w)
    ct = trays.build_camera_window_buffers(images, cam_dirs, l2c, w)
    for name in ("cam_dirs", "intensities", "has_image", "lidar_to_camera"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)))
    c = rng.normal(size=(w * n_cam, 11)).astype(np.float32)

    def f_j(tw):
        rays, intens, valid = jrays.sample_and_build_camera_rays(
            key, cj, tw, jnp.asarray(12.0), jnp.asarray(shift), (0.5, 14.0), n_cam,
            jnp.asarray(slot_valid), detach_poses=detach_poses)
        return (rays * c).sum(), (rays, intens, valid)

    (_, (rays_j, int_j, valid_j)), g_j = jax.value_and_grad(f_j, has_aux=True)(
        jnp.asarray(twists))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (w, n_cam))))
    tw = torch.tensor(twists, requires_grad=True)
    rays_t, int_t, valid_t = trays.sample_and_build_camera_rays(
        ct, tw, torch.tensor(12.0), torch.tensor(shift), (0.5, 14.0), n_cam,
        torch.from_numpy(slot_valid), u, detach_poses=detach_poses)
    np.testing.assert_allclose(rays_t.detach().numpy(), np.asarray(rays_j), atol=1e-6)
    np.testing.assert_array_equal(int_t.numpy(), np.asarray(int_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert valid_t.view(w, n_cam)[0].all() and not valid_t.view(w, n_cam)[1:].any()
    if detach_poses:
        assert not rays_t.requires_grad and np.abs(np.asarray(g_j)).max() == 0
    else:
        (rays_t * torch.tensor(c)).sum().backward()
        scale = max(np.abs(np.asarray(g_j)).max(), 1.0)
        np.testing.assert_allclose(tw.grad.numpy() / scale, np.asarray(g_j) / scale, atol=1e-5)
