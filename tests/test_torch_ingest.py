"""The port's ingest path against the JAX package's, on the same inputs.

Each port module gets the inputs its ``loner_tpu`` counterpart gets, made from
a numpy seed, and must give the same outputs: the YAML reader on OpenCV
calibration text (PyYAML after the JAX package's strip), the calibration
loader, the bag reader and writer across packages (bytes equal), the C++ host
ops against the JAX package's library (bits equal; their plain versions within
``scan_ops.DECODE_PLAIN_RTOL``, or equal), the timestamp heuristics (bits
equal), the bag generator (bytes equal) and the converter (npz arrays to the
bit, ``poses_gt.tum`` as text, ``meta.yaml`` as values). Then the drill end to
end on the CPU: bag, converter, threaded SLAM and the metrics pipeline, under
the ATE bar.
"""
import filecmp
import importlib.util
import os
import struct
import sys
import time

import numpy as np
import pytest
import yaml

from loner_tpu.datasets import calibration as jcal
from loner_tpu.datasets import rosbag_reader as jreader
from loner_tpu.datasets import rosbag_writer as jwriter
from loner_tpu.datasets import scan_stream as jstream
from loner_tpu.ops import native as jnative
from loner_tpu_torch.common import yaml_lite
from loner_tpu_torch.datasets import calibration as tcal
from loner_tpu_torch.datasets import rosbag_reader as treader
from loner_tpu_torch.datasets import rosbag_writer as twriter
from loner_tpu_torch.datasets import scan_stream as tstream
from loner_tpu_torch.ops import build, scan_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATE_MAX = 0.15  # m, tests/test_e2e_slam.py's bar

# OpenCV writes a matrix's data as a flow sequence over several lines.
CAM_YAML = """%YAML:1.0
---
image_width: 1024
image_height: 768
camera_name: frame_cam00
camera_matrix: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 6.0621e+02, 0., 5.1206e+02, 0., 6.0598e+02,
       3.8321e+02, 0., 0., 1. ]
distortion_model: plumb_bob
distortion_coefficients: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [ -2.8e-01, 7.3e-02, 1.9e-04,
       -1.8e-05, 0. ]
rectification_matrix: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 1., 0., 0., 0., 1., 0., 0., 0., 1. ]
projection_matrix: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [ 6.1e+02, 0., 5.2e+02, 0., 0., 6.1e+02, 3.9e+02, 0., 0.,
       0., 1., 0. ]
"""
OUSTER_YAML = """%YAML:1.0
---
quaternion_sensor_frame_cam00: !!opencv-matrix
   rows: 4
   cols: 1
   dt: d
   data: [ 0.5, -0.5,
       0.5, -0.5 ]
translation_sensor_frame_cam00: !!opencv-matrix
   rows: 3
   cols: 1
   dt: d
   data: [ 0.0571, -0.0011, -0.0734 ]
"""
EXTRA_YAML = """a: {x: 1e-3, y: [1.,
  -2.8e-01, 3], z: 'q, r'}
b: [[1, 2],
    [3, 4]]
rows: 3
"""


def _jax_strip(text: str) -> str:
    """loner_tpu/datasets/calibration.py's strip of the directive and tags."""
    import re

    return re.sub(r"^%YAML.*\n(---)?\n?", "", text).replace("!!opencv-matrix", "")


@pytest.mark.parametrize("text", [CAM_YAML, OUSTER_YAML, EXTRA_YAML])
def test_yaml_reader_reads_opencv_text_as_pyyaml(text):
    stripped = _jax_strip(text)
    ours, theirs = yaml_lite.loads(stripped), yaml.safe_load(stripped)
    assert ours == theirs
    assert repr(ours) == repr(theirs)  # same types: 1. a float, 1e-3 a string, rows an int


def _calib_dir(root):
    calib = os.path.join(root, "calib")
    os.makedirs(calib)
    for name, text in (("ouster00.yaml", OUSTER_YAML), ("frame_left.yaml", CAM_YAML),
                       ("frame_right.yaml", CAM_YAML.replace("6.0621e+02", "6.0711e+02"))):
        with open(os.path.join(calib, name), "w") as f:
            f.write(text)
    return root


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("name", ["ouster00.yaml", "frame_left.yaml"])
def test_load_opencv_yaml_matches_jax(tmp_path, name):
    root = _calib_dir(str(tmp_path))
    path = os.path.join(root, "calib", name)
    _same_tree(tcal.load_opencv_yaml(path), jcal.load_opencv_yaml(path))


@pytest.mark.parametrize("scale,layout", [(1.0, "calib"), (0.5, "calib"), (0.5, "flat")])
def test_fusion_portable_calibration_matches_jax(tmp_path, scale, layout):
    root = _calib_dir(str(tmp_path))
    if layout == "flat":
        root = os.path.join(root, "calib")
    ours, theirs = (tcal.FusionPortableCalibration(root, scale),
                    jcal.FusionPortableCalibration(root, scale))
    _same_tree(ours.t_lidar_to_left_cam, theirs.t_lidar_to_left_cam)
    _same_tree(ours.left_cam_intrinsic, theirs.left_cam_intrinsic)
    _same_tree(ours.right_cam_intrinsic, theirs.right_cam_intrinsic)
    assert ours.t_lidar_to_left_cam["orientation"] == [-0.5, 0.5, -0.5, 0.5]
    s_ours, s_theirs = {"calibration": {}}, {"calibration": {}}
    ours.apply_to_settings(s_ours)
    theirs.apply_to_settings(s_theirs)
    _same_tree(s_ours, s_theirs)


def test_calibration_without_files_matches_jax(tmp_path):
    ours, theirs = (tcal.FusionPortableCalibration(str(tmp_path)),
                    jcal.FusionPortableCalibration(str(tmp_path)))
    assert ours.t_lidar_to_left_cam == theirs.t_lidar_to_left_cam
    assert ours.left_cam_intrinsic is None and theirs.left_cam_intrinsic is None


# -- bags ------------------------------------------------------------------------

def _write_messages(writer_mod, path, compression, seed=0, n_msgs=30):
    """A seeded sequence of PointCloud2 and TF messages across several chunks."""
    rng = np.random.default_rng(seed)
    with writer_mod.BagWriter(path, compression=compression, chunk_bytes=4096) as w:
        w.add_connection("/pts", "sensor_msgs/PointCloud2")
        w.add_connection("/tf", "tf2_msgs/TFMessage")
        for i in range(n_msgs):
            t = 1.7e9 + 0.1 * i + rng.uniform(0, 1e-3)
            xyz = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
            t_ns = rng.integers(0, 10**8, 16).astype(np.uint64)
            msg = writer_mod.pointcloud2_bytes(
                t, "lidar", 2, 8, writer_mod.OUSTER_FIELDS, writer_mod.OUSTER_POINT_STEP,
                writer_mod.ouster_blob(xyz, t_ns, rng.random(16), np.arange(16) % 2,
                                       rng.integers(0, 10**5, 16)), seq=i)
            w.write("/pts", msg, t)
            w.write("/tf", writer_mod.tf_message_bytes(t, "map", "body", rng.normal(size=3),
                                                       rng.normal(size=4), seq=i), t)
        chunks = len(w._chunk_infos)
    return chunks + 1  # the last chunk is flushed on close


def _read_all(reader_mod, path, topics=None):
    out = []
    with reader_mod.Bag(path) as bag:
        for topic, msg, ts in bag.read_messages(topics):
            if topic == "/tf":
                tf = msg.transforms[0]
                v = (tf.header.seq, tf.header.stamp.secs, tf.header.stamp.nsecs,
                     tf.header.frame_id, tf.child_frame_id,
                     vars(tf.transform.translation), vars(tf.transform.rotation))
            else:
                v = (msg.header.seq, msg.header.stamp.secs, msg.header.stamp.nsecs,
                     msg.header.frame_id, msg.height, msg.width,
                     [vars(f) for f in msg.fields], msg.is_bigendian, msg.point_step,
                     msg.row_step, bytes(msg.data), msg.is_dense)
            out.append((topic, ts.secs, ts.nsecs, v))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_port_writer_writes_the_jax_writers_bytes(tmp_path, compression):
    ours, theirs = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    assert _write_messages(twriter, ours, compression) > 3  # several chunks
    _write_messages(jwriter, theirs, compression)
    assert filecmp.cmp(ours, theirs, shallow=False)


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_port_reader_reads_as_the_jax_reader(tmp_path, compression, written_by):
    path = str(tmp_path / "x.bag")
    _write_messages(jwriter if written_by == "jax" else twriter, path, compression)
    ours, theirs = _read_all(treader, path), _read_all(jreader, path)
    assert len(ours) == 60 and ours == theirs
    assert _read_all(treader, path, ["/tf"]) == _read_all(jreader, path, ["/tf"])
    assert treader.bag_topics(path) == jreader.bag_topics(path) == {
        "/pts": "sensor_msgs/PointCloud2", "/tf": "tf2_msgs/TFMessage"}


def test_lz4_chunks_raise_and_a_bad_magic_is_refused(tmp_path):
    path = str(tmp_path / "lz4.bag")
    rec = twriter._record({b"op": bytes([twriter.OP_CHUNK]), b"compression": b"lz4",
                           b"size": struct.pack("<I", 4)}, b"\0\0\0\0")
    with open(path, "wb") as f:
        f.write(twriter._MAGIC + rec)
    for mod in (treader, jreader):
        with pytest.raises(NotImplementedError, match="lz4"):
            with mod.Bag(path) as bag:
                list(bag.read_messages())
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="not a ROS1 v2.0 bag"):
        treader.Bag(path)


# -- host ops --------------------------------------------------------------------

STEP = 48


def _blob(seed=0, n=4096):
    """Records of the 48-byte Ouster stride: xyz f32 at 0, f32 seconds at 16,
    u32 ns at 20, f64 seconds at 24; NaN, infinite and zero rows, and points at
    and around 0.3 m."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
    xyz[::97] = np.nan
    xyz[5::101] = 0.0
    xyz[7::103, 0] = np.inf
    near = rng.normal(size=(n // 40, 3))
    near *= 0.3 / np.linalg.norm(near, axis=1, keepdims=True)
    near *= 1.0 + rng.integers(-3, 4, (n // 40, 1)) * 6e-8
    xyz[11::40][: n // 40] = near.astype(np.float32)
    rec = np.zeros((n, STEP), np.uint8)
    rec[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    rec[:, 16:20] = rng.random(n).astype(np.float32).view(np.uint8).reshape(n, 4)
    rec[:, 20:24] = rng.integers(0, 10**8, n).astype(np.uint32).view(np.uint8).reshape(n, 4)
    rec[:, 24:32] = (1.7e9 + rng.random(n)).view(np.uint8).reshape(n, 8)
    return rec.tobytes(), n


TIME_FIELDS = [(0, 16), (1, 24), (2, 20), (3, 0), (-1, -1)]  # (time_kind, offset)


@pytest.mark.parametrize("kind,offset", TIME_FIELDS)
@pytest.mark.parametrize("min_range", [0.0, 0.3])
def test_decode_equals_the_jax_library(kind, offset, min_range):
    assert jnative.native_available()
    blob, n = _blob()
    ours = scan_ops.decode_point_blob(blob, n, STEP, (0, 4, 8), offset, kind, min_range)
    theirs = jnative.decode_point_blob(blob, n, STEP, (0, 4, 8), offset, kind, min_range)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The C++ filters on squares: a kept range may round to min_range itself.
    assert np.isfinite(ours[1]).all() and (ours[1] >= np.float32(min_range)).all()


@pytest.mark.parametrize("kind,offset", TIME_FIELDS)
@pytest.mark.parametrize("min_range", [0.0, 0.3])
def test_decode_plain_version_within_its_tolerance(kind, offset, min_range):
    """The plain version differs from the C++ only by the rounding the module's
    docstring lists: directions and ranges within DECODE_PLAIN_RTOL, times equal,
    and the kept sets equal but for points within DECODE_PLAIN_RTOL of min_range."""
    blob, n = _blob(seed=1)
    idx_c = scan_ops.decode_point_blob(blob, n, STEP, (0, 4, 8), 0, 3, min_range)[2]
    idx_p = scan_ops.decode_point_blob_plain(blob, n, STEP, (0, 4, 8), 0, 3, min_range)[2]
    only = np.setxor1d(idx_c, idx_p).astype(np.int64)
    xyz = np.frombuffer(blob, np.uint8).reshape(n, STEP)[only, :12].copy().view(np.float32)
    r = np.linalg.norm(xyz.astype(np.float64), axis=1)
    assert np.all(np.abs(r - min_range) <= scan_ops.DECODE_PLAIN_RTOL * min_range)
    if min_range == 0.0:
        assert only.size == 0  # NaN, infinite and zero rows dropped by both
    (d_c, r_c, t_c) = scan_ops.decode_point_blob(blob, n, STEP, (0, 4, 8), offset, kind,
                                                 min_range)
    (d_p, r_p, t_p) = scan_ops.decode_point_blob_plain(blob, n, STEP, (0, 4, 8), offset, kind,
                                                       min_range)
    kc, kp = np.isin(idx_c, idx_p), np.isin(idx_p, idx_c)
    np.testing.assert_allclose(r_p[kp], r_c[kc], rtol=scan_ops.DECODE_PLAIN_RTOL, atol=0)
    np.testing.assert_allclose(d_p[:, kp], d_c[:, kc], rtol=0, atol=scan_ops.DECODE_PLAIN_RTOL)
    np.testing.assert_array_equal(t_p[kp], t_c[kc])


@pytest.mark.parametrize("voxel,n", [(0.25, 5000), (0.1, 20000), (1.0, 1), (0.05, 0)])
def test_voxel_downsample_equals_the_jax_library_in_first_seen_order(voxel, n):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    ours = scan_ops.voxel_downsample(pts, voxel)
    if n:
        theirs = jnative.voxel_downsample_native(pts, voxel)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
        # First-seen order: the first point's voxel comes first.
        first = np.floor(pts[0].astype(np.float64) / np.float32(voxel))
        assert np.array_equal(np.floor(ours[0].astype(np.float64) / np.float32(voxel)), first)
    assert ours.shape == (len(np.unique(np.floor(pts.astype(np.float64) * (1.0 / float(
        np.float32(voxel)))), axis=0)), 3)
    np.testing.assert_array_equal(scan_ops.voxel_downsample_plain(pts, voxel), ours)


@pytest.mark.parametrize("windows", [[[0, 100], [350, 360]], [[180.5, 200.25]], [[0, 360]],
                                     [[90, 90]]])
def test_fov_mask_equals_the_jax_library(windows):
    rng = np.random.default_rng(3)
    d = rng.normal(size=(3, 20000)).astype(np.float32)
    angles = np.deg2rad([0, 45, 90, 180, 270, 359, 350, 100, 200.25])
    d[:, :9] = np.stack([np.cos(angles), np.sin(angles), np.zeros(9)]).astype(np.float32)
    ours = scan_ops.fov_mask(d, windows)
    np.testing.assert_array_equal(ours, jnative.fov_mask_native(d, windows))
    plain = scan_ops.fov_mask_plain(d, windows)
    az = np.rad2deg(np.arctan2(d[1].astype(np.float64), d[0].astype(np.float64))) % 360.0
    near = np.min(np.abs(az[:, None] - np.asarray(windows, np.float64).reshape(1, -1)),
                  axis=1) <= scan_ops.FOV_PLAIN_DEG
    np.testing.assert_array_equal(plain[~near], ours[~near])
    assert not near[9:].any()  # only the directions put on a bound


@pytest.mark.parametrize("n,step,xyz,t_off,t_kind", [
    (9, STEP, (0, 4, 8), 20, 2),     # one record more than the blob holds
    (8, STEP, (0, 4, 46), 20, 2),    # z past the record's end
    (8, STEP, (0, 4, 8), 44, 1),     # an f64 time past the record's end
    (8, STEP, (-4, 4, 8), -1, -1),
])
def test_decode_refuses_a_blob_that_does_not_hold_its_fields(n, step, xyz, t_off, t_kind):
    blob, _ = _blob(n=8)
    with pytest.raises(ValueError, match="does not hold"):
        scan_ops.decode_point_blob(blob, n, step, xyz, t_off, t_kind)


@pytest.mark.parametrize("fault", ["broken source", "no compiler"])
def test_a_failed_host_build_raises(tmp_path, monkeypatch, fault):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "scan_ops.cpp").write_text(
        "int broken(" if fault == "broken source"
        else (build.CSRC / "scan_ops.cpp").read_text())
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if fault == "no compiler":
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
    build.load_host_library.cache_clear()
    try:
        blob, n = _blob(n=8)
        with pytest.raises(RuntimeError, match="c\\+\\+"):
            scan_ops.decode_point_blob(blob, n, STEP, (0, 4, 8))
    finally:
        build.load_host_library.cache_clear()


# -- timestamps ------------------------------------------------------------------

# tests/test_data_layer.py's cases: (stamps, header time).
STAMP_CASES = [
    (np.array([1.6e18, 1.6e18 + 1e8]), 0.0),            # absolute nanoseconds
    (np.array([0.0, 0.05, 0.1]), 1000.0),               # scan-local seconds
    (np.array([-0.05, 0.0, 0.05]), 1000.0),             # Velodyne negative offsets
    (np.array([5.0e5, 5.0e5 + 0.05]), 1000.0),          # global stamps
    (np.array([0.02, 0.02, 0.0201]), 1000.0),           # degenerate
    (1.7e9 + np.array([0.0, 0.05, 0.1]), 1000.0),       # epoch seconds
    (np.array([0.02, 0.05, 0.09]), 1000.0),             # first kept point 20 ms late
    (np.array([]), 5.0),
    (np.random.default_rng(4).uniform(0, 0.1, 1000), 1.7e9 + 0.3),
    (np.random.default_rng(5).integers(0, 10**8, 1000) * 1.0, 1.7e9),  # u32 ns as f64
]


@pytest.mark.parametrize("case", range(len(STAMP_CASES)))
@pytest.mark.parametrize("relative", [True, False])
def test_normalize_timestamps_equals_jax_to_the_bit(case, relative):
    ts, scan_time = STAMP_CASES[case]
    ours = tstream.normalize_timestamps(ts, scan_time, relative)
    theirs = jstream.normalize_timestamps(ts, scan_time, relative)
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("h_res,period", [(2048, 0.1), (64, 0.2), (1024, 0.1)])
def test_recompute_scan_timestamps_equals_jax_to_the_bit(h_res, period):
    idx = np.concatenate([[0, 2, 3, 2048], np.random.default_rng(6).integers(0, 131072, 500)])
    np.testing.assert_array_equal(
        tstream.recompute_scan_timestamps(idx, h_res, period),
        jstream.recompute_scan_timestamps(idx, h_res, period))


def test_apply_min_range_matches_jax():
    from loner_tpu.common.sensors import LidarScan as JScan
    from loner_tpu_torch.common.sensors import LidarScan

    rng = np.random.default_rng(7)
    d, r, t = rng.normal(size=(3, 50)), rng.uniform(0, 1, 50), np.sort(rng.random(50))
    ours = tstream.apply_min_range(LidarScan(d, r, t), 0.3)
    theirs = jstream.apply_min_range(JScan(d, r, t), 0.3)
    for a, b in ((ours.ray_directions, theirs.ray_directions), (ours.distances, theirs.distances),
                 (ours.timestamps, theirs.timestamps)):
        np.testing.assert_array_equal(a, b)


# -- generator and converter -----------------------------------------------------

def _jax_maker():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_bag", os.path.join(REPO, "examples", "scripts", "make_synthetic_bag.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_convert(argv, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    import convert_rosbag

    monkeypatch.setattr(sys, "argv", ["convert_rosbag.py"] + argv)
    convert_rosbag.main()


def _bags(tmp_path, monkeypatch, mode, compression):
    """The same arguments through JAX's script (sys.argv patched) and the port's
    generator; returns (JAX's bag, the port's bag)."""
    from loner_tpu_torch.datasets import synthetic_bag

    args = ["--duration", "1", "--rate", "5", "--channels", "16", "--columns", "64",
            "--compression", compression, "--chunk_mb", "0.25", "--timestamp_mode", mode]
    theirs, ours = str(tmp_path / "j" / "drill.bag"), str(tmp_path / "t" / "drill.bag")
    monkeypatch.setattr(sys, "argv", ["make_synthetic_bag.py", theirs] + args)
    _jax_maker().main()
    synthetic_bag.main([ours] + args)
    return theirs, ours


def _same_dataset(ours: str, theirs: str) -> None:
    names = sorted(os.listdir(os.path.join(theirs, "scans")))
    assert names and names == sorted(os.listdir(os.path.join(ours, "scans")))
    for name in names:
        a, b = (np.load(os.path.join(d, "scans", name)) for d in (ours, theirs))
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert filecmp.cmp(os.path.join(ours, "poses_gt.tum"), os.path.join(theirs, "poses_gt.tum"),
                       shallow=False)
    with open(os.path.join(ours, "meta.yaml")) as f, open(os.path.join(theirs, "meta.yaml")) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)


MODES = [("ouster_ns", []), ("epoch_f64", []), ("zeros", ["--recompute_timestamps"])]


@pytest.mark.parametrize("compression", ["bz2", "none"])
@pytest.mark.parametrize("mode,extra", MODES)
def test_generator_and_converter_match_jax(tmp_path, monkeypatch, mode, extra, compression):
    """The port's generator writes JAX's script's bytes (and ground-truth file);
    the port's converter turns the bag into JAX's converter's dataset."""
    from loner_tpu_torch import convert_rosbag

    theirs, ours = _bags(tmp_path, monkeypatch, mode, compression)
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert filecmp.cmp(ours.replace(".bag", "_gt.tum"), theirs.replace(".bag", "_gt.tum"),
                       shallow=False)
    conv = ["--gt_topic", "/tf", "--gt_frame", "body"] + extra
    _jax_convert([theirs, str(tmp_path / "jd")] + conv, monkeypatch)
    convert_rosbag.main([theirs, str(tmp_path / "td")] + conv)
    _same_dataset(str(tmp_path / "td"), str(tmp_path / "jd"))
    scan = tstream.ScanStreamReader(str(tmp_path / "td")).read_scan(1)
    assert np.all(np.diff(scan.timestamps) >= 0) and abs(scan.timestamps[0] - (1.7e9 + 0.2)) < 0.01


def test_converter_reads_a_fusion_portable_sequence_config_as_jax(tmp_path, monkeypatch):
    """--config: `dataset` is the output, `groundtruth_traj` the GT copied, and
    `dataset_family: fusion_portable` turns on the column-index stamps; flags
    are the same for both converters."""
    from loner_tpu_torch import convert_rosbag

    theirs, _ = _bags(tmp_path, monkeypatch, "zeros", "none")
    gt = str(tmp_path / "gt.txt")
    with open(gt, "w") as f:
        f.write("1700000000.0 0 0 0 0 0 0 1\n1700000001.0 1 0 0 0 0 0 1\n")
    configs = {}
    for who in ("j", "t"):
        configs[who] = str(tmp_path / f"{who}_seq.yaml")
        with open(configs[who], "w") as f:
            f.write(f"baseline: {os.path.join(REPO, 'cfg', 'defaults.yaml')}\n"
                    f"dataset: {tmp_path / (who + '_out')}\ngroundtruth_traj: {gt}\n"
                    "experiment_name: canteen\ndataset_family: fusion_portable\n"
                    "changes:\n  mapper:\n    optimizer:\n      model_config:\n"
                    "        data:\n          ray_range: &r [1, 50]\n")
    _jax_convert([theirs, "--config", configs["j"]], monkeypatch)
    args = convert_rosbag.parse_args([theirs, "--config", configs["t"]])
    assert args.recompute_timestamps and args.gt_file == gt
    convert_rosbag.main([theirs, "--config", configs["t"]])
    _same_dataset(str(tmp_path / "t_out"), str(tmp_path / "j_out"))
    ts = tstream.ScanStreamReader(str(tmp_path / "t_out")).read_scan(0).timestamps
    assert 0.05 < ts[-1] - ts[0] < 0.11  # the column-index sweep of 0.1 s


def test_drill_end_to_end_on_the_cpu(tmp_path, request):
    """bag (32 x 256, 3 s, bz2, epoch stamps) -> the port's converter -> threaded
    SLAM at box_room_drill.yaml cut to a CPU size (run_trial on the CPU) -> the
    metrics pipeline against the bag's /tf ground truth: ATE under the bar, the
    stages in well under a minute."""
    import torch

    from loner_tpu_torch import real_data_drill

    # Four threads for this run only: a later test on this worker that holds a
    # computation to a one-thread process's bits must find the one thread its
    # module set.
    threads = torch.get_num_threads()
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    torch.set_num_threads(4)
    cut = {
        "system": {"log_dir_prefix": str(tmp_path / "outputs")},
        "tracker": {"icp": {"downsample": {"target_uniform_point_count": 1000}}},
        "mapper": {
            "keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 1.0}},
                                 "window_selection": {"window_size": 2}},
            "optimizer": {
                "num_samples": {"lidar": 16},
                "keyframe_schedule": [
                    {"num_keyframes": 1, "iteration_schedule": [
                        {"num_iterations": 3, "freeze_poses": True}]},
                    {"num_keyframes": -1, "iteration_schedule": [{"num_iterations": 2}]}],
                "model_config": {"model": {
                    "render": {"N_samples_train": 16},
                    "nerf_config": {"fourier_sigma": {"n_freqs": 8},
                                    "sigma_network": {"n_neurons": 32}},
                    "occ_model": {"prop_n_ctrl": 5,
                                  "proposal": {"n_freqs": 8, "n_neurons": 16}}}}}},
    }
    t0 = time.perf_counter()
    out = real_data_drill.run_drill(str(tmp_path / "drill"), duration=3.0, device="cpu",
                                    channels=32, columns=256, changes=cut)
    seconds = time.perf_counter() - t0
    assert out["convert"]["scans"] == 30
    log_dir = out["log_dir"]
    assert filecmp.cmp(os.path.join(tmp_path, "drill", "dataset", "poses_gt.tum"),
                       os.path.join(log_dir, "trajectory", "groundtruth.txt"), shallow=False)
    for f in ("regression.yaml", "summary.csv", "traj_metrics.yaml"):
        assert os.path.exists(os.path.join(log_dir, f)), f
    est = np.loadtxt(os.path.join(log_dir, "trajectory", "estimated_trajectory.txt"))
    assert est[0, 0] >= 1.7e9 and np.all(np.diff(est[:, 0]) > 0)  # epoch stamps kept
    assert out["metrics"]["ate"]["rmse"] < ATE_MAX
    assert seconds < 60, seconds
