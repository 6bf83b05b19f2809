"""The port's offline tools against the JAX package's, on the CPU.

- ``flythrough_poses`` within 1e-6 of JAX's (interpolated f32 poses and spins).
- ``render_sequence`` (depth, intensity and peak frames) on the JAX package's
  tiny experiment of ``tests/test_torch_render.py``, at its f32 tolerance;
  ``render_flythrough``: the JAX package's frame list, ``make_video.sh`` and
  frame count.
- ``save_depth_png`` / ``save_rgb_png`` decoded by PIL: pixel for pixel
  ``loner_tpu/analysis/renderer.py::_save_depth_png`` / ``_save_rgb_png``
  (matplotlib) on the same f32 and f64 arrays, constant frames included; the
  PNG reader on PIL's own PNGs (every filter type PIL picks).
- The port's JPEG decoded by PIL: DQT and DHT bytes equal to PIL's at the same
  quality, and the mean absolute difference from PIL's own JPEG, both decoded
  by PIL, at most 1 level on a 512 x 256 turbo depth frame (uniform noise,
  the worst case, differs more: the float DCT rounds otherwise than libjpeg's
  integer one).
- The AVI read by JAX's ``read_avi_frame_count`` and by OpenCV.
- ``vis_flow`` / ``depth_to_warp`` equal to JAX's.
- ``plot_poses`` and ``visualize_loss``: the PNG's ``Series`` text equal to the
  data JAX passes to ``plt.plot`` (recorded by patching it), and the last
  series' points drawn at their projected pixels.
- ``map_jobs`` over two CPU devices (order, an exception, no jobs);
  ``run_pool`` (``tests/test_trial_pool.py``'s cases, ``CUDA_VISIBLE_DEVICES``
  pinned) and ``run_loner --num_repeats 2 --trial_workers 2 --device cpu`` on
  box_room_tiny.yaml.
"""
import io
import os
import subprocess
import sys
import threading
import time

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from loner_tpu.analysis import plot_poses as jplot
from loner_tpu.analysis import renderer as jr
from loner_tpu.analysis import video as jvideo
from loner_tpu.analysis import warp as jwarp
from loner_tpu.runtime import debug_artifacts as jdbg
from loner_tpu_torch.analysis import image_io, raster_plot
from loner_tpu_torch.analysis import plot_poses as tplot
from loner_tpu_torch.analysis import renderer as tr
from loner_tpu_torch.analysis import video as tvideo
from loner_tpu_torch.analysis import warp as twarp
from loner_tpu_torch.parallel.device_pool import map_jobs
from loner_tpu_torch.parallel.trial_pool import run_pool
from loner_tpu_torch.runtime import debug_artifacts as tdbg

matplotlib.use("Agg")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    from test_torch_render import _jax_experiment

    return _jax_experiment(tmp_path_factory.mktemp("exp") / "f32", "float32", "xla")


def test_flythrough_poses_match_jax():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    mats = np.tile(np.eye(4), (4, 1, 1))
    mats[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 0.6, (4, 3))).as_matrix()
    mats[:, :3, 3] = rng.normal(0, 3, (4, 3))
    for kw in ({}, {"steps_between": 3, "spin_every": 2, "spin_steps": 5}):
        got, want = tr.flythrough_poses(mats, **kw), jr.flythrough_poses(mats, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_render_sequence_matches_jax(experiment, tmp_path):
    from test_torch_render import RTOL, _assert_renders_match

    kw = dict(width=16, height=8, n_samples=64, with_intensity=True, with_peak=True)
    out_j = jr.render_sequence(str(experiment), out_dir=str(tmp_path / "j"), **kw)
    out_t = tr.render_sequence(str(experiment), out_dir=str(tmp_path / "t"), device="cpu", **kw)
    names = sorted(os.listdir(out_j))
    assert names == sorted(os.listdir(out_t)) and len(names) == 12  # 2 poses x 3 kinds x 2
    for i in range(2):
        frame = {k: np.load(os.path.join(d, f"{k}_{i:04d}.npy"))
                 for d, k in ((out_t, "depth"), (out_t, "intensity"), (out_t, "peak"))}
        ref = {k: np.load(os.path.join(out_j, f"{k}_{i:04d}.npy"))
               for k in ("depth", "intensity", "peak")}
        _assert_renders_match(frame, ref, RTOL["float32"], keys=("depth", "peak"))
        np.testing.assert_allclose(frame["intensity"], ref["intensity"], rtol=RTOL["float32"],
                                   atol=1e-6)
        px, _ = image_io.read_png(os.path.join(out_t, f"depth_{i:04d}.png"))
        assert px.shape == (8, 16, 4)
    # One explicit pose, and the last keyframe pose alone.
    pose = np.eye(4)
    pose[:3, 3] = [0.3, -0.2, 0.1]
    for extra in ({"explicit_pose": pose}, {"only_last_frame": True}):
        d_j = jr.render_sequence(str(experiment), out_dir=str(tmp_path / "j1"), width=16,
                                 height=8, n_samples=64, **extra)
        d_t = tr.render_sequence(str(experiment), out_dir=str(tmp_path / "t1"), width=16,
                                 height=8, n_samples=64, device="cpu", **extra)
        _assert_renders_match({"depth": np.load(os.path.join(d_t, "depth_0000.npy"))},
                              {"depth": np.load(os.path.join(d_j, "depth_0000.npy"))},
                              RTOL["float32"], keys=("depth",))


def test_render_flythrough_matches_jax(experiment, tmp_path):
    kw = dict(width=16, height=8, steps_between=3, spin_every=1, spin_steps=2, n_samples=32)
    d_j = jr.render_flythrough(str(experiment), out_dir=str(tmp_path / "j"), **kw)
    d_t = tr.render_flythrough(str(experiment), out_dir=str(tmp_path / "t"), device="cpu", **kw)
    for name in ("frames.txt", "make_video.sh"):
        with open(os.path.join(d_t, name)) as a, open(os.path.join(d_j, name)) as b:
            assert a.read() == b.read(), name
    n = len(open(os.path.join(d_t, "frames.txt")).read().split())
    assert n == 3 + 2 + 1  # one gap of 3 poses, a 2-pose spin, the last pose
    for reader in (jvideo.read_avi_frame_count, tvideo.read_avi_frame_count):
        assert reader(os.path.join(d_t, "flythrough.avi")) == (n, (8, 16), 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_png_writers_give_matplotlibs_pixels(dtype, tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.uniform(1.0, 9.0, (24, 40)), np.full((8, 8), 3.5),
              np.linspace(0, 1, 256 * 3).reshape(3, 256)]
    for n, frame in enumerate(frames):
        frame = frame.astype(dtype)
        jr._save_depth_png(frame, str(tmp_path / "j.png"))
        image_io.save_depth_png(frame, str(tmp_path / "t.png"))
        a, b = (np.asarray(Image.open(tmp_path / f"{p}.png")) for p in "jt")
        assert a.shape == b.shape == frame.shape + (4,)
        np.testing.assert_array_equal(b, a, err_msg=f"depth frame {n}")
    for c in (1, 3):
        rgb = rng.uniform(-0.2, 1.2, (12, 20, c)).astype(dtype)
        jr._save_rgb_png(rgb, str(tmp_path / "j.png"))
        image_io.save_rgb_png(rgb, str(tmp_path / "t.png"))
        a, b = (np.asarray(Image.open(tmp_path / f"{p}.png")) for p in "jt")
        np.testing.assert_array_equal(b, a, err_msg=f"{c} channels")


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_reads_pils_pngs(mode):
    rng = np.random.default_rng(1)
    c = len(mode)
    arr = rng.integers(0, 256, (29, 37, c), dtype=np.uint8)
    arr[10:20] = np.cumsum(arr[10:20], axis=1)  # smooth rows: PIL picks other filters
    im = Image.fromarray(arr[..., 0] if c == 1 else arr, mode)
    for optimize in (False, True):
        buf = io.BytesIO()
        im.save(buf, format="PNG", optimize=optimize)
        got, _ = image_io.decode_png(buf.getvalue())
        np.testing.assert_array_equal(got, arr)
    # And PIL reads the port's, with its text chunks.
    png = image_io.encode_png(arr, {"Title": "x", "Series": "[1, 2]"})
    back = Image.open(io.BytesIO(png))
    np.testing.assert_array_equal(np.asarray(back).reshape(arr.shape), arr)
    assert back.text == {"Title": "x", "Series": "[1, 2]"}


def _jpeg_segments(data: bytes) -> dict:
    """{marker: [payload, ...]} of a JPEG's segments before the scan."""
    out, pos = {}, 2
    while data[pos + 1] != 0xDA:
        size = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.setdefault(data[pos + 1], []).append(data[pos + 4:pos + 2 + size])
        pos += 2 + size
    return out


def _depth_frame(h=256, w=512):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 5 + 2 * np.sin(xx / 40.0) + np.cos(yy / 17.0) + 0.3 * rng.random((h, w))
    return image_io.colormap_rgba(depth.astype(np.float32), image_io.TURBO_LUT)[..., :3]


@pytest.mark.parametrize("quality", [90, 75, 30])
def test_jpeg_decodes_in_pil_with_pils_tables(quality):
    img = _depth_frame()
    ours = tvideo.encode_jpeg(img, quality)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    theirs = buf.getvalue()
    seg_o, seg_t = _jpeg_segments(ours), _jpeg_segments(theirs)
    assert seg_o[0xDB] == seg_t[0xDB]  # DQT: libjpeg's scaled Annex K tables
    assert sorted(seg_o[0xC4]) == sorted(seg_t[0xC4])  # DHT: the standard tables
    assert seg_o[0xC0] == seg_t[0xC0]  # SOF0: size, 4:2:0 sampling
    a = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB")).astype(int)
    b = np.asarray(Image.open(io.BytesIO(theirs)).convert("RGB")).astype(int)
    assert np.abs(a - b).mean() <= 1.0
    # Ragged sizes and gray input decode at the right shape.
    for shape in ((1, 1), (7, 13), (17, 33, 1)):
        small = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
        dec = np.asarray(Image.open(io.BytesIO(tvideo.encode_jpeg(small, quality))))
        assert dec.shape == shape[:2] + (3,)


def test_avi_reads_in_jax_and_opencv(tmp_path):
    frames = [_depth_frame(32, 48)[::-1] for _ in range(2)] + [
        np.full((32, 48, 1), 0.5), np.full((32, 48), 200, np.uint8)]
    pngs = []
    for i, f in enumerate(frames[:2]):
        pngs.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(f).save(pngs[-1])  # PIL's PNGs, read by the port's reader
    path = tvideo.write_mjpeg_avi(str(tmp_path / "v.avi"), pngs + frames[2:], fps=10)
    assert jvideo.read_avi_frame_count(path) == tvideo.read_avi_frame_count(path) == (
        4, (32, 48), 10)
    # The first chunk is the port's JPEG of the first frame, read from PIL's PNG.
    assert jvideo.extract_first_jpeg(path) == tvideo.extract_first_jpeg(path) == (
        tvideo.encode_jpeg(frames[0], 90))
    with pytest.raises(ValueError, match="resolution"):
        tvideo.write_mjpeg_avi(str(tmp_path / "bad.avi"), [frames[3], frames[3][:8]])
    with pytest.raises(ValueError, match="no frames"):
        tvideo.write_mjpeg_avi(str(tmp_path / "empty.avi"), [])
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(path)
    got, (ok, img) = 0, cap.read()
    shape = img.shape if ok else None
    while ok:
        got += 1
        ok, _ = cap.read()
    assert got == 4 and shape == (32, 48, 3)
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(10.0)


def test_warp_matches_jax():
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 3, (12, 16, 2))
    for scale in (0.0, 2.5):
        np.testing.assert_array_equal(twarp.vis_flow(flow, scale), jwarp.vis_flow(flow, scale))
    k = np.array([[20.0, 0, 7.5], [0, 20.0, 5.5], [0, 0, 1]])
    d1, d2 = rng.uniform(2, 8, (12, 16)), rng.uniform(2, 8, (12, 16))
    d1[3, 4] = np.inf
    t = np.eye(4)
    t[:3, 3] = [0.1, -0.05, 0.2]
    for a, b in zip(twarp.depth_to_warp(d1, d2, k, t, k, 0.7),
                    jwarp.depth_to_warp(d1, d2, k, t, k, 0.7)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def recorded_plots(monkeypatch):
    import matplotlib.pyplot as plt

    calls = []
    real = plt.plot

    def plot(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(plt, "plot", plot)
    return calls


def _check_series(fname, calls, colors):
    pixels, meta = raster_plot.read_plot(fname)
    series = meta["Series"]
    assert len(series) == len(calls)
    for s, (args, kwargs), color in zip(series, calls, colors):
        x, y = args[0], args[1]
        np.testing.assert_array_equal(np.asarray(s["x"]), np.asarray(x, np.float64))
        np.testing.assert_array_equal(np.asarray(s["y"]), np.asarray(y, np.float64))
        assert s["label"] == kwargs["label"] and s["color"] == color
    # The last series (drawn on top, opaque) at its projected pixels.
    last = series[-1]
    cols, rows = raster_plot.project(meta["Axes"], last["x"], last["y"])
    c0, r0, c1, r1 = meta["Axes"]["box"]
    inside = (cols >= c0) & (cols <= c1) & (rows >= r0) & (rows <= r1)
    assert inside.sum() > 0
    want = [int(last["color"][i:i + 2], 16) for i in (1, 3, 5)]
    np.testing.assert_array_equal(pixels[rows[inside], cols[inside], :3],
                                  np.broadcast_to(want, (inside.sum(), 3)))
    return meta


def test_plot_poses_holds_jaxs_series(experiment, tmp_path, recorded_plots):
    out_j = jplot.plot_poses(str(experiment), out_file=str(tmp_path / "j.png"))
    assert out_j and len(recorded_plots) == 3
    out_t = tplot.plot_poses(str(experiment), out_file=str(tmp_path / "poses.png"))
    fmt_colors = {"g": "#008000", "b": "#0000ff", "r": "#ff0000"}
    colors = [fmt_colors[args[2][0]] for args, _ in recorded_plots]
    assert colors == [matplotlib.colors.to_hex(c) for c in "gbr"]
    meta = _check_series(out_t, recorded_plots, colors)
    assert meta["Title"] == "Keyframe poses" and meta["Axes"]["equal"]
    assert [s["style"] for s in meta["Series"]] == [args[2][1:] for args, _ in recorded_plots]
    # The CLI writes poses.png beside the run.
    tplot.main([str(experiment)])
    assert os.path.exists(experiment / "poses.png")


def test_visualize_loss_holds_jaxs_series(tmp_path, recorded_plots):
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(1, 9, (3, 40)), axis=1).astype(np.float32)
    w_pred = rng.dirichlet(np.ones(40), 3).astype(np.float32)
    w_gt = rng.dirichlet(np.ones(40), 3).astype(np.float32)
    args = (z, w_pred, w_gt, 5.0, 0.8, 0.5)
    jdbg.visualize_loss(*args, str(tmp_path / "j"), 7, ray_idx=1)
    out = tdbg.visualize_loss(*args, str(tmp_path / "t"), 7, ray_idx=1)
    assert out == str(tmp_path / "t" / "viz_loss" / "iter_7.png")
    assert os.path.exists(tmp_path / "j" / "viz_loss" / "iter_7.png")
    colors = [kw["color"] for _, kw in recorded_plots]
    meta = _check_series(out, recorded_plots, colors)
    assert meta["VLines"] == [5.0] and meta["Axes"]["ylim"] == [0.0, 1.0]


def test_map_jobs_over_two_cpu_devices():
    seen = []
    both = threading.Barrier(2, timeout=30)  # the first two jobs need both workers at once

    def square(job, device):
        seen.append((threading.current_thread().name, device))
        if job < 2:
            both.wait()
        return job * job

    devices = [CPU, CPU]
    assert map_jobs(square, range(12), devices=devices) == [i * i for i in range(12)]
    assert len({name for name, _ in seen}) == 2 and {d for _, d in seen} == {CPU}
    assert map_jobs(square, [], devices=devices) == []
    assert map_jobs(square, [3], devices=[CPU]) == [9]  # one device: in this thread
    ran = []

    def failing(job, device):
        ran.append(job)
        if job == 2:
            raise KeyError("job 2")
        time.sleep(0.02)
        return job

    with pytest.raises(KeyError, match="job 2"):
        map_jobs(failing, range(40), devices=devices)
    assert len(ran) < 40  # the queue stopped
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            map_jobs(square, [1])  # the default devices are the cards: no fallback


def _stamp_cmd(path: str, sleep_s: float) -> list:
    code = ("import time,sys;open(sys.argv[1],'w').write(str(time.time()));"
            f"time.sleep({sleep_s});open(sys.argv[1],'a').write(' '+str(time.time()))")
    return [sys.executable, "-c", code, path]


def test_run_pool_runs_concurrently_pins_devices_and_reports_failures(tmp_path):
    paths = [str(tmp_path / f"t{i}") for i in range(3)]
    results = run_pool([_stamp_cmd(p, 1.5) for p in paths], workers=2)
    assert [r.returncode for r in results] == [0, 0, 0]
    iv = [tuple(map(float, open(p).read().split())) for p in paths]
    assert iv[0][0] < iv[1][1] and iv[1][0] < iv[0][1]  # 0 and 1 overlap
    assert iv[2][0] >= min(iv[0][1], iv[1][1]) - 0.2  # 2 waits for a slot
    code = "import os,sys;open(sys.argv[1],'w').write(os.environ.get('CUDA_VISIBLE_DEVICES','-'))"
    paths = [str(tmp_path / f"d{i}") for i in range(2)]
    results = run_pool([[sys.executable, "-c", code, p] for p in paths], workers=2,
                       devices=["0", "1"])
    assert all(r.returncode == 0 for r in results) and [r.device for r in results] == ["0", "1"]
    assert sorted(open(p).read() for p in paths) == ["0", "1"]
    results = run_pool([[sys.executable, "-c", "import sys; sys.exit(3)"],
                        _stamp_cmd(str(tmp_path / "ok"), 0.1)], workers=2)
    assert [r.returncode for r in results] == [3, 0]


def test_run_loner_runs_repeats_through_the_trial_pool(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "loner_tpu_torch.run_loner", "synthetic",
         os.path.join(REPO, "cfg/synthetic/box_room_tiny.yaml"), "--device", "cpu", "--lite",
         "--synthetic_scans", "12", "--duration", "1.2", "--num_repeats", "2",
         "--trial_workers", "2", "--experiment_name", "pool"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "trial 0: rc=0" in out.stdout and "trial 1: rc=0" in out.stdout
    base = tmp_path / "outputs" / "pool" / "config_0"  # the JAX runner's layout
    trials = sorted(p for p in base.iterdir() if p.name.startswith("trial_"))
    assert [p.name for p in trials] == ["trial_0", "trial_1"]
    for d in trials:
        assert (d / "trajectory" / "estimated_trajectory.txt").exists()
        assert (d / "checkpoints" / "final.tar").exists()
