"""The viewer's camera and core vs the JAX package's: `render/camera.
OrbitCamera` for each `Orientation`, and `apps/main_gui.Viewer` driven the
same way in both packages (as `tests/test_gui.py` drives JAX's): every
mode (run00017, nearest, bilinear, bicubic, the ground truth) and channel,
focus of context, temporal smoothing, the screenshot, the per-mode
recurrence and the headless orbit of `main`, at 32x24 low resolution on
a 32^3 analytic volume with ``renderer="sweep_pallas"`` (JAX's Pallas
march in interpret mode, the port's march kernel through its plain
version on the CPU); and the apps built on the viewer:
`main_comparison_video` (a script and a one-scene preset, through the
PNG branch) and `image_vis`, on the default scan.

Tolerances.  The orbit camera is the same host float math and the same
float32 matrices: 1e-6.  The ground truth, focus of context and the
resize modes are float32 G-buffers of the same march (held to JAX's at
1e-4 with the mask equal in `test_torch_port_sweep.py`) shaded alike:
1e-4 over every pixel.  run00017 runs the planar engine in both packages,
whose borders use the same resize-clamp semantics (`infer/planar.py:
23-25`), so the whole frame is compared: float32 convolutions (oneDNN
against XLA) through 10 residual blocks and a recurrence of up to six
frames, 2e-4 (seen: 6.6e-5).  PNGs within one 8-bit level (a value
within 2e-4 of a quantisation step may truncate the other way).
"""

import contextlib
import io
import json
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from isosurfacesuperresolution_tpu.apps import image_vis as j_image_vis
from isosurfacesuperresolution_tpu.apps import main_comparison_video as j_vid
from isosurfacesuperresolution_tpu.apps import main_gui as j_gui
from isosurfacesuperresolution_tpu.apps.main_gui import Viewer as JViewer
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu.render import camera as jcam
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.apps import image_vis as p_image_vis
from isosurfacesuperresolution_tpu_torch.apps import (
    main_comparison_video as p_vid)
from isosurfacesuperresolution_tpu_torch.apps import main_gui as p_gui
from isosurfacesuperresolution_tpu_torch.apps.main_gui import Viewer
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.render import camera as pcam
from isosurfacesuperresolution_tpu_torch.volume import analytic

RUN = "artifacts/run00017"
VOLUME = "analytic:sphere:32"
MODEL_BOUND, RENDER_BOUND = 2e-4, 1e-4


@pytest.mark.parametrize("name", [o.name for o in pcam.Orientation])
def test_orbit_camera_matches_jax(name):
    """Eye, view and projection after a drag past the pitch clamp, a zoom
    and a second drag."""
    cams = [jcam.OrbitCamera(32, 24), pcam.OrbitCamera(32, 24)]
    for c in cams:
        c.orientation = type(c.orientation)[name]
        c.start_move()
        c.move(37, -250)                     # past -80 degrees: clamped
        c.zoom(-3)
        c.start_move()
        c.move(-12, 40)
    j, p = (c.params() for c in cams)
    assert cams[1].current_pitch == cams[0].current_pitch
    assert cams[1].get_up() == cams[0].get_up()
    np.testing.assert_allclose(p.eye.numpy(), np.asarray(j.eye), atol=1e-6)
    np.testing.assert_allclose(p.view_matrix().numpy(),
                               np.asarray(j.view_matrix()), atol=1e-6)
    np.testing.assert_allclose(p.mvp(32, 24).numpy(),
                               np.asarray(j.mvp(32, 24)), atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def viewers():
    """(JAX viewer, port viewer) on the same 32^3 blobs with run00017,
    moved closer so that the object fills the frame."""
    jv = JViewer(j_analytic.blobs_volume(32, num_blobs=5),
                 {"run00017": JLoadedModel.from_run_dir(RUN)},
                 res_x=32, res_y=24, isovalue=0.5, renderer="sweep_pallas")
    pv = Viewer(analytic.blobs_volume(32, num_blobs=5, device="cpu"),
                {"run00017": LoadedModel.from_run_dir(RUN, device="cpu")},
                res_x=32, res_y=24, isovalue=0.5, renderer="sweep_pallas")
    for v in (jv, pv):
        v.camera.zoom(-4)
    return jv, pv


def _both(viewers, fn):
    for v in viewers:
        fn(v)


def _frames(viewers):
    jv, pv = viewers
    a, b = jv.render_frame(), pv.render_frame()
    assert b.shape == a.shape == (96, 128, 3) and b.dtype == np.float32
    return a, b


@pytest.mark.parametrize("mode", ["run00017", "bilinear", "nearest",
                                  "bicubic", "gt"])
def test_modes_and_channels_match_jax(viewers, mode):
    """Each channel in turn, one orbit step a frame: the recurrence
    advances across the channels as a user's clicks would."""
    bound = MODEL_BOUND if mode == "run00017" else RENDER_BOUND
    _both(viewers, lambda v: v.set_mode(mode))
    for ch in Viewer.CHANNELS:
        _both(viewers, lambda v: setattr(v, "channel", ch))
        _both(viewers, lambda v: (v.camera.start_move(),
                                  v.camera.move(15, 5)))
        a, b = _frames(viewers)
        np.testing.assert_allclose(b, a, atol=bound, rtol=0,
                                   err_msg=f"{mode} {ch}")
    _both(viewers, lambda v: setattr(v, "channel", "color"))
    assert viewers[1].fps > 0


def test_focus_of_context_matches_jax(viewers):
    _both(viewers, lambda v: v.set_mode("bilinear"))
    plain = viewers[1].render_frame()
    viewers[0].render_frame()

    def foc(v):
        v.foc_enabled = True
        v.foc_center = (64, 48)
        v.foc_window_size = 24
    _both(viewers, foc)
    a, b = _frames(viewers)
    _both(viewers, lambda v: setattr(v, "foc_enabled", False))
    np.testing.assert_allclose(b, a, atol=RENDER_BOUND, rtol=0)
    assert np.abs(b - plain).max() > 0.01      # the lens shows


def test_temporal_smoothing_matches_jax(viewers):
    _both(viewers, lambda v: v.set_mode("run00017"))
    _both(viewers, lambda v: setattr(v, "temporal_smoothing", 0.5))
    for i in range(3):
        _both(viewers, lambda v: (v.camera.start_move(),
                                  v.camera.move(-20, 0)))
        a, b = _frames(viewers)
        np.testing.assert_allclose(b, a, atol=MODEL_BOUND, rtol=0)
    _both(viewers, lambda v: setattr(v, "temporal_smoothing", 0.0))


def test_screenshot_matches_jax(viewers, tmp_path):
    """After a material change (remembered for the pipelines; the frames
    read the viewer's own render parameters, as in JAX) the PNG and its
    JSON sidecar."""
    _both(viewers, lambda v: v.set_mode("bilinear"))
    _both(viewers, lambda v: v.set_material(diffuse_color=(0.2, 0.5, 0.9)))
    paths = [v.save_screenshot(str(tmp_path / str(i)))
             for i, v in enumerate(viewers)]
    imgs = [np.asarray(Image.open(p), np.int16) for p in paths]
    assert imgs[1].shape == imgs[0].shape == (96, 128, 3)
    assert np.abs(imgs[1] - imgs[0]).max() <= 1
    infos = []
    for p in paths:
        with open(p + ".json") as f:
            info = json.load(f)
        assert info.pop("timestamp")
        infos.append(info)
    assert infos[1] == infos[0]
    assert os.path.basename(paths[1]).startswith("volume.bilinear.color.")


def test_mode_switch_keeps_each_pipelines_recurrence(viewers):
    """The preset videos flip ``mode`` per column: each pipeline keeps its
    own state; a scripted isovalue sweep keeps it when asked, the slider
    clears it."""
    v = viewers[1]
    v.set_mode("bilinear")
    v.render_frame()
    pipe = v._pipeline("bilinear")
    assert pipe._last_cam is not None
    v.mode = "nearest"
    v.render_frame()
    assert pipe._last_cam is not None
    v.set_isovalue(0.45, reset_temporal=False)
    assert pipe._last_cam is not None
    assert pipe.render_params.isovalue == 0.45
    v.set_isovalue(0.5)
    assert pipe._last_cam is None
    assert not pipe.state.has_prev


def test_headless_orbit_matches_jax(tmp_path):
    """`main --frames N`: the orbit written as PNGs, on the default scan."""
    argv = ["--volume", "analytic:sphere:32", "--resX", "16", "--resY",
            "12", "--frames", "3"]
    j_gui.main(argv + ["--output", str(tmp_path / "j")])
    viewer = p_gui.main(argv + ["--output", str(tmp_path / "p"),
                                "--device", "cpu"])
    assert viewer.mode == "bilinear" and viewer.input_name == "sphere"
    names = [f"frame_{i:04d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "p")) == names
    for n in names:
        a = np.asarray(Image.open(tmp_path / "j" / n), np.int16)
        b = np.asarray(Image.open(tmp_path / "p" / n), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        assert np.abs(a - b).max() <= 1


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fn(*args)
    return out, buf.getvalue()


def _png(path):
    return np.asarray(Image.open(path), np.int16)


def _same_pngs(a_dir, b_dir, names):
    for n in names:
        a, b = _png(os.path.join(a_dir, n)), _png(os.path.join(b_dir, n))
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= 1, n


def test_comparison_video_script_matches_jax(tmp_path):
    """The isovalue sweep (the recurrence kept across it) on two baseline
    modes, two channels, PNGs."""
    argv = ["--volume", VOLUME, "--models", "bilinear", "nearest",
            "--script", "isovalue", "--frames", "3", "--lowRes", "16",
            "--channels", "color", "normal", "--pngs"]
    j_vid.main(argv + ["--output", str(tmp_path / "j")])
    written, _ = _stdout(p_vid.main, argv + ["--output",
                                             str(tmp_path / "p"),
                                             "--device", "cpu"])
    tags = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == tags
    assert len(written) == len(tags) == 4
    for tag in tags:
        _same_pngs(tmp_path / "j" / tag, tmp_path / "p" / tag,
                   [f"{i:04d}.png" for i in range(3)])


def test_comparison_video_preset_png_branch_matches_jax(tmp_path,
                                                        monkeypatch):
    """A one-scene preset: labeled side-by-side columns, and the video
    falls back to PNGs (no mp4 writer here; no imageio on the card's
    machine)."""
    scene = dict(p_vid.PRESETS["v2"][1], volume=VOLUME)
    for mod in (j_vid, p_vid):
        monkeypatch.setattr(mod, "PRESETS", {"t": [scene]})
    argv = ["--preset", "t", "--models", "bilinear", "nearest", "--frames",
            "2", "--lowRes", "16"]
    j_vid.main(argv + ["--output", str(tmp_path / "j")])
    written, out = _stdout(p_vid.main, argv + ["--output",
                                               str(tmp_path / "p"),
                                               "--device", "cpu"])
    assert "writing PNGs" in out
    assert written == [str(tmp_path / "p" / "t_gyroid-shell")]
    _same_pngs(tmp_path / "j" / "t_gyroid-shell", written[0],
               ["0000.png", "0001.png"])
    assert _png(os.path.join(written[0], "0000.png")).shape == (64, 128, 3)


def test_image_vis_matches_jax(tmp_path):
    argv = ["--volume", VOLUME, "--models", "bilinear", "gt", "--lowRes",
            "16", "--lens", "0.4,0.6,0.3"]
    j_image_vis.main(argv + ["--output", str(tmp_path / "j")])
    paths, _ = _stdout(p_image_vis.main, argv + ["--output",
                                                 str(tmp_path / "p"),
                                                 "--device", "cpu"])
    names = ["sphere_bilinear_lens.png", "sphere_gt_lens.png"]
    assert [os.path.basename(p) for p in paths] == names
    _same_pngs(tmp_path / "j", tmp_path / "p", names)
