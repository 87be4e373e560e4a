"""The port's front ends vs the JAX package's: the pipe server
(`apps/render_server.py`) and its client (`infer/pipe_client.py`), the
renderer CLI (`apps/render_cli.py`), the volume converter
(`apps/convert_volume.py`), the statistics harness (`bench/stats.py`,
`apps/main_psnr_stats.py`), the trainer's imported datasets
(`apps/main_video_unshaded.load_sequences` on ``descriptor:`` and
``.dat``) and `data/dataset_single.load_image_folder`.

Tolerances.  Frames are float32 slice-scan renders of a 32^3 sphere,
which `test_torch_port_sweep.py` holds to JAX's at 1e-4 with the mask
equal: the same bound here, over every pixel (the sphere's background is
identical); decoded 8-bit PNGs of such frames within one level (a value
within 1e-4 of a quantisation step may truncate the other way); the
direct volume renders at 1e-4 (`test_torch_port_volume_render.py`'s
float32 bound).  The converter's arrays are the importers' (equal) and
the bake's (1e-6, `test_torch_port_generation.py`).  `Statistics` fed
the same frames: histogram counts equal; every per-frame metric is a
float32 reduction over 10^2-10^4 terms in another order, so means and
spreads agree within 2e-5 absolute (a few ulps of the PSNRs' magnitude;
the SSIMs of noise sit near 0, where a relative bound means nothing).
The whole harness adds the renders (1e-4) and float32 convolutions
(oneDNN against XLA): PSNR within 0.05 dB, SSIM within 1e-3, the L2
terms within 1e-3 relative.  Clips:
`test_torch_port_generation.py`'s 1e-4, and at most one pixel a frame
whose hit flips (a grazing sample within float32 rounding of the
isovalue, seen on a uint8 torus).
"""

# first: builds the JAX package's native readers once, under a lock
import tests._torch_port_native  # noqa: F401,I001

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.apps import convert_volume as j_convert
from isosurfacesuperresolution_tpu.apps import main_psnr_stats as j_stats_app
from isosurfacesuperresolution_tpu.apps import main_video_unshaded as j_train
from isosurfacesuperresolution_tpu.apps import render_cli as j_cli
from isosurfacesuperresolution_tpu.bench import stats as j_stats
from isosurfacesuperresolution_tpu.data import dataset_single as j_single
from isosurfacesuperresolution_tpu.data.exr import read_exr as j_read_exr
from isosurfacesuperresolution_tpu_torch.apps import (
    convert_volume as p_convert)
from isosurfacesuperresolution_tpu_torch.apps import (
    main_psnr_stats as p_stats_app)
from isosurfacesuperresolution_tpu_torch.apps import (
    main_video_unshaded as p_train)
from isosurfacesuperresolution_tpu_torch.apps import render_cli as p_cli
from isosurfacesuperresolution_tpu_torch.bench import stats as p_stats
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.data import (
    dataset_single as p_single)
from isosurfacesuperresolution_tpu_torch.data.exr import read_exr
from isosurfacesuperresolution_tpu_torch.infer.pipe_client import (
    PipeRenderer)
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.volume import analytic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "artifacts", "run00017")
FRAME_TOL = 1e-4
STATS_ABS = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as `tests/_torch_port_training.py` runs them:
    the suite's workers oversubscribe the machine otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames_close(got, want):
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    assert (got[..., 3] > 0.5).sum() > 20
    np.testing.assert_allclose(got, want, atol=FRAME_TOL, rtol=0)


# ------------------------------------------------------------ pipe server --

W, H = 32, 24
FRAME_BYTES = 12 * W * H * 4 + 4
SESSION = (b"resolution=32,24\nrender\ncameraOrigin=0.3,1.0,-1.6\nrender\n"
           b"isovalue=0.4\nfov=50\nrender\nexit\n")


def _start(package, extra=()):
    cmd = [sys.executable, "-m", f"{package}.apps.render_server",
           "--volume", "analytic:sphere:32", *extra]
    return subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            cwd=ROOT)


def _session(proc, session=SESSION):
    """(exit code, stdout text, the frame stream) of one session."""
    out, stream = proc.communicate(session, timeout=240)
    return proc.returncode, out.decode(), stream


@pytest.fixture(scope="module")
def servers():
    """One session of three frames on each package's server (one child
    process each, started together)."""
    procs = {"port": _start("isosurfacesuperresolution_tpu_torch",
                            ("--device", "cpu")),
             "jax": _start("isosurfacesuperresolution_tpu")}
    return {k: _session(p) for k, p in procs.items()}


def _frames(stream):
    out = []
    for i in range(len(stream) // FRAME_BYTES):
        chunk = stream[i * FRAME_BYTES:(i + 1) * FRAME_BYTES]
        out.append((np.frombuffer(chunk[:-4], "<f4").reshape(12, H, W)
                    .transpose(1, 2, 0),
                    np.frombuffer(chunk[-4:], "<f4")[0]))
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_pipe_server_stream_and_banner(servers, package):
    rc, out, stream = servers[package]
    assert rc == 0
    assert len(stream) == 3 * FRAME_BYTES          # frames and nothing else
    lines = out.splitlines()
    assert lines[0] == "Enter Pipe mode and wait for commands"
    assert lines[-1] == "Exit program"
    for frame, seconds in _frames(stream):
        assert np.isfinite(frame).all() and seconds > 0


def test_pipe_server_frames_match_jax(servers):
    got = _frames(servers["port"][2])
    want = _frames(servers["jax"][2])
    for (g, _), (w, _) in zip(got, want):
        _frames_close(g, w)
    # the isovalue and fov commands took effect
    assert not np.array_equal(got[1][0][..., 3], got[2][0][..., 3])


def test_pipe_server_keeps_other_writes_off_the_frame_stream():
    """What the process writes to stderr (here Python's message for a bad
    volume) reaches stdout; the frame stream stays empty."""
    rc, out, stream = _session(
        _start("isosurfacesuperresolution_tpu_torch",
               ("--device", "cpu", "--volume", "bad:spec")), b"exit\n")
    assert rc != 0 and stream == b""
    assert "bad" in out


def test_pipe_client_round_trip():
    grid = analytic.sphere_volume(32, device="cpu")
    cfg = RenderConfig(width=24, height=16, ao_samples=0)
    with PipeRenderer.local_server("analytic:sphere:32", 24, 16,
                                   device="cpu", cwd=ROOT) as r:
        a = r.render()
        r.send_command("cameraOrigin", "0.2,1.1,-1.5")
        b = r.render()
        assert r.last_time > 0
    assert r.output[0] == "Enter Pipe mode and wait for commands"
    cam_a = CameraParams.create((0.0, 1.0, -1.7))
    cam_b = CameraParams.create((0.2, 1.1, -1.5))
    rp = RenderParams.from_config(cfg)
    for got, cam, prev in ((a, cam_a, cam_a), (b, cam_b, cam_a)):
        want = render_frame_gbuffer(grid, cam, prev, cfg, rp).numpy()
        assert got.shape == (16, 24, 12)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ render CLI --

CLI_CASES = {
    "single": ["--saveExr"],
    "animation": ["--animation", "2", "--downscale_factor", "2",
                  "--origin", "0,1,-1.7,0.4,1,-1.6"],
    "screen_ao": ["--ao", "screen", "--aosamples", "8", "--aoradius", "0.2"],
    "volume": ["-m", "volume"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_render_cli_matches_jax(tmp_path, case):
    common = ["--volume", "analytic:sphere:32", "--res", "32,32",
              "--isovalue", "0.5", "--saveGbuffer", *CLI_CASES[case]]
    p_cli.main(common + ["--output", str(tmp_path / "p"), "--device",
                         "cpu"])
    j_cli.main(common + ["--output", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    assert any(n.endswith(".png") for n in names)
    from PIL import Image
    for n in names:
        got, want = tmp_path / "p" / n, tmp_path / "j" / n
        if n.endswith(".npz"):
            key = "rgba" if case == "volume" else "gbuffer"
            g, w = np.load(got)[key], np.load(want)[key]
            if case == "volume":
                np.testing.assert_allclose(g, w, atol=FRAME_TOL, rtol=0)
            else:
                _frames_close(g, w)
        elif n.endswith(".png"):
            g = np.asarray(Image.open(got), np.int16)
            w = np.asarray(Image.open(want), np.int16)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1
    if case == "single":
        # the EXRs read back as the saved G-buffer's channels, exactly
        gb = np.load(tmp_path / "p" / "sphere.npz")["gbuffer"]
        base = str(tmp_path / "p" / "sphere")
        for suffix, chans in (("", (0, 1, 2, 3)), ("_depth", (4, 5, 6, 7)),
                              ("_fx", (10, 11)), ("_flow", (8, 9))):
            for reader in (read_exr, j_read_exr):
                exr = reader(base + suffix + ".exr")
                for c, k in zip(chans, "RGBA"):
                    np.testing.assert_array_equal(exr[k], gb[..., c])


# ------------------------------------------------------- convert_volume --

def _dat(path):
    vol = np.random.RandomState(9).randint(0, 256, (20, 18, 12)).astype(
        np.uint8)
    vol[:, :, :2] = 0
    (path / "v.raw").write_bytes(vol.transpose(2, 1, 0).tobytes())
    (path / "v.dat").write_text(
        "ObjectFileName: v.raw\nResolution: 20 18 12\nFormat: UCHAR\n")
    return str(path / "v.dat")


@pytest.mark.parametrize("out,extra", [("v.cvol.npz", []),
                                       ("v.vdb", []),
                                       ("ao.cvol.npz", ["--bakeAO",
                                                        "--isovalue", "0.5",
                                                        "--aoRadius",
                                                        "0.3"])])
def test_convert_volume_matches_jax(tmp_path, out, extra):
    dat = _dat(tmp_path)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    p_convert.main([dat, str(tmp_path / "p" / out), "--device", "cpu",
                    *extra])
    j_convert.main([dat, str(tmp_path / "j" / out), *extra])
    got, want = tmp_path / "p" / out, tmp_path / "j" / out
    if out.endswith(".vdb"):
        assert got.read_bytes() == want.read_bytes()
        return
    g, w = np.load(got), np.load(want)
    assert sorted(g.files) == sorted(w.files)
    for k in g.files:
        if k == "ao_sh":
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g[k], w[k])
    assert ("ao_sh" in g.files) == bool(extra)


# ---------------------------------------------------------- statistics --

def _stats_frames(seed, hh=144, lo=36):
    """Seeded (pred, gt, input) frames: masks in [-1, 1] with a filled
    disc, unit normals, depth and AO in [0, 1]."""
    rng = np.random.RandomState(seed)
    out = []
    for res, ch in ((hh, 6), (hh, 6), (lo, 5)):
        y, x = np.mgrid[:res, :res] / res - 0.5
        m = np.where(x ** 2 + y ** 2 < 0.12 + 0.02 * rng.rand(), 1.0, -1.0)
        n = rng.randn(res, res, 3)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        rest = rng.rand(res, res, ch - 4)
        out.append(np.concatenate([m[..., None], n, rest], -1)[None]
                   .astype(np.float32))
    return out


def test_histogram_edges_and_counts_match_jnp():
    import jax.numpy as jnp
    x = np.random.RandomState(0).rand(5000).astype(np.float32) * 1.2 - 0.1
    x[:4] = [0.0, 1.0, p_stats.BIN_EDGES[7], p_stats.BIN_EDGES[133]]
    counts, edges = jnp.histogram(jnp.asarray(x), bins=200, range=(0, 1))
    np.testing.assert_array_equal(p_stats.BIN_EDGES, np.asarray(edges))
    np.testing.assert_array_equal(
        p_stats.histogram_counts(torch.from_numpy(x)).numpy(),
        np.asarray(counts))


def test_statistics_match_jax():
    got, want = p_stats.Statistics(), j_stats.Statistics()
    import jax.numpy as jnp
    seeds = [1, 2, 3, 4]
    for i, seed in enumerate(seeds):
        pred, gt, inp = _stats_frames(seed)
        a = got.add_timestep_sample(*(torch.from_numpy(t)
                                      for t in (pred, gt, inp)))
        b = want.add_timestep_sample(*(jnp.asarray(t)
                                       for t in (pred, gt, inp)))
        assert a == b
        if i % 2 == 1:
            got.mark_sequence()
            want.mark_sequence()
    assert got.n == want.n == 4
    for k, v in want.means().items():
        assert got.means()[k] == pytest.approx(v, rel=0, abs=STATS_ABS), k
    # the counts behind each histogram are equal, so their running means
    # agree to float64 rounding
    for k in want.histograms:
        np.testing.assert_allclose(got.histograms[k], want.histograms[k],
                                   rtol=1e-12, atol=1e-15)
    gs, ws = got.seq_spread(), want.seq_spread()
    assert sorted(gs) == sorted(ws)
    for f in ws:
        assert gs[f]["nseq"] == ws[f]["nseq"] == 2
        for s in ("mean", "std", "min", "max"):
            assert gs[f][s] == pytest.approx(ws[f][s], rel=0,
                                             abs=STATS_ABS), (f, s)
    # an empty frame is skipped by both
    pred, gt, inp = _stats_frames(5)
    gt[..., 0] = -1.0
    assert not got.add_timestep_sample(*(torch.from_numpy(t)
                                         for t in (pred, gt, inp)))


def _read_tsv(path):
    lines = open(path).read().splitlines()
    head = lines[0].split("\t")
    return head, {r.split("\t")[0]: np.array(r.split("\t")[1:], float)
                  for r in lines[1:]}


def test_main_psnr_stats_matches_jax(tmp_path):
    """bilinear and run00017 on one 3-frame clip at highRes 144 (the 15-px
    border crops 60 px a side at 4x, and MS-SSIM needs 16 px left)."""
    args = ["--volumes", "analytic:sphere:32", "--models", "bilinear", RUN,
            "--numSequences", "1", "--numFrames", "3", "--highRes", "144",
            "--aoSamples", "8"]
    p_stats_app.main(args + ["--output", str(tmp_path / "p"),
                             "--renderer", "sweep", "--device", "cpu"])
    j_stats_app.main(args + ["--output", str(tmp_path / "j")])
    head, got = _read_tsv(tmp_path / "p" / "stats_sphere.tsv")
    jhead, want = _read_tsv(tmp_path / "j" / "stats_sphere.tsv")
    assert head == jhead and sorted(got) == sorted(want) == [
        "bilinear", "run00017"]
    fields = head[1:]
    for model in want:
        assert np.isfinite(got[model]).all()
        for f, g, w in zip(fields, got[model], want[model]):
            if f.startswith("PSNR"):
                assert abs(g - w) < 0.05, (model, f, g, w)
            elif f.startswith("SSIM"):
                assert abs(g - w) < 1e-3, (model, f, g, w)
            else:
                assert g == pytest.approx(w, rel=1e-3, abs=1e-6), (
                    model, f, g, w)
    for name in ("hist_sphere_bilinear.npz", "hist_sphere_run00017.npz",
                 "stats_sphere_err.tsv"):
        assert (tmp_path / "p" / name).is_file()
    g = np.load(tmp_path / "p" / "hist_sphere_run00017.npz")
    w = np.load(tmp_path / "j" / "hist_sphere_run00017.npz")
    assert sorted(g.files) == sorted(w.files)
    assert g["seq_psnr_normal"].shape == w["seq_psnr_normal"].shape == (1,)


# ------------------------------------------------- trainer's datasets --

def _train_args(parser, dataset):
    return parser.parse_args(["--dataset", dataset, "--numberOfImages", "1",
                              "--numFrames", "2", "--cropSize", "4",
                              "--aoSamples", "0"])


@pytest.mark.parametrize("kind", ["descriptor", "dat"])
def test_load_sequences_imported_volumes_match_jax(tmp_path, kind):
    vol = analytic.torus_volume(24, device="cpu").values.numpy()
    raw = np.round(vol * 255).astype(np.uint8)
    (tmp_path / "t.raw").write_bytes(raw.transpose(2, 1, 0).tobytes())
    (tmp_path / "t.dat").write_text(
        "ObjectFileName: t.raw\nResolution: 24 24 24\nFormat: UCHAR\n")
    if kind == "descriptor":
        (tmp_path / "list.txt").write_text("# volume min max\n"
                                           "t.dat 0.45 0.55\n")
        spec = "descriptor:" + str(tmp_path / "list.txt")
    else:
        spec = str(tmp_path / "t.dat")
    got = p_train.load_sequences(_train_args(p_train.build_parser(), spec),
                                 None, "cpu")
    want = j_train.load_sequences(_train_args(j_train.build_parser(), spec),
                                  None)
    assert len(got) == len(want) == 1
    for k, shape in (("low", (2, 16, 16, 5)), ("high", (2, 64, 64, 6)),
                     ("flow", (2, 16, 16, 2))):
        g, w = got[0][k], want[0][k]
        assert g.shape == w.shape == shape
        if k == "flow":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
            continue
        # a grazing sample within float32 rounding of the isovalue may
        # hit in one scan and miss in the other: one pixel a frame
        flips = g[..., 0] != w[..., 0]
        assert flips.sum(axis=(1, 2)).max() <= 1, flips.sum(axis=(1, 2))
        np.testing.assert_allclose(g[~flips], w[~flips], atol=1e-4, rtol=0)
    assert (got[0]["low"][..., 0] > 0).any()


# ---------------------------------------------------- image folders --

def test_load_image_folder_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(6)
    Image.fromarray(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)).save(
        tmp_path / "a.png")
    Image.fromarray(rng.randint(0, 256, (16, 12, 3)).astype(np.uint8)).save(
        tmp_path / "b.jpg", quality=90)
    Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).convert(
        "P").save(tmp_path / "c.png")
    (tmp_path / "notes.txt").write_text("skipped")
    got = p_single.load_image_folder(str(tmp_path))
    want = j_single.load_image_folder(str(tmp_path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        p_single.load_image_folder(str(tmp_path / "empty"))
