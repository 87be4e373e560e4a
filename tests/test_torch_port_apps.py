"""The evaluation apps vs the JAX package's, at tiny counts on the CPU:
`main_comparison` (timings.csv and the saved frames),
`main_psnr_allangles` (without and with the baked AO field),
`vgg_analysis`, `discr_test` on the adversarial orbax run
`artifacts/run00020/run00020`, `delete_empty_runs` and `utils/profiling`
(the apps built on the viewer are in `test_torch_port_gui.py`).

Tolerances.  Frames are float32 slice-scan renders of a 32^3 sphere
(1e-4 against JAX, `test_torch_port_sweep.py`) through the resize modes
or run00017's float32 network (the viewer's 2e-4, `test_torch_port_
gui.py`): PNGs within one 8-bit level.  Times are the two machines'
own and are not compared; the files, their names and columns are.  The
all-angle PSNRs and SSIMs are float32 reductions of such frames: 0.05 dB
and 1e-3, the stats harness's bounds (`test_torch_port_frontends.py`);
the PSNR variances over the views 0.05 dB^2.  The VGG table's mean
responses are float32 convolutions of such renders: 1e-3 relative (both
packages read the same VGG weight file).  The discriminator's logits: both
packages score the one clip the port's generator renders (the clips
themselves are held against JAX's in `test_torch_port_generation.py`),
through the generator and an 8-layer conv stack: 1e-3 relative to the
logit, plus JAX's printed rounding.
"""

import contextlib
import io
import os
import re
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from isosurfacesuperresolution_tpu.apps import delete_empty_runs as j_delete
from isosurfacesuperresolution_tpu.apps import discr_test as j_discr
from isosurfacesuperresolution_tpu.apps import main_comparison as j_cmp
from isosurfacesuperresolution_tpu.apps import main_psnr_allangles as j_aa
from isosurfacesuperresolution_tpu.apps import vgg_analysis as j_vgg
from isosurfacesuperresolution_tpu_torch.apps import (
    delete_empty_runs as p_delete)
from isosurfacesuperresolution_tpu_torch.apps import discr_test as p_discr
from isosurfacesuperresolution_tpu_torch.apps import main_comparison as p_cmp
from isosurfacesuperresolution_tpu_torch.apps import (
    main_psnr_allangles as p_aa)
from isosurfacesuperresolution_tpu_torch.apps import vgg_analysis as p_vgg
from isosurfacesuperresolution_tpu_torch.losses.vgg import load_vgg19_params
from isosurfacesuperresolution_tpu_torch.utils import profiling

RUN = "artifacts/run00017"
VOLUME = "analytic:sphere:32"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_main_comparison_matches_jax(tmp_path):
    argv = ["--volume", VOLUME, "--models", RUN, "--width", "64",
            "--height", "64", "--warmup", "1", "--timed", "2",
            "--saveImages"]
    j_cmp.main(argv + ["--output", str(tmp_path / "j")])
    rows, out = _stdout(p_cmp.main, argv + ["--output", str(tmp_path / "p"),
                                            "--device", "cpu"])
    assert "run00017: total" in out
    j_csv, p_csv = (open(tmp_path / d / "timings.csv").read().splitlines()
                    for d in ("j", "p"))
    assert p_csv[0] == j_csv[0]
    assert [r.split(",")[0] for r in p_csv] == [r.split(",")[0]
                                                for r in j_csv]
    for name, rt, nt, tt in rows:
        assert rt > 0 and tt > 0 and nt >= 0
    _same_pngs(tmp_path / "j", tmp_path / "p", ["sphere_run00017.png"])


def _tsv(path):
    lines = open(path).read().strip().split("\n")
    return lines[0], [line.split("\t") for line in lines[1:]]


@pytest.mark.parametrize("ao", [0, 8])
def test_allangles_matches_jax(tmp_path, ao):
    models = ["bilinear", RUN] if ao == 0 else ["bilinear"]
    argv = ["--volume", VOLUME, "--models", *models, "--cameras",
            "2" if ao == 0 else "1", "--rolls", "2", "--lowRes", "16",
            "--aoSamples", str(ao)]
    j_aa.main(argv + ["--output", str(tmp_path / "j")])
    _stdout(p_aa.main, argv + ["--output", str(tmp_path / "p"), "--device",
                               "cpu"])
    jh, jrows = _tsv(tmp_path / "j" / "allangles_sphere.tsv")
    ph, prows = _tsv(tmp_path / "p" / "allangles_sphere.tsv")
    assert ph == jh
    assert [r[0] for r in prows] == [r[0] for r in jrows] == [
        os.path.basename(m) for m in models]
    for j, p in zip(jrows, prows):
        jv, pv = np.array(j[1:], float), np.array(p[1:], float)
        psnrs = [0, 1, 2, 4, 5, 6]
        np.testing.assert_allclose(pv[psnrs], jv[psnrs], atol=0.05, rtol=0)
        np.testing.assert_allclose(pv[[3, 7]], jv[[3, 7]], atol=0.05,
                                   rtol=0)
        np.testing.assert_allclose(pv[[8, 9]], jv[[8, 9]], atol=1e-3,
                                   rtol=0)
        assert pv[10] == jv[10] == 0
        assert 5.0 < pv[2] < 80.0 and 5.0 < pv[6] < 80.0


def test_vgg_analysis_matches_jax(tmp_path, monkeypatch):
    """Both packages read one weight file: the port's fixed-seed
    features written in the npz layout."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, pretrained = load_vgg19_params(3)
    assert not pretrained
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **{
        f"conv_{i}_{leaf}": (state[f"conv_{i}.weight"].permute(2, 3, 1, 0)
                             if leaf == "kernel" else
                             state[f"conv_{i}.bias"]).numpy()
        for i in range(1, 4) for leaf in ("kernel", "bias")})
    monkeypatch.setenv("ISOSR_VGG19_WEIGHTS", path)
    argv = ["--volume", VOLUME, "--images", "2", "--res", "32",
            "--layers", "3"]
    _, jout = _stdout(j_vgg.main, argv)
    table, pout = _stdout(p_vgg.main, argv + ["--device", "cpu"])
    assert "pretrained VGG: True" in pout
    jtab = re.findall(r"^(conv_\d+)\t([\d.]+)\t([\d.]+)$", jout, re.M)
    assert [k for k, _, _ in jtab] == [k for k, _, _ in table] == [
        "conv_1", "conv_2", "conv_3"]
    for (_, jm, jw), (_, pm, pw) in zip(jtab, table):
        np.testing.assert_allclose(pm, float(jm), rtol=1e-3, atol=5e-5)
        np.testing.assert_allclose(pw, float(jw), rtol=1e-3, atol=5e-5)
    assert "--perceptualLossLayers" in pout


def test_discr_test_on_run00020_matches_jax(monkeypatch):
    """The port's app renders its clip; JAX's app scores that same clip
    (its generator swapped for one returning it)."""
    from isosurfacesuperresolution_tpu.data import generation as j_gen
    from isosurfacesuperresolution_tpu_torch.data import generation as p_gen
    clips = []

    def port_generate(*args, **kw):
        clips.extend(real(*args, **kw))
        return clips

    real = p_gen.generate_sequences
    monkeypatch.setattr(p_gen, "generate_sequences", port_generate)
    monkeypatch.setattr(j_gen, "generate_sequences",
                        lambda *args, **kw: clips)
    run = "artifacts/run00020/run00020"
    argv = [run, "--crops", "2", "--volume", VOLUME]
    (epoch, logits), pout = _stdout(p_discr.main, argv + ["--device",
                                                          "cpu"])
    _, jout = _stdout(j_discr.main, argv)
    assert len(clips) == 1 and clips[0]["high"].shape == (2, 256, 256, 6)
    assert "restored epoch 23" in jout and "restored epoch 23" in pout
    assert epoch == 23
    jlog = [(int(c), n, float(v)) for c, n, v in re.findall(
        r"crop (\d+) (gt|pred): adv logit = ([-+][\d.]+)", jout)]
    assert [(c, n) for c, n, _ in logits] == [(c, n) for c, n, _ in jlog]
    assert len(logits) == 4
    for (_, _, p), (_, _, j) in zip(logits, jlog):
        assert abs(p - j) <= 1e-3 * abs(j) + 5e-5, (p, j)


def test_delete_empty_runs_removes_the_same_directories(tmp_path):
    """Runs with an orbax step stay, runs without a checkpoint go, names
    that are not runs are left alone; the port also keeps runs with its
    own epoch_<N>.pt checkpoints."""
    def make(base):
        (base / "run00001" / "checkpoints" / "3").mkdir(parents=True)
        (base / "run00002").mkdir()
        (base / "run00002" / "info.txt").write_text("x")
        (base / "run00003" / "checkpoints").mkdir(parents=True)
        (base / "run00003" / "checkpoints" / "tmp").write_text("x")
        (base / "notarun").mkdir()
    for name in ("j", "p"):
        make(tmp_path / name)
    assert p_delete.find_empty_runs(str(tmp_path / "p", )) == [
        str(tmp_path / "p" / r) for r in ("run00002", "run00003")]
    _stdout(j_delete.main, [str(tmp_path / "j")])
    gone, _ = _stdout(p_delete.main, [str(tmp_path / "p")])
    assert len(gone) == 2
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j")) == ["notarun", "run00001"]
    own = tmp_path / "own" / "run00004" / "checkpoints"
    own.mkdir(parents=True)
    (own / "epoch_2.pt").write_bytes(b"")
    assert p_delete.find_empty_runs(str(tmp_path / "own")) == []
    _, out = _stdout(p_delete.main, [str(tmp_path / "own"), "--dryRun"])
    assert "no empty runs found" in out


def test_frame_timer_timed_chain_and_trace(tmp_path):
    timer = profiling.FrameTimer(window=3)
    for _ in range(5):
        timer.start()
        dt = timer.stop({"b": torch.ones(2), "a": (torch.zeros(3),)})
        assert dt >= 0
    assert len(timer.times) == 3 and timer.fps > 0 and timer.ms >= 0
    assert profiling.first_tensor({"b": torch.ones(2),
                                   "a": [torch.zeros(3)]}).shape == (3,)
    dt = profiling.timed_chain(lambda c: c * 0.999 + 0.001,
                               torch.ones(64, 64), n=4)
    assert dt > 0
    with profiling.trace(str(tmp_path / "trace")) as d:
        torch.ones(8).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
