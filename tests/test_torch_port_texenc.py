"""The learned texture features and the apps on clip datasets vs the JAX
package's: `losses/learned_features` (`TexEncoder` on the committed
`artifacts/texenc/texenc.npz`, `TexDecoder`, `degrade`, the npz layout),
the draws it needs (`utils/jax_prng.normal`, `randint`), the antialiased
x1/4 resize, `apps/train_texenc` (three steps from the same weights),
`apps/adv_evidence`, `apps/main_psnr_crops` and `apps/dataset_viewer`'s
export, on one clip directory that JAX's generator writes.

Tolerances.  Convolutions and resizes in float32 (oneDNN against XLA):
the encoder's features 1e-5, the resizes 1e-6.  `jax_prng.randint` and
``split`` are JAX's bit for bit; `normal` computes XLA's erf_inv
polynomial in numpy, whose ``log1p`` is the C library's and not XLA's:
at most 4 ulps (3 seen).  `degrade` adds 0.02 x that noise to the
resizes: 1e-6.  Three Adam steps of the restoration loss from the same
weights and draws: the losses within 1e-4 relative (Adam's first steps
are nearly sign steps of the float32 gradients).  The harnesses' PSNRs
0.05 dB (the stats harness's bound, `test_torch_port_frontends.py`);
the gradient ratio and the gram distances, float32 reductions, 1e-3
relative; the gradient histograms' mean L1 1e-3 (a value on a bin edge
may land in the next bin); the crop PSNRs as JAX prints them (two
decimals) 0.055 dB; PNGs and contact sheets within one level.
"""

import contextlib
import io
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from isosurfacesuperresolution_tpu.apps import adv_evidence as j_adv
from isosurfacesuperresolution_tpu.apps import dataset_viewer as j_viewer
from isosurfacesuperresolution_tpu.apps import main_psnr_crops as j_crops
from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.data.generation import (
    SequenceConfig, generate_sequences)
from isosurfacesuperresolution_tpu.losses import learned_features as J
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.apps import adv_evidence as p_adv
from isosurfacesuperresolution_tpu_torch.apps import dataset_viewer as p_viewer
from isosurfacesuperresolution_tpu_torch.apps import main_psnr_crops as p_crops
from isosurfacesuperresolution_tpu_torch.apps import train_texenc as p_train
from isosurfacesuperresolution_tpu_torch.losses import learned_features as P
from isosurfacesuperresolution_tpu_torch.losses.vgg import load_vgg19_params
from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.utils import jax_prng

RUN = "artifacts/run00017"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two 3-frame clips of a 32^3 sphere at 96^2, written by JAX's
    generator in the reference's npy layout."""
    out = str(tmp_path_factory.mktemp("clips"))
    generate_sequences([(j_analytic.sphere_volume(32), (0.5, 0.5))], 2,
                       SequenceConfig(num_frames=3, high_res=96,
                                      ao_samples=0),
                       base_render_cfg=JRenderConfig(step_voxels=0.5),
                       seed=0, out_dir=out)
    return out


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fn(*args)
    return out, buf.getvalue()


def _torch_state(flax_params, names):
    """A Flax conv tree -> a PyTorch conv state dict (OIHW kernels)."""
    state = {}
    for name in names:
        k = np.asarray(flax_params[name]["kernel"])
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(
            np.array(flax_params[name]["bias"]))
    return state


def test_encoder_on_committed_weights_matches_jax():
    x = np.random.RandomState(0).rand(2, 32, 40, 3).astype(np.float32)
    want = J.TexEncoder().apply({"params": J.load_texenc_params()},
                                jnp.asarray(x))
    enc = P.TexEncoder()
    enc.load_state_dict(P.load_texenc_params())
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert list(got) == ["conv_1", "conv_2", "conv_3", "conv_4"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0)
    assert P.load_texenc_params("no/such/texenc.npz") is None


def test_saved_npz_loads_in_both_packages(tmp_path):
    enc = P.TexEncoder()
    enc.load_state_dict(P.load_texenc_params())
    path = str(tmp_path / "texenc.npz")
    P.save_texenc_params(enc.state_dict(), path)
    with np.load(path) as a, np.load(P.DEFAULT_PATH) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    jp = J.load_texenc_params(path)
    np.testing.assert_array_equal(np.asarray(jp["conv_2"]["kernel"]),
                                  enc.conv_2.weight.detach().permute(
                                      2, 3, 1, 0).numpy())


def test_decoder_matches_jax():
    z = jnp.asarray(np.random.RandomState(1).rand(2, 8, 10, 128)
                    .astype(np.float32))
    params = J.TexDecoder().init(jax.random.PRNGKey(1), z)["params"]
    want = J.TexDecoder().apply({"params": params}, z)
    dec = P.TexDecoder()
    dec.load_state_dict(_torch_state(params, dec.names + ["out"]))
    with torch.no_grad():
        got = dec(torch.from_numpy(np.asarray(z)))
    assert tuple(got.shape) == want.shape == (2, 32, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shape", [(2, 32, 40, 3), (1, 96, 64, 3)])
def test_quarter_resize_is_jax_antialiased_linear(shape):
    """`jax.image.resize(..., "linear")` antialiases when it shrinks
    (F.interpolate does not); the port's `ops/resize` follows JAX."""
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    b, h, w, c = shape
    want = jax.image.resize(jnp.asarray(x), (b, h // 4, w // 4, c), "linear")
    got = resize(torch.from_numpy(x), size=(h // 4, w // 4), method="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(h // 4, w // 4),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_and_randint_draws_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    pkey = jax_prng.prng_key(seed)
    want = np.asarray(jax.random.normal(key, (4, 64, 64, 3), jnp.float32))
    got = jax_prng.normal(pkey, (4, 64, 64, 3))
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4 and (ulps == 0).mean() > 0.9
    for n in (1, 7, 100, 12345):
        np.testing.assert_array_equal(
            jax_prng.randint(pkey, (32,), 0, n),
            np.asarray(jax.random.randint(key, (32,), 0, n)))
    split = [tuple(int(v) for v in np.asarray(k))
             for k in jax.random.split(key, 3)]
    assert jax_prng.split(pkey, 3) == split


def test_degrade_matches_jax():
    x = np.random.RandomState(3).rand(2, 32, 40, 3).astype(np.float32)
    want = J.degrade(jnp.asarray(x), jax.random.PRNGKey(5))
    got = P.degrade(torch.from_numpy(x), jax_prng.prng_key(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def _jax_losses(clean, pe, pd, steps, batch, lr, seed):
    """JAX's `train_texenc` loop from the given weights."""
    enc, dec = J.TexEncoder(), J.TexDecoder()
    params = {"enc": pe, "dec": pd}
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch, key):
        def loss_fn(p):
            feats = enc.apply({"params": p["enc"]}, J.degrade(batch, key))
            out = dec.apply({"params": p["dec"]}, feats["conv_4"])
            return jnp.mean((out - batch) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(seed)
    clean_j = jnp.asarray(clean)
    losses = []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        idx = jax.random.randint(k1, (batch,), 0, clean.shape[0])
        params, opt_state, loss = step(params, opt_state, clean_j[idx], k2)
        losses.append(float(loss))
    return losses


def test_train_texenc_steps_match_jax(clips, tmp_path):
    clean = p_train.clean_crops(clips, 16, 12, 0, "cpu")
    assert tuple(clean.shape[1:]) == (64, 64, 3)
    x0 = jnp.zeros((1,) + tuple(clean.shape[1:]))
    key = jax.random.PRNGKey(0)
    pe = J.TexEncoder().init(key, x0)["params"]
    pd = J.TexDecoder().init(
        key, J.TexEncoder().apply({"params": pe}, x0)["conv_4"])["params"]
    want = _jax_losses(clean.numpy(), pe, pd, 3, 4, 2e-4, 0)
    enc, dec = P.TexEncoder(), P.TexDecoder()
    enc.load_state_dict(_torch_state(pe, enc.names))
    dec.load_state_dict(_torch_state(pd, dec.names + ["out"]))
    got = [float(v) for v in p_train.train(clean, enc, dec, 3, 4, 2e-4, 0)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[2] != got[0]

    # the entry point writes an encoder that JAX's loader reads
    out = str(tmp_path / "texenc.npz")
    (losses, _), log = _stdout(p_train.main, [
        "--dataset", clips, "--cropSize", "16", "--samples", "12",
        "--steps", "3", "--batchSize", "4", "--output", out, "--device",
        "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "step 0: loss" in log and "step 2: loss" in log
    assert "gram(clean, blurred) at conv_3" in log
    assert J.load_texenc_params(out) is not None


def _shared_vgg(tmp_path, monkeypatch, max_conv=8):
    """Point both packages at one VGG weight file: the port's fixed-seed
    features in the npz layout."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, _ = load_vgg19_params(max_conv)
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **{
        f"conv_{i}_{leaf}": (state[f"conv_{i}.weight"].permute(2, 3, 1, 0)
                             if leaf == "kernel" else
                             state[f"conv_{i}.bias"]).numpy()
        for i in range(1, max_conv + 1) for leaf in ("kernel", "bias")})
    monkeypatch.setenv("ISOSR_VGG19_WEIGHTS", path)


def test_adv_evidence_matches_jax(clips, tmp_path, monkeypatch):
    _shared_vgg(tmp_path, monkeypatch)
    argv = ["--dataset", clips, "--models", "bilinear", RUN, "--samples",
            "16", "--cropSize", "16", "--testFraction", "0.5",
            "--numPanels", "2"]
    _stdout(j_adv.main, argv + ["--output", str(tmp_path / "j")])
    rows, out = _stdout(p_adv.main, argv + ["--output", str(tmp_path / "p"),
                                            "--device", "cpu"])
    lines = [open(tmp_path / d / "adv_evidence.tsv").read().splitlines()
             for d in ("j", "p")]
    assert lines[1][0] == lines[0][0]
    assert [r[0] for r in rows] == ["bilinear", "run00017"]
    for jline, row in zip(lines[0][1:], rows):
        j = [float(v) for v in jline.split("\t")[1:]]
        p = np.array(row[1:])
        assert jline.split("\t")[0] == row[0]
        assert abs(p[0] - j[0]) <= 0.05
        np.testing.assert_allclose(p[[1, 3, 4, 5]], np.array(j)[[1, 3, 4, 5]],
                                   rtol=1e-3, atol=1e-4)
        assert abs(p[2] - j[2]) <= 1e-3
        assert np.isfinite(p).all()
    assert 0.0 < rows[0][2] < 1.0            # bilinear smooths
    a, b = (np.asarray(Image.open(tmp_path / d / "panels.png"), np.int16)
            for d in ("j", "p"))
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert (open(tmp_path / "p" / "panels.txt").read()
            == open(tmp_path / "j" / "panels.txt").read())


def test_main_psnr_crops_matches_jax(clips):
    argv = ["--dataset", clips, "--models", "bilinear", RUN, "--samples",
            "16", "--cropSize", "16", "--testFraction", "0.5"]
    _, jout = _stdout(j_crops.main, argv)
    got, pout = _stdout(p_crops.main, argv + ["--device", "cpu"])
    assert re.search(r"test crops: 8", pout) and "test crops: 8" in jout
    for name in ("bilinear", "run00017"):
        row = [ln for ln in jout.splitlines() if ln.startswith(name)][0]
        want = np.array([float(v) for v in row.split()[1:]])
        assert len(got[name]) == 6 and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want, atol=0.05 + 0.005,
                                   rtol=0)


def test_dataset_viewer_export_matches_jax(clips, tmp_path):
    j_viewer.main([clips, "--output", str(tmp_path / "j")])
    written, _ = _stdout(p_viewer.main, [clips, "--output",
                                         str(tmp_path / "p"), "--device",
                                         "cpu"])
    assert [os.path.basename(p) for p in written] == ["clip_000.png",
                                                      "clip_001.png"]
    for p in written:
        a = np.asarray(Image.open(tmp_path / "j" / os.path.basename(p)),
                       np.int16)
        b = np.asarray(Image.open(p), np.int16)
        assert a.shape == b.shape == (3 * 96, 6 * 96, 3)
        assert np.abs(a - b).max() <= 1
