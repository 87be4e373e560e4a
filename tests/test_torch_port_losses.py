"""The port's loss stack and metrics vs the JAX package's: every
`losses/builder.py` function, the loss DSL, the discriminators (spectral
norm on and off), the VGG taps, `LossNetUnshaded` per loss term on the
generator side and `train_discriminator` for bce, wgan and wgan-gp, the
metrics, and the sweep-vs-march target PSNR.  JAX's parameter trees are
carried into the port's modules; inputs are numpy-seeded.

Tolerances.  Loss terms and metrics are float32 means and sums of the same
elementwise terms in another order: rel 1e-5 (abs 1e-6 near zero).  The
discriminator logits and VGG taps go through several float32 convs
(oneDNN against XLA): 1e-5 of their scale.  The WGAN-GP interpolates use
JAX's own uniform draw (`utils.jax_prng`), so they are the same points.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import carry_criterion, load_flax, to_torch
from isosurfacesuperresolution_tpu import config as jconfig
from isosurfacesuperresolution_tpu.losses import builder as jb
from isosurfacesuperresolution_tpu.losses.discriminators import (
    build_discriminator as j_build_discriminator)
from isosurfacesuperresolution_tpu.losses.lossnet_unshaded import (
    LossNetUnshaded as JLossNetUnshaded)
from isosurfacesuperresolution_tpu.losses.vgg import (
    VGG19Features as JVGG19Features, load_vgg19_params as j_load_vgg)
from isosurfacesuperresolution_tpu.ops import metrics as jm
from isosurfacesuperresolution_tpu_torch import config as pconfig
from isosurfacesuperresolution_tpu_torch.losses import builder as pb
from isosurfacesuperresolution_tpu_torch.losses.discriminators import (
    build_discriminator)
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.losses.vgg import (
    VGG19Features, load_vgg19_params)
from isosurfacesuperresolution_tpu_torch.ops import metrics as pm
from isosurfacesuperresolution_tpu_torch.utils import jax_prng

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _no_vgg_file(monkeypatch, tmp_path):
    """No VGG weight file: both packages take their seeded fallback."""
    monkeypatch.delenv("ISOSR_VGG19_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def images(seed, shape=(2, 16, 16, 6)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = (a + 0.2 * rng.randn(*shape)).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

PAIR_FNS = ["mse", "l1", "gradient_difference", "fft_mse",
            "perceptual_loss", "texture_loss"]


@pytest.mark.parametrize("name", PAIR_FNS)
def test_pair_losses_match_jax(name):
    a, b = images(1, (2, 20, 24, 6))
    want = getattr(jb, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(pb, name)(*to_torch(a, b))
    close(got, want, what=name)


def test_gram_matrix_matches_jax():
    a, _ = images(2, (3, 8, 12, 5))
    close(pb.gram_matrix(torch.from_numpy(a)), jb.gram_matrix(jnp.asarray(a)))


def test_temporal_l2_masked_matches_jax():
    a, b = images(3, (2, 16, 16, 4))
    a[..., 3] = (a[..., 3] > 0.4).astype(np.float32)
    close(pb.temporal_l2_masked(*to_torch(a, b)),
          jb.temporal_l2_masked(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("loss", ["l2", "l1"])
@pytest.mark.parametrize("gt_low_res", [False, True])
def test_downsample_loss_matches_jax(loss, gt_low_res):
    """JAX's antialiased bilinear downsampling (`jax.image.resize`)."""
    a, b = images(4, (2, 32, 24, 5))
    if gt_low_res:
        a = a[:, :8, :6]
    kw = dict(loss=loss, factor=4, gt_low_res=gt_low_res)
    close(pb.downsample_loss(*to_torch(a, b), **kw),
          jb.downsample_loss(jnp.asarray(a), jnp.asarray(b), **kw))


def test_downsample_resize_matches_jax():
    from isosurfacesuperresolution_tpu.ops.resize import resize as jresize
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    a, _ = images(5, (1, 36, 20, 3))
    for size in ((9, 5), (12, 10), (36, 7)):
        close(resize(torch.from_numpy(a), size=size),
              jresize(jnp.asarray(a), size=size), what=str(size))


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_and_gan_losses_match_jax(target):
    rng = np.random.RandomState(6)
    x = (rng.randn(8, 1) * 3).astype(np.float32)
    y = (rng.randn(8, 1) * 3).astype(np.float32)
    tx, ty = to_torch(x, y)
    close(pb.bce_with_logits(tx, target),
          jb.bce_with_logits(jnp.asarray(x), target))
    close(pb.gan_generator_loss(tx), jb.gan_generator_loss(jnp.asarray(x)))
    close(pb.wgan_generator_loss(tx), jb.wgan_generator_loss(jnp.asarray(x)))
    for g, w in zip(pb.gan_discriminator_loss(tx, ty),
                    jb.gan_discriminator_loss(jnp.asarray(x),
                                              jnp.asarray(y))):
        close(g, w)


@pytest.mark.parametrize("border", [0, 3])
def test_pad_border_zero_matches_jax(border):
    a, _ = images(7, (2, 12, 10, 3))
    close(pb.pad_border_zero(torch.from_numpy(a), border),
          jb.pad_border_zero(jnp.asarray(a), border), rtol=0, atol=0)


@pytest.fixture(scope="module")
def small_discr():
    """A 16x16, 8-channel EnhanceNetSmall critic in both packages."""
    jd = j_build_discriminator("enhanceNetSmall", 16, 8)
    params = jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 8)))
    pd = load_flax(build_discriminator("enhanceNetSmall", 16, 8), params)
    return jd, params, pd


@pytest.mark.parametrize("penalty", [False, True])
def test_wgan_discriminator_loss_matches_jax(small_discr, penalty):
    """With the penalty the interpolates come from JAX's uniform draw on
    the same key, and the penalty's gradient reaches the critic's
    parameters through the input gradient."""
    jd, params, pd = small_discr
    a, b = images(8, (3, 16, 16, 8))
    key = jax.random.PRNGKey(11)
    want = jb.wgan_discriminator_loss(
        lambda x: jd.apply(params, x), jnp.asarray(a), jnp.asarray(b),
        gradient_penalty=penalty, lambda_=10.0, rng=key)
    got = pb.wgan_discriminator_loss(pd, *to_torch(a, b),
                                     gradient_penalty=penalty, lambda_=10.0,
                                     rng=jax_prng.prng_key(11))
    for g, w in zip(got, want):
        close(g, w)
    # d(loss)/d(critic parameters), the penalty's double backward included
    jgrad = jax.grad(lambda p: jb.wgan_discriminator_loss(
        lambda x: jd.apply(p, x), jnp.asarray(a), jnp.asarray(b),
        gradient_penalty=penalty, rng=key)[0])(params)
    names = [n for n, _ in pd.named_parameters()]
    pgrad = torch.autograd.grad(got[0], list(pd.parameters()))
    from _torch_port_training import port_layout
    want_g = port_layout(jgrad)
    for n, g in zip(names, pgrad):
        scale = np.abs(want_g[n]).max()
        close(g, want_g[n], rtol=0, atol=1e-4 * scale + 1e-12, what=n)


def test_wgan_gp_alpha_is_jax_draw():
    key = jax.random.PRNGKey(123)
    want = np.asarray(jax.random.uniform(key, (4, 1, 1, 1), jnp.float32))
    got = jax_prng.uniform(jax_prng.prng_key(123), (4, 1, 1, 1))
    np.testing.assert_array_equal(got, want)
    sub = jax.random.split(key, 3)
    for k, (a, b) in zip(jax_prng.split(jax_prng.prng_key(123), 3),
                         np.asarray(sub)):
        assert k == (int(a), int(b))


def test_style_and_content_scores_match_jax():
    jv = JVGG19Features(max_conv=5)
    params = jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    pv = load_flax(VGG19Features(max_conv=5), params)
    a, b = images(9, (2, 24, 24, 3))
    content = [("conv_1", 0.5), ("conv_4", 2.0)]
    style = [("conv_2", 1.0), ("conv_5", 3.0)]
    want = jb.style_and_content_scores(lambda x: jv.apply(params, x),
                                       jnp.asarray(a), jnp.asarray(b),
                                       content, style)
    got = pb.style_and_content_scores(pv, *to_torch(a, b), content, style)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# DSL
# ---------------------------------------------------------------------------

VALID_SPECS = [
    "l1:mask:1,l1:ao:1,l1:normal:10,l1:depth:10,temp-l2:color:0.1",
    "l2:mask:2,tl2:color,gan:all:0.5",
    " mse:normal:3 , ,l1_loss:depth, l2_loss:ao:0",
    "perceptual:color:0.1,texture:normal:2,tgan:all,sgan:all:0.2",
    "l2-ds:mask,l1-ds:color:4,gdl:normal:1.5",
    "",
]
INVALID_SPECS = ["l1", "l1:bogus:1", "adv:mask:1", "nosuch:mask:1",
                 "tgan:color", "l1:mask:x"]


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_loss_dsl_matches_jax(spec):
    assert pconfig.parse_loss_dsl(spec) == jconfig.parse_loss_dsl(spec)


@pytest.mark.parametrize("spec", INVALID_SPECS)
def test_parse_loss_dsl_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jconfig.parse_loss_dsl(spec)
    with pytest.raises(ValueError) as got:
        pconfig.parse_loss_dsl(spec)
    assert str(got.value) == str(want.value)


def test_parse_layer_weights_and_loss_config_match_jax():
    spec = "conv_1:0.03, conv_5 ,conv_16:1.5"
    assert (pconfig.parse_layer_weights(spec)
            == jconfig.parse_layer_weights(spec))
    jl, pl = jconfig.LossConfig(), pconfig.LossConfig()
    assert pl.weight_dict() == jl.weight_dict()
    import dataclasses
    assert ({f.name: getattr(pl, f.name) for f in dataclasses.fields(pl)}
            == {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)})


# ---------------------------------------------------------------------------
# discriminators and VGG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,res,channels", [
    ("enhanceNetLarge", 16, 26), ("enhanceNetSmall", 32, 16),
    ("tecoGAN", 64, 13)])
@pytest.mark.parametrize("sn", [False, True])
def test_discriminator_logits_match_jax(name, res, channels, sn):
    jd = j_build_discriminator(name, res, channels, sn)
    params = jd.init(jax.random.PRNGKey(5), jnp.zeros((1, res, res,
                                                       channels)))
    pd = load_flax(build_discriminator(name, res, channels, sn), params)
    x = np.random.RandomState(10).rand(3, res, res, channels).astype(
        np.float32)
    want = np.asarray(jd.apply(params, jnp.asarray(x)))
    got = pd(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 1)
    close(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-3))


def test_discriminator_init_matches_jax_rules():
    """He fan-out normal conv kernels, N(0, 0.01) dense kernels, zero
    biases: the standard deviations within sampling error."""
    d = build_discriminator("enhanceNetLarge", 32, 26,
                            generator=torch.Generator().manual_seed(0))
    for name, p in d.named_parameters():
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
            continue
        if p.dim() == 4:
            want = np.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
        else:
            want = 0.01
        n = p.numel()
        assert abs(float(p.std()) / want - 1) < 5 / np.sqrt(n) + 0.02, name


def test_discriminator_refuses_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        build_discriminator("enhanceNetLarge", 48, 8)


@pytest.mark.parametrize("max_conv", [5, 16])
def test_vgg_taps_match_jax(max_conv):
    jv = JVGG19Features(max_conv=max_conv)
    params = jv.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    pv = load_flax(VGG19Features(max_conv=max_conv), params)
    x = np.random.RandomState(12).rand(2, 32, 32, 3).astype(np.float32)
    want = jv.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = pv(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        close(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), what=k)


def test_vgg_weight_file_loads_in_both_packages(tmp_path):
    """An npz of HWIO kernels (JAX's format) gives the same features in
    both packages; without a file both warn and fall back."""
    jparams, pretrained = j_load_vgg(3, jax.random.PRNGKey(4))
    assert not pretrained
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{f"conv_{i}_{leaf}": np.asarray(
        jparams["params"][f"conv_{i}"][leaf]) for i in (1, 2, 3)
        for leaf in ("kernel", "bias")})
    want_params, ok = j_load_vgg(3, paths=[str(path)])
    state, ok2 = load_vgg19_params(3, paths=[str(path)])
    assert ok and ok2
    pv = VGG19Features(max_conv=3)
    pv.load_state_dict(state)
    x = np.random.RandomState(13).rand(1, 16, 16, 3).astype(np.float32)
    want = JVGG19Features(max_conv=3).apply(want_params, jnp.asarray(x))
    with torch.no_grad():
        got = pv(torch.from_numpy(x))
    for k in want:
        w = np.asarray(want[k])
        close(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), what=k)
    with pytest.warns(UserWarning, match="No pretrained VGG-19 weights"):
        _, ok3 = load_vgg19_params(3, paths=[str(tmp_path / "none.npz")])
    assert not ok3


# ---------------------------------------------------------------------------
# LossNetUnshaded
# ---------------------------------------------------------------------------

def loss_inputs(seed, b=2, res=32):
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, res, res, 6).astype(np.float32)
    gt[..., 0] = np.sign(gt[..., 0] - 0.3)
    pred = (gt + 0.1 * rng.randn(b, res, res, 6)).astype(np.float32)
    inp = rng.rand(b, res, res, 5).astype(np.float32)
    inp[..., 0] = gt[..., 0]
    prev_in = (inp + 0.05 * rng.randn(b, res, res, 5)).astype(np.float32)
    prev_pred = (gt + 0.05 * rng.randn(b, res, res, 6)).astype(np.float32)
    return gt, pred, inp, prev_in, prev_pred


def criteria(losses, res=32, sn=False, **kw):
    jcfg = jconfig.LossConfig(losses=losses, padding=2, **kw)
    pcfg = pconfig.LossConfig(losses=losses, padding=2, **kw)
    jc = JLossNetUnshaded(jcfg, high_res=res, use_spectral_norm=sn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparams = jc.init(jax.random.PRNGKey(7))
    pc = carry_criterion(LossNetUnshaded(pcfg, high_res=res,
                                         use_spectral_norm=sn), jparams)
    return jc, jparams, pc


ALL_TARGETS = ",".join(f"{n}:{t}:{w}" for n, w in (("mse", 1.5), ("l1", 2),
                                                   ("gdl", 0.5))
                       for t in ("mask", "normal", "ao", "depth", "color"))
LOSS_CASES = {
    "default": pconfig.LossConfig().losses,
    "pixel": ALL_TARGETS,
    "downsample": ",".join(f"{n}:{t}:1.5" for n in ("l2-ds", "l1-ds")
                           for t in ("mask", "normal", "depth", "color")),
    "temporal": ",".join(f"temp-l2:{t}:0.3" for t in
                         ("mask", "normal", "ao", "depth", "color")),
    "vgg": ",".join(f"{n}:{t}:0.7" for n in ("perceptual", "texture")
                    for t in ("mask", "normal", "color", "ao", "depth")),
    "gan": "l1:mask:1,adv:all:0.3,tgan:all:0.2,sgan:all:0.1",
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lossnet_unshaded_terms_match_jax(case):
    """Every loss term the generator side reports, and the total."""
    jc, jparams, pc = criteria(LOSS_CASES[case])
    args = loss_inputs(20)
    want_total, want = jc(jparams, *map(jnp.asarray, args))
    got_total, got = pc(*to_torch(*args))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], what=k)
    close(got_total, want_total, what="total")


@pytest.mark.parametrize("gan_type", ["wgan", "wgan-gp"])
def test_lossnet_unshaded_wgan_generator_side_matches_jax(gan_type):
    jc, jparams, pc = criteria("adv:all:0.3,tgan:all:0.2",
                               gan_type=gan_type)
    args = loss_inputs(21)
    want_total, want = jc(jparams, *map(jnp.asarray, args))
    got_total, got = pc(*to_torch(*args))
    for k in want:
        close(got[k], want[k], what=k)
    close(got_total, want_total)


@pytest.mark.parametrize("gan_type,sn", [("bce", False), ("wgan", False),
                                         ("wgan-gp", False),
                                         ("wgan-gp", True)])
def test_train_discriminator_matches_jax(gan_type, sn):
    """The discriminator side of all three critics; wgan-gp with the
    jax_prng interpolation weight (one key for every critic, as JAX)."""
    jc, jparams, pc = criteria("adv:all:0.3,tgan:all:0.2,sgan:all:0.5",
                               res=16, sn=sn, gan_type=gan_type)
    gt, pred, inp, prev_in, prev_pred = loss_inputs(22, res=16)
    gt_prev = (gt + 0.02).astype(np.float32)
    key = jax.random.PRNGKey(9)
    order = (inp, gt, prev_in, gt_prev, pred, prev_pred)
    want = jc.train_discriminator(jparams, *map(jnp.asarray, order),
                                  rng=key)
    got = pc.train_discriminator(*to_torch(*order),
                                 rng=jax_prng.prng_key(9))
    for g, w, what in zip(got, want, ("loss", "real", "fake")):
        close(g, w, what=what)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_psnr_matches_jax():
    a, b = images(30, (3, 16, 16, 3))
    mask = (np.random.RandomState(31).rand(3, 16, 16, 1) > 0.3).astype(
        np.float32)
    close(pm.psnr(*to_torch(a, b)), jm.psnr(jnp.asarray(a), jnp.asarray(b)))
    close(pm.psnr(*to_torch(a, b, mask)),
          jm.psnr(jnp.asarray(a), jnp.asarray(b), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("shift", [0.0, -0.5])
def test_ssim_and_msssim_match_jax(shift):
    a, b = images(32, (2, 40, 36, 3))
    a, b = a + shift, b + shift
    ta, tb = to_torch(a, b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    close(pm.ssim(ta, tb), jm.ssim(ja, jb_))
    close(pm.ssim(ta, tb, size_average=False),
          jm.ssim(ja, jb_, size_average=False))
    for g, w in zip(pm.ssim(ta, tb, val_range=1.0, full=True),
                    jm.ssim(ja, jb_, val_range=1.0, full=True)):
        close(g, w)
    close(pm.msssim(ta, tb), jm.msssim(ja, jb_))
    close(pm.msssim(ta, tb, normalize=True), jm.msssim(ja, jb_,
                                                       normalize=True))
    with pytest.raises(ValueError, match="at least 16 px"):
        pm.msssim(ta[:, :8], tb[:, :8])


def test_mean_variance_matches_jax():
    xs = np.random.RandomState(33).randn(50)
    j, p = jm.MeanVariance(), pm.MeanVariance()
    for x in xs:
        j.append(float(x))
        p.append(float(x))
    assert (p.mean(), p.var(), p.count()) == (j.mean(), j.var(), j.count())


def test_sweep_training_target_psnr_matches_jax():
    """tests/test_sweep.py's sweep-vs-march target PSNR on the port (mask,
    and normal and depth under the mask) at a smaller size: the port's
    renders through the port's `psnr`, held to JAX's numbers and to that
    test's floors."""
    from isosurfacesuperresolution_tpu.config import RenderConfig as JRC
    from isosurfacesuperresolution_tpu.render.api import (
        render_frame_gbuffer as j_render)
    from isosurfacesuperresolution_tpu.render.camera import (
        CameraParams as JCam)
    from isosurfacesuperresolution_tpu.render.raycast import (
        gbuffer_to_high_target as j_target, render_gbuffer as j_march)
    from isosurfacesuperresolution_tpu.volume import analytic as ja
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        gbuffer_to_high_target)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    def psnrs(fn, gt, sw):
        mask = gt[..., 0:1] * 0.5 + 0.5
        return [float(fn(sw[..., 0:1], gt[..., 0:1])[0]),
                float(fn(sw[..., 1:4], gt[..., 1:4], mask=mask)[0]),
                float(fn(sw[..., 4:5], gt[..., 4:5], mask=mask)[0])]

    jgrid = ja.blobs_volume(48, num_blobs=6)
    pgrid = analytic.blobs_volume(48, num_blobs=6, device="cpu")
    kw = dict(width=48, height=48, isovalue=0.5, step_voxels=0.25,
              ao_samples=0, renderer="march")
    for eye in [(0.0, 1.0, -1.7), (-0.9, -0.9, 0.9)]:
        jc, pc = JCam.create(eye), CameraParams.create(eye)
        jgt = j_target(j_march(jgrid, jc, jc, JRC(**kw)))[None]
        jsw = j_target(j_render(jgrid, jc, jc,
                                JRC(**kw).replace(renderer="sweep")))[None]
        pgt = gbuffer_to_high_target(render_frame_gbuffer(
            pgrid, pc, pc, RenderConfig(**kw)))[None]
        psw = gbuffer_to_high_target(render_frame_gbuffer(
            pgrid, pc, pc, RenderConfig(**kw).replace(renderer="sweep")))[None]
        want = psnrs(jm.psnr, jgt, jsw)
        got = psnrs(pm.psnr, pgt, psw)
        # the renders agree to 1e-4 (their own tests), a dB here and there
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
        assert got[0] > 15.0 and got[1] > 22.0 and got[2] > 35.0, got
