"""The planar engine's int8 post-training quantization (`planar_int8`)
and spectral normalization (`use_sn`) vs the JAX package: the quantized
conv's integers and output, `planar_apply`, chained fused frames, the
refusal of the phase tail with int8, `spectral_normalize` and
`apply_sn_tree`, and the planar frame of run00017 with `use_sn`."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import Config as JConfig
from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.infer import pipeline as j_pipeline
from isosurfacesuperresolution_tpu.infer import planar as J
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu.models.generators import create_network
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.utils import spectral_norm as JSN
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer import planar as P
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, InferencePipeline, initial_state)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.utils import spectral_norm as SN
from isosurfacesuperresolution_tpu_torch.volume import analytic

RUN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                   "run00017")
PADDINGS = {"same": "SAME", "valid": "VALID",
            "split_top": ((1, 0), (1, 1)), "split_bottom": ((0, 1), (1, 1))}


def _jax_int8_parts(x, kernel, padding):
    """The lines of the JAX package's `_conv_int8` up to its int32 sums
    (that function returns only the dequantized output)."""
    f32 = jnp.float32
    kf = kernel.astype(f32)
    sw = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)) / 127.0, 1e-12)
    kq = jnp.round(kf / sw).astype(jnp.int8)
    xf = x.astype(f32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf)) / 127.0, 1e-12)
    xq = jnp.round(xf / sx).astype(jnp.int8)
    y = jax.lax.conv_general_dilated(
        xq, kq, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return kq, sw, xq, sx, y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", sorted(PADDINGS))
def test_conv_int8_matches_jax(pad, dtype):
    """Weights, activations and int32 sums equal JAX's; the output, one
    float32 multiply and add of the same integers and scales (XLA may fuse
    them into an FMA), within 1e-6 of its scale."""
    rng = np.random.RandomState(0)
    padding = PADDINGS[pad]
    kh = 3 if isinstance(padding, str) else 2
    x = rng.randn(1, 7, 9, 24).astype(np.float32)   # 24 -> 20: padded to 32
    k = (rng.randn(kh, 3, 24, 20) * 0.1).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    kq, sw, xq, sx, sums = (np.asarray(a) for a in _jax_int8_parts(
        jx, jnp.asarray(k), padding))
    pkq, psw = P.quantize_kernel(torch.from_numpy(k))
    pxq, psx = P.quantize_activation(tx)
    assert pkq.dtype == pxq.dtype == torch.int8
    np.testing.assert_array_equal(pkq.numpy(), kq)
    np.testing.assert_array_equal(psw.numpy(), sw)
    np.testing.assert_array_equal(pxq.numpy(), xq)
    assert psx.dim() == 0 and float(psx) == float(sx)
    q = P.int8_conv(torch.from_numpy(k), torch.from_numpy(b))
    got_sums = P.int8_conv_sums(pxq, q.taps, P._nchw_pad(padding))
    assert got_sums.dtype == torch.int32
    np.testing.assert_array_equal(got_sums[..., :20].numpy(), sums)
    ref = np.asarray(J._conv_int8(jx, jnp.asarray(k), jnp.asarray(b),
                                  padding, jdt).astype(jnp.float32))
    got = P._conv_int8(tx, torch.from_numpy(k), torch.from_numpy(b), padding,
                       tdt)
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape
    tol = 1e-6 * np.abs(ref).max()
    if dtype == "bfloat16":      # a one-ulp float32 difference may round
        tol = tol + 2.0 ** -7 * np.abs(ref)      # to the other bf16 value
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def test_conv_int8_helpers_thread_quant_as_jax():
    """`_conv`, `_edge_conv`, `planar_tail_conv` and
    `planar_tail_conv_split` take ``quant`` as JAX's do."""
    rng = np.random.RandomState(1)
    z = rng.rand(1, 5, 7, 16).astype(np.float32)
    k = (rng.randn(3, 3, 4, 6) * 0.2).astype(np.float32)
    k16 = (rng.randn(3, 3, 16, 8) * 0.2).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    b8 = rng.randn(8).astype(np.float32)
    f32 = (jnp.float32, torch.float32)
    pairs = [
        (lambda: J._conv(jnp.asarray(z), jnp.asarray(k16), jnp.asarray(b8),
                         dtype=f32[0], quant=True),
         lambda: P._conv(torch.from_numpy(z), torch.from_numpy(k16),
                         torch.from_numpy(b8), dtype=f32[1], quant=True)),
        (lambda: J._edge_conv(jnp.asarray(z), jnp.asarray(k16),
                              jnp.asarray(b8), dtype=f32[0], quant=True),
         lambda: P._edge_conv(torch.from_numpy(z), torch.from_numpy(k16),
                              torch.from_numpy(b8), dtype=f32[1],
                              quant=True)),
        (lambda: J.planar_tail_conv(jnp.asarray(z), jnp.asarray(k),
                                    jnp.asarray(b), f32[0], quant=True),
         lambda: P.planar_tail_conv(torch.from_numpy(z), torch.from_numpy(k),
                                    torch.from_numpy(b), f32[1],
                                    quant=True)),
        (lambda: J.planar_tail_conv_split(jnp.asarray(z), jnp.asarray(k),
                                          jnp.asarray(b), f32[0],
                                          quant=True)[0],
         lambda: P.planar_tail_conv_split(torch.from_numpy(z),
                                          torch.from_numpy(k),
                                          torch.from_numpy(b), f32[1],
                                          quant=True)[0])]
    for jfn, pfn in pairs:
        ref, got = np.asarray(jfn()), pfn().numpy()
        assert got.shape == ref.shape
        # the same integers; one float32 multiply-add of the scales
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


MODEL = dict(num_residual_blocks=2, num_features=64)


@pytest.fixture(scope="module")
def small_net():
    """A numpy-seeded 2-block, 64-feature EnhanceNet on both sides."""
    net = EnhanceNet(ModelConfig(**MODEL))
    rng = np.random.RandomState(3)
    tree = {}
    for name, conv in net.named_children():
        cout, cin, kh, kw = conv.weight.shape
        tree[name] = {
            "kernel": rng.normal(0, (kh * kw * cin) ** -0.5,
                                 (kh, kw, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    net.load_state_dict(params_from_flax({"params": tree}))
    jparams = {"params": {k: {kk: jnp.asarray(v) for kk, v in d.items()}
                          for k, d in tree.items()}}
    return net.eval(), jparams


def _gap_bounds(got, ref, ref_float, max_share, mean_share):
    """The port's int8 output against JAX's, bounded by JAX's own
    int8-vs-float gap: a one-ulp difference upstream (conv sums in another
    order) may move an activation across a rounding boundary, one step
    ``sx`` of one input, which the gap's scale bounds."""
    gap = np.abs(ref - ref_float)
    d = np.abs(got - ref)
    assert gap.max() > 0
    assert d.max() <= max_share * gap.max(), (d.max(), gap.max())
    assert d.mean() <= mean_share * gap.mean(), (d.mean(), gap.mean())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planar_apply_int8_matches_jax(small_net, dtype, split):
    """Measured: bf16 equal to JAX, float32 within 2e-7, against a gap of
    0.01 (mean 2e-3).  Bounds: a tenth of the gap's max, a hundredth of
    its mean."""
    net, jparams = small_net
    flags = dict(MODEL, compute_dtype=dtype, planar_split_tail=split)
    x = np.random.RandomState(1).rand(1, 6, 8, 101).astype(np.float32)
    ref, ref_float = (np.asarray(J.planar_apply(
        jparams, JModelConfig(**flags, planar_int8=q8), jnp.asarray(x))
        .astype(jnp.float32)) for q8 in (True, False))
    pnet = P.PlanarNet(net, ModelConfig(**flags, planar_int8=True))
    assert pnet.int8 and isinstance(pnet.blocks[0][0], P.Int8Conv)
    assert not isinstance(pnet.pre, P.Int8Conv)
    assert not isinstance(pnet.out, P.Int8Conv)
    got = pnet(torch.from_numpy(x)).to(torch.float32).numpy()
    assert got.shape == ref.shape == (1, 6, 8, 96)
    _gap_bounds(got, ref, ref_float, 0.1, 0.01)


def test_planar_apply_int8_run00017_matches_jax():
    """The trained 10x64 net in bf16 with int8, the `bench.py --int8`
    network, against JAX's (bounds as above)."""
    jlm = JLoadedModel.from_run_dir(RUN)
    lm = LoadedModel.from_run_dir(RUN, device="cpu")
    x = np.random.RandomState(1).rand(1, 12, 16, 101).astype(np.float32)
    ref, ref_float = (np.asarray(J.planar_apply(
        jlm.params, dataclasses.replace(jlm.cfg.model,
                                        compute_dtype="bfloat16",
                                        planar_int8=q8),
        jnp.asarray(x)).astype(jnp.float32)) for q8 in (True, False))
    cfg = dataclasses.replace(lm.cfg.model, compute_dtype="bfloat16",
                              planar_int8=True)
    got = P.planar_apply(lm.model, cfg, torch.from_numpy(x)).numpy()
    _gap_bounds(got, ref, ref_float, 0.1, 0.01)


def test_phase_tail_with_int8_raises_jax_message(small_net):
    net, jparams = small_net
    flags = dict(MODEL, planar_phase_tail=True, planar_int8=True)
    x = np.zeros((1, 4, 4, 101), np.float32)
    with pytest.raises(ValueError) as jerr:
        J.planar_apply(jparams, JModelConfig(**flags), jnp.asarray(x))
    with pytest.raises(ValueError) as err:
        P.planar_apply(net, ModelConfig(**flags), torch.from_numpy(x))
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedFrame(net, Config(model=ModelConfig(**flags)),
                   RenderConfig(width=8, height=8), device="cpu")
    # other widths have no phase tail, in JAX too: int8 then applies
    cfg8 = ModelConfig(num_residual_blocks=1, num_features=8,
                       planar_phase_tail=True, planar_int8=True)
    pnet = P.PlanarNet(EnhanceNet(cfg8), cfg8)
    assert not pnet.phase_tail and isinstance(pnet.post3, P.Int8Conv)


RENDER = dict(width=32, height=24, isovalue=0.3, ao_samples=0,
              renderer="sweep", sweep_dtype="float32")


def _eye(ang):
    return (1.3 * math.sin(ang + 0.6), 0.9, -1.3 * math.cos(ang + 0.6))


def _jax_chain(jparams, jgrid, mkw, cams):
    """States and RGB of JAX's fused planar frames over ``cams``."""
    jcfg, jrcfg = JConfig(model=JModelConfig(**mkw)), JRenderConfig(**RENDER)
    jfused = j_pipeline.make_fused_frame(create_network(jcfg.model), jcfg,
                                         jrcfg, donate=False, planar="on")
    jstate = j_pipeline.initial_state(jcfg, jrcfg, planar="on")
    out = []
    for cur, prev in cams:
        jrgb, _, jstate = jfused(jparams, jgrid, JCameraParams.create(cur),
                                 JCameraParams.create(prev), jstate)
        out.append((np.asarray(jstate.prev_high), np.asarray(jrgb)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_int8_frames_match_jax(small_net, dtype):
    """Three chained int8 planar frames against JAX's, bounded by JAX's
    own int8-vs-float gap on the same frames.  One activation scale per
    call makes every rounding depend on the tensor's max: the G-buffers
    differ by float32 rounding (1e-5), which flips some roundings (a step
    ``sx`` each), and the recurrence carries the flips, so from the
    second frame on (bf16: from the first, whose network input already
    rounds apart) the port and JAX quantize differently and differ about
    as much as int8 differs from float.  Measured (frames 1-3, state and
    RGB mean |diff| over the gap's mean): float32 0.0003 / 0.0002 on frame
    1, then up to 0.71 / 0.95; bf16 up to 0.87 / 1.0.  Bounds: frame 1 in
    float32 a hundredth of the gap's mean (state and RGB); every frame 1.5
    times the gap's mean, and the RGB's max twice the gap's max."""
    net, jparams = small_net
    mkw = dict(MODEL, compute_dtype=dtype, planar_int8=True)
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    angles = (0.0, 0.0, 0.06, 0.12)
    cams = [(_eye(angles[i]), _eye(angles[i - 1])) for i in range(1, 4)]
    ref = _jax_chain(jparams, jgrid, mkw, cams)
    ref_float = _jax_chain(jparams, jgrid, dict(mkw, planar_int8=False),
                           cams)
    cfg, rcfg = Config(model=ModelConfig(**mkw)), RenderConfig(**RENDER)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    frame = FusedFrame(net, cfg, rcfg, planar="on", device="cpu")
    assert frame.planar_net.int8
    state = initial_state(cfg, rcfg, planar="on", device="cpu")
    for i, (cur, prev) in enumerate(cams):
        rgb, _, state = frame(grid, CameraParams.create(cur),
                              CameraParams.create(prev), state)
        assert rgb.shape == (3, 96, 128)
        for k, got in enumerate((state.prev_high.numpy(), rgb.numpy())):
            d = np.abs(got - ref[i][k])
            gap = np.abs(ref_float[i][k] - ref[i][k])
            share = 1e-2 if (i == 0 and dtype == "float32") else 1.5
            assert d.mean() <= share * gap.mean(), (i, k, d.mean(),
                                                    gap.mean())
            if k == 1:
                assert d.max() <= 2.0 * gap.max(), (i, d.max(), gap.max())


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (3, 3, 101, 64), (20, 7),
                                   (3, 3, 64, 6)])
def test_spectral_normalize_matches_jax(shape):
    """Five power iterations from the same start: float32 sums in another
    order, 1e-6 of the kernel's scale."""
    w = np.random.RandomState(4).randn(*shape).astype(np.float32)
    ref = np.asarray(JSN.spectral_normalize(jnp.asarray(w)))
    got = SN.spectral_normalize(torch.from_numpy(w)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # not converged: another sigma than the exact largest singular value
    exact = np.linalg.norm(w.reshape(-1, shape[-1]), 2)
    assert not np.allclose(w / exact, ref, rtol=1e-6, atol=0)


def test_apply_sn_tree_matches_jax():
    """Every conv and linear weight of a state dict (OIHW and (out, in))
    normalized as JAX normalizes the HWIO / (in, out) kernels; biases
    kept."""
    rng = np.random.RandomState(5)
    conv = rng.randn(3, 3, 12, 16).astype(np.float32)       # HWIO
    dense = rng.randn(16, 5).astype(np.float32)             # (in, out)
    bias = rng.randn(16).astype(np.float32)
    ref = JSN.apply_sn_tree({"conv": {"kernel": jnp.asarray(conv),
                                      "bias": jnp.asarray(bias)},
                             "fc": {"kernel": jnp.asarray(dense)}})
    got = SN.apply_sn_tree({
        "conv.weight": torch.from_numpy(conv).permute(3, 2, 0, 1),
        "conv.bias": torch.from_numpy(bias),
        "fc.weight": torch.from_numpy(dense).t()})
    np.testing.assert_array_equal(got["conv.bias"].numpy(), bias)
    for name, perm, jref in (("conv", (2, 3, 1, 0), ref["conv"]["kernel"]),
                             ("fc", (1, 0), ref["fc"]["kernel"])):
        a = got[f"{name}.weight"].permute(*perm).numpy()
        b = np.asarray(jref)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_use_sn_planar_frames_run00017_match_jax():
    """run00017's weights with use_sn through `InferencePipeline` (planar
    "auto"): JAX normalizes the params before `planar_apply` each frame,
    the port once when it builds the engine.  float32 throughout; the
    planar frames' bound (5e-4)."""
    jlm = JLoadedModel.from_run_dir(RUN)
    lm = LoadedModel.from_run_dir(RUN, device="cpu")
    kw = dict(use_sn=True)
    jcfg = JConfig(model=dataclasses.replace(jlm.cfg.model, **kw))
    cfg = Config(model=dataclasses.replace(lm.cfg.model, **kw))
    rcfg, jrcfg = RenderConfig(**RENDER), JRenderConfig(**RENDER)
    pipe = InferencePipeline(lm.model, cfg, rcfg, device="cpu")
    jpipe = j_pipeline.InferencePipeline(create_network(jcfg.model),
                                         jlm.params, jcfg, jrcfg)
    assert pipe.use_planar and jpipe._use_planar
    plain = InferencePipeline(lm.model, lm.cfg, rcfg, device="cpu")
    grid = analytic.sphere_volume(32, device="cpu")
    jgrid = j_analytic.sphere_volume(32)
    for ang in (0.0, 0.05):
        rgb = pipe.frame(grid, CameraParams.create(_eye(ang)))
        jrgb = np.asarray(jpipe.frame(jgrid, JCameraParams.create(_eye(ang))))
        assert rgb.shape == jrgb.shape == (96, 128, 3)
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=5e-4, rtol=0)
        unnormalized = plain.frame(grid, CameraParams.create(_eye(ang)))
        assert np.abs(unnormalized.numpy() - jrgb).max() > 1e-2


def test_use_sn_interleaved_network_is_refused():
    """The interleaved network's forward refuses use_sn (not ported), so a
    non-planar frame of such a model raises instead of running without
    the normalization."""
    cfg = ModelConfig(num_residual_blocks=1, num_features=8, use_sn=True)
    net = EnhanceNet(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        net(torch.zeros((1, 4, 4, 101)))
    rcfg = RenderConfig(width=8, height=8, renderer="sweep")
    frame = FusedFrame(net, Config(model=cfg), rcfg, planar="off",
                       device="cpu")
    cam = CameraParams.create(_eye(0.0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        frame(analytic.sphere_volume(8, device="cpu"), cam, cam,
              initial_state(Config(model=cfg), rcfg, planar="off",
                            device="cpu"))
