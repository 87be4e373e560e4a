"""The port's planar engine vs the JAX package's `infer/planar.py`: each
piece on numpy-seeded inputs, `planar_apply` at full width with the
trained run00017 weights, and three chained planar fused frames of a
64-feature net with and without the phase tail."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu.config import Config as JConfig
from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.config import ShadingConfig as JShading
from isosurfacesuperresolution_tpu.infer import pipeline as j_pipeline
from isosurfacesuperresolution_tpu.infer import planar as J
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu.models.generators import create_network
from isosurfacesuperresolution_tpu.ops import fused_upsample as JF
from isosurfacesuperresolution_tpu.ops.resize import (
    pixel_shuffle as j_pixel_shuffle)
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig, ShadingConfig)
from isosurfacesuperresolution_tpu_torch.infer import planar as P
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, InferencePipeline, initial_state, resolve_planar)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)
from isosurfacesuperresolution_tpu_torch.ops import fused_upsample as PF
from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
from isosurfacesuperresolution_tpu_torch.ops.resize import (
    pixel_shuffle as p_pixel_shuffle)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.volume import analytic

RUN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                   "run00017")
RNG = np.random.RandomState(0)
A = {name: RNG.rand(*shape).astype(np.float32) * 2 - 1 for name, shape in {
    "nhwc16": (1, 5, 7, 16), "k": (3, 3, 4, 6), "b": (6,), "k5": (3, 3, 4, 5),
    "pred": (2, 5, 7, 96), "low": (1, 5, 7, 5), "prev": (1, 5, 7, 96),
    "flow": (1, 5, 7, 2), "rgb": (2, 5, 7, 48)}.items()}


def _j(name):
    return jnp.asarray(A[name])


def _t(name):
    return torch.from_numpy(A[name])


def _warp(special_mask, dtype):
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    return (lambda: J.warp_planar(_j("prev"), _j("flow") * 3.0,
                                  special_mask=special_mask,
                                  compute_dtype=jdt),
            lambda: P.warp_planar(_t("prev"), _t("flow") * 3.0,
                                  special_mask=special_mask,
                                  compute_dtype=tdt))


# name -> (JAX call, port call); all float32 unless named otherwise
PIECES = {
    "pixel_shuffle": (lambda: j_pixel_shuffle(_j("nhwc16"), 2),
                      lambda: p_pixel_shuffle(_t("nhwc16"), 2)),
    "pixel_shuffle_x4": (lambda: j_pixel_shuffle(_j("rgb"), 4),
                         lambda: p_pixel_shuffle(_t("rgb"), 4)),
    "compose_up2x_bilinear": (
        lambda: JF.compose_up2x_conv3x3(_j("k5"), "bilinear"),
        lambda: PF.compose_up2x_conv3x3(_t("k5"), "bilinear")),
    "compose_up2x_nearest": (
        lambda: JF.compose_up2x_conv3x3(_j("k5"), "nearest"),
        lambda: PF.compose_up2x_conv3x3(_t("k5"), "nearest")),
    "up2x_conv_bias": (lambda: JF.up2x_conv_bias(_j("b")),
                       lambda: PF.up2x_conv_bias(_t("b"))),
    "upsample_stencil_kernel": (
        lambda: JF.upsample_stencil_kernel(5, "bilinear", 4),
        lambda: PF.upsample_stencil_kernel(5, "bilinear", 4)),
    "planar_tail_conv": (
        lambda: J.planar_tail_conv(_j("nhwc16"), _j("k"), _j("b"),
                                   jnp.float32),
        lambda: P.planar_tail_conv(_t("nhwc16"), _t("k"), _t("b"),
                                   torch.float32)),
    "planar_tail_conv_in_perm": (
        lambda: J.planar_tail_conv(_j("nhwc16"), _j("k"), _j("b"),
                                   jnp.float32,
                                   in_perm=np.arange(16)[::-1].copy()),
        lambda: P.planar_tail_conv(_t("nhwc16"), _t("k"), _t("b"),
                                   torch.float32,
                                   in_perm=np.arange(16)[::-1].copy())),
    "planar_tail_conv_bf16": (
        lambda: J.planar_tail_conv(_j("nhwc16"), _j("k"), _j("b"),
                                   jnp.bfloat16),
        lambda: P.planar_tail_conv(_t("nhwc16"), _t("k"), _t("b"),
                                   torch.bfloat16)),
    "planar_tail_conv_split": (
        lambda: J.planar_tail_conv_split(_j("nhwc16"), _j("k"), _j("b"),
                                         jnp.float32),
        lambda: P.planar_tail_conv_split(_t("nhwc16"), _t("k"), _t("b"),
                                         torch.float32)),
    "clamp_output_planar": (lambda: J.clamp_output_planar(_j("pred")),
                            lambda: P.clamp_output_planar(_t("pred"))),
    "shading_planar": (
        lambda: J.screen_space_shading_planar(
            _j("pred"), JShading(ao_strength=0.7)),
        lambda: P.screen_space_shading_planar(
            _t("pred"), ShadingConfig(ao_strength=0.7))),
    "shading_planar_specular": (
        lambda: J.screen_space_shading_planar(
            _j("pred"), JShading(enable_specular=True, inverse_ao=True)),
        lambda: P.screen_space_shading_planar(
            _t("pred"), ShadingConfig(enable_specular=True,
                                      inverse_ao=True))),
    **{f"initial_image_planar_{m}": (
        lambda m=m: J.initial_image_planar(_j("low"), 6, m, True),
        lambda m=m: P.initial_image_planar(_t("low"), 6, m, True))
       for m in ("zero", "unshaded", "input")},
    **{f"warp_planar_{'mask' if sm else 'plain'}_{dt}": _warp(sm, dt)
       for sm in (False, True) for dt in ("float32", "bfloat16")},
    "planar_rgb_to_planes": (lambda: J.planar_rgb_to_planes(_j("rgb")),
                             lambda: P.planar_rgb_to_planes(_t("rgb"))),
    "state_to_flat": (lambda: J.state_to_flat(_j("prev")),
                      lambda: P.state_to_flat(_t("prev"))),
    "state_from_flat": (lambda: J.state_from_flat(_j("prev")),
                        lambda: P.state_from_flat(_t("prev"))),
}


@pytest.mark.parametrize("name", sorted(PIECES))
def test_planar_piece_matches_jax(name):
    jfn, pfn = PIECES[name]
    ref, got = jfn(), pfn()
    if name == "planar_tail_conv_split":
        (ref, ref_order), (got, got_order) = ref, got
        np.testing.assert_array_equal(got_order, ref_order)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape
    if name.endswith("bf16") or name.endswith("bfloat16"):
        # every op rounds to bf16 on both sides, but XLA may keep a fused
        # chain in float32 or sum a conv in another order: a few bf16
        # steps (2^-8 relative) of O(1) values
        np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    else:
        # the same float32 operations; sums of at most 36 products (1e-5)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def run00017():
    return (JLoadedModel.from_run_dir(RUN),
            LoadedModel.from_run_dir(RUN, device="cpu"))


# (tail flags, compute dtype, max |diff|, mean |diff|)
APPLY = {
    # float32 through 26 convs: conv algorithms sum in other orders (1e-4)
    "dense_f32": ({}, "float32", 1e-4, 1e-6),
    "split_f32": ({"planar_split_tail": True}, "float32", 1e-4, 1e-6),
    # bf16: each conv output and residual add rounds to bf16 (2^-8
    # relative); a one-step flip early in the trunk spreads through ten
    # blocks, measured 0.035 at most on outputs up to 1.7, so 0.06 and a
    # mean of 1e-3
    "phase_bf16": ({"planar_phase_tail": True}, "bfloat16", 6e-2, 1e-3),
}


@pytest.mark.parametrize("variant", sorted(APPLY))
def test_planar_apply_run00017_matches_jax(run00017, variant):
    jlm, lm = run00017
    flags, dtype, max_tol, mean_tol = APPLY[variant]
    jcfg = dataclasses.replace(jlm.cfg.model, compute_dtype=dtype, **flags)
    cfg = dataclasses.replace(lm.cfg.model, compute_dtype=dtype, **flags)
    assert (cfg.num_residual_blocks, cfg.num_features) == (10, 64)
    x = np.random.RandomState(1).rand(1, 12, 16, 101).astype(np.float32)
    ref = np.asarray(J.planar_apply(jlm.params, jcfg, jnp.asarray(x))
                     .astype(jnp.float32))
    before = pc.phase_conv.launches
    got = P.planar_apply(lm.model, cfg, torch.from_numpy(x)).numpy()
    assert pc.phase_conv.launches == before       # plain version on CPU
    assert got.shape == ref.shape == (1, 12, 16, 96)
    d = np.abs(got - ref)
    assert d.max() < max_tol and d.mean() < mean_tol, (d.max(), d.mean())


def test_phase_tail_needs_64_features():
    """With another width the phase tail falls back to the dense tail, as
    in JAX (the kernel is 4 x 64 wide)."""
    cfg = ModelConfig(num_residual_blocks=1, num_features=16,
                      planar_phase_tail=True)
    net = EnhanceNet(cfg)
    assert not P.PlanarNet(net, cfg).phase_tail
    assert P.PlanarNet(net, dataclasses.replace(cfg, num_features=16,
                                                planar_split_tail=True)
                       ).split_tail


TABLE_USERS = {
    "warp_planar": lambda tables: P.warp_planar(
        _t("prev"), _t("flow") * 3.0, special_mask=True, tables=tables),
    "initial_unshaded": lambda tables: P.initial_image_planar(
        _t("low"), 6, "unshaded", False, tables),
    "initial_input": lambda tables: P.initial_image_planar(
        _t("low"), 6, "input", True, tables),
    "rgb_to_planes": lambda tables: P.planar_rgb_to_planes(
        _t("rgb")[:1], tables),
}


@pytest.mark.parametrize("name", sorted(TABLE_USERS))
def test_planar_tables_built_once_give_the_same_result(name):
    """A frame's `PlanarTables`, built once, give what each function makes
    for itself when given none, bit for bit (the same index tensors)."""
    fn = TABLE_USERS[name]
    tables = P.PlanarTables(5, 7, 6, "cpu")
    assert torch.equal(fn(tables), fn(None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planar_net_layout_follows_compute_dtype(monkeypatch, dtype):
    """bf16 activations lie channels-last, so the phase conv gets its
    input without a layout copy; float32 ones stay NCHW.  Checked through
    the tensor the phase conv sees."""
    cfg = ModelConfig(num_residual_blocks=1, num_features=64,
                      planar_phase_tail=True, compute_dtype=dtype)
    net = P.PlanarNet(EnhanceNet(cfg), cfg)
    seen = []

    def spy(x, k3, b3, **kw):
        seen.append(x)
        return pc.phase_conv_plain(x, k3, b3, **kw)

    monkeypatch.setattr(P, "phase_conv3x3_amajor_blocked", spy)
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 6, 8, 101)
                         .astype(np.float32))
    assert net(x).shape == (1, 6, 8, 96)
    assert len(seen) == 1 and seen[0].shape == (1, 12, 16, 256)
    if dtype == "bfloat16":
        assert net.memory_format == torch.channels_last
        assert seen[0].is_contiguous() and seen[0].dtype == torch.bfloat16
    else:
        assert net.memory_format == torch.contiguous_format


@pytest.mark.parametrize("split", [False, True])
def test_planar_net_same_result_in_either_layout(split):
    """The float32 engine run with channels-last activations (the bf16
    layout: NHWC edge pads and shuffles) equals its NCHW run; bound 1e-5,
    float32 sums of the same operands in another order."""
    cfg = ModelConfig(num_residual_blocks=1, num_features=16,
                      planar_split_tail=split)
    net = P.PlanarNet(EnhanceNet(cfg), cfg)
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 6, 8, 101)
                         .astype(np.float32))
    ref = net(x)
    net.memory_format = torch.channels_last
    got = net(x)
    assert (got - ref).abs().max() < 1e-5


@pytest.mark.parametrize("op", ["edge_pad", "shuffle", "unshuffle"])
def test_layout_keeping_helpers_match_torch(op):
    """`_edge_pad` and `_shuffle_nchw` on a channels-last tensor equal the
    torch functions on the contiguous one exactly, and stay channels-last
    (one copy, no layout conversion for the next conv)."""
    x = torch.from_numpy(np.random.RandomState(6).rand(1, 8, 6, 10)
                         .astype(np.float32))
    fn, ref_fn = {
        "edge_pad": (P._edge_pad,
                     lambda t: F.pad(t, (1, 1, 1, 1), mode="replicate")),
        "shuffle": (P._shuffle_nchw, lambda t: F.pixel_shuffle(t, 2)),
        "unshuffle": (lambda t: P._shuffle_nchw(t, inverse=True),
                      lambda t: F.pixel_unshuffle(t, 2)),
    }[op]
    got = fn(x.contiguous(memory_format=torch.channels_last))
    assert torch.equal(got, ref_fn(x))
    assert P._channels_last(got)
    assert torch.equal(fn(x), ref_fn(x)) and fn(x).is_contiguous()


@pytest.mark.parametrize("flag", ["planar_int8", "use_sn"])
def test_planar_refuses_unported_options(flag):
    """Both options run in the planar engine (held against JAX in
    tests/test_torch_port_int8.py).  int8 with the phase tail is refused
    with JAX's own ValueError; use_sn, which the interleaved forward once
    refused, runs there too (`SpectralNormalizedModule`) and equals JAX's
    SN-wrapped module on the same weights."""
    if flag == "planar_int8":
        bad = ModelConfig(num_residual_blocks=1, num_features=64,
                          planar_phase_tail=True, planar_int8=True)
        with pytest.raises(ValueError, match="mutually exclusive"):
            P.planar_apply(EnhanceNet(bad), bad, torch.zeros((1, 4, 4, 101)))
        with pytest.raises(ValueError, match="mutually exclusive"):
            FusedFrame(EnhanceNet(bad), Config(model=bad),
                       RenderConfig(width=8, height=8), device="cpu")
        return
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network as p_create_network)
    cfg = ModelConfig(num_residual_blocks=1, num_features=8, use_sn=True)
    net = EnhanceNet(cfg)
    assert P.planar_apply(net, cfg, torch.zeros((1, 4, 4, 101))).shape == (
        1, 4, 4, 96)
    jnet = create_network(JModelConfig(num_residual_blocks=1, num_features=8,
                                       use_sn=True))
    x = np.random.RandomState(5).rand(1, 4, 5, 101).astype(np.float32)
    variables = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    sn_net = p_create_network(cfg)
    sn_net.load_state_dict(params_from_flax(variables))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x))[0])
    with torch.no_grad():
        got = sn_net(torch.from_numpy(x))[0].numpy()
    # float32, 6 convs of an 8-feature net on both sides
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    with torch.no_grad():
        raw = net(torch.from_numpy(x))[0].numpy()
    assert np.abs(raw - ref).max() > 1e-3       # the normalization matters


def test_resolve_planar_follows_jax():
    ok = Config(model=ModelConfig(num_residual_blocks=1))
    direct = Config(model=ModelConfig(recon_type="direct"))
    for cfg, jcfg in ((ok, JConfig(model=JModelConfig(num_residual_blocks=1))),
                      (direct, JConfig(model=JModelConfig(
                          recon_type="direct")))):
        for mode in ("network", "bilinear"):
            for planar in ("auto", "off"):
                assert (resolve_planar(cfg, mode, planar)
                        == j_pipeline.resolve_planar(jcfg, mode, planar))
    assert resolve_planar(ok, "network", "on")
    with pytest.raises(ValueError, match="does not support"):
        resolve_planar(direct, "network", "on")
    state = initial_state(ok, RenderConfig(width=8, height=6), device="cpu")
    assert tuple(state.prev_high.shape) == (1, 6, 8, 96)


# ---------------------------------------------------------------------------
# The whole slice: chained planar fused frames
# ---------------------------------------------------------------------------

MODEL = dict(num_residual_blocks=2, num_features=64)
RENDER = dict(width=32, height=24, isovalue=0.3, ao_samples=0,
              renderer="sweep", sweep_dtype="float32")


def _eye(ang):
    return (1.3 * math.sin(ang + 0.6), 0.9, -1.3 * math.cos(ang + 0.6))


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
    return net.eval(), jparams, (j_analytic.blobs_volume(32, num_blobs=5),
                                 analytic.blobs_volume(32, num_blobs=5,
                                                       device="cpu"))


@pytest.mark.parametrize("phase_tail", [False, True])
def test_chained_planar_frames_match_jax(small_net, phase_tail):
    net, jparams, (jgrid, grid) = small_net
    mkw = dict(MODEL, planar_phase_tail=phase_tail)
    cfg, rcfg = Config(model=ModelConfig(**mkw)), RenderConfig(**RENDER)
    jcfg = JConfig(model=JModelConfig(**mkw))
    jrcfg = JRenderConfig(**RENDER)
    jfused = j_pipeline.make_fused_frame(create_network(jcfg.model), jcfg,
                                         jrcfg, donate=False, planar="on")
    jstate = j_pipeline.initial_state(jcfg, jrcfg, planar="on")
    frame = FusedFrame(net, cfg, rcfg, planar="on", device="cpu")
    assert frame.use_planar and frame.planar_net.phase_tail == phase_tail
    state = initial_state(cfg, rcfg, planar="on", device="cpu")
    angles = (0.0, 0.0, 0.06, 0.12)          # first frame: prev = itself
    for i in range(1, 4):
        cur, prev = _eye(angles[i]), _eye(angles[i - 1])
        jrgb, jfr, jstate = jfused(jparams, jgrid, JCameraParams.create(cur),
                                   JCameraParams.create(prev), jstate)
        rgb, fr, state = frame(grid, CameraParams.create(cur),
                               CameraParams.create(prev), state)
        jrgb, jstate_np = np.asarray(jrgb), np.asarray(jstate.prev_high)
        assert rgb.shape == jrgb.shape == (3, 96, 128)
        assert state.prev_high.shape == jstate_np.shape == (1, 24, 32, 96)
        np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), atol=1e-4,
                                   rtol=0)
        assert np.asarray(jfr)[..., 3].mean() > 0.05
        # float32 network (the non-planar frame's 5e-4: normalizing short
        # normals amplifies float32 rounding).  The phase tail rounds
        # post3's input to bf16 on both sides, so a 1e-6 difference in a
        # G-buffer flips roundings (2^-8 of an operand) and the recurrence
        # compounds them: the state measured up to 0.018 (mean 3e-4) by
        # frame 3, mostly in background normals that the shading masks
        # out; the RGB up to 4e-4.  Bounds: state max 0.05, mean 1e-3;
        # RGB max 1e-3
        for name, got, ref in (("state", state.prev_high.numpy(), jstate_np),
                               ("rgb", rgb.numpy(), jrgb)):
            d = np.abs(got - ref)
            if phase_tail and name == "state":
                assert d.max() < 5e-2 and d.mean() < 1e-3, (d.max(),
                                                              d.mean())
            elif phase_tail:
                assert d.max() < 1e-3, d.max()
            else:
                assert d.max() < 5e-4, d.max()


def test_inference_pipeline_auto_runs_planar_as_jax():
    """`InferencePipeline` resolves planar "auto" as JAX does, so the same
    checkpoint gives the same (Hh, Wh, 3) image in both packages (the
    planar engine's borders differ from the interleaved network's)."""
    kw = dict(num_residual_blocks=1, num_features=8)
    cfg, jcfg = Config(model=ModelConfig(**kw)), JConfig(
        model=JModelConfig(**kw))
    rcfg, jrcfg = RenderConfig(**RENDER), JRenderConfig(**RENDER)
    jmodel = create_network(jcfg.model)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, 101), jnp.float32))
    net = EnhanceNet(cfg.model)
    net.load_state_dict(params_from_flax(jparams))
    pipe = InferencePipeline(net.eval(), cfg, rcfg, device="cpu")
    jpipe = j_pipeline.InferencePipeline(jmodel, jparams, jcfg, jrcfg)
    assert pipe.use_planar and jpipe._use_planar
    jgrid = j_analytic.sphere_volume(32)
    grid = analytic.sphere_volume(32, device="cpu")
    for ang in (0.0, 0.05):
        rgb = pipe.frame(grid, CameraParams.create(_eye(ang)))
        jrgb = np.asarray(jpipe.frame(jgrid, JCameraParams.create(_eye(ang))))
        assert rgb.shape == jrgb.shape == (96, 128, 3)
        # float32 throughout (the non-planar frame's 5e-4)
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=5e-4, rtol=0)
    assert tuple(pipe.state.prev_high.shape) == (1, 24, 32, 96)
