"""The GUI's modes of the fused frame vs the JAX package: the bicubic
upscale mode, the exact gather warp (``fast_warp=False``) of the
non-planar frame, and `InferencePipeline.set_render_params` on the small
XLA sweep, with one numpy-seeded 2-block, 16-feature EnhanceNet."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import Config as JConfig
from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.infer import pipeline as j_pipeline
from isosurfacesuperresolution_tpu.models.generators import create_network
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.params import (
    RenderParams as JRenderParams)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, InferencePipeline, initial_state)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.volume import analytic

MODEL = dict(num_residual_blocks=2, num_features=16)
RENDER = dict(width=32, height=24, isovalue=0.3, ao_samples=0,
              renderer="sweep", sweep_dtype="float32")
ANGLES = (0.0, 0.0, 0.06, 0.12)          # first frame: prev = itself


def _eye(ang):
    return (1.3 * math.sin(ang + 0.6), 0.9, -1.3 * math.cos(ang + 0.6))


@pytest.fixture(scope="module")
def nets():
    """The port's net and JAX's params from one numpy-seeded tree."""
    net = EnhanceNet(ModelConfig(**MODEL))
    rng = np.random.RandomState(0)
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


@pytest.mark.parametrize("mode", ["bicubic", "exact_warp"])
def test_chained_frames_match_jax(nets, mode):
    """Three chained frames of the bicubic upscale mode (JAX's `resize`
    "cubic" of the low-res input) and of the network with the exact
    gather warp, against JAX's `make_fused_frame`: G-buffers to the sweep
    test's 1e-4, the state to 5e-4 and RGB to 1e-4, the bounds of
    `test_torch_port_frame.py`."""
    net, jparams = nets
    upscale = "bicubic" if mode == "bicubic" else "network"
    fast_warp = mode != "exact_warp"
    cfg, rcfg = Config(model=ModelConfig(**MODEL)), RenderConfig(**RENDER)
    jcfg = JConfig(model=JModelConfig(**MODEL))
    jrcfg = JRenderConfig(**RENDER)
    jfused = j_pipeline.make_fused_frame(
        create_network(jcfg.model), jcfg, jrcfg, upscale_mode=upscale,
        donate=False, fast_warp=fast_warp, planar="off")
    jstate = j_pipeline.initial_state(jcfg, jrcfg, upscale, planar="off")
    frame = FusedFrame(net, cfg, rcfg, upscale_mode=upscale, planar="off",
                       device="cpu", fast_warp=fast_warp)
    state = initial_state(cfg, rcfg, upscale, planar="off", device="cpu")
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    for i in range(1, 4):
        cur, prev = _eye(ANGLES[i]), _eye(ANGLES[i - 1])
        jrgb, jfr, jstate = jfused(jparams, jgrid, JCameraParams.create(cur),
                                   JCameraParams.create(prev), jstate)
        rgb, fr, state = frame(grid, CameraParams.create(cur),
                               CameraParams.create(prev), state)
        assert rgb.shape == (96, 128, 3)
        np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(state.prev_high.numpy(),
                                   np.asarray(jstate.prev_high), atol=5e-4,
                                   rtol=0)
        np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-4,
                                   rtol=0)
    if mode == "exact_warp":       # the warp is not the shift-blend one
        fast = FusedFrame(net, cfg, rcfg, planar="off", device="cpu")
        st = initial_state(cfg, rcfg, planar="off", device="cpu")
        for i in range(1, 4):
            _, _, st = fast(grid, CameraParams.create(_eye(ANGLES[i])),
                            CameraParams.create(_eye(ANGLES[i - 1])), st)
        assert float((st.prev_high - state.prev_high).abs().max()) > 1e-6


def test_set_render_params_matches_jax(nets):
    """The GUI's slider path on the planar main path: after frame 1 the
    isovalue and the material change; the next frames equal JAX's
    `InferencePipeline` after its own `set_render_params`, the mask of
    the G-buffer changes, and the port rebuilt nothing (the same
    `FusedFrame`, planar net and tables)."""
    net, jparams = nets
    cfg, rcfg = Config(model=ModelConfig(**MODEL)), RenderConfig(**RENDER)
    jcfg = JConfig(model=JModelConfig(**MODEL))
    pipe = InferencePipeline(net, cfg, rcfg, device="cpu")
    jpipe = j_pipeline.InferencePipeline(create_network(jcfg.model), jparams,
                                         jcfg, JRenderConfig(**RENDER))
    assert pipe.use_planar and jpipe._use_planar
    frame, tables, pnet = (pipe._frame, pipe._frame.planar_tables,
                           pipe._frame.planar_net)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    masks = []
    for i, ang in enumerate((0.0, 0.05, 0.1)):
        if i == 1:
            kw = dict(isovalue=0.45, diffuse_color=(0.6, 0.7, 0.9),
                      specular_exponent=8)
            pipe.set_render_params(**kw)
            jpipe.set_render_params(**kw)
            for k, v in pipe.render_params._asdict().items():
                np.testing.assert_array_equal(
                    np.asarray(v, np.float32),
                    np.asarray(getattr(jpipe.render_params, k)))
        rgb = pipe.frame(grid, CameraParams.create(_eye(ang)))
        jrgb = np.asarray(jpipe.frame(jgrid, JCameraParams.create(_eye(ang))))
        assert rgb.shape == jrgb.shape == (96, 128, 3)
        # the planar frames' bound (test_torch_port_planar.py)
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=5e-4, rtol=0)
        _, fr, _ = frame(grid, CameraParams.create(_eye(ang)),
                         CameraParams.create(_eye(ang)), pipe.state,
                         pipe.render_params)
        masks.append(fr[..., 3])
    assert not torch.equal(masks[0], masks[1])
    assert pipe._frame is frame and frame.planar_tables is tables
    assert frame.planar_net is pnet


def test_render_params_replace_casts_like_from_config():
    rp = RenderParams.from_config(RenderConfig())
    new = rp.replace(isovalue=1, light_direction=[0, 1, 0],
                     specular_exponent=np.int64(4))
    assert new.isovalue == 1.0 and isinstance(new.isovalue, float)
    assert new.light_direction == (0.0, 1.0, 0.0)
    assert all(isinstance(v, float) for v in new.light_direction)
    assert new.specular_exponent == 4.0
    assert isinstance(new.specular_exponent, float)
    assert new.ambient_color == rp.ambient_color
    jnew = JRenderParams.from_config(JRenderConfig()).replace(
        isovalue=1, light_direction=[0, 1, 0], specular_exponent=4)
    for k, v in new._asdict().items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      np.asarray(getattr(jnew, k)))
