"""The non-planar fused frame: three chained frames of the port (on the
CPU) vs the JAX package's `make_fused_frame(..., planar="off")` with the
XLA sweep, with one numpy-seeded 2-block, 16-feature EnhanceNet on both
sides.  (The planar frame is held in `test_torch_port_planar.py`.)"""

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
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, InferencePipeline, initial_state)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic

MODEL = dict(num_residual_blocks=2, num_features=16)
RENDER = dict(width=32, height=24, isovalue=0.3, ao_samples=0,
              renderer="sweep", sweep_dtype="float32")


def _eye(ang):
    # oblique orbit: the view-adaptive oversample would raise the
    # intermediate grid here, so a fused frame that applied it would differ
    return (1.3 * math.sin(ang + 0.6), 0.9, -1.3 * math.cos(ang + 0.6))


def _flax_tree(net, seed=0):
    rng = np.random.RandomState(seed)
    tree = {}
    for name, conv in net.named_children():
        cout, cin, kh, kw = conv.weight.shape
        tree[name] = {
            "kernel": rng.normal(0, (kh * kw * cin) ** -0.5,
                                 (kh, kw, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.05, cout).astype(np.float32)}
    return {"params": tree}


def test_chained_fused_frames_match_jax():
    net = EnhanceNet(ModelConfig(**MODEL))
    tree = _flax_tree(net)
    net.load_state_dict(params_from_flax(tree))
    net.eval()
    cfg, rcfg = Config(model=ModelConfig(**MODEL)), RenderConfig(**RENDER)
    jcfg = JConfig(model=JModelConfig(**MODEL))
    jrcfg = JRenderConfig(**RENDER)
    jparams = {"params": {k: {kk: jnp.asarray(v) for kk, v in d.items()}
                          for k, d in tree["params"].items()}}
    jfused = j_pipeline.make_fused_frame(create_network(jcfg.model), jcfg,
                                         jrcfg, donate=False, planar="off")
    jstate = j_pipeline.initial_state(jcfg, jrcfg, planar="off")
    frame = FusedFrame(net, cfg, rcfg, planar="off", device="cpu")
    state = initial_state(cfg, rcfg, planar="off", device="cpu")
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")

    angles = (0.0, 0.0, 0.06, 0.12)          # first frame: prev = itself
    for i in range(1, 4):
        cur, prev = _eye(angles[i]), _eye(angles[i - 1])
        jrgb, jfr, jstate = jfused(jparams, jgrid, JCameraParams.create(cur),
                                   JCameraParams.create(prev), jstate)
        rgb, fr, state = frame(grid, CameraParams.create(cur),
                               CameraParams.create(prev), state)
        jfr, jrgb = np.asarray(jfr), np.asarray(jrgb)
        jhigh = np.asarray(jstate.prev_high)
        assert rgb.shape == jrgb.shape == (96, 128, 3)
        assert state.has_prev and bool(jstate.has_prev)
        # float32 throughout: the G-buffers agree to float32 rounding of the
        # sweep (the sweep test's 1e-4) and the RGB to 1e-4; in the state,
        # normalizing the network's short normal vectors amplifies its
        # ~1e-6 differences (measured 1.0e-4 at most), hence 5e-4
        np.testing.assert_array_equal(fr[..., 3].numpy(), jfr[..., 3])
        np.testing.assert_allclose(fr.numpy(), jfr, atol=1e-4, rtol=0)
        assert jfr[..., 3].mean() > 0.05
        np.testing.assert_allclose(state.prev_high.numpy(), jhigh,
                                   atol=5e-4, rtol=0)
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=1e-4, rtol=0)


def test_fused_frame_skips_adaptive_oversample():
    """The JAX fused frame renders with a traced camera, so the adaptive
    oversample never applies there; the port's frame must not apply it."""
    grid = analytic.sphere_volume(32, device="cpu")
    rcfg = RenderConfig(**RENDER)
    cam = CameraParams.create(_eye(0.2))
    cfg = Config(model=ModelConfig(**MODEL))
    frame = FusedFrame(None, cfg, rcfg, upscale_mode="bilinear",
                       device="cpu")
    _, fr, _ = frame(grid, cam, cam, initial_state(
        cfg, rcfg, upscale_mode="bilinear", device="cpu"))
    torch.testing.assert_close(fr, render_gbuffer_sweep(grid, cam, cam, rcfg),
                               rtol=0, atol=0)
    adaptive = render_frame_gbuffer(grid, cam, cam, rcfg)
    assert not torch.equal(fr, adaptive)


def test_pipeline_tracks_previous_camera():
    cfg = Config(model=ModelConfig(**MODEL))     # planar "auto": on
    net = EnhanceNet(cfg.model).eval()
    pipe = InferencePipeline(net, cfg, RenderConfig(**RENDER), device="cpu")
    grid = analytic.sphere_volume(32, device="cpu")
    cams = [CameraParams.create(_eye(a)) for a in (0.0, 0.05)]
    for cam in cams:
        rgb = pipe.frame(grid, cam)
    assert rgb.shape == (96, 128, 3)
    assert pipe.state.has_prev and pipe._last_cam is cams[1]
    pipe.reset()
    assert not pipe.state.has_prev and pipe._last_cam is None


@pytest.mark.parametrize("planar", ["on", "sideways"])
def test_fused_frame_refuses_planar(planar):
    """The JAX rule: planar="on" raises ValueError for a configuration that
    `supports_planar` rejects (here a direct reconstruction); an unknown
    setting raises too."""
    cfg = Config(model=ModelConfig(recon_type="direct", **MODEL))
    with pytest.raises(ValueError):
        FusedFrame(EnhanceNet(cfg.model), cfg, RenderConfig(**RENDER),
                   planar=planar, device="cpu")


@pytest.mark.parametrize("planar", ["on", "off"])
def test_frame_runs_convs_with_cudnn_tf32_off(planar, monkeypatch):
    """With cuDNN's TF32 allowed globally (PyTorch's default), every conv
    of a frame, planar engine or interleaved EnhanceNet, runs with it
    off; the global flag is as it was after the frame.  The convs are
    functional: a spy on `F.conv2d` sees each, a forward pre-hook the
    interleaved network's entry."""
    seen, hooked = [], []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    net = EnhanceNet(ModelConfig(**MODEL)).eval()
    net.register_forward_pre_hook(
        lambda *_: hooked.append(torch.backends.cudnn.allow_tf32))
    cfg, rcfg = Config(model=ModelConfig(**MODEL)), RenderConfig(**RENDER)
    frame = FusedFrame(net, cfg, rcfg, planar=planar, device="cpu")
    assert frame.use_planar == (planar == "on")
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    cam = CameraParams.create(_eye(0.0))
    state = initial_state(cfg, rcfg, planar=planar, device="cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    frame(grid, cam, cam, state)
    assert torch.backends.cudnn.allow_tf32
    assert len(seen) >= 5 and not any(seen)
    assert hooked == ([] if planar == "on" else [False])
