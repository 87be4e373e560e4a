"""The port's direct volume rendering and SSAO vs the JAX package's
`render/volume_render.py` and `render/ssao.py`.

Tolerances.  The transfer function evaluates ``jnp.interp``'s formula
in float32 (the same rounding to 1e-7).  The sweep shares the iso
sweep's host geometry and resamples with float32 products summed in
another order than XLA's (1e-6 a slice), and the march's pixel rays come
from a 3x3 product XLA sums with fused multiply-adds (one ulp); both
composite hundreds of samples: 2e-5 (measured 2.5e-6).  SSAO counts the
same comparisons of the same depths: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.render import ssao as JS
from isosurfacesuperresolution_tpu.render import volume_render as JV
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_sweep)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu.volume import grid as JG
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import ssao as PS
from isosurfacesuperresolution_tpu_torch.render import volume_render as PV
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume import grid as PG

EYES = ((0.4, 0.9, -1.6), (1.8, 0.2, 0.1), (0.1, 1.8, 0.2),
        (-0.2, 0.3, 1.8))
MAX_DVR_DIFF = 2e-5
TF2 = ((0.1, 0.2, 0.2, 0.2, 0.0), (0.3, 1.0, 0.5, 0.0, 0.3),
       (0.9, 0.0, 0.5, 1.0, 0.6))
# not clear at density 0: every sample composites, inside the volume or
# outside it
TF_FOG = ((0.0, 0.1, 0.2, 0.4, 0.02), (0.5, 1.0, 0.5, 0.0, 0.2),
          (1.0, 1.0, 1.0, 1.0, 0.4))


@pytest.fixture(scope="module")
def spheres():
    return (j_analytic.sphere_volume(32),
            analytic.sphere_volume(32, device="cpu"))


@pytest.mark.parametrize("tf", ["default", "custom"])
def test_apply_transfer_matches_jax(tf):
    """At, between and beyond the nodes (clamped to the end values)."""
    tf = PV.DEFAULT_TF if tf == "default" else TF2
    nodes = [n[0] for n in tf]
    d = np.concatenate([nodes, [-1.0, -1e-3, 1.001, 2.0, 0.125, 0.6, 0.99],
                        np.random.RandomState(0).rand(200) * 1.4 - 0.2])
    d = d.astype(np.float32)
    got = PV.apply_transfer(torch.from_numpy(d), tf).numpy()
    want = np.asarray(JV.apply_transfer(jnp.asarray(d), tf))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(got[:len(tf)],
                                  np.asarray(tf, np.float32)[:, 1:])
    assert (got[d < nodes[0]] == np.asarray(tf[0][1:], np.float32)).all()
    assert (got[d > nodes[-1]] == np.asarray(tf[-1][1:], np.float32)).all()


@pytest.mark.parametrize("fn", ["render_volume_sweep",
                                "render_volume_march"])
def test_volume_render_matches_jax(spheres, fn):
    jg, pg = spheres
    kw = dict(width=32, height=24, step_voxels=0.25)
    for eye, tf, alpha in zip(EYES, (PV.DEFAULT_TF, TF2) * 2,
                              (1.0, 2.0) * 2):
        want = np.asarray(getattr(JV, fn)(
            jg, JCameraParams.create(eye),
            JRenderConfig(volume_alpha_scale=alpha, **kw), tf))
        got = getattr(PV, fn)(pg, CameraParams.create(eye),
                              RenderConfig(volume_alpha_scale=alpha, **kw),
                              tf).numpy()
        assert got.shape == (24, 32, 4)
        assert want[..., 3].max() > 0.2
        np.testing.assert_allclose(got, want, atol=MAX_DVR_DIFF, rtol=0)


def test_volume_march_opaque_at_zero_matches_jax(spheres):
    """A transfer function with opacity at density 0: the march samples
    every step of its range, not only those inside the volume (the
    sweep has one path for both kinds of function)."""
    jg, pg = spheres
    kw = dict(width=32, height=24, step_voxels=0.5)
    want = np.asarray(JV.render_volume_march(
        jg, JCameraParams.create(EYES[1]), JRenderConfig(**kw), TF_FOG))
    got = PV.render_volume_march(pg, CameraParams.create(EYES[1]),
                                 RenderConfig(**kw), TF_FOG).numpy()
    assert want[..., 3].min() > 0.1          # every ray gathers the fog
    np.testing.assert_allclose(got, want, atol=MAX_DVR_DIFF, rtol=0)


def test_volume_render_uint8_grid_matches_jax():
    v = np.asarray(j_analytic.sphere_volume(32).values)
    jg = JG.BrickGrid.from_dense(v, store_dtype="uint8")
    pg = PG.BrickGrid.from_dense(v, store_dtype="uint8", device="cpu")
    kw = dict(width=24, height=24, step_voxels=0.5,
              sweep_dtype="bfloat16")
    for fn in ("render_volume_sweep", "render_volume_march"):
        want = np.asarray(getattr(JV, fn)(jg, JCameraParams.create(EYES[0]),
                                          JRenderConfig(**kw)))
        got = getattr(PV, fn)(pg, CameraParams.create(EYES[0]),
                              RenderConfig(**kw)).numpy()
        # bf16 resample: a rounding flip moves a density by 2^-8
        tol = 5e-3 if fn == "render_volume_sweep" else MAX_DVR_DIFF
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("samples,radius", [(16, 16), (8, 5), (3, 1)])
def test_apply_screen_ao_matches_jax(spheres, samples, radius):
    jg, _ = spheres
    cam = JCameraParams.create((0.4, 0.9, -1.6))
    frame = np.array(j_sweep(jg, cam, cam, JRenderConfig(
        width=40, height=32, isovalue=0.5)))
    frame[5:9, 10:20, 7] -= 0.01           # a step in depth occludes
    want = np.asarray(JS.apply_screen_ao(jnp.asarray(frame), samples=samples,
                                         radius_px=radius, depth_range=0.05))
    got = PS.apply_screen_ao(torch.from_numpy(frame), samples=samples,
                             radius_px=radius, depth_range=0.05).numpy()
    np.testing.assert_array_equal(got, want)
    hit = frame[..., 3] > 0.5
    assert (got[..., 10][~hit] == 1).all() and (got[..., 10][hit] < 1).any()
    np.testing.assert_array_equal(got[..., :10], frame[..., :10])
