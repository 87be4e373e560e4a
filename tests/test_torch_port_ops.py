"""The port's image operations vs the JAX package's, on the same
numpy-seeded inputs (one parametrised test, one case per operation)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import ShadingConfig as JShading
from isosurfacesuperresolution_tpu.models import videotools as j_video
from isosurfacesuperresolution_tpu.ops import inpaint as j_inpaint
from isosurfacesuperresolution_tpu.ops.resize import resize as j_resize
from isosurfacesuperresolution_tpu.ops import separable_warp as j_warp
from isosurfacesuperresolution_tpu.ops import warp_fast as j_warp_fast
from isosurfacesuperresolution_tpu.render import shading as j_shading
from isosurfacesuperresolution_tpu.train.trainer import (
    clamp_output as j_clamp_output)
from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
from isosurfacesuperresolution_tpu_torch.infer.pipeline import clamp_output
from isosurfacesuperresolution_tpu_torch.models import videotools
from isosurfacesuperresolution_tpu_torch.ops import (
    inpaint, resize, separable_warp, warp_fast)
from isosurfacesuperresolution_tpu_torch.render import shading


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _interp_matrix(rng):
    pos = rng.uniform(-2.0, 14.0, (5, 7)).astype(np.float32)
    return (j_warp.interp_matrix(jnp.asarray(pos), 12),
            separable_warp.interp_matrix(_t(pos), 12))


def _homography_warp(rng):
    img = rng.rand(20, 16, 3).astype(np.float32)
    h = np.array([[1.1, 0.05, 0.3], [0.02, 0.9, -0.4], [1e-3, -2e-3, 1.0]],
                 np.float32)
    return (j_warp.homography_warp(jnp.asarray(img), jnp.asarray(h),
                                   (18, 14)),
            separable_warp.homography_warp(_t(img), _t(h), (18, 14)))


def _inpaint_flow(rng):
    flow = rng.uniform(-0.1, 0.1, (1, 16, 20, 2)).astype(np.float32)
    yy, xx = np.mgrid[:16, :20]
    mask = ((yy - 8) ** 2 + (xx - 9) ** 2 < 20).astype(np.float32)
    mask = mask[None, ..., None]
    return (j_inpaint.inpaint_flow(jnp.asarray(flow), jnp.asarray(mask), 8),
            inpaint.inpaint_flow(_t(flow), _t(mask), 8))


def _resize_bilinear_4x(rng):
    x = rng.rand(1, 6, 5, 3).astype(np.float32)
    return (j_resize(jnp.asarray(x), scale=4.0, method="bilinear"),
            resize.resize(_t(x), scale=4.0, method="bilinear"))


def _flatten_high(rng):
    x = rng.rand(1, 8, 12, 6).astype(np.float32)
    return (j_video.flatten_high(jnp.asarray(x), 4),
            videotools.flatten_high(_t(x), 4))


def _initial_image(mode):
    def build(rng):
        low = rng.uniform(-1.0, 1.0, (1, 5, 7, 5)).astype(np.float32)
        return (j_video.initial_image(jnp.asarray(low), 6, mode, False, 4),
                videotools.initial_image(_t(low), 6, mode, False, 4))
    return build


def _warp_upscale_fast(rng):
    img = rng.rand(1, 24, 32, 6).astype(np.float32)
    img[..., 0] = img[..., 0] * 2.0 - 1.0
    # up to ~10 px displacements, so the 8 px clamp is exercised
    flow = rng.uniform(-0.3, 0.3, (1, 6, 8, 2)).astype(np.float32)
    return (j_warp_fast.warp_upscale_fast(jnp.asarray(img),
                                          jnp.asarray(flow), 4,
                                          special_mask=True, max_disp=8),
            warp_fast.warp_upscale_fast(_t(img), _t(flow), 4,
                                        special_mask=True, max_disp=8))


def _shading_buffer(rng):
    buf = rng.uniform(-1.0, 1.0, (1, 8, 9, 6)).astype(np.float32)
    buf[..., 5] = rng.uniform(-0.2, 1.2, (1, 8, 9))
    return buf


def _screen_space_shading(rng):
    buf = _shading_buffer(rng)
    return (j_shading.screen_space_shading(jnp.asarray(buf), JShading()),
            shading.screen_space_shading(_t(buf), ShadingConfig()))


def _screen_space_shading_specular(rng):
    buf = _shading_buffer(rng)
    kw = dict(enable_specular=True, inverse_ao=True, ao_strength=0.7,
              light_direction=(0.3, -0.2, 1.0), background=(0.2, 0.3, 0.4))
    return (j_shading.screen_space_shading(jnp.asarray(buf), JShading(**kw)),
            shading.screen_space_shading(_t(buf), ShadingConfig(**kw)))


def _clamp_output(rng):
    x = rng.uniform(-2.0, 2.0, (1, 8, 9, 6)).astype(np.float32)
    x[0, 0, 0, 1:4] = 0.0                  # zero normal: the safe path
    return j_clamp_output(jnp.asarray(x)), clamp_output(_t(x))


# float32 on both sides; the tolerances cover summation order (the JAX
# resize and interpolation products are dense matmuls, the port's
# F.interpolate sums two taps) and pow/sqrt/division rounding
CASES = {
    "interp_matrix": (_interp_matrix, 1e-6),
    "homography_warp": (_homography_warp, 1e-5),
    "inpaint_flow": (_inpaint_flow, 1e-6),
    "resize_bilinear_4x": (_resize_bilinear_4x, 1e-6),
    "flatten_high": (_flatten_high, 0.0),
    "initial_image_unshaded": (_initial_image("unshaded"), 0.0),
    "initial_image_input": (_initial_image("input"), 1e-6),
    "initial_image_zero": (_initial_image("zero"), 0.0),
    "warp_upscale_fast": (_warp_upscale_fast, 1e-5),
    "screen_space_shading": (_screen_space_shading, 1e-6),
    "screen_space_shading_specular": (_screen_space_shading_specular, 1e-5),
    "clamp_output": (_clamp_output, 1e-6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    build, atol = CASES[name]
    ref, got = build(np.random.RandomState(0))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
