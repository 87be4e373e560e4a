"""The port's sweep renderer vs the JAX package's `render_gbuffer_sweep`,
for cameras on all three major axes with both flips, in float32 and
bfloat16: ``renderer="sweep"`` (the slice scan) against JAX's scan, and
``"sweep_pallas"`` (the march kernel) against JAX's kernel in interpret
mode."""

import numpy as np
import pytest

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_render)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic

# (eye, up): major axis x, y, z, each looked along from both sides
EYES = [((1.7, 0.3, 0.2), (0, 1, 0)), ((-1.6, 0.4, -0.3), (0, 1, 0)),
        ((0.3, 1.6, 0.4), (0, 1, 0)), ((-0.2, -1.7, 0.3), (0, 1, 0)),
        ((0.2, 0.7, 1.6), (0, 1, 0)), ((0.3, -0.5, -1.6), (0, 1, 0))]


def _volumes(name):
    if name == "sphere":
        return j_analytic.sphere_volume(32), analytic.sphere_volume(
            32, device="cpu")
    return (j_analytic.blobs_volume(32, num_blobs=5),
            analytic.blobs_volume(32, num_blobs=5, device="cpu"))


# the JAX suite's bounds for kernel vs scan (tests/test_sweep_pallas.py):
# depth, then the three normal channels; flow is added here
SCAN_TOL = ((7, 3e-3), (4, 3e-2), (5, 3e-2), (6, 3e-2), (8, 1e-3), (9, 1e-3))


@pytest.mark.parametrize("renderer", ["sweep", "sweep_pallas"])
@pytest.mark.parametrize("volume", ["sphere", "blobs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eye,up", EYES)
def test_sweep_matches_jax(volume, dtype, eye, up, renderer):
    jgrid, grid = _volumes(volume)
    kw = dict(width=32, height=24, isovalue=0.5, ao_samples=0,
              sweep_dtype=dtype)
    eye_prev = tuple(e + d for e, d in zip(eye, (0.03, -0.02, 0.02)))
    jcams = (JCameraParams.create(eye, up=up),
             JCameraParams.create(eye_prev, up=up))
    scan = np.asarray(j_render(jgrid, *jcams, JRenderConfig(**kw)))
    got = render_gbuffer_sweep(
        grid, CameraParams.create(eye, up=up),
        CameraParams.create(eye_prev, up=up),
        RenderConfig(renderer=renderer, **kw)).numpy()
    assert got.shape == scan.shape == (24, 32, 12)
    assert np.isfinite(got).all()

    if renderer == "sweep":
        # the port's scan rounds where JAX's scan rounds (the volume lerped
        # in float32, then rounded): float32 within rounding of the sums
        # and the host geometry (1e-4), the mask identical; in bf16 such a
        # rounding difference can flip one bf16 rounding of an operand, a
        # step of 2^-8 relative in a gradient: 5e-3, one mask pixel
        if dtype == "float32":
            np.testing.assert_array_equal(got[..., 3], scan[..., 3])
        assert np.sum(scan[..., 3] != got[..., 3]) <= 1
        both = (scan[..., 3] > 0.5) & (got[..., 3] > 0.5)
        assert both.sum() > 20
        d = np.abs(scan - got)[both]
        assert d.max() < (1e-4 if dtype == "float32" else 5e-3), d.max(0)
        return

    kernel = np.asarray(j_render(jgrid, *jcams, JRenderConfig(
        renderer="sweep_pallas", **kw)))          # interpret mode on CPU
    # the port reproduces the TPU kernel's arithmetic (bf16 volume storage
    # and rounding points included): in float32 all twelve channels agree
    # within float32 rounding of the sums and the host geometry (1e-4); in
    # bf16 such a rounding difference can flip one bf16 rounding of an
    # operand, a step of 2^-8 relative in a gradient, so normals and the
    # colour derived from them may move by up to 5e-3
    assert np.sum(kernel[..., 3] != got[..., 3]) <= 1
    both = (kernel[..., 3] > 0.5) & (got[..., 3] > 0.5)
    assert both.sum() > 20
    d = np.abs(kernel - got)[both]
    assert d.max() < (1e-4 if dtype == "float32" else 5e-3), d.max(0)

    # against the scan, the JAX suite's kernel-vs-scan bounds; where the
    # JAX kernel itself departs from the scan by more (bf16 storage at
    # some cameras), the port may depart as far as the kernel does
    assert np.mean(scan[..., 3] != got[..., 3]) < 0.01
    both = ((scan[..., 3] > 0.5) & (got[..., 3] > 0.5)
            & (kernel[..., 3] > 0.5))
    for ch, tol in SCAN_TOL:
        dev_kernel = np.abs(scan[..., ch] - kernel[..., ch])[both].max()
        d = np.abs(scan[..., ch] - got[..., ch])[both]
        assert d.max() < max(tol, dev_kernel + 1e-4), (ch, d.max())


def test_sweep_viewport_matches_jax():
    """Focus-of-context clipping: outside the viewport only ao and shadow
    stay (at 1)."""
    jgrid, grid = _volumes("sphere")
    kw = dict(width=32, height=24, isovalue=0.5, ao_samples=0,
              viewport=(4, 3, 25, 20))
    eye = (0.2, 0.7, -1.6)
    ref = np.asarray(j_render(jgrid, JCameraParams.create(eye),
                              JCameraParams.create(eye), JRenderConfig(**kw)))
    got = render_gbuffer_sweep(grid, CameraParams.create(eye),
                               CameraParams.create(eye),
                               RenderConfig(**kw)).numpy()
    assert (got[:3, :, :10] == 0).all() and (got[:, 25:, 10:] == 1).all()
    # float32: the port's scan and JAX's compute the same sums (1e-4)
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
