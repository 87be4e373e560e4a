"""The port's baked AO vs the JAX package's `render/ao_sweep.py`: the bake
and its helpers, `attach_baked_ao` (coarse and uint8 fields), the march's
AO capture vs the Pallas kernel in interpret mode, and the sweep renderer
with a baked field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.render import ao_sweep as J
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_render)
from isosurfacesuperresolution_tpu.render.sweep_pallas import march_pallas
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import ao_sweep as P
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    ao_field_zcxy, render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic

from _torch_port_inputs import (BF16_TOL, CASES, SN, TN,
                                assert_bf16_render_close, make_ao_field,
                                make_inputs)


def test_fibonacci_sphere_and_shift_volume_match_jax():
    np.testing.assert_array_equal(P.fibonacci_sphere(13),
                                  J.fibonacci_sphere(13))
    v = np.random.RandomState(0).rand(9, 8, 7).astype(np.float32)
    for off in ((0.3, -1.7, 2.25), (-3.5, 0.0, 0.9), (12.0, 0.5, -8.0)):
        ref = np.asarray(J._shift_volume(jnp.asarray(v),
                                         jnp.asarray(off, jnp.float32)))
        got = P._shift_volume(torch.from_numpy(v), off).numpy()
        # the same float32 lerps of the same zero-filled shifts
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def spheres():
    return (j_analytic.sphere_volume(16), analytic.sphere_volume(16,
                                                                 device="cpu"))


def test_bake_occlusion_sh_matches_jax(spheres):
    jgrid, grid = spheres
    ref = np.asarray(J.bake_occlusion_sh(jgrid.values, 0.5, 3.0, num_dirs=6,
                                         num_steps=4))
    got = P.bake_occlusion_sh(grid.values, 0.5, 3.0, num_dirs=6,
                              num_steps=4).numpy()
    assert got.shape == ref.shape == (16, 16, 16, 4)
    assert ref[..., 0].max() > 0.2            # some voxels are occluded
    # the inside test and the max over steps agree exactly; the SH sums
    # differ by float32 rounding of the 1/num_dirs scaling (1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_ao_from_sh_matches_jax():
    rng = np.random.RandomState(1)
    sh = (rng.rand(5, 7, 4) - 0.3).astype(np.float32)
    n = rng.normal(size=(5, 7, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ref = np.asarray(J.ao_from_sh(jnp.asarray(sh), jnp.asarray(n)))
    got = P.ao_from_sh(torch.from_numpy(sh), torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    assert (got == 0).any() or (got == 1).any() or got.min() >= 0


# (downsample, out_dtype, keep_coarse)
ATTACH = {"full_f32": (1, None, False),
          "full_uint8": (1, "uint8", False),
          "coarse2_f32": (2, None, False),
          "coarse2_uint8": (2, "uint8", False),
          "coarse2_keep": (2, None, True)}


@pytest.mark.parametrize("case", sorted(ATTACH))
def test_attach_baked_ao_matches_jax(spheres, case):
    f, out, keep = ATTACH[case]
    jgrid, grid = spheres
    kw = dict(num_dirs=6, num_steps=4, downsample=f, keep_coarse=keep)
    ref = J.attach_baked_ao(jgrid, 0.5, 0.2,
                            out_dtype=None if out is None else np.uint8, **kw)
    got = P.attach_baked_ao(grid, 0.5, 0.2, out_dtype=out, **kw)
    assert got.ao_downsample == ref.ao_downsample
    assert got.ao_sh.shape == ref.ao_sh.shape
    assert got.values is grid.values
    if out == "uint8":
        assert got.ao_sh.dtype == torch.uint8
        assert isinstance(got.ao_scale, tuple) and len(got.ao_scale) == 4
        # per-channel scales and offsets from the same field extrema
        np.testing.assert_allclose(got.ao_scale, ref.ao_scale, rtol=1e-5)
        np.testing.assert_allclose(got.ao_offset, ref.ao_offset, atol=1e-6)
        # float32 rounding of the field may move a value across a
        # quantization boundary: one step at most
        d = np.abs(got.ao_sh.numpy().astype(int)
                   - np.asarray(ref.ao_sh).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got.ao_sh.numpy(), np.asarray(ref.ao_sh),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("store,mm", CASES)
def test_march_ao_plain_matches_pallas_interpret(store, mm, quantize):
    vol, meta, sg, tg, scale, offset = make_inputs(store)
    _, ao, _, _ = make_ao_field(quantize)     # the dequantized field
    ref = march_pallas(jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(sg),
                       jnp.asarray(tg), SN, TN, interpret=True,
                       dtype=jnp.dtype(mm), scale=scale, offset=offset,
                       ao_zcxy=jnp.asarray(ao))
    got = sweep_march.march_plain(
        torch.from_numpy(vol), torch.from_numpy(meta), torch.from_numpy(sg),
        torch.from_numpy(tg), SN, TN, dtype=getattr(torch, mm), scale=scale,
        offset=offset, ao_zcxy=torch.from_numpy(ao))
    assert len(got) == len(ref) == 6
    ref, got = [np.asarray(r) for r in ref], [g.numpy() for g in got]
    hit = ref[0] >= 0
    assert hit.mean() > 0.3 and (~hit).any()
    assert (ref[5][:, hit] != 0).all() and (got[5][:, ~hit] == 0).all()
    # the same operands rounded at the same points, two-tap float32 sums:
    # hits exact, frac and gradients 1e-5 (as without AO), SH 1e-6
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:5], ref[1:5]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[5], ref[5], atol=1e-6, rtol=0)


def test_march_ao_wrapper_runs_plain_on_cpu_without_counting():
    vol, meta, sg, tg, _, _ = make_inputs("bfloat16")
    _, ao, _, _ = make_ao_field()
    args = [torch.from_numpy(a) for a in (vol, meta, sg, tg)]
    before = (sweep_march.march.launches, sweep_march.march.ao_launches)
    got = sweep_march.march(*args, SN, TN, ao_zcxy=torch.from_numpy(ao))
    want = sweep_march.march_plain(*args, SN, TN,
                                   ao_zcxy=torch.from_numpy(ao))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (sweep_march.march.launches,
            sweep_march.march.ao_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ao_field_is_slice_major_contiguous(dtype):
    """The sweep hands the march a permuted (Z, 4, X, Y) view of the
    (X, Y, Z, 4) field; the kernel reads raw memory, so the wrapper copies
    a view even when its type already fits."""
    field = torch.from_numpy(np.random.RandomState(0).rand(5, 4, 3, 4)
                             .astype(np.float32))
    grid = analytic.sphere_volume(4, device="cpu")
    grid = dataclasses.replace(grid, ao_sh=field)
    view = ao_field_zcxy(grid, (0, 1, 2))
    assert tuple(view.shape) == (3, 4, 5, 4) and not view.is_contiguous()
    ao = sweep_march.kernel_ao_field(view, dtype)
    assert ao.is_contiguous() and ao.dtype == dtype
    torch.testing.assert_close(ao, view.to(dtype), rtol=0, atol=0)
    same = view.contiguous()
    if dtype == torch.float32:
        assert sweep_march.kernel_ao_field(same, dtype) is same


def test_ao_field_dequantizes_uint8_per_channel():
    q = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (3, 4, 5, 4)).astype(np.uint8))
    scale, offset = (0.1, 0.01, 0.02, 0.03), (-0.5, 0.0, 0.25, 1.0)
    grid = dataclasses.replace(analytic.sphere_volume(4, device="cpu"),
                               ao_sh=q, ao_scale=scale, ao_offset=offset)
    got = ao_field_zcxy(grid, (1, 2, 0))
    want = (q.numpy().astype(np.float32) * np.float32(scale)
            + np.float32(offset)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The sweep renderer with a baked field
# ---------------------------------------------------------------------------

EYES = [((0.3, 0.9, -1.5), (0, 1, 0)), ((1.6, 0.4, 0.3), (0, 1, 0)),
        ((0.2, -1.7, 0.4), (0, 1, 0))]


@pytest.fixture(scope="module")
def baked_blobs():
    """One JAX bake, handed to both renderers (the bake is held above)."""
    jgrid = J.attach_baked_ao(j_analytic.blobs_volume(32, num_blobs=5), 0.5,
                              0.2, num_dirs=8, num_steps=6)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    u8 = J.attach_baked_ao(j_analytic.blobs_volume(32, num_blobs=5), 0.5,
                           0.2, num_dirs=8, num_steps=6, out_dtype=np.uint8)
    ported = {
        "float32": dataclasses.replace(
            grid, ao_sh=torch.from_numpy(np.array(jgrid.ao_sh))),
        "uint8": dataclasses.replace(
            grid, ao_sh=torch.from_numpy(np.array(u8.ao_sh)),
            ao_scale=u8.ao_scale, ao_offset=u8.ao_offset)}
    return {"float32": jgrid, "uint8": u8}, ported


@pytest.mark.parametrize("renderer", ["sweep", "sweep_pallas"])
@pytest.mark.parametrize("field", ["float32", "uint8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eye,up", EYES)
def test_sweep_with_baked_ao_matches_jax(baked_blobs, eye, up, dtype, field,
                                         renderer):
    jgrids, grids = baked_blobs
    kw = dict(width=32, height=24, isovalue=0.5, ao_samples=64,
              ao_mode="volume", sweep_dtype=dtype, renderer=renderer)
    eye_prev = tuple(e + d for e, d in zip(eye, (0.03, -0.02, 0.02)))
    jcams = (JCameraParams.create(eye, up=up),
             JCameraParams.create(eye_prev, up=up))
    before = sweep_march.march.ao_launches
    got = render_gbuffer_sweep(
        grids[field], CameraParams.create(eye, up=up),
        CameraParams.create(eye_prev, up=up), RenderConfig(**kw)).numpy()
    assert sweep_march.march.ao_launches == before     # plain on the CPU
    # each renderer against JAX's: the scan (AO sampled in float32, the
    # dequant after the lerp) and the kernel (interpret mode)
    ref = np.asarray(j_render(jgrids[field], *jcams, JRenderConfig(**kw)))
    assert got.shape == ref.shape == (24, 32, 12)
    assert np.sum(ref[..., 3] != got[..., 3]) <= 1
    both = (ref[..., 3] > 0.5) & (got[..., 3] > 0.5)
    assert both.sum() > 20
    ao_ref, ao_got = ref[..., 10][both], got[..., 10][both]
    assert ao_ref.min() < 0.95                # the field occludes some hits
    # AO = clip(1 - mean - 2/3 g.n): the SH capture agrees to 1e-6 (the
    # flat kernel dequantizes a uint8 field before the z-lerp, as JAX's
    # kernel path does: float32 rounding, 1e-6), so AO follows the
    # normal: 1e-4 in float32 (the sweep test's bound).  In bf16 a
    # rounding flip moves a gradient by 2^-8 relative: 5e-3 on every
    # channel (AO measured 4e-4), but at the one flip pixel of the first
    # camera that `assert_bf16_render_close` names (its normal 7.5e-3)
    if dtype == "float32":
        assert np.abs(ao_got - ao_ref).max() < 1e-4
        d = np.abs(got - ref)[both]
        assert d.max() < 1e-4, d.max(0)
    else:
        assert np.abs(ao_got - ao_ref).max() < BF16_TOL
        assert_bf16_render_close(got, ref, both, eye)


def test_ao_mode_rules():
    grid = analytic.sphere_volume(16, device="cpu")
    cam = CameraParams.create((0.3, 0.9, -1.5))
    cfg = RenderConfig(width=16, height=12, isovalue=0.5, ao_samples=8)
    with pytest.raises(ValueError, match="needs a baked occlusion field"):
        render_gbuffer_sweep(grid, cam, cam, cfg.replace(ao_mode="volume"))
    # no field, or ao_mode "ray": hemisphere rays, as in JAX (the raycast
    # tests' bounds: 1e-4 off the AO channel, an AO ray flip moves AO by
    # 1/samples); "ray" ignores a baked field
    j_sphere = j_analytic.sphere_volume(16)
    j_cam = JCameraParams.create((0.3, 0.9, -1.5))
    baked = P.attach_baked_ao(grid, 0.5, 0.2, num_dirs=2, num_steps=2)
    ray = render_gbuffer_sweep(grid, cam, cam, cfg.replace(ao_mode="ray"))
    ref = np.asarray(j_render(j_sphere, j_cam, j_cam, JRenderConfig(
        width=16, height=12, isovalue=0.5, ao_samples=8, ao_mode="ray")))
    for g, mode in ((grid, "auto"), (grid, "ray"), (baked, "ray")):
        got = render_gbuffer_sweep(g, cam, cam,
                                   cfg.replace(ao_mode=mode)).numpy()
        # the same branch in JAX whatever the mode here
        np.testing.assert_array_equal(got, ray.numpy())
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])
        hit = got[..., 3] > 0.5
        d = np.abs(got - ref)[hit]
        assert d[:, [c for c in range(12) if c != 10]].max() < 1e-4
        assert d[:, 10].max() < 1.0 / 8 + 1e-4
        assert (d[:, 10] > 1e-4).mean() <= 0.02
        assert (got[..., 10][hit] < 1).any()
    # a coarse field renders, as in JAX (flat path: upsampled first; the
    # scan and the kernel's plain version)
    coarse = P.attach_baked_ao(grid, 0.5, 0.2, num_dirs=2, num_steps=2,
                               downsample=2, keep_coarse=True,
                               out_dtype="uint8")
    jgrid = dataclasses.replace(
        j_analytic.sphere_volume(16),
        ao_sh=jnp.asarray(coarse.ao_sh.numpy()), ao_scale=coarse.ao_scale,
        ao_offset=coarse.ao_offset, ao_downsample=2)
    jcam = JCameraParams.create((0.3, 0.9, -1.5))
    for renderer in ("sweep", "sweep_pallas"):
        rcfg = cfg.replace(renderer=renderer)
        got = render_gbuffer_sweep(coarse, cam, cam, rcfg).numpy()
        ref = np.asarray(j_render(jgrid, jcam, jcam, JRenderConfig(
            width=16, height=12, isovalue=0.5, ao_samples=8,
            renderer=renderer)))
        np.testing.assert_array_equal(got[..., 3], ref[..., 3])
        assert (got[..., 10][got[..., 3] > 0.5] < 1).any()
        # float32 sums and the upsample (F.interpolate against
        # jax.image.resize): the sweep test's 1e-4
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # ao_samples = 0 ignores a baked field; "auto" uses it
    plain = render_gbuffer_sweep(baked, cam, cam, cfg.replace(ao_samples=0))
    assert (plain[..., 10] == 1).all()
    auto = render_gbuffer_sweep(baked, cam, cam, cfg)
    assert (auto[..., 10] < 1).any()
