"""The port's large-volume path vs the JAX package: the brick pyramid, the
occupancy tables, the tiled march (B2) and the tiled AO capture (B4)
plain versions vs the Pallas kernels in interpret mode, the whole tiled
render, the rule that picks it, and coarse AO fields on the flat path."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.render import ao_sweep as J_ao
from isosurfacesuperresolution_tpu.render import sweep_pallas as J_flat
from isosurfacesuperresolution_tpu.render import sweep_pallas_tiled as JT
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_render)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu.volume import grid as j_grid
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import ao_sweep as P_ao
from isosurfacesuperresolution_tpu_torch.render import sweep as P_sweep
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume.grid import (
    BrickGrid, compute_brick_minmax)

from _torch_port_inputs import (CASES, TILE, TSN, TTN,
                                assert_bf16_render_close,
                                make_tiled_ao_field, make_tiled_inputs)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# (a) the brick pyramid
# ---------------------------------------------------------------------------

def test_compute_brick_minmax_matches_jax():
    v = np.random.RandomState(0).rand(13, 10, 17).astype(np.float32)
    for b in (4, 8):
        ref = j_grid.compute_brick_minmax(v, b)
        got = compute_brick_minmax(v, b)
        for r, g in zip(ref, got):
            assert g.shape == r.shape == (-(-13 // b), -(-10 // b),
                                          -(-17 // b))
            np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("store", ["float32", "bfloat16", "uint8"])
def test_from_dense_brick_pyramid_matches_jax(store):
    """The pyramid bounds the dequantized STORED values, as in JAX."""
    v = (np.random.RandomState(1).rand(12, 9, 20) * 1.7 - 0.2).astype(
        np.float32)
    ref = j_grid.BrickGrid.from_dense(v, brick_size=4, store_dtype=store)
    got = BrickGrid.from_dense(v, brick_size=4, store_dtype=store,
                               device="cpu")
    assert got.brick_size == 4
    np.testing.assert_array_equal(got.brick_min.numpy(),
                                  np.asarray(ref.brick_min))
    np.testing.assert_array_equal(got.brick_max.numpy(),
                                  np.asarray(ref.brick_max))
    vox = np.random.RandomState(2).uniform(-3, 23, (40, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        got.brick_max_at(torch.from_numpy(vox)).numpy(),
        np.asarray(ref.brick_max_at(jnp.asarray(vox))))


def test_analytic_volumes_carry_the_pyramid():
    for jg, g in ((j_analytic.sphere_volume(16, brick_size=4),
                   analytic.sphere_volume(16, brick_size=4, device="cpu")),
                  (j_analytic.blobs_volume(16, num_blobs=3),
                   analytic.blobs_volume(16, num_blobs=3, device="cpu"))):
        assert g.brick_size == jg.brick_size
        np.testing.assert_array_equal(g.brick_max.numpy(),
                                      np.asarray(jg.brick_max))
    # a baked field keeps the pyramid
    g = analytic.sphere_volume(8, device="cpu")
    baked = P_ao.attach_baked_ao(g, 0.5, 0.2, num_dirs=2, num_steps=2)
    assert baked.brick_max is g.brick_max and baked.brick_size == 8


# ---------------------------------------------------------------------------
# (b) the occupancy tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("X,Y,TX,TY", [(32, 32, 16, 16), (24, 20, 12, 5)])
def test_occupancy_tables_match_jax(X, Y, TX, TY):
    """Bricks of 8 straddle tiles of 12 and 5: they count for both."""
    rng = np.random.RandomState(3)
    bmax = rng.rand(-(-X // 8), -(-Y // 8), 3).astype(np.float32)
    K = 40
    meta = np.zeros((K, 8), np.float32)
    meta[:, 2] = np.minimum(np.arange(K) // 2, 22)
    meta[:, 4] = (rng.rand(K) > 0.2).astype(np.float32)
    iso = 0.62
    ref = JT._tile_occupancy(jnp.asarray(bmax), 8, jnp.asarray(
        meta[:, 2].astype(np.int32)), iso, X, Y, TX, TY)
    got = PT.tile_occupancy(torch.from_numpy(bmax), 8,
                            torch.from_numpy(meta[:, 2]).long(), iso, X, Y,
                            TX, TY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()
    P = (X // TX) * (Y // TY)
    _, counts, ybits = JT._pair_lists(ref, jnp.asarray(meta), K, P)
    occ_g, counts_g, ybits_g = PT.pair_tables(got, torch.from_numpy(meta))
    np.testing.assert_array_equal(counts_g.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(ybits_g.numpy(),
                                  np.asarray(ybits).astype(bool))
    assert not occ_g[meta[:, 4] < 0.5].any()
    np.testing.assert_array_equal(PT.dilate_tiles(got).numpy(),
                                  np.asarray(JT._dilate_tiles(ref)))


@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("X,Y,TX,TY", [(32, 32, 16, 16), (24, 20, 12, 5)])
def test_tile_table_matches_jax_occupancy(X, Y, TX, TY, dilate):
    """The kernels' camera-free table, compared with the isovalue at a
    slice's floor row, is JAX's per-frame occupancy (dilated for B4), and
    its last column says whether the slice has an occupied tile."""
    rng = np.random.RandomState(5)
    bmax = rng.rand(-(-X // 8), -(-Y // 8), 3).astype(np.float32)
    zfs = np.minimum(np.arange(40) // 2, 22).astype(np.int32)
    iso = 0.9                  # some slices, dilated or not, stay empty
    ref = JT._tile_occupancy(jnp.asarray(bmax), 8, jnp.asarray(zfs), iso, X,
                             Y, TX, TY)
    if dilate:
        ref = JT._dilate_tiles(ref)
    ref = np.asarray(ref)
    table = PT.tile_table(torch.from_numpy(bmax), 8, X, Y, TX, TY, dilate)
    P = (X // TX) * (Y // TY)
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert tuple(table.shape) == (3 * 8, P + 1)
    rows = table.numpy()[zfs] >= np.float32(iso)
    np.testing.assert_array_equal(rows[:, :P].reshape(ref.shape), ref)
    np.testing.assert_array_equal(rows[:, P], ref.reshape(len(zfs), -1)
                                  .any(1))
    assert ref.any() and not ref.all()


def test_slice_has_hit_and_pick_tile_match_jax():
    rng = np.random.RandomState(4)
    m_hit = np.where(rng.rand(37, 29) < 0.4, -1.0,
                     rng.randint(0, 50, (37, 29))).astype(np.float32)
    for K in (50, 64):
        np.testing.assert_array_equal(
            PT.slice_has_hit(torch.from_numpy(m_hit), K).numpy(),
            np.asarray(JT._slice_has_hit(jnp.asarray(m_hit), K)))
    assert [PT.pick_tile(n, 256) for n in (512, 480, 257, 16)] == \
        [256, 240, 1, 16]


# ---------------------------------------------------------------------------
# (c) the tiled march: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _tiled_args(store):
    vol, meta, sg, tg, scale, offset, bmax, iso = make_tiled_inputs(store)
    return vol, meta, sg, tg, scale, offset, bmax, iso


@pytest.mark.parametrize("store,mm", CASES)
def test_march_tiled_plain_matches_pallas_interpret(store, mm):
    vol, meta, sg, tg, scale, offset, bmax, iso = _tiled_args(store)
    ref = JT.march_pallas_tiled(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(sg),
        jnp.asarray(tg), TSN, TTN, jnp.asarray(bmax), 8, iso, tile=TILE,
        interpret=True, dtype=jnp.dtype(mm), scale=scale, offset=offset)
    ref = [np.asarray(r) for r in ref]
    args = _t(vol, meta, sg, tg) + [TSN, TTN]
    got = PT.march_tiled_plain(*args, torch.from_numpy(bmax), 8, iso,
                               tile=TILE, dtype=getattr(torch, mm),
                               scale=scale, offset=offset)
    got = [g.numpy() for g in got]

    # what the inputs exercise (the JAX kernel's own output):
    m_ref = ref[0]
    occ = JT._tile_occupancy(jnp.asarray(bmax), 8, jnp.asarray(
        meta[:, 2].astype(np.int32)), iso, 32, 32, TILE, TILE)
    _, counts, _ = JT._pair_lists(occ, jnp.asarray(meta), meta.shape[0], 4)
    counts, occ = np.asarray(counts), np.asarray(occ)
    works = (meta[:, 4] > 0.5) & (counts > 0)
    # a working slice whose occupied tiles sit beside culled ones, and the
    # culling changes the result against the flat march
    assert any(occ[k].any() and not occ[k].all() for k in np.flatnonzero(
        works))
    flat = sweep_march.march_plain(*args, dtype=getattr(torch, mm),
                                   scale=scale, offset=offset)
    assert (flat[0].numpy() != m_ref).any()
    # a do-slice with no occupied tile right before crossings (Fm1 reset)
    reset = [k for k in range(1, len(counts))
             if meta[k - 1, 4] > 0.5 and counts[k - 1] == 0
             and (m_ref == k).any()]
    assert reset
    # crossings on the border rows and columns with non-zero gradients
    assert ((m_ref[-1] >= 0) & (ref[2][-1] != 0)).any()
    assert ((m_ref[:, 0] >= 0) & (ref[3][:, 0] != 0)).any()
    # the same operands rounded at the same points and two-tap float32
    # sums: hits exact, frac and gradients within float32 rounding (1e-5)
    np.testing.assert_array_equal(got[0], m_ref)
    for name, a, b in zip(("frac", "g_s", "g_t", "g_z"), got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_march_tiled_wrapper_runs_plain_on_cpu_without_counting():
    vol, meta, sg, tg, scale, offset, bmax, iso = _tiled_args("uint8")
    args = _t(vol, meta, sg, tg) + [TSN, TTN, torch.from_numpy(bmax), 8, iso]
    before = PT.march_tiled_kernel.launches
    got = PT.march_tiled(*args, tile=TILE, scale=scale, offset=offset)
    want = PT.march_tiled_plain(*args, tile=TILE, scale=scale, offset=offset)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert PT.march_tiled_kernel.launches == before


# ---------------------------------------------------------------------------
# (d) the tiled AO capture: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------

# (field storage, field downsample, resample type); AO tiles of 8 so that
# pixels' taps straddle field tiles
AO_CASES = [("float32", 1, "float32"), ("bfloat16", 1, "bfloat16"),
            ("uint8", 1, "float32"), ("uint8", 1, "bfloat16"),
            ("uint8", 2, "bfloat16"), ("float32", 2, "float32")]


@pytest.fixture(scope="module")
def tiled_hits():
    """The JAX tiled march's hits on the uint8 inputs (bf16)."""
    vol, meta, sg, tg, scale, offset, bmax, iso = _tiled_args("uint8")
    m_hit = np.array(JT.march_pallas_tiled(
        jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(sg),
        jnp.asarray(tg), TSN, TTN, jnp.asarray(bmax), 8, iso, tile=TILE,
        interpret=True, dtype=jnp.bfloat16, scale=scale, offset=offset)[0])
    return meta, sg, tg, bmax, iso, m_hit


@pytest.mark.parametrize("field,fd,mm", AO_CASES)
def test_ao_capture_tiled_plain_matches_pallas_interpret(tiled_hits, field,
                                                         fd, mm):
    meta, sg, tg, bmax, iso, m_hit = tiled_hits
    ao, scale, offset = make_tiled_ao_field(fd, quantize=field == "uint8")
    if field == "bfloat16":
        ao = torch.from_numpy(ao).to(torch.bfloat16)
        j_ao = jnp.asarray(ao.float().numpy()).astype(jnp.bfloat16)
    else:
        j_ao = jnp.asarray(ao)
        ao = torch.from_numpy(ao)
    ref = np.asarray(JT.ao_capture_tiled(
        j_ao, jnp.asarray(meta), jnp.asarray(sg), jnp.asarray(tg), TSN, TTN,
        jnp.asarray(m_hit), jnp.asarray(bmax), 8, iso, tile=8,
        interpret=True, dtype=jnp.dtype(mm), ao_scale=scale,
        ao_offset=offset, field_downsample=fd))
    got = PT.ao_capture_tiled_plain(
        ao, *_t(meta, sg, tg), TSN, TTN, torch.from_numpy(m_hit),
        torch.from_numpy(bmax), 8, iso, tile=8, dtype=getattr(torch, mm),
        ao_scale=scale, ao_offset=offset, field_downsample=fd).numpy()
    hit = m_hit >= 0
    assert hit.mean() > 0.5 and (ref[:, hit] != 0).all()
    assert (got[:, ~hit] == 0).all() and (ref[:, ~hit] == 0).all()
    # hit pixels whose two x taps or two y taps lie in different field
    # tiles of 8, so that per-pair rounding and the pair order matter
    lam = meta[m_hit[hit].astype(int), 1]
    s = np.broadcast_to(sg[:, None], m_hit.shape)[hit]
    t = np.broadcast_to(tg[None, :], m_hit.shape)[hit]
    jx = np.floor((16.0 + lam * (s - 16.0)) / fd - 0.5).astype(int)
    jy = np.floor((15.5 + lam * (t - 15.5)) / fd - 0.5).astype(int)
    assert ((jx % 8 == 7) | (jy % 8 == 7)).any()
    # the same operands rounded at the same points, summed per pair in the
    # same order: float32 within rounding of the two-tap sums (1e-6); in
    # bf16 a sum may round to the neighbouring bf16 value, one step of the
    # term (2^-8 relative)
    if mm == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=2.0 ** -8)


def test_ao_capture_tiled_wrapper_runs_plain_on_cpu_without_counting(
        tiled_hits):
    meta, sg, tg, bmax, iso, m_hit = tiled_hits
    ao, scale, offset = make_tiled_ao_field(2, quantize=True)
    args = ([torch.from_numpy(ao)] + _t(meta, sg, tg)
            + [TSN, TTN, torch.from_numpy(m_hit), torch.from_numpy(bmax), 8,
               iso])
    kw = dict(tile=8, ao_scale=scale, ao_offset=offset, field_downsample=2)
    before = PT.ao_capture_tiled_kernel.launches
    got = PT.ao_capture_tiled(*args, **kw)
    want = PT.ao_capture_tiled_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert PT.ao_capture_tiled_kernel.launches == before


# ---------------------------------------------------------------------------
# (e) the whole tiled render, (g) coarse fields on the flat path
# ---------------------------------------------------------------------------

# the baked-AO test's first camera and one of the sweep test's
EYES = [(0.3, 0.9, -1.5), (0.2, 0.7, 1.6)]


@pytest.fixture(scope="module")
def blobs32():
    """32^3 blobs in both packages, with the same coarse uint8 field (the
    JAX bake, handed across; the bake itself is held in
    test_torch_port_ao)."""
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    coarse = J_ao.attach_baked_ao(jgrid, 0.5, 0.2, num_dirs=8, num_steps=6,
                                  downsample=2, keep_coarse=True,
                                  out_dtype=np.uint8)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    ported = dataclasses.replace(
        grid, ao_sh=torch.from_numpy(np.array(coarse.ao_sh)),
        ao_scale=coarse.ao_scale, ao_offset=coarse.ao_offset,
        ao_downsample=2)
    return {False: jgrid, True: coarse}, {False: grid, True: ported}


def _render_both(blobs32, ao, eye, **kw):
    jgrids, grids = blobs32
    eye_prev = tuple(e + d for e, d in zip(eye, (0.03, -0.02, 0.02)))
    if ao:
        kw.update(ao_samples=64, ao_mode="volume")
    kw = dict(width=32, height=24, isovalue=0.5, **kw)
    ref = np.asarray(j_render(jgrids[ao], JCameraParams.create(eye),
                              JCameraParams.create(eye_prev),
                              JRenderConfig(**kw)))
    got = P_sweep.render_gbuffer_sweep(
        grids[ao], CameraParams.create(eye), CameraParams.create(eye_prev),
        RenderConfig(**kw)).numpy()
    assert got.shape == ref.shape == (24, 32, 12)
    assert np.isfinite(got).all()
    both = (ref[..., 3] > 0.5) & (got[..., 3] > 0.5)
    assert both.sum() > 20
    if ao:
        assert ref[..., 10][both].min() < 0.95       # the field occludes
    return ref, got, both


@pytest.mark.parametrize("eye", EYES)
@pytest.mark.parametrize("ao", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_render_matches_jax(blobs32, dtype, ao, eye):
    """sweep_tile=16 forces B2 (and B4) on 32^3: 2 x 2 march tiles, one
    field tile."""
    calls = []
    orig = P_sweep.march_tiled
    try:
        P_sweep.march_tiled = lambda *a, **k: calls.append(1) or orig(*a,
                                                                     **k)
        ref, got, both = _render_both(blobs32, ao, eye, sweep_dtype=dtype,
                                      renderer="sweep_pallas", sweep_tile=16)
    finally:
        P_sweep.march_tiled = orig
    assert calls == [1]
    # float32: the same sums up to float32 rounding (1e-4, the sweep
    # test's bound); bf16: 5e-3 but at the one flip pixel that
    # `assert_bf16_render_close` names
    assert np.sum(ref[..., 3] != got[..., 3]) <= 1
    if dtype == "float32":
        d = np.abs(ref - got)[both]
        assert d.max() < 1e-4, d.max(0)
    else:
        assert_bf16_render_close(got, ref, both, eye)


def test_renderer_keeps_tile_tables_with_the_grid(blobs32, monkeypatch):
    """The tile tables depend on the grid, axis order and tile only: two
    frames build them once (the march's and the capture's), and a grid
    made by `dataclasses.replace` starts without them."""
    grid = dataclasses.replace(blobs32[1][True])      # no tables yet
    assert grid.derived == {}
    built = []
    monkeypatch.setattr(P_sweep, "tile_table", lambda *a: built.append(
        a[2:]) or PT.tile_table(*a))
    cfg = RenderConfig(width=32, height=24, isovalue=0.5, ao_samples=64,
                       ao_mode="volume", renderer="sweep_pallas",
                       sweep_tile=16)
    for eye in (EYES[0], (0.35, 0.85, -1.5)):
        cam = CameraParams.create(eye)
        P_sweep.render_gbuffer_sweep(grid, cam, cam, cfg)
    # march tiles 16 on 32 voxels; capture tiles 16 (one) on the 16^3
    # field, in fine voxels 32
    assert built == [(32, 32, 16, 16, False), (32, 32, 32, 32, True)]
    assert len(grid.derived) == 2
    assert dataclasses.replace(grid).derived == {}


@pytest.mark.parametrize("renderer", ["sweep", "sweep_pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_render_with_coarse_field_matches_jax(blobs32, dtype, renderer):
    """Off the tiled path a coarse field is dequantized and upsampled
    linearly before the march (F.interpolate against jax.image.resize,
    float32 rounding)."""
    ref, got, both = _render_both(blobs32, True, EYES[0], sweep_dtype=dtype,
                                  renderer=renderer, sweep_tile=-1)
    assert np.sum(ref[..., 3] != got[..., 3]) <= 1
    # float32: the sweep test's 1e-4.  bf16: 5e-3 on AO too (it follows
    # the normal through g . n), but at the flip pixel that
    # `assert_bf16_render_close` names
    if dtype == "float32":
        d = np.abs(ref - got)[both]
        assert d.max() < 1e-4, d.max(0)
    else:
        assert_bf16_render_close(got, ref, both, EYES[0])


# ---------------------------------------------------------------------------
# (f) the rule that picks the tiled march
# ---------------------------------------------------------------------------

def _jax_kernel_calls(monkeypatch, jgrid, cfg):
    """Trace JAX's renderer (all three axis branches) and record which
    march kernel each branch calls, by its (Z, X, Y) volume shape."""
    calls = set()

    def rec(kind, orig):
        def f(vol_zxy, *a, **k):
            calls.add((kind, tuple(vol_zxy.shape)))
            return orig(vol_zxy, *a, **k)
        return f

    monkeypatch.setattr(JT, "march_pallas_tiled",
                        rec("tiled", JT.march_pallas_tiled))
    monkeypatch.setattr(J_flat, "march_pallas",
                        rec("flat", J_flat.march_pallas))
    cam = JCameraParams.create((0.0, 0.2, 1.6))
    jax.make_jaxpr(partial(j_render.__wrapped__, cfg=cfg))(jgrid, cam, cam)
    return calls


@pytest.mark.parametrize("tile", [0, -1])
def test_tiled_rule_matches_jax(monkeypatch, tile):
    """A (512, 16, 16) volume: seen along y or z the slice plane spans
    512 voxels (tiled at sweep_tile=0), along x it is 16 x 16 (flat)."""
    v = np.zeros((512, 16, 16), np.float32)
    v[200:300, 4:12, 4:12] = 1.0
    kw = dict(width=16, height=12, isovalue=0.5, renderer="sweep_pallas",
              sweep_tile=tile)
    calls = _jax_kernel_calls(monkeypatch, j_grid.BrickGrid.from_dense(v),
                              JRenderConfig(**kw))
    auto = "tiled" if tile == 0 else "flat"
    assert calls == {("flat", (512, 16, 16)), (auto, (16, 512, 16))}

    grid = BrickGrid.from_dense(v, device="cpu")
    for eye, shape in (((1.6, 0.1, 0.05), (512, 16, 16)),
                       ((0.1, 1.6, 0.05), (16, 512, 16)),
                       ((0.1, 0.05, 1.6), (16, 512, 16))):
        seen = []
        for name, kind in (("march_tiled", "tiled"), ("march", "flat")):
            orig = getattr(P_sweep, name)
            monkeypatch.setattr(P_sweep, name, lambda vol_zxy, *a, kind=kind,
                                orig=orig, **k: seen.append(
                                    (kind, tuple(vol_zxy.shape)))
                                or orig(vol_zxy, *a, **k))
        cam = CameraParams.create(eye)
        fr = P_sweep.render_gbuffer_sweep(grid, cam, cam, RenderConfig(**kw))
        monkeypatch.undo()
        assert seen == [(auto if shape[1] == 512 else "flat", shape)]
        assert torch.isfinite(fr).all()
