"""The port's sparse packed volumes vs the JAX package: the packing
(`volume/packed.py`), the packed march (B3) and the packed AO capture
(B4p) plain versions vs the Pallas kernels in interpret mode, the whole
packed render, its refusals, three chained fused frames on a packed grid,
and the sparse analytic families."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import Config as JConfig
from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.infer import pipeline as j_pipeline
from isosurfacesuperresolution_tpu.models.generators import create_network
from isosurfacesuperresolution_tpu.render import ao_sweep as J_ao
from isosurfacesuperresolution_tpu.render import sweep_pallas_tiled as JT
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_render)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu.volume import packed as JP
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, initial_state)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)
from isosurfacesuperresolution_tpu_torch.render import sweep as P_sweep
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume import packed as PP
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid

from _torch_port_inputs import (CASES, TILE, TSN, TTN,
                                assert_bf16_render_close,
                                make_packed_ao_field, make_packed_inputs)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(x):
    """A torch or JAX array as numpy (bf16 widened to float32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same_packing(ref, got, ao=False):
    """Atlas, slots (and slice_max) bit for bit, contiguous, same types."""
    assert got.atlas.is_contiguous() and got.slots.is_contiguous()
    assert got.slots.dtype == torch.int32
    assert str(got.atlas.dtype).split(".")[-1] == str(ref.atlas.dtype)
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.tile_shape == tuple(ref.tile_shape)
    np.testing.assert_array_equal(_np(got.atlas), _np(ref.atlas))
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(ref.slots))
    if not ao:
        assert got.slice_max.dtype == torch.float32
        np.testing.assert_array_equal(got.slice_max.numpy(),
                                      np.asarray(ref.slice_max))


# ---------------------------------------------------------------------------
# (a) the packing
# ---------------------------------------------------------------------------

def _sparse48(store):
    """A (Z, X, Y) 48^3 volume with a zero background: two noisy balls,
    and a floor of 5e-4 in one corner (under a tolerance of 1e-3)."""
    rng = np.random.RandomState(7)
    idx = np.indices((48, 48, 48)).astype(np.float32)
    vol = np.zeros((48, 48, 48), np.float32)
    for c, r in (((0.3, 0.4, 0.55), 9.0), ((0.7, 0.6, 0.35), 7.0)):
        d2 = sum((idx[i] - c[i] * 48) ** 2 for i in range(3))
        vol = np.maximum(vol, np.maximum(0.0, 1.0 - d2 / r ** 2))
    vol = (vol * (0.5 + 0.5 * rng.rand(48, 48, 48))).astype(np.float32)
    vol[:8, 32:, 32:] = np.where(vol[:8, 32:, 32:] == 0, 5e-4,
                                 vol[:8, 32:, 32:])
    if store == "uint8":
        return np.round(vol * 255).astype(np.uint8)
    if store == "bfloat16":
        return torch.from_numpy(vol).to(torch.bfloat16)
    return vol


def _both(vol):
    """The same stored array as a torch tensor and a JAX-side numpy one."""
    if isinstance(vol, torch.Tensor):
        return vol, np.asarray(jnp.asarray(vol.float().numpy()).astype(
            jnp.bfloat16))
    return torch.from_numpy(vol), vol


@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "uint8"])
def test_pack_axis_matches_jax(store, tol):
    vol, vol_np = _both(_sparse48(store))
    ref = JP.pack_axis(vol_np, tile=16, tolerance=tol)
    got = PP.pack_axis(vol, tile=16, tolerance=tol)
    _same_packing(ref, got)
    n_tiles = 48 * 3 * 3
    assert 1 < got.atlas.shape[0] - 1 < n_tiles      # sparse, not empty
    dense = _np(got.to_dense_zxy())
    if tol == 0.0 or store == "uint8":       # lossless; uint8 ignores tol
        np.testing.assert_array_equal(dense, _np(vol))
    else:
        # the corner floor is dropped: exact background there, and the
        # error stays within the tolerance (in float32: + 1e-7)
        assert got.atlas.shape[0] < PP.pack_axis(vol, tile=16).atlas.shape[0]
        assert np.abs(dense - _np(vol)).max() <= tol + 1e-7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_ao_axis_matches_jax(dtype):
    """AO tiles whose four channels all lie within 1e-3 of 0 are dropped;
    the atlas is float32 whatever the field's type, as in JAX."""
    field = make_packed_ao_field()                 # (16, 4, 32, 32)
    f, f_np = _both(torch.from_numpy(field).to(getattr(torch, dtype))
                    if dtype == "bfloat16" else field)
    ref = JP.pack_ao_axis(f_np, tile=8)
    got = PP.pack_ao_axis(f, tile=8)
    _same_packing(ref, got, ao=True)
    assert got.atlas.dtype == torch.float32
    slots = got.slots.numpy()
    assert (slots == 0).any() and (slots > 0).any()
    back = got.to_dense_zcxy().numpy()
    assert np.abs(back - _np(f)).max() <= 1e-3 + 1e-7
    assert back[9, :, 24:32, 8:16].max() == 0.0    # the sub-tolerance tile


@pytest.fixture(scope="module")
def torus48_baked():
    """torus_volume(48) in both packages and three baked fields of the
    JAX package's (the bake itself is held in test_torch_port_ao): full
    resolution float32, uint8 per channel, half resolution kept coarse in
    uint8."""
    jgrid = j_analytic.torus_volume(48)
    kw = dict(num_dirs=4, num_steps=4)
    fields = {
        "full f32": J_ao.attach_baked_ao(jgrid, 0.5, 0.2, **kw),
        "full uint8": J_ao.attach_baked_ao(jgrid, 0.5, 0.2,
                                           out_dtype=np.uint8, **kw),
        "coarse uint8": J_ao.attach_baked_ao(jgrid, 0.5, 0.2, downsample=2,
                                             keep_coarse=True,
                                             out_dtype=np.uint8, **kw)}
    grid = analytic.torus_volume(48, device="cpu")
    return jgrid, grid, fields


@pytest.mark.parametrize("field", ["full f32", "full uint8", "coarse uint8"])
def test_from_brick_grid_matches_jax(torus48_baked, field):
    """Every axis order's atlases, AO atlases included (dequantized per
    channel, a coarse field upsampled first), the storage accounting and
    the round trip."""
    jgrid, grid, fields = torus48_baked
    jg = fields[field]
    g = dataclasses.replace(grid, ao_sh=torch.from_numpy(np.array(jg.ao_sh)),
                            ao_scale=jg.ao_scale, ao_offset=jg.ao_offset,
                            ao_downsample=jg.ao_downsample)
    ref = JP.SparseBrickGrid.from_brick_grid(jg, tile=16, tolerance=1e-3,
                                             ao_tile=16)
    got = PP.SparseBrickGrid.from_brick_grid(g, tile=16, tolerance=1e-3,
                                             ao_tile=16)
    assert got.resolution == tuple(ref.resolution) == (48, 48, 48)
    for r, p in zip(ref.per_axis, got.per_axis):
        _same_packing(r, p)
    assert len(got.ao_per_axis) == 3
    for r, p in zip(ref.ao_per_axis, got.ao_per_axis):
        _same_packing(r, p, ao=True)
    assert got.storage_bytes() == ref.storage_bytes()
    assert got.dense_bytes() == ref.dense_bytes()
    assert (got.value_scale, got.value_offset, got.brick_size) == (
        ref.value_scale, ref.value_offset, ref.brick_size)
    assert got.device == torch.device("cpu")
    back, jback = got.to_brick_grid(), ref.to_brick_grid()
    assert isinstance(back, BrickGrid)
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(jback.values))
    np.testing.assert_array_equal(back.ao_sh.numpy(), np.asarray(jback.ao_sh))
    np.testing.assert_array_equal(back.brick_max.numpy(),
                                  np.asarray(jgrid.brick_max))


def test_from_dense_packs_what_brick_grid_packs():
    v = _sparse48("float32")
    got = PP.SparseBrickGrid.from_dense(v, tile=16, tolerance=1e-3,
                                        store_dtype="uint8", device="cpu")
    ref = JP.SparseBrickGrid.from_dense(v, tile=16, tolerance=1e-3,
                                        store_dtype="uint8")
    for r, p in zip(ref.per_axis, got.per_axis):
        _same_packing(r, p)
    assert got.ao_per_axis is None and got.value_scale == ref.value_scale
    assert got.storage_bytes() == ref.storage_bytes()


# ---------------------------------------------------------------------------
# (b) the packed march: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _packed_args(store):
    vol, meta, sg, tg, scale, offset, bmax, iso = make_packed_inputs(store)
    tol = 0.0 if store == "uint8" else 1e-3
    return (vol, JP.pack_axis(vol, tile=TILE, tolerance=tol),
            PP.pack_axis(torch.from_numpy(vol), tile=TILE, tolerance=tol),
            meta, sg, tg, scale, offset, bmax, iso)


@pytest.mark.parametrize("store,mm", CASES)
def test_march_packed_plain_matches_pallas_interpret(store, mm):
    vol, jpa, pa, meta, sg, tg, scale, offset, bmax, iso = _packed_args(store)
    _same_packing(jpa, pa)
    ref = JT.march_pallas_packed(
        jpa, jnp.asarray(meta), jnp.asarray(sg), jnp.asarray(tg), TSN, TTN,
        jnp.asarray(bmax), 8, iso, interpret=True, dtype=jnp.dtype(mm),
        scale=scale, offset=offset)
    ref = [np.asarray(r) for r in ref]
    got = PT.march_packed_plain(pa, *_t(meta, sg, tg), TSN, TTN,
                                torch.from_numpy(bmax), 8, iso,
                                dtype=getattr(torch, mm), scale=scale,
                                offset=offset)
    got = [g.numpy() for g in got]
    # what the inputs exercise: a working slice reads a brick-occupied
    # tile whose slot is 0 (background) on one of its planes, before hits
    zfs = torch.from_numpy(meta[:, 2]).long()
    occ = PT.tile_occupancy(torch.from_numpy(bmax), 8, zfs, iso, 32, 32,
                            TILE, TILE)
    occ, counts, _ = PT.pair_tables(occ, torch.from_numpy(meta))
    rows0, rows1 = PT.slot_rows(pa.slots, zfs)
    bg = occ.flatten(1) & ((rows0 == 0) | (rows1 == 0))
    m_ref = ref[0]
    assert any(bg[k].any() and (m_ref >= k).any()
               for k in range(len(counts)))
    assert (m_ref >= 0).mean() > 0.5
    # the same operands rounded at the same points and two-tap float32
    # sums: hits exact, frac and gradients within float32 rounding (1e-5),
    # B2's bound
    np.testing.assert_array_equal(got[0], m_ref)
    for name, a, b in zip(("frac", "g_s", "g_t", "g_z"), got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("store,mm", CASES)
def test_march_packed_plain_lossless_equals_tiled(store, mm):
    """A lossless packing reads what the dense volume holds: B3's plain
    version gives B2's bit for bit on the same tiles."""
    vol, meta, sg, tg, scale, offset, bmax, iso = make_packed_inputs(store)
    args = _t(meta, sg, tg) + [TSN, TTN, torch.from_numpy(bmax), 8, iso]
    kw = dict(dtype=getattr(torch, mm), scale=scale, offset=offset)
    got = PT.march_packed_plain(PP.pack_axis(torch.from_numpy(vol),
                                             tile=TILE), *args, **kw)
    want = PT.march_tiled_plain(torch.from_numpy(vol), *args, tile=TILE,
                                **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_march_packed_wrapper_runs_plain_on_cpu_without_counting():
    _, _, pa, meta, sg, tg, scale, offset, bmax, iso = _packed_args("uint8")
    args = [pa] + _t(meta, sg, tg) + [TSN, TTN, torch.from_numpy(bmax), 8,
                                      iso]
    before = PT.march_packed_kernel.launches
    got = PT.march_packed(*args, scale=scale, offset=offset)
    want = PT.march_packed_plain(*args, scale=scale, offset=offset)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert PT.march_packed_kernel.launches == before


# ---------------------------------------------------------------------------
# (c) the packed AO capture: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_hits():
    """The JAX packed march's hits on the uint8 inputs (bf16), and the AO
    field packed in both packages (tiles of 8)."""
    _, jpa, _, meta, sg, tg, scale, offset, bmax, iso = _packed_args("uint8")
    m_hit = np.array(JT.march_pallas_packed(
        jpa, jnp.asarray(meta), jnp.asarray(sg), jnp.asarray(tg), TSN, TTN,
        jnp.asarray(bmax), 8, iso, interpret=True, dtype=jnp.bfloat16,
        scale=scale, offset=offset)[0])
    field = make_packed_ao_field()
    return (meta, sg, tg, m_hit, JP.pack_ao_axis(field, tile=8),
            PP.pack_ao_axis(torch.from_numpy(field), tile=8))


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_ao_capture_packed_plain_matches_pallas_interpret(packed_hits, mm):
    meta, sg, tg, m_hit, jpao, pao = packed_hits
    ref = np.asarray(JT.ao_capture_packed(
        jpao, jnp.asarray(meta), jnp.asarray(sg), jnp.asarray(tg), TSN, TTN,
        jnp.asarray(m_hit), interpret=True, dtype=jnp.dtype(mm)))
    got = PT.ao_capture_packed_plain(pao, *_t(meta, sg, tg), TSN, TTN,
                                     torch.from_numpy(m_hit),
                                     dtype=getattr(torch, mm)).numpy()
    hit = m_hit >= 0
    assert hit.mean() > 0.5
    assert (got[:, ~hit] == 0).all() and (ref[:, ~hit] == 0).all()
    # what the inputs exercise: hit pixels whose taps straddle AO tiles of
    # 8, pairs with both slots 0 (skipped) and pairs with one (a zero tile
    # beside a stored one)
    k = m_hit[hit].astype(int)
    zf = meta[k, 2].astype(int)
    lam = meta[k, 1]
    s = np.broadcast_to(sg[:, None], m_hit.shape)[hit]
    t = np.broadcast_to(tg[None, :], m_hit.shape)[hit]
    jx = np.floor(16.0 + lam * (s - 16.0) - 0.5).astype(int)
    jy = np.floor(15.5 + lam * (t - 15.5) - 0.5).astype(int)
    assert ((jx % 8 == 7) | (jy % 8 == 7)).any()
    slots = pao.slots.numpy()
    s0 = slots[zf, np.clip(jx, 0, 31) // 8, np.clip(jy, 0, 31) // 8]
    s1 = slots[zf + 1, np.clip(jx, 0, 31) // 8, np.clip(jy, 0, 31) // 8]
    assert ((s0 == 0) & (s1 == 0)).any() and ((s0 == 0) & (s1 > 0)).any()
    # the same operands rounded at the same points, summed per pair in the
    # same order: float32 within rounding of the two-tap sums (1e-6); in
    # bf16 a sum may round to the neighbouring bf16 value, one step of the
    # term (2^-8 relative): B4's bounds
    np.testing.assert_allclose(got, ref, atol=1e-6,
                               rtol=0 if mm == "float32" else 2.0 ** -8)
    assert (ref[:, hit] != 0).any(1).all()


def test_ao_capture_packed_wrapper_runs_plain_on_cpu_without_counting(
        packed_hits):
    meta, sg, tg, m_hit, _, pao = packed_hits
    args = [pao] + _t(meta, sg, tg) + [TSN, TTN, torch.from_numpy(m_hit)]
    before = PT.ao_capture_packed_kernel.launches
    torch.testing.assert_close(PT.ao_capture_packed(*args),
                               PT.ao_capture_packed_plain(*args), rtol=0,
                               atol=0)
    assert PT.ao_capture_packed_kernel.launches == before


# ---------------------------------------------------------------------------
# (d) the whole packed render, its refusals, and chained fused frames
# ---------------------------------------------------------------------------

EYE = (0.3, 0.9, -1.5)          # the tiled render test's first camera
EYE_PREV = (0.33, 0.88, -1.48)


@pytest.fixture(scope="module")
def blobs32_packed():
    """blobs_volume(32) with the same coarse uint8 field in both packages
    (the JAX bake, handed across), packed with a tolerance of 1e-3 (some
    faint tiles drop), march tiles 16 and AO tiles 8; and without the
    field."""
    jgrid = j_analytic.blobs_volume(32, num_blobs=5)
    jbaked = J_ao.attach_baked_ao(jgrid, 0.5, 0.2, num_dirs=8, num_steps=6,
                                  downsample=2, keep_coarse=True,
                                  out_dtype=np.uint8)
    grid = analytic.blobs_volume(32, num_blobs=5, device="cpu")
    baked = dataclasses.replace(
        grid, ao_sh=torch.from_numpy(np.array(jbaked.ao_sh)),
        ao_scale=jbaked.ao_scale, ao_offset=jbaked.ao_offset,
        ao_downsample=2)
    kw = dict(tile=16, tolerance=1e-3, ao_tile=8)
    out = {}
    for ao, jg, g in ((False, jgrid, grid), (True, jbaked, baked)):
        out[ao] = (JP.SparseBrickGrid.from_brick_grid(jg, **kw),
                   PP.SparseBrickGrid.from_brick_grid(g, **kw))
    return out


@pytest.mark.parametrize("ao", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_render_matches_jax(blobs32_packed, dtype, ao):
    jg, g = blobs32_packed[ao]
    assert any(pa.atlas.shape[0] - 1 < 128 for pa in g.per_axis)
    kw = dict(width=32, height=24, isovalue=0.5, renderer="sweep_pallas",
              sweep_dtype=dtype, sweep_tile=-1)
    if ao:
        kw.update(ao_samples=64, ao_mode="volume")
    calls = []
    orig = P_sweep.march_packed
    try:
        P_sweep.march_packed = lambda *a, **k: calls.append(1) or orig(*a,
                                                                      **k)
        got = P_sweep.render_gbuffer_sweep(
            g, CameraParams.create(EYE), CameraParams.create(EYE_PREV),
            RenderConfig(**kw)).numpy()
    finally:
        P_sweep.march_packed = orig
    # sweep_tile -1 (never tiled for dense grids) still runs B3
    assert calls == [1]
    ref = np.asarray(j_render(jg, JCameraParams.create(EYE),
                              JCameraParams.create(EYE_PREV),
                              JRenderConfig(**kw)))
    assert got.shape == ref.shape == (24, 32, 12) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    both = ref[..., 3] > 0.5
    assert both.sum() > 20
    if ao:
        assert ref[..., 10][both].min() < 0.95       # the field occludes
    # float32: the same sums up to float32 rounding (1e-4, the sweep
    # test's bound); bf16: 5e-3 but at the flip pixel that
    # `assert_bf16_render_close` names for this camera
    if dtype == "float32":
        d = np.abs(ref - got)[both]
        assert d.max() < 1e-4, d.max(0)
    else:
        assert_bf16_render_close(got, ref, both, EYE)


@pytest.mark.parametrize("store", ["float32", "uint8"])
def test_lossless_packed_render_equals_dense_tiled(store):
    """On a lossless packing with the same tiles, the packed render is the
    port's dense tiled render (sweep_tile 16), bit for bit."""
    grid = analytic.blobs_volume(32, num_blobs=5, store_dtype=store,
                                 device="cpu")
    sparse = PP.SparseBrickGrid.from_brick_grid(grid, tile=16)
    cfg = RenderConfig(width=32, height=24, isovalue=0.5, ao_samples=0,
                       renderer="sweep_pallas", sweep_tile=16)
    for eye in (EYE, (1.6, 0.3, 0.2), (0.1, 1.7, 0.3)):   # all three axes
        cam = CameraParams.create(eye)
        got = P_sweep.render_gbuffer_sweep(sparse, cam, cam, cfg)
        want = P_sweep.render_gbuffer_sweep(grid, cam, cam, cfg)
        assert bool((want[..., 3] > 0.5).any())
        torch.testing.assert_close(got, want, rtol=0, atol=0)


REFUSALS = {
    "scan renderer": (dict(renderer="sweep", ao_samples=0), False,
                      "sweep_pallas"),
    "hemisphere-ray AO": (dict(renderer="sweep_pallas", ao_samples=4,
                               ao_mode="auto"), False, "dense"),
    "hemisphere-ray AO beside a field": (
        dict(renderer="sweep_pallas", ao_samples=4, ao_mode="ray"), True,
        "dense"),
    "volume AO without a field": (
        dict(renderer="sweep_pallas", ao_samples=4, ao_mode="volume"), False,
        "before packing"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_packed_render_refuses_what_jax_refuses(blobs32_packed, name):
    kw, ao, match = REFUSALS[name]
    jg, g = blobs32_packed[ao]
    kw = dict(width=16, height=12, isovalue=0.5, **kw)
    with pytest.raises(ValueError, match=match) as jerr:
        j_render(jg, JCameraParams.create(EYE), JCameraParams.create(EYE),
                 JRenderConfig(**kw))
    with pytest.raises(ValueError, match=match) as err:
        P_sweep.render_gbuffer_sweep(g, CameraParams.create(EYE),
                                     CameraParams.create(EYE),
                                     RenderConfig(**kw))
    if "volume AO" not in name:          # the port names its own bake call
        assert str(err.value) == str(jerr.value)


MODEL = dict(num_residual_blocks=2, num_features=16)


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


def test_chained_packed_fused_frames_match_jax():
    """Three chained non-planar fused frames on a packed 48^3 grid with
    its packed AO field (B3 + B4p), float32, against JAX's
    `make_fused_frame` on the same packing."""
    jgrid = J_ao.attach_baked_ao(j_analytic.blobs_volume(48, num_blobs=5),
                                 0.5, 0.2, num_dirs=4, num_steps=4)
    grid = dataclasses.replace(
        analytic.blobs_volume(48, num_blobs=5, device="cpu"),
        ao_sh=torch.from_numpy(np.array(jgrid.ao_sh)))
    kw = dict(tile=16, tolerance=1e-3, ao_tile=16)
    jsparse = JP.SparseBrickGrid.from_brick_grid(jgrid, **kw)
    sparse = PP.SparseBrickGrid.from_brick_grid(grid, **kw)
    render = dict(width=32, height=24, isovalue=0.5, ao_samples=64,
                  ao_mode="volume", renderer="sweep_pallas",
                  sweep_dtype="float32")
    net = EnhanceNet(ModelConfig(**MODEL))
    tree = _flax_tree(net)
    net.load_state_dict(params_from_flax(tree))
    net.eval()
    cfg, rcfg = Config(model=ModelConfig(**MODEL)), RenderConfig(**render)
    jcfg = JConfig(model=JModelConfig(**MODEL))
    jrcfg = JRenderConfig(**render)
    jparams = {"params": {k: {kk: jnp.asarray(v) for kk, v in d.items()}
                          for k, d in tree["params"].items()}}
    jfused = j_pipeline.make_fused_frame(create_network(jcfg.model), jcfg,
                                         jrcfg, donate=False, planar="off")
    jstate = j_pipeline.initial_state(jcfg, jrcfg, planar="off")
    frame = FusedFrame(net, cfg, rcfg, planar="off", device="cpu")
    state = initial_state(cfg, rcfg, planar="off", device="cpu")
    eyes = [(0.2, 0.6, -1.0), (0.2, 0.6, -1.0), (0.24, 0.59, -0.99),
            (0.28, 0.58, -0.98)]                  # first frame: prev = itself
    for i in range(1, 4):
        cur, prev = eyes[i], eyes[i - 1]
        jrgb, jfr, jstate = jfused(jparams, jsparse,
                                   JCameraParams.create(cur),
                                   JCameraParams.create(prev), jstate)
        rgb, fr, state = frame(sparse, CameraParams.create(cur),
                               CameraParams.create(prev), state)
        jfr, jrgb = np.asarray(jfr), np.asarray(jrgb)
        assert rgb.shape == jrgb.shape == (96, 128, 3)
        # the bounds of test_torch_port_frame's chained frames: the
        # G-buffers to float32 rounding of the sweep (1e-4), the state 5e-4
        # (normalizing the network's short normals amplifies its ~1e-6
        # differences), the RGB 1e-4
        np.testing.assert_array_equal(fr[..., 3].numpy(), jfr[..., 3])
        assert jfr[..., 3].mean() > 0.05
        assert jfr[..., 10][jfr[..., 3] > 0.5].min() < 0.95
        np.testing.assert_allclose(fr.numpy(), jfr, atol=1e-4, rtol=0)
        np.testing.assert_allclose(state.prev_high.numpy(),
                                   np.asarray(jstate.prev_high), atol=5e-4,
                                   rtol=0)
        np.testing.assert_allclose(rgb.numpy(), jrgb, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# (e) the sparse analytic families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["torus", "gyroid", "turbulence", "ejecta",
                                    "interface", "skull", "thorax"])
def test_analytic_family_matches_jax(family):
    ref = getattr(j_analytic, f"{family}_volume")(32)
    got = getattr(analytic, f"{family}_volume")(32, device="cpu")
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.brick_max.numpy(),
                                  np.asarray(ref.brick_max))
    np.testing.assert_array_equal(got.bbox_max.numpy(),
                                  np.asarray(ref.bbox_max))
    # a background that a packing tolerance of 1e-3 drops (ejecta's
    # Gaussian tails never reach 0 at 32^3)
    assert (got.values.numpy() < 1e-3).any()
    u8 = getattr(analytic, f"{family}_volume")(32, store_dtype="uint8",
                                               device="cpu")
    assert u8.values.dtype == torch.uint8
