"""The port's march oracle and hemisphere-ray AO vs the JAX package's
`render/raycast.py`: the grid's samplers, the AO tables (bit for bit),
the march's parts, whole march-rendered G-buffers and the sweep with
``ao_mode="ray"``.

Tolerances.  The samplers, the tables, the box range, a march from given
rays and AO from given hits run the same float32 operations in the same
order as XLA on the CPU: equal.  XLA sums a vector norm's squares with
fused multiply-adds: normals are one ulp apart (2e-7).  Pixel rays come
from a 3x3 product that XLA sums with fused multiply-adds and this port
does not (one ulp in ~1% of the components, measured); a one-ulp ray moves a refined hit by <= 1e-5 of
a voxel and a normal or shading channel by <= 3e-5 (measured 2e-5), so
G-buffers are held to 1e-4 on pixels both hit, and a grazing ray may
flip hit or miss: at most 1% of the pixels (measured 0).  An AO ray that
flips moves its pixel's AO by 1/samples: AO is held to 1/samples + 1e-4
and the flips to 2% of the hits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.render import raycast as J
from isosurfacesuperresolution_tpu.render.api import (
    render_frame_gbuffer as j_frame)
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams, random_sphere_camera as j_sphere_cam)
from isosurfacesuperresolution_tpu.render.sweep import (
    render_gbuffer_sweep as j_sweep)
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu.volume import grid as JG
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import raycast as P
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, random_sphere_camera)
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume import grid as PG

EYES = ((0.0, 1.2, -0.25), (1.6, 0.5, -0.4), (-0.9, -0.9, 0.9))
MAX_DIFF = 1e-4
MAX_FLIPS = 0.01
# the march with ray AO; one config, and JAX's `render_gbuffer` called
# as its `render_frame_gbuffer` calls it (``rp`` given), so that both
# tests share one compile
RAY_AO = dict(width=32, height=24, isovalue=0.5, ao_samples=8,
              ao_radius=0.2, step_voxels=0.5, renderer="march")


def _grids(store="float32", n=32):
    rng = np.random.RandomState(3)
    v = (rng.rand(n, n - 2, n - 5) * 0.3).astype(np.float32)
    v[8:20, 6:18, 5:16] += 0.6
    return (JG.BrickGrid.from_dense(v, store_dtype=store),
            PG.BrickGrid.from_dense(v, store_dtype=store, device="cpu"))


@pytest.fixture(scope="module")
def tori():
    return j_analytic.torus_volume(32), analytic.torus_volume(32,
                                                               device="cpu")


@pytest.mark.parametrize("store", ["float32", "uint8", "bfloat16"])
def test_samplers_match_jax(store):
    jg, pg = _grids(store)
    vox = (np.random.RandomState(1).rand(4000, 3) * 36 - 3).astype(
        np.float32)                     # almost half of them outside
    jv, pv = jnp.asarray(vox), torch.from_numpy(vox)
    for name in ("sample_trilinear", "sample_nearest", "brick_max_at"):
        np.testing.assert_array_equal(getattr(pg, name)(pv).numpy(),
                                      np.asarray(getattr(jg, name)(jv)))
    got = PG.sample_trilinear(pg.values, pv, pg.value_scale,
                              pg.value_offset).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.sample_trilinear(
        jg.values, jv, scale=jg.value_scale, offset=jg.value_offset)))
    assert (got == 0).mean() > 0.2 and (got > 0).mean() > 0.4


class _CrossDeviceCopies(TorchDispatchMode):
    """Records the ops that copy a tensor from the host to another device
    (dispatched ops with host inputs and outputs elsewhere)."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {a.device.type for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, torch.Tensor) and a.dim() > 0}
        outs = {o.device.type for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)}
        if "cpu" in ins and outs - {"cpu"}:
            self.copies.append(str(func))
        return out


def _record_host_data(monkeypatch, copies):
    """Record ``torch.tensor`` / ``torch.as_tensor`` calls that put host
    data on another device (they bypass dispatch modes)."""
    for name in ("tensor", "as_tensor"):
        fn = getattr(torch, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            if out.device.type != "cpu":
                copies.append(f"torch.{_name}")
            return out

        monkeypatch.setattr(torch, name, wrapped)


def test_march_step_copies_nothing_from_the_host(monkeypatch):
    """A lattice step of the march (brick max, sample, skip) on a grid
    that is not on the host copies nothing from the host: the brick
    pyramid's shape enters as host ints."""
    _, pg = _grids()
    grid = dataclasses.replace(pg, values=pg.values.to("meta"),
                               brick_max=pg.brick_max.to("meta"))
    n = 64
    st = {k: torch.empty(s, device="meta") for k, s in (
        ("o", (n, 3)), ("d", (n, 3)), ("inv", (n, 3)), ("pos", (n, 3)),
        ("t", (n,)), ("t1", (n,)), ("t_hit", (n,)))}
    st["alive"] = torch.empty(n, dtype=torch.bool, device="meta")
    st["hit"] = torch.empty(n, dtype=torch.bool, device="meta")
    copies = []
    _record_host_data(monkeypatch, copies)
    with _CrossDeviceCopies() as mode:
        P._march_chunk(grid, st, 0.5, 0.25, 4)
        grid.brick_max_at(st["o"])
        grid.sample_nearest(st["o"])
    assert copies == [] and mode.copies == []
    # the checks see both kinds of copy
    with _CrossDeviceCopies() as mode:
        torch.tensor(grid.brick_max.shape, device="meta")
        torch.ones(3).to("meta")
    assert copies == ["torch.tensor"]
    assert mode.copies == ["aten._to_copy.default"]


@pytest.mark.parametrize("num_samples,rotations",
                         [(8, 4), (32, 4), (256, 4), (17, 3), (1, 1)])
def test_ao_tables_match_jax_bit_for_bit(num_samples, rotations):
    hemi, rot = P.ao_tables(num_samples, rotations)
    j_hemi, j_rot = J.ao_tables(num_samples, rotations)
    assert hemi.dtype == rot.dtype == np.float32
    np.testing.assert_array_equal(hemi.view(np.uint32),
                                  np.asarray(j_hemi).view(np.uint32))
    np.testing.assert_array_equal(rot.view(np.uint32),
                                  np.asarray(j_rot, np.float32).view(
                                      np.uint32))
    assert (hemi[:, 2] >= 0).all()


def _rays(shared: bool, n=400, seed=0):
    """Origins (n, 3), or one (3,) when ``shared``, and normalized
    directions: half of them aimed into the dense block, a few along
    the axes."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 60 - 15).astype(np.float32)
    if shared:
        o = o[7]
    target = (rng.rand(n, 3) * 24 + 4).astype(np.float32)
    target[::2] = rng.rand(n // 2, 3) * 10 + (9, 7, 6)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:5] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1]]
    return o, d.astype(np.float32)


def test_ray_box_range_matches_jax():
    for shared in (False, True):
        o, d = _rays(shared)
        got = P._ray_box_range(torch.from_numpy(o), torch.from_numpy(d),
                               (32, 30, 27))
        want = J._ray_box_range(jnp.asarray(o), jnp.asarray(d),
                                (32, 30, 27))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["refined", "lattice", "step_cap"])
def test_march_rays_matches_jax(case):
    """Hits and distances equal to JAX's from the same rays: refined by
    10 halvings, the raw lattice hit (AO rays), and a cap of 41 steps,
    which the loop runs as (41 // 4 + 1) * 4 = 44 (rays still alive then
    miss: about a fifth of the hits)."""
    jg, pg = _grids()
    bs = 10 if case == "refined" else 0
    max_steps = 41 if case == "step_cap" else 4096
    # primary rays share their origin, AO rays do not
    for shared in (case == "refined",):
        o, d = _rays(shared)
        want_hit, want_t = J.march_rays(jg, jnp.asarray(o), jnp.asarray(d),
                                        0.5, 0.25, max_steps,
                                        binary_search_steps=bs)
        hit, t = P.march_rays(pg, torch.from_numpy(o), torch.from_numpy(d),
                              0.5, 0.25, max_steps, binary_search_steps=bs)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
        np.testing.assert_array_equal(t.numpy(), np.asarray(want_t))
        assert 0.3 < hit.float().mean() < 0.9
        if case == "step_cap":
            full, _ = P.march_rays(pg, torch.from_numpy(o),
                                   torch.from_numpy(d), 0.5, 0.25, 4096,
                                   binary_search_steps=0)
            assert (full & ~hit).any()   # the cap turned hits into misses


def test_gradient_normal_matches_jax():
    jg, pg = _grids()
    vox = (np.random.RandomState(2).rand(3000, 3) * 30).astype(np.float32)
    got = P.gradient_normal(pg, torch.from_numpy(vox)).numpy()
    want = np.asarray(J.gradient_normal(jg, jnp.asarray(vox)))
    # equal samples; XLA sums the norm's squares as fused multiply-adds,
    # the port rounds each square: one ulp of the norm
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
    assert (got == 0).all(-1).any()            # flat regions: no normal


def test_compute_ao_matches_jax():
    jg, pg = _grids()
    rng = np.random.RandomState(4)
    n = 300
    pos = (rng.rand(n, 3) * 20 + 4).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[:3] = [[1, 0, 0], [0, 1, 0], [-1, 0, 0]]   # parallel to a rotation
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mask = rng.rand(n) < 0.8
    pix = rng.randint(0, 40, size=(n, 2)).astype(np.int32)
    kw = dict(isovalue=0.5, step_voxels=0.5, ao_samples=8, ao_radius=0.2,
              ao_ray_steps=64)
    want = np.asarray(J.compute_ao(
        jg, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(dirs),
        jnp.asarray(mask), jnp.asarray(pix), JRenderConfig(**kw),
        jg.voxel_size[0]))
    got = P.compute_ao(pg, *[torch.from_numpy(a) for a in
                             (pos, nrm, dirs, mask, pix)],
                       RenderConfig(**kw), float(pg.voxel_size[0])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == 1).all() and (got[mask] < 1).mean() > 0.3


def _check_frames(got, ref, samples=0):
    flips = (got[..., 3] != ref[..., 3]).mean()
    assert flips <= MAX_FLIPS, flips
    both = (got[..., 3] > 0.5) & (ref[..., 3] > 0.5)
    assert both.sum() > 50
    d = np.abs(got - ref)[both]
    ch = [c for c in range(12) if c != 10]
    assert d[:, ch].max() < MAX_DIFF, d.max(0)
    if samples:
        ao_d = d[:, 10]
        assert (ao_d > MAX_DIFF).mean() <= 0.02, (ao_d > MAX_DIFF).mean()
        assert ao_d.max() < 1.0 / samples + MAX_DIFF, ao_d.max()
        assert (ref[..., 10][both] < 1).mean() > 0.02
    else:
        assert (got[..., 10] == 1).all()


@pytest.mark.parametrize("variant", ["plain", "viewport", "ray_ao"])
def test_render_gbuffer_matches_jax(tori, variant):
    jg, pg = tori
    kw = dict(width=32, height=24, isovalue=0.5)
    if variant == "viewport":
        kw["viewport"] = (4, 6, 25, 20)
    if variant == "ray_ao":
        kw = RAY_AO
    for eye in EYES:
        jcam, cam = JCameraParams.create(eye), CameraParams.create(eye)
        jprev = JCameraParams.create((eye[0] + 0.05, eye[1], eye[2]))
        prev = CameraParams.create((eye[0] + 0.05, eye[1], eye[2]))
        ref = np.asarray(J.render_gbuffer(jg, jcam, jprev,
                                          JRenderConfig(**kw), None))
        got = P.render_gbuffer(pg, cam, prev, RenderConfig(**kw)).numpy()
        _check_frames(got, ref, kw.get("ao_samples", 0))
        if variant == "viewport":
            assert not got[:6, :, 3].any() and not got[:, 25:, 3].any()


def test_render_frame_gbuffer_march_matches_jax(tori):
    jg, pg = tori
    eye = (0.4, 1.1, -1.3)
    ref = np.asarray(j_frame(jg, JCameraParams.create(eye),
                             JCameraParams.create(eye),
                             JRenderConfig(**RAY_AO)))
    got = render_frame_gbuffer(pg, CameraParams.create(eye),
                               CameraParams.create(eye),
                               RenderConfig(**RAY_AO)).numpy()
    _check_frames(got, ref, RAY_AO["ao_samples"])
    with pytest.raises(ValueError, match="unknown renderer"):
        render_frame_gbuffer(pg, CameraParams.create(eye),
                             CameraParams.create(eye),
                             RenderConfig(renderer="raytrace"))


@pytest.mark.parametrize("tile", [-1, 16])
def test_sweep_ray_ao_matches_jax(tori, monkeypatch, tile):
    """``ao_mode="ray"`` on the flat march's plain version (B1's) and on
    the tiled march's (B2's, forced by ``sweep_tile=16``), then
    hemisphere rays from the intermediate grid's hits (on the scan:
    `test_torch_port_ao.py::test_ao_mode_rules`)."""
    from isosurfacesuperresolution_tpu_torch.render import sweep as P_sweep
    calls = []
    tiled = P_sweep.march_tiled
    monkeypatch.setattr(P_sweep, "march_tiled",
                        lambda *a, **k: calls.append(1) or tiled(*a, **k))
    jg, pg = tori
    kw = dict(width=24, height=20, isovalue=0.5, ao_samples=8,
              ao_radius=0.2, ao_mode="ray", renderer="sweep_pallas",
              sweep_tile=tile)
    eye = EYES[0]
    jcam, cam = JCameraParams.create(eye), CameraParams.create(eye)
    ref = np.asarray(j_sweep(jg, jcam, jcam, JRenderConfig(**kw)))
    got = render_gbuffer_sweep(pg, cam, cam, RenderConfig(**kw)).numpy()
    assert calls == ([1] if tile > 0 else [])
    _check_frames(got, ref, 8)


def test_pixel_rays_and_random_sphere_camera_match_jax():
    for eye in EYES:
        _, got = CameraParams.create(eye).pixel_rays(37, 23)
        _, want = JCameraParams.create(eye).pixel_rays(37, 23)
        assert got.shape == (23, 37, 3)
        # XLA sums the 3x3 rotation with fused multiply-adds: one ulp
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2.5e-7, rtol=0)
    for seed in range(4):
        a = random_sphere_camera(np.random.RandomState(seed))
        b = j_sphere_cam(np.random.RandomState(seed))
        for name in ("eye", "look_at_pt", "up"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)))
