"""Numpy-seeded march inputs shared by the port's CPU and card tests
(no JAX import, so the card tests run where JAX is not installed)."""

import numpy as np

Z, X, Y = 6, 12, 11
SN, TN = 10, 8


def make_inputs(store: str, seed: int = 0):
    """A smooth field plus noise, one skipped slice, grids that overhang
    the volume, and an isovalue that puts crossings on the image border."""
    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                          indexing="ij")
    field = (0.15 * z + 0.04 * x + 0.02 * y
             + 0.05 * rng.rand(X, Y, Z)).astype(np.float32)
    vol = np.ascontiguousarray(np.transpose(field, (2, 0, 1)))  # (Z, X, Y)
    scale, offset = 1.0, 0.0
    if store == "uint8":
        scale, offset = float(field.max()) / 255.0, 0.01
        vol = np.clip(np.round(vol / scale), 0, 255).astype(np.uint8)
    K = 2 * Z
    zc = (np.arange(K) + 0.5) / 2.0
    lam = 0.8 + 0.05 * np.arange(K)
    zf = np.clip(np.floor(zc - 0.5), 0, Z - 2)
    fz = np.clip(zc - 0.5 - zf, 0.0, 1.0)
    flag = np.ones(K)
    flag[3] = 0.0                                  # a culled slice
    iso = 0.55
    meta = np.stack([zc, lam, zf, fz, flag, np.full(K, iso),
                     np.full(K, 6.0), np.full(K, 5.5)], 1).astype(np.float32)
    s_grid = np.linspace(1.0, X - 0.2, SN).astype(np.float32)
    t_grid = np.linspace(0.3, Y + 0.6, TN).astype(np.float32)
    return vol, meta, s_grid, t_grid, scale, offset


CASES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("uint8", "float32"), ("uint8", "bfloat16")]


def make_ao_field(quantize: bool = False, seed: int = 1):
    """A smooth (Z, 4, X, Y) SH-like field for the march inputs above:
    float32, or uint8 with per-channel scale and offset (4-tuples) when
    ``quantize``; returns (field, physical float32 field, scale, offset)."""
    rng = np.random.RandomState(seed)
    z, x, y = np.meshgrid(np.arange(Z), np.arange(X), np.arange(Y),
                          indexing="ij")
    chans = [0.3 + 0.02 * x + 0.01 * z, 0.1 * np.sin(0.5 * y),
             0.05 * np.cos(0.3 * x + 0.2 * z), -0.04 + 0.01 * y]
    field = np.stack(chans, 1) + 0.01 * rng.rand(Z, 4, X, Y)
    field = field.astype(np.float32)
    if not quantize:
        return field, field, 1.0, 0.0
    lo = field.min(axis=(0, 2, 3))
    scale = np.maximum((field.max(axis=(0, 2, 3)) - lo) / 255.0, 1e-8)
    q = np.clip(np.round((field - lo[:, None, None])
                         / scale[:, None, None]), 0, 255).astype(np.uint8)
    phys = (q.astype(np.float32) * scale.astype(np.float32)[:, None, None]
            + lo.astype(np.float32)[:, None, None])
    return q, phys, tuple(float(s) for s in scale), tuple(float(v) for v in lo)


# the tiled march's inputs: a (Z, X, Y) volume cut into 2 x 2 tiles of 16
TZ, TXY, TSN, TTN = 16, 32, 20, 18
TILE = 16


def make_tiled_inputs(store: str, seed: int = 0):
    """Inputs of the tiled march: a field rising along z with a bump in
    the slice plane, and noise; a brick pyramid (bricks of 8, the march's axis order) made
    from it with two cuts: no brick of the lower z layer reaches the
    isovalue (the slices there have no occupied tile: Fm1 resets just
    before the first crossings), and the x-tile 1 / y-tile 0 bricks of the
    upper layer never do (taps of a culled tile beside occupied ones); one
    slice is skipped by its do-flag.  Returns
    (vol, meta, s_grid, t_grid, scale, offset, brick_max_p, iso)."""
    from isosurfacesuperresolution_tpu_torch.volume.grid import (
        compute_brick_minmax)
    rng = np.random.RandomState(seed)
    z, x, y = np.meshgrid(np.arange(TZ), np.arange(TXY), np.arange(TXY),
                          indexing="ij")
    vol = (0.1 * z + 0.2 * np.exp(-((x - 10) ** 2 + (y - 20) ** 2) / 60.0)
           + 0.03 * rng.rand(TZ, TXY, TXY)).astype(np.float32)
    scale, offset = 1.0, 0.0
    phys = vol
    if store == "uint8":
        scale, offset = float(vol.max()) / 255.0, 0.01
        vol = np.clip(np.round((vol - offset) / scale), 0, 255).astype(
            np.uint8)
        phys = vol.astype(np.float32) * np.float32(scale) + np.float32(
            offset)
    _, bmax = compute_brick_minmax(np.transpose(phys, (1, 2, 0)), 8)
    bmax[:, :, 0] = 0.0
    bmax[2:4, 0:2, 1] = 0.0
    K = 2 * TZ
    zc = (np.arange(K) + 0.5) / 2.0
    lam = 0.8 + 0.005 * np.arange(K)
    zf = np.clip(np.floor(zc - 0.5), 0, TZ - 2)
    fz = np.clip(zc - 0.5 - zf, 0.0, 1.0)
    flag = np.ones(K)
    flag[24] = 0.0                                 # a culled slice
    iso = 0.9
    meta = np.stack([zc, lam, zf, fz, flag, np.full(K, iso),
                     np.full(K, 16.0), np.full(K, 15.5)], 1).astype(np.float32)
    s_grid = np.linspace(0.5, TXY - 0.5, TSN).astype(np.float32)
    t_grid = np.linspace(0.3, TXY - 0.3, TTN).astype(np.float32)
    return vol, meta, s_grid, t_grid, scale, offset, bmax, iso


def make_tiled_ao_field(fd: int = 1, quantize: bool = False, seed: int = 2):
    """A smooth (Z', 4, X', Y') SH-like field for the tiled inputs, at
    1/fd of their resolution: float32, or uint8 with per-channel scale
    and offset (4-tuples); returns (field, scale, offset)."""
    rng = np.random.RandomState(seed)
    n, m = TZ // fd, TXY // fd
    z, x, y = np.meshgrid(np.arange(n) * fd, np.arange(m) * fd,
                          np.arange(m) * fd, indexing="ij")
    chans = [0.2 + 0.01 * x + 0.02 * z, 0.1 * np.sin(0.4 * y),
             0.05 * np.cos(0.3 * x + 0.2 * z), -0.04 + 0.005 * y]
    field = (np.stack(chans, 1) + 0.01 * rng.rand(n, 4, m, m)).astype(
        np.float32)
    if not quantize:
        return field, 1.0, 0.0
    lo = field.min(axis=(0, 2, 3))
    sc = np.maximum((field.max(axis=(0, 2, 3)) - lo) / 255.0, 1e-8)
    q = np.clip(np.round((field - lo[:, None, None]) / sc[:, None, None]),
                0, 255).astype(np.uint8)
    return q, tuple(float(v) for v in sc), tuple(float(v) for v in lo)


# ---------------------------------------------------------------------------
# The bf16 bound of whole renders against the JAX package
# ---------------------------------------------------------------------------

BF16_TOL = 5e-3    # one bf16 rounding flip of a gradient operand
# Pixels of a 32x24 render of blobs_volume(32, num_blobs=5) at iso 0.5
# where the two packages round one bf16 weight differently, by camera eye.
# At (0.3, 0.9, -1.5): XLA's CPU backend fuses the host geometry's
# multiply-adds (t_grid, then y = eye_t + lam * (t - eye_t)) into FMAs and
# PyTorch rounds each product and sum, so slice 33's y position at t = 26
# is 20.9433651 in JAX and 20.9433575 here (4 ulps); its tap weight
# 0.55663 lies on a bf16 rounding boundary (0.556640625) and rounds to
# 0.5547 in JAX and 0.5586 here.  That slice's F moves frac, g_z and,
# through a neighbour's Fm1, g_t of three intermediate pixels, and the
# normal of output pixel (9, 14) by 7.5e-3, on the scan, the flat kernel
# and the tiled kernel alike.  (JAX's own kernel and scan differ by up to
# 1.9e-2 there, at 8 pixels above 5e-3.)
BF16_FLIP_PIXELS = {(0.3, 0.9, -1.5): ((9, 14),)}
BF16_FLIP_TOL = 1e-2


def assert_bf16_render_close(got, ref, both, eye) -> None:
    """|got - ref| < BF16_TOL on every common hit of two (H, W, C)
    renders, except at the named flip pixels of camera ``eye``, where the
    flip itself is allowed (< BF16_FLIP_TOL)."""
    d = np.abs(np.asarray(got) - np.asarray(ref)) * both[..., None]
    for i, j in BF16_FLIP_PIXELS.get(tuple(eye), ()):
        assert d[i, j].max() < BF16_FLIP_TOL, (i, j, d[i, j])
        d[i, j] = 0.0
    assert d.max() < BF16_TOL, d.reshape(-1, d.shape[-1]).max(0)


# ---------------------------------------------------------------------------
# Packed storage: the tiled inputs with background tiles
# ---------------------------------------------------------------------------

def make_packed_inputs(store: str, seed: int = 0):
    """`make_tiled_inputs` with background tiles (stored 0) in the volume:
    x-tile 1 / y-tile 0 on every plane (a tile the bricks cull as well),
    x-tile 0 / y-tile 0 on planes 9 and 10 (tiles the bricks, made from
    the volume before, keep: they read background), and, in float
    storage, x-tile 1 / y-tile 1 of plane 13 set to 5e-4 (dropped by a
    packing tolerance of 1e-3).  Same return as `make_tiled_inputs`."""
    vol, meta, sg, tg, scale, offset, bmax, iso = make_tiled_inputs(store,
                                                                    seed)
    vol = vol.copy()
    vol[:, TILE:, :TILE] = 0
    vol[9:11, :TILE, :TILE] = 0
    if store != "uint8":
        vol[13, TILE:, TILE:] = 5e-4
    return vol, meta, sg, tg, scale, offset, bmax, iso


def make_packed_ao_field(seed: int = 2):
    """`make_tiled_ao_field` (float32) with zero tiles of 8: x-tile 0 on
    every plane, y-tile 2 on planes up to 8 (beside hits whose lower
    plane is 8), and x-tile 3 / y-tile 1 of plane 9 at 2e-4 (dropped by
    the packing tolerance of 1e-3)."""
    field, _, _ = make_tiled_ao_field(1, seed=seed)
    field = field.copy()
    field[:, :, :8] = 0.0
    field[:9, :, :, 16:24] = 0.0
    field[9, :, 24:32, 8:16] = 2e-4
    return field


# ---------------------------------------------------------------------------
# Inputs that span many blocks of the march kernel (8 x 32 pixels a block)
# ---------------------------------------------------------------------------

BZ, BX, BY = 34, 40, 42    # rows of 42 / 84 / 168 bytes: not multiples of 16
BSN, BTN = 27, 75          # 4 x 3 blocks, the last row and column ragged
BTILE = 8                  # tiles of (8, 7): 5 x 6 a plane
BEYE = (17.3, 23.6)        # the eye's (s, t), inside the volume


def make_block_inputs(store: str, seed: int = 0):
    """Inputs of the marches at many blocks: a field rising slowly along z
    with a bump and a ripple in the slice plane, and noise; grids whose
    spacing runs from 0.35 to 2.9 voxels (s rising, t falling) around an
    eye inside the volume, overhanging it; K = 68 slices, more than one
    chunk of the kernel's tap tables; lam = 0.05 (k - 12), from -0.6 to
    2.75 (0 on slice 12: every pixel on one voxel; beyond 1.5 a block's
    taps span more voxels than the block has pixels, and at the far
    slices whole blocks see only the volume's outside); slices 0 and 2
    skipped as behind the eye (slice 1, at -0.55, is not: its taps run
    backwards) and slice 9 by its do-flag.  A brick pyramid (bricks of 8)
    culls the x tiles 3 and 4 on every plane and the y tiles below 16 on
    the lowest brick layer; background tiles (stored 0): x-tile 0 /
    y-tile 5 on every plane, x-tile 2 / y-tile 1 on planes 4 and 5.
    Same return as `make_tiled_inputs`."""
    from isosurfacesuperresolution_tpu_torch.volume.grid import (
        compute_brick_minmax)
    rng = np.random.RandomState(seed)
    z, x, y = np.meshgrid(np.arange(BZ), np.arange(BX), np.arange(BY),
                          indexing="ij")
    vol = (0.02 * z + 0.25 * np.exp(-((x - 14) ** 2 + (y - 28) ** 2) / 90.0)
           + 0.1 * np.sin(0.7 * x) * np.cos(0.5 * y)
           + 0.03 * rng.rand(BZ, BX, BY)).astype(np.float32)
    vol[:, :8, 35:] = 0.0
    vol[4:6, 16:24, 7:14] = 0.0
    scale, offset = 1.0, 0.0
    phys = vol
    if store == "uint8":
        scale = float(vol.max()) / 255.0
        vol = np.clip(np.round(vol / scale), 0, 255).astype(np.uint8)
        phys = vol.astype(np.float32) * np.float32(scale)
    _, bmax = compute_brick_minmax(np.transpose(phys, (1, 2, 0)), 8)
    bmax[3:5] = 0.0
    bmax[:, 0:2, 0] = 0.0
    K = 2 * BZ
    zc = (np.arange(K) + 0.5) / 2.0
    lam = 0.05 * (np.arange(K) - 12)
    zf = np.clip(np.floor(zc - 0.5), 0, BZ - 2)
    fz = np.clip(zc - 0.5 - zf, 0.0, 1.0)
    flag = np.ones(K)
    flag[[0, 2, 9]] = 0.0
    iso = 0.55
    meta = np.stack([zc, lam, zf, fz, flag, np.full(K, iso),
                     np.full(K, BEYE[0]), np.full(K, BEYE[1])],
                    1).astype(np.float32)
    u = np.linspace(-13.0, 13.0, BSN)
    v = np.linspace(-37.0, 37.0, BTN)
    s_grid = (BEYE[0] + 0.9 * u + 0.004 * u ** 3).astype(np.float32)
    t_grid = (BEYE[1] - 0.35 * v - 0.0003 * v ** 3).astype(np.float32)
    return vol, meta, s_grid, t_grid, scale, offset, bmax, iso


def make_block_ao_field(seed: int = 3):
    """A smooth (BZ, 4, BX, BY) float32 SH-like field for the block
    inputs."""
    rng = np.random.RandomState(seed)
    z, x, y = np.meshgrid(np.arange(BZ), np.arange(BX), np.arange(BY),
                          indexing="ij")
    chans = [0.3 + 0.01 * x + 0.02 * z, 0.1 * np.sin(0.3 * y),
             0.05 * np.cos(0.2 * x + 0.3 * z), -0.03 + 0.004 * y]
    return (np.stack(chans, 1)
            + 0.01 * rng.rand(BZ, 4, BX, BY)).astype(np.float32)


# ---------------------------------------------------------------------------
# AO capture images: hit patterns over several blocks of the capture kernel
# (kCapThreads pixels a block, in csrc/sweep_march.cu)
# ---------------------------------------------------------------------------

HSN, HTN = 40, 30          # 1200 pixels: three blocks of 512, the last ragged


def make_hit_grids():
    """(s_grid, t_grid) float32 over the tiled inputs' 32 x 32 slice
    plane, overhanging it (the slices' lam of 0.8-0.96 draws them in) so
    that taps fall outside the volume; t runs backwards."""
    s = np.linspace(-5.3, 37.6, HSN).astype(np.float32)
    t = np.linspace(38.4, -4.9, HTN).astype(np.float32)
    return s, t


def make_hit_pattern(kind: str, K: int, seed: int = 0) -> np.ndarray:
    """An (HSN, HTN) float32 m_hit: "none" (no pixel hits), "all" (every
    pixel, on random slices, slice K - 1 and slice 24 among them), or
    "mixed" (a disk of hits dense enough that a block holds more than its
    warps take at a time, with scattered hits and misses)."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, K, size=(HSN, HTN)).astype(np.float32)
    k[::7, ::5] = K - 1
    k[3, 4] = 24.0
    if kind == "none":
        return np.full((HSN, HTN), -1.0, dtype=np.float32)
    if kind == "all":
        return k
    s, t = np.meshgrid(np.arange(HSN), np.arange(HTN), indexing="ij")
    disk = (s - 18) ** 2 + (t - 14) ** 2 < 120
    keep = disk | (rng.rand(HSN, HTN) < 0.1)
    return np.where(keep, k, -1.0).astype(np.float32)
