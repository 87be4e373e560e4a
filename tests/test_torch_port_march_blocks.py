"""The march kernel's block decomposition (``csrc/sweep_march.cu``),
emulated in torch on the CPU and held bit for bit against the plain
versions of B1, B2 and B3 (`march_plain`, `march_tiled_plain`,
`march_packed_plain`), at several block shapes, on inputs whose blocks'
footprints run from one voxel to wider than the block, backwards, and
out of the volume.

The rule, per block of BS pixel rows x BT pixel columns and per working
slice: the block lists its row taps once, two a pixel row (jx0, jx0 + 1,
with their rounded tent weights; outside the volume marked), and each
pixel finds its column's two; each pixel reads its four voxels of planes
zf and zf + 1, formed as rnd(((1 - fz) v0 + fz v1) * scale + offset), 0
outside the volume and in an unoccupied tile (a tap the plain versions
skip: the +0 it adds leaves a sum that starts at +0 as it was); pass 1
makes each column tap's tmp = rnd(wx0 sl0 + wx1 sl1) over the pixel
row's taps, pass 2 F = tmp0 wy0 + tmp1 wy1, each sum starting at +0.
Emulated for the whole block at once: its row taps x column taps, pass
1 over all of them.  The inputs (K = 68) cross the kernel's chunks of
tap tables.  bf16 resampling keeps every product exact, so the plain
versions' dense products give the same bits.
"""

import pytest
import torch

from isosurfacesuperresolution_tpu_torch.render import sweep_march as SM
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.volume import packed as PP

from _torch_port_inputs import BSN, BTILE, BTN, make_block_inputs

BF16 = torch.bfloat16
# (BS, BT): the kernel's 8 x 32, a block larger than the image along s,
# and small ones whose taps cross tile and volume edges often
BLOCKS = [(8, 32), (32, 16), (3, 5), (1, 7)]


def _rnd(x):
    return x.to(BF16).to(torch.float32)


def _axis(g, lam, eye, extent):
    """The block's taps along one axis for grid values ``g``: entries
    2 i and 2 i + 1 are value i's voxels jx0, jx0 + 1, with their rounded
    tent weights and whether they lie in [0, extent)."""
    pos = eye + lam * (g - eye)
    j0 = torch.floor(pos - 0.5).to(torch.int64)
    j = torch.stack([j0, j0 + 1], 1).reshape(-1)
    posr = pos.repeat_interleave(2)
    w = _rnd(torch.clamp(1.0 - torch.abs(posr - (j.to(torch.float32) + 0.5)),
                         min=0.0))
    return w, j, (j >= 0) & (j < extent)


def _march_blocks(read, meta, s_grid, t_grid, Sn, Tn, shape, scale, offset,
                  block, table=None, tile=(1, 1)):
    """The kernel's march with the rule above.  ``read(z, rows, cols)``
    gives plane z at rows x cols in float32; ``table`` (rows, P + 1) is
    the tile table for tiles ``tile`` (None: the flat march)."""
    Z, X, Y = shape
    BS, BT = block
    TX, TY = tile
    NTY = Y // TY
    iso32 = None
    zero = torch.zeros((Sn, Tn))
    m_hit = zero - 1.0
    frac, g_s, g_t, g_z, fm1 = (zero.clone() for _ in range(5))
    for k, row in enumerate(meta.tolist()):
        _, lam, zfm, fz, flag, iso, eye_s, eye_t = row
        zf = min(max(int(zfm), 0), Z - 2)
        work = flag > 0.5
        if table is not None:
            trow = table[min(max(int(zfm), 0), table.shape[0] - 1)]
            iso32 = float(torch.tensor(iso, dtype=torch.float32))
            work = work and bool(trow[-1] >= iso32)
        if not work:
            fm1 = zero
            continue
        F = torch.zeros((Sn, Tn))
        for s0 in range(0, Sn, BS):
            gs = s_grid[torch.clamp(torch.arange(s0, s0 + BS), max=Sn - 1)]
            wx, rows, rin = _axis(gs, lam, eye_s, X)
            for t0 in range(0, Tn, BT):
                gt = t_grid[torch.clamp(torch.arange(t0, t0 + BT),
                                        max=Tn - 1)]
                wy, cols, cin = _axis(gt, lam, eye_t, Y)
                ok = rin[:, None] & cin[None, :]
                r = torch.clamp(rows, 0, X - 1)
                c = torch.clamp(cols, 0, Y - 1)
                if table is not None:
                    cell = (r // TX)[:, None] * NTY + (c // TY)[None, :]
                    ok &= trow[cell] >= iso32
                sl = (1.0 - fz) * read(zf, r, c) + fz * read(zf + 1, r, c)
                sl = torch.where(ok, _rnd(sl * scale + offset), 0.0)
                tmp = torch.zeros((BS, 2 * BT))
                tmp = tmp + wx[0::2, None] * sl[0::2]
                tmp = _rnd(tmp + wx[1::2, None] * sl[1::2])
                f = torch.zeros((BS, BT))
                f = f + tmp[:, 0::2] * wy[None, 0::2]
                f = f + tmp[:, 1::2] * wy[None, 1::2]
                hs, ht = min(BS, Sn - s0), min(BT, Tn - t0)
                F[s0:s0 + hs, t0:t0 + ht] = f[:hs, :ht]
        crossing = (m_hit < 0.0) & (F >= iso)
        d = F - fm1
        denom = torch.where(torch.abs(d) > 1e-12, d, 1e-12)
        m_hit = torch.where(crossing, float(k), m_hit)
        frac = torch.where(crossing,
                           torch.clamp((iso - fm1) / denom, 0.0, 1.0), frac)
        g_s = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 0)
                                           - torch.roll(fm1, 1, 0)), g_s)
        g_t = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 1)
                                           - torch.roll(fm1, 1, 1)), g_t)
        g_z = torch.where(crossing, d, g_z)
        fm1 = F
    return m_hit, frac, g_s, g_t, g_z


def _dense_reader(vol):
    v = vol.to(torch.float32)
    return lambda z, r, c: v[z][r[:, None], c[None, :]]


def _packed_reader(pa):
    atlas = pa.atlas.to(torch.float32)
    slots = pa.slots.long()
    TX, TY = pa.tile_shape

    def read(z, r, c):
        s = slots[z][(r // TX)[:, None], (c // TY)[None, :]]
        return atlas[s, (r % TX)[:, None], (c % TY)[None, :]]
    return read


def _inputs(store):
    vol, meta, sg, tg, scale, offset, bmax, iso = make_block_inputs(store)
    vol = torch.from_numpy(vol)
    if store == "float32":
        vol = vol.to(BF16)       # the kernel's store for bf16 resampling
    return (vol, torch.from_numpy(meta), torch.from_numpy(sg),
            torch.from_numpy(tg), scale, offset, torch.from_numpy(bmax), iso)


def _assert_same(got, want):
    assert (want[0] >= 0).float().mean() > 0.1
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("store", ["float32", "uint8"])
def test_block_rule_matches_flat_plain(store, block):
    vol, meta, sg, tg, scale, offset, _, _ = _inputs(store)
    want = SM.march_plain(vol, meta, sg, tg, BSN, BTN, BF16, scale, offset)
    got = _march_blocks(_dense_reader(vol), meta, sg, tg, BSN, BTN,
                        tuple(vol.shape), scale, offset, block)
    _assert_same(got, want)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("store", ["float32", "uint8"])
def test_block_rule_matches_tiled_plain(store, block):
    vol, meta, sg, tg, scale, offset, bm, iso = _inputs(store)
    Z, X, Y = vol.shape
    TX, TY = PT.pick_tile(X, BTILE), PT.pick_tile(Y, BTILE)
    table = PT.tile_table(bm, 8, X, Y, TX, TY)
    want = PT.march_tiled_plain(vol, meta, sg, tg, BSN, BTN, bm, 8, iso,
                                BTILE, BF16, scale, offset)
    got = _march_blocks(_dense_reader(vol), meta, sg, tg, BSN, BTN,
                        (Z, X, Y), scale, offset, block, table, (TX, TY))
    _assert_same(got, want)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("store", ["float32", "uint8"])
def test_block_rule_matches_packed_plain(store, block):
    vol, meta, sg, tg, scale, offset, bm, iso = _inputs(store)
    pa = PP.pack_axis(vol, tile=BTILE)
    assert pa.tile_shape == (8, 7) and bool((pa.slots == 0).any())
    Z, X, Y = pa.shape
    table = PT.tile_table(bm, 8, X, Y, *pa.tile_shape)
    want = PT.march_packed_plain(pa, meta, sg, tg, BSN, BTN, bm, 8, iso,
                                 BF16, scale, offset)
    got = _march_blocks(_packed_reader(pa), meta, sg, tg, BSN, BTN,
                        (Z, X, Y), scale, offset, block, table,
                        pa.tile_shape)
    _assert_same(got, want)
