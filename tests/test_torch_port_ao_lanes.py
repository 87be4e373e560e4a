"""The AO capture kernels' hit-compacted rule (``ao_capture_kernel`` in
``csrc/sweep_march.cu``, B4 and B4p), emulated in torch on the CPU and
held bit for bit against their plain versions (`ao_capture_tiled_plain`,
`ao_capture_packed_plain`) in bf16.

The rule, per block of kCapThreads pixels (o = s * Tn + t; warp w of
block b of G takes the 32 pixels of run w * G + b): pass A reads each
pixel's m_hit, the hit slice's meta row, its taps, rounded weights and
tiles, and the gates of its (up to four) tap pairs; a pixel with no kept
pair stores zeros, the others are listed in pixel order.  Pass B: warp w
of W takes listed hits w * H, ..., w * H + H - 1, then W H on (H = 32 /
kCapLanes hits a warp at a time); each hit's field values go to its
kCapLanes = 8 lanes (plane p, x tap a, y tap b), four channels a lane, a
lane outside a kept pair holding 0, and are summed by shuffles: the
z-lerp across the p lanes, rnd(wx_a x) summed over the pair's x taps (xor
a), rounded, times wy_b, summed over its y taps (xor b), then the kept
pairs' terms in increasing pair id at lane (0, 0, 0), each sum starting
at +0.  Emulated with the lanes as a tensor axis and each shuffle an
index map over it; the layout is read from the kernel's source.  In bf16
every product is exact and each sum has at most two terms, so the plain
versions' dense products give the same bits; float32 cases are held to
the `cuda` tests' tolerances (the plain version's matmuls may fuse a
product into a sum, one rounding fewer).
"""

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.volume import packed as PP

from _torch_port_inputs import (HSN, HTN, make_hit_grids, make_hit_pattern,
                                make_packed_ao_field, make_packed_inputs,
                                make_tiled_ao_field, make_tiled_inputs)

F32 = torch.float32
BLOCK = kernels.source_constant("sweep_march", "kCapThreads")
WARPS = BLOCK // 32
LANES = kernels.source_constant("sweep_march", "kCapLanes")
HITS = 32 // LANES          # hits a warp takes at a time
SN, TN = HSN, HTN


def _rnd(x, bf16):
    return x.to(torch.bfloat16).to(F32) if bf16 else x


def _grids():
    return tuple(torch.from_numpy(g) for g in make_hit_grids())


def _m_hit(kind: str, K: int) -> torch.Tensor:
    return torch.from_numpy(make_hit_pattern(kind, K))


def _pass_a(meta, s_grid, t_grid, m_hit, X2, Y2, TX, TY, fd, bf16, gate):
    """Per pixel: listed or not, and its record (zf, fz, taps, weights,
    tiles, flags).  ``gate(k, zf, xt, yt)`` -> (kept, slots) for pairs of
    valid tiles (bool tensors, slots None or (n, 2) int64)."""
    K = meta.shape[0]
    mh = m_hit.flatten()
    n = mh.numel()
    o = torch.arange(n)
    s, t = o // m_hit.shape[1], o % m_hit.shape[1]
    hit = mh >= 0
    k = torch.where(hit, torch.clamp(mh.long(), max=K - 1), 0)
    m = meta[k]
    work = hit & (m[:, 4] > 0.5)
    lam, eye_s, eye_t = m[:, 1], m[:, 6], m[:, 7]
    fz, zf = m[:, 3], m[:, 2].long()
    zrow = zf
    inv_f = PT.inv_f32(fd)
    if fd > 1:
        zc2 = m[:, 0] / float(fd)
        zf2 = torch.clamp(torch.floor(zc2 - 0.5), 0.0, float(gate.Z2 - 2))
        fz = torch.clamp(zc2 - 0.5 - zf2, 0.0, 1.0)
        zf = zf2.long()
    zf = torch.clamp(zf, 0, gate.Z2 - 2)
    s_pos = (eye_s + lam * (s_grid[s] - eye_s)) * inv_f
    t_pos = (eye_t + lam * (t_grid[t] - eye_t)) * inv_f
    jx0 = torch.floor(s_pos - 0.5).long()
    jy0 = torch.floor(t_pos - 0.5).long()
    xt, yt, wx, wy = [], [], [], []
    for a in range(2):
        jx, jy = jx0 + a, jy0 + a
        xt.append(torch.where((jx >= 0) & (jx < X2), jx // TX, -1))
        yt.append(torch.where((jy >= 0) & (jy < Y2), jy // TY, -1))
        wx.append(_rnd(torch.clamp(1.0 - torch.abs(s_pos - (jx.to(F32)
                                                            + 0.5)), min=0.0),
                       bf16))
        wy.append(_rnd(torch.clamp(1.0 - torch.abs(t_pos - (jy.to(F32)
                                                            + 0.5)), min=0.0),
                       bf16))
    flags = (torch.where((xt[0] >= 0) & (xt[0] == xt[1]), 16, 0)
             | torch.where((yt[0] >= 0) & (yt[0] == yt[1]), 32, 0))
    slots = torch.zeros((n, 4, 2), dtype=torch.int64)
    for a in range(2):
        for b in range(2):
            valid = work & (xt[a] >= 0) & (yt[b] >= 0)
            kept, sl = gate(zrow, zf, torch.clamp(xt[a], min=0),
                            torch.clamp(yt[b], min=0))
            flags = flags | torch.where(valid & kept, 1 << (2 * a + b), 0)
            if sl is not None:
                slots[:, 2 * a + b] = torch.where(valid[:, None], sl, 0)
    listed = work & ((flags & 15) != 0)
    return dict(o=o, listed=listed, zf=zf, fz=fz, jx0=jx0, jy0=jy0,
                xt=torch.stack(xt, 1), yt=torch.stack(yt, 1),
                wx=torch.stack(wx, 1), wy=torch.stack(wy, 1), flags=flags,
                slots=slots)


def block_pixels(n: int) -> list:
    """The pixels of each of the kernel's blocks: warp w of block b (of G)
    takes the 32 pixels of run w * G + b."""
    G = -(-n // BLOCK)
    out = []
    for b in range(G):
        o = torch.cat([torch.arange(32) + (w * G + b) * 32
                       for w in range(WARPS)])
        out.append(o[o < n])
    return out


def _hit_list(listed: torch.Tensor, H: int) -> list:
    """Each block's listed pixels in pixel order, and the (warp, round,
    slot) that takes list entry i: warp (i // H) % WARPS, round
    i // (WARPS H), slot i % H.  Checks every entry is taken once; returns
    the pixels in the order the warps' rounds take them."""
    order = []
    for pix in block_pixels(listed.numel()):
        ids = pix[listed[pix]]
        assert bool((ids[1:] > ids[:-1]).all())        # pixel order
        taken = {}
        for w in range(WARPS):
            i0 = w * H
            while i0 < len(ids):
                for j in range(H):
                    if i0 + j < len(ids):
                        assert i0 + j not in taken
                        taken[i0 + j] = (w, i0 // (WARPS * H), j)
                i0 += WARPS * H
        assert sorted(taken) == list(range(len(ids)))
        order.extend(int(ids[i]) for i in sorted(taken, key=taken.get))
    return order


# the kept pairs' terms are added in increasing pair id: (a, b) = (0, 0),
# (0, 1), (1, 0), (1, 1)
PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _pass_b(rec, order, read, scale, offset, bf16, pairs=PAIRS):
    """The lanes of the listed hits (in the warps' order): a (hits, LANES)
    tensor of loaded values a channel, summed by shuffles over the lane
    axis.  ``read(rec, idx, p, a, b, c)`` gives the field values (float32)
    of hits idx at those lane coordinates.  Returns (pixels, (hits, 4))."""
    idx = torch.tensor(order, dtype=torch.int64)
    r = torch.arange(LANES)
    b, a, p = r & 1, (r >> 1) & 1, (r >> 2) & 1
    OB, OA, OP = 1, 2, 4
    flags = rec["flags"][idx][:, None]
    kept = ((flags >> (2 * a + b)[None]) & 1) == 1
    same_x, same_y = (flags & 16) != 0, (flags & 32) != 0
    fz = rec["fz"][idx][:, None]
    wxa = torch.where(a[None] == 1, rec["wx"][idx][:, 1:2],
                      rec["wx"][idx][:, 0:1])
    wyb = torch.where(b[None] == 1, rec["wy"][idx][:, 1:2],
                      rec["wy"][idx][:, 0:1])
    out = torch.zeros((len(order), 4), dtype=F32)

    def xor(x, m):
        return x[:, r ^ m]

    def down(x, d):
        return x[:, torch.clamp(r + d, max=LANES - 1)]

    for c in range(4):
        v = torch.where(kept, read(rec, idx, p, a, b, torch.full_like(r, c)),
                        0.0)
        vo = xor(v, OP)
        v0 = torch.where(p[None] == 1, vo, v)
        v1 = torch.where(p[None] == 1, v, vo)
        x = (1.0 - fz) * v0 + fz * v1
        x = _rnd(x * scale[c] + offset[c], bf16)
        px = wxa * x
        pxo = xor(px, OA)
        tmp = 0.0 + torch.where(same_x & (a[None] == 1), pxo, px)
        tmp = torch.where(same_x, tmp + torch.where(a[None] == 1, px, pxo),
                          tmp)
        tmp = _rnd(tmp, bf16)
        py = tmp * wyb
        pyo = xor(py, OB)
        term = 0.0 + torch.where(same_y & (b[None] == 1), pyo, py)
        term = torch.where(same_y, term + torch.where(b[None] == 1, py, pyo),
                           term)
        t = {(0, 0): term, (0, 1): down(term, OB), (1, 0): down(term, OA),
             (1, 1): down(term, OA + OB)}
        first = {(0, 0): True, (0, 1): ~same_y, (1, 0): ~same_x,
                 (1, 1): ~same_x & ~same_y}
        acc = torch.zeros_like(term)
        for pa, pb in pairs:
            use = (((flags >> (2 * pa + pb)) & 1) != 0) & first[(pa, pb)]
            acc = torch.where(use, acc + t[(pa, pb)], acc)
        out[:, c] = acc[:, 0]
    return idx, out


def _emulate(rec, m_hit, read, scale, offset, bf16, pairs=PAIRS):
    sh = torch.zeros((4, m_hit.numel()), dtype=F32)
    order = _hit_list(rec["listed"], HITS)
    if order:
        idx, vals = _pass_b(rec, order, read, scale, offset, bf16, pairs)
        sh[:, idx] = vals.t()
    return sh.reshape(4, *m_hit.shape)


class _TableGate:
    """B4's gate: the dilated tile table row of the slice's fine zf."""

    def __init__(self, table, iso, Z2, NTY):
        self.table, self.iso, self.Z2, self.NTY = table, iso, Z2, NTY

    def __call__(self, zrow, zf, xt, yt):
        row = torch.clamp(zrow, 0, self.table.shape[0] - 1)
        return self.table[row, xt * self.NTY + yt] >= self.iso, None


class _SlotGate:
    """B4p's gate: a slot of plane zf or zf + 1 is non-zero."""

    def __init__(self, slots):
        self.slots, self.Z2 = slots.long(), slots.shape[0]

    def __call__(self, zrow, zf, xt, yt):
        sl = torch.stack([self.slots[zf, xt, yt], self.slots[zf + 1, xt, yt]],
                         1)
        return (sl != 0).any(1), sl


def _tiled_case(field_kind, fd, mm, kind, wide=False):
    """B4's inputs; ``wide``: the float field's values scaled by random
    powers of two from 2^-12 to 2^12, and every pixel's taps straddling an
    x and a y tile edge (lam 1, grid values just past 8 k), so that each
    hit sums four pair terms whose float32 sums round: their order shows
    in the bits."""
    vol, meta, sg, tg, scale, offset, bmax, iso = make_tiled_inputs("uint8")
    meta = torch.from_numpy(meta)
    s_grid, t_grid = _grids()
    if wide:
        meta[:, 1] = 1.0

        def corners(n):
            i = torch.arange(n, dtype=F32)
            return 8.0 * (1 + i % 3) + 0.05 + 0.4 * i / n
        s_grid, t_grid = corners(SN), corners(TN)
    m_hit = _m_hit(kind, meta.shape[0])
    ao, a_scale, a_offset = make_tiled_ao_field(fd, field_kind == "uint8")
    if wide:
        rng = np.random.RandomState(5)
        ao = ao * np.exp2(rng.randint(-12, 13, size=ao.shape)).astype(
            np.float32)
    xyzc = torch.from_numpy(np.ascontiguousarray(ao.transpose(2, 3, 0, 1)))
    if field_kind == "bfloat16":
        xyzc = xyzc.to(torch.bfloat16)
    view = xyzc.permute(2, 3, 0, 1)
    dtype = getattr(torch, mm)
    kw = dict(tile=8, dtype=dtype, ao_scale=a_scale, ao_offset=a_offset,
              field_downsample=fd)
    want = PT.ao_capture_tiled_plain(view, meta, s_grid, t_grid, SN, TN,
                                     m_hit, torch.from_numpy(bmax), 8, iso,
                                     **kw)
    field = PT._field_store(view, dtype)
    Z2, _, X2, Y2 = field.shape
    TX, TY = PT.pick_tile(X2, 8), PT.pick_tile(Y2, 8)
    table = PT.tile_table(torch.from_numpy(bmax), 8, X2 * fd, Y2 * fd,
                          TX * fd, TY * fd, dilate=True)
    gate = _TableGate(table, PT._iso32(iso), Z2, Y2 // TY)
    bf16 = dtype == torch.bfloat16
    rec = _pass_a(meta, s_grid, t_grid, m_hit, X2, Y2, TX, TY, fd, bf16,
                  gate)
    sc = torch.tensor(PT.per_channel(a_scale), dtype=F32)
    of = torch.tensor(PT.per_channel(a_offset), dtype=F32)

    def read(rec, idx, p, a, b, c):
        z = rec["zf"][idx][:, None] + p[None]
        x = rec["jx0"][idx][:, None] + a[None]
        y = rec["jy0"][idx][:, None] + b[None]
        ok = (x >= 0) & (x < X2) & (y >= 0) & (y < Y2)
        v = field[z, c[None].expand_as(z), torch.clamp(x, 0, X2 - 1),
                  torch.clamp(y, 0, Y2 - 1)].to(F32)
        return torch.where(ok, v, 0.0)

    return rec, m_hit, read, sc, of, bf16, want


def _packed_case(mm, kind):
    vol, meta, sg, tg, scale, offset, bmax, iso = make_packed_inputs("uint8")
    meta = torch.from_numpy(meta)
    s_grid, t_grid = _grids()
    m_hit = _m_hit(kind, meta.shape[0])
    pao = PP.pack_ao_axis(torch.from_numpy(make_packed_ao_field()), tile=8)
    dtype = getattr(torch, mm)
    want = PT.ao_capture_packed_plain(pao, meta, s_grid, t_grid, SN, TN,
                                      m_hit, dtype=dtype)
    atlas = PT.kernel_atlas(pao, dtype)
    Z, X, Y = pao.shape
    TX, TY = pao.tile_shape
    bf16 = dtype == torch.bfloat16
    rec = _pass_a(meta, s_grid, t_grid, m_hit, X, Y, TX, TY, 1, bf16,
                  _SlotGate(pao.slots))
    one, zero = torch.ones(4), torch.zeros(4)

    def read(rec, idx, p, a, b, c):
        pair = (2 * a + b)[None]
        slot = torch.gather(rec["slots"][idx].reshape(len(idx), 8), 1,
                            (2 * pair + p[None]).expand(len(idx), -1))
        xt = torch.gather(rec["xt"][idx], 1, a[None].expand(len(idx), -1))
        yt = torch.gather(rec["yt"][idx], 1, b[None].expand(len(idx), -1))
        x = rec["jx0"][idx][:, None] + a[None] - xt * TX
        y = rec["jy0"][idx][:, None] + b[None] - yt * TY
        ok = (xt >= 0) & (yt >= 0)
        v = atlas[slot, c[None].expand_as(slot), torch.clamp(x, 0, TX - 1),
                  torch.clamp(y, 0, TY - 1)].to(F32)
        return torch.where(ok, v, 0.0)

    return rec, m_hit, read, one, zero, bf16, want


def _check(got, want, m_hit, mm, kind):
    hit = m_hit >= 0
    assert bool((got[:, ~hit] == 0).all())
    if kind != "none":
        assert bool((want[:, hit] != 0).any())
    if mm == "bfloat16":
        # exact products, sums of at most two terms: the same bits
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        # the plain version's matmuls may fuse a product into its sum (one
        # rounding fewer): the `cuda` tests' float32 bound
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)


# (field storage, field downsample, resample type), as the `cuda` tests'
# AO_CASES
AO_CASES = [("float32", 1, "float32"), ("bfloat16", 1, "bfloat16"),
            ("uint8", 1, "float32"), ("uint8", 1, "bfloat16"),
            ("uint8", 2, "bfloat16"), ("float32", 2, "float32")]


@pytest.mark.parametrize("kind", ["mixed", "all", "none"])
@pytest.mark.parametrize("field,fd,mm", AO_CASES)
def test_tiled_capture_lanes_match_plain(field, fd, mm, kind):
    rec, m_hit, read, sc, of, bf16, want = _tiled_case(field, fd, mm, kind)
    got = _emulate(rec, m_hit, read, sc, of, bf16)
    _check(got, want, m_hit, mm, kind)


@pytest.mark.parametrize("kind", ["mixed", "all", "none"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_packed_capture_lanes_match_plain(mm, kind):
    rec, m_hit, read, sc, of, bf16, want = _packed_case(mm, kind)
    got = _emulate(rec, m_hit, read, sc, of, bf16)
    _check(got, want, m_hit, mm, kind)


@pytest.mark.parametrize("field", ["float32", "bfloat16"])
def test_tiled_capture_lanes_keep_the_pair_order(field):
    """On a field of wide dynamic range the pair terms' float32 sums round:
    the kernel's order (increasing pair id) gives the plain version's
    bits, and the reverse order or (0, 1) and (1, 0) swapped do not."""
    rec, m_hit, read, sc, of, bf16, want = _tiled_case(field, 1, "bfloat16",
                                                       "all", wide=True)
    got = _emulate(rec, m_hit, read, sc, of, bf16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    four = rec["listed"] & ((rec["flags"] & 63) == 15)
    assert int(four.sum()) > 100
    for order in (PAIRS[::-1], (PAIRS[0], PAIRS[2], PAIRS[1], PAIRS[3])):
        other = _emulate(rec, m_hit, read, sc, of, bf16, order)
        assert not torch.equal(other.view(torch.int32),
                               want.view(torch.int32))


@pytest.mark.parametrize("n", [1, BLOCK - 1, HSN * HTN, 600 * 338])
def test_blocks_take_every_pixel_once(n):
    """The kernel's grid of ceil(n / BLOCK) blocks, its warps taking runs
    spread over the blocks, covers each of n pixels once: at the hit
    patterns' size and at the 512^3 frame's 600 x 338."""
    pix = torch.cat(block_pixels(n))
    assert torch.equal(torch.sort(pix).values, torch.arange(n))


def test_inputs_reach_every_case():
    """The inputs hold what the rule must get right: taps across tile and
    volume edges, hits on slice K - 1 and on a skipped slice, blocks with
    more hits than a warp takes, and listed hits with a culled pair."""
    rec, m_hit, *_ = _tiled_case("uint8", 1, "bfloat16", "mixed")
    K = 32
    x0, x1 = rec["xt"][:, 0], rec["xt"][:, 1]
    y0, y1 = rec["yt"][:, 0], rec["yt"][:, 1]
    work = rec["listed"]
    assert bool((work & (x0 >= 0) & (x1 >= 0) & (x0 != x1)).any())
    assert bool((work & (y0 >= 0) & (y1 >= 0) & (y0 != y1)).any())
    assert bool((work & ((x0 < 0) | (x1 < 0))).any())
    assert bool((work & ((y0 < 0) | (y1 < 0))).any())
    assert bool((work & (m_hit.flatten() == K - 1)).any())
    per = [int(work[pix].sum()) for pix in block_pixels(work.numel())]
    assert max(per) > HITS * WARPS
    rec_all, m_all, *_ = _tiled_case("uint8", 1, "bfloat16", "all")
    assert bool(((m_all.flatten() == 24) & ~rec_all["listed"]).any())
    culled = rec_all["listed"] & ((rec_all["flags"] & 15) != 15)
    both = (rec_all["xt"] >= 0).all(1) & (rec_all["yt"] >= 0).all(1)
    assert bool((culled & both).any())


@pytest.mark.parametrize("fd", [1, 2, 3, 4])
def test_inv_f_is_the_float32_reciprocal(fd):
    """The capture's 1 / fd, made without a tensor, has the bits of the
    float32 division the kernel wrapper used to make through a tensor."""
    want = torch.tensor(1.0 / fd, dtype=F32).item()
    got = PT.inv_f32(fd)
    assert np.float32(got).view(np.int32) == np.float32(want).view(np.int32)
    assert got == float(np.float32(1) / np.float32(fd))
