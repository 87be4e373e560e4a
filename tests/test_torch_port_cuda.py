"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: without a card these tests skip (decided inside each
test).  On a machine with one: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu_torch import ops as port_ops
from isosurfacesuperresolution_tpu_torch.infer import planar as PL
from isosurfacesuperresolution_tpu_torch.ops import packed_conv as PK
from isosurfacesuperresolution_tpu_torch.ops import pallas_conv as PC
from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT

from isosurfacesuperresolution_tpu_torch.volume import packed as PP

from _torch_port_inputs import (BSN, BTILE, BTN, CASES, HSN, HTN, SN, TILE,
                                TN, TSN, TTN, make_ao_field,
                                make_block_ao_field, make_block_inputs,
                                make_hit_grids, make_hit_pattern, make_inputs,
                                make_packed_ao_field, make_packed_inputs,
                                make_tiled_ao_field, make_tiled_inputs)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_kernel_matches_plain(store, mm):
    _need_card()
    vol, meta, sg, tg, scale, offset = make_inputs(store)
    args = [torch.from_numpy(a).cuda() for a in (vol, meta, sg, tg)]
    before = sweep_march.march.launches
    got = sweep_march.march(*args, SN, TN, dtype=getattr(torch, mm),
                            scale=scale, offset=offset)
    torch.cuda.synchronize()
    assert sweep_march.march.launches == before + 1
    want = sweep_march.march_plain(*[a.cpu() for a in args], SN, TN,
                                   dtype=getattr(torch, mm), scale=scale,
                                   offset=offset)
    # same operands rounded at the same points; float32 sums of two taps
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("store,mm", CASES)
def test_march_ao_kernel_matches_plain(store, mm, quantize):
    _need_card()
    vol, meta, sg, tg, scale, offset = make_inputs(store)
    _, ao, _, _ = make_ao_field(quantize)
    args = [torch.from_numpy(a).cuda() for a in (vol, meta, sg, tg)]
    ao_t = torch.from_numpy(ao).cuda()
    before = (sweep_march.march.launches, sweep_march.march.ao_launches)
    got = sweep_march.march(*args, SN, TN, dtype=getattr(torch, mm),
                            scale=scale, offset=offset, ao_zcxy=ao_t)
    torch.cuda.synchronize()
    assert (sweep_march.march.launches,
            sweep_march.march.ao_launches) == (before[0], before[1] + 1)
    want = sweep_march.march_plain(*[a.cpu() for a in args], SN, TN,
                                   dtype=getattr(torch, mm), scale=scale,
                                   offset=offset, ao_zcxy=ao_t.cpu())
    assert len(got) == len(want) == 6 and got[5].shape == (4, SN, TN)
    hit = want[0].numpy() >= 0
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    assert (got[5].cpu().numpy()[:, ~hit] == 0).all()
    # the SH capture rounds like the density: two-tap float32 sums
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=0)



def _close_to_plain(got, want, mm):
    """m_hit exact, the other outputs within 1e-5; in float32 frac within
    1e-3: the plain version's CPU matmul fuses multiply-adds where the
    kernel rounds each product, and frac divides that difference by
    F - Fm1 (the smoke's MAX_FRAC_DIFF); bf16 products are exact, so
    there it is 1e-5 too."""
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        tol = 1e-3 if i == 0 and mm == "float32" else 1e-5
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=tol,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ao", [False, True])
@pytest.mark.parametrize("store,mm", CASES)
def test_march_kernel_matches_plain_across_blocks(store, mm, with_ao):
    """B1 and B1-ao at 4 x 3 blocks with ragged edges: footprints from one
    voxel to wider than a block's taps, backwards, outside the volume."""
    _need_card()
    vol, meta, sg, tg, scale, offset, _, _ = make_block_inputs(store)
    args = [torch.from_numpy(a) for a in (vol, meta, sg, tg)]
    ao = torch.from_numpy(make_block_ao_field()) if with_ao else None
    kw = dict(dtype=getattr(torch, mm), scale=scale, offset=offset)
    got = sweep_march.march(*[a.cuda() for a in args], BSN, BTN,
                            ao_zcxy=None if ao is None else ao.cuda(), **kw)
    want = sweep_march.march_plain(*args, BSN, BTN, ao_zcxy=ao, **kw)
    assert 0.2 < (want[0].numpy() >= 0).mean() < 0.9
    _close_to_plain(got, want, mm)
    if with_ao:
        assert (got[5].cpu().numpy()[:, want[0].numpy() < 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_tiled_and_packed_kernels_across_blocks(store, mm):
    """B2 and B3 at 4 x 3 blocks with ragged edges, tiles of (8, 7) some
    culled or background, against their plain versions; B3 on the
    lossless packing equals B2 bit for bit."""
    _need_card()
    vol, meta, sg, tg, scale, offset, bmax, iso = make_block_inputs(store)
    args = [torch.from_numpy(a) for a in (meta, sg, tg)]
    bm = torch.from_numpy(bmax)
    kw = dict(dtype=getattr(torch, mm), scale=scale, offset=offset)
    dense = torch.from_numpy(vol)
    got = PT.march_tiled(dense.cuda(), *[a.cuda() for a in args], BSN, BTN,
                         bm.cuda(), 8, iso, tile=BTILE, **kw)
    want = PT.march_tiled_plain(dense, *args, BSN, BTN, bm, 8, iso,
                                tile=BTILE, **kw)
    assert 0.1 < (want[0].numpy() >= 0).mean() < 0.9
    _close_to_plain(got, want, mm)
    pa = PP.pack_axis(dense.cuda(), tile=BTILE)
    assert pa.tile_shape == (8, 7) and int((pa.slots == 0).sum()) > 0
    packed = PT.march_packed(pa, *[a.cuda() for a in args], BSN, BTN,
                             bm.cuda(), 8, iso, **kw)
    cpu = PP.PackedAxisVolume(pa.atlas.cpu(), pa.slots.cpu(),
                              pa.slice_max.cpu(), pa.shape)
    _close_to_plain(packed, PT.march_packed_plain(cpu, *args, BSN, BTN, bm,
                                                  8, iso, **kw), mm)
    for a, b in zip(packed, got):
        assert torch.equal(a, b)

def _phase_case(seed, h, w):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(1, h, w, 256) - 0.5).astype(np.float32))
    k3 = torch.from_numpy(((rng.rand(3, 3, 64, 64) - 0.5) * 0.2
                           ).astype(np.float32))
    bias = torch.from_numpy((rng.rand(64) - 0.5).astype(np.float32))
    return x.to(torch.bfloat16), k3, bias


def _phase_close(got, want, out):
    """Exact bf16 products, float32 sums in another order (2e-5 on O(1)
    sums); a bf16 output may round the other way, one step (2^-7 rel.)."""
    got, want = got.cpu().to(torch.float32), want.to(torch.float32)
    tol = 2e-5 + (2.0 ** -7 * want.abs() if out == "bfloat16" else 0.0)
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(11, 21), (37, 45), (1, 1), (1, 37),
                                   (7, 130), (18, 5)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_phase_conv_kernel_matches_plain(relu, out, shape):
    """Partial tiles on both axes, one row, one pixel, widths that are no
    multiple of any tile width."""
    _need_card()
    h, w = shape
    xb, k3, bias = _phase_case(5, h, w)
    before = pc.phase_conv.launches
    got = pc.phase_conv3x3_amajor_blocked(
        xb.cuda(), k3.cuda(), bias.cuda(), relu=relu,
        out_dtype=getattr(torch, out))
    torch.cuda.synchronize()
    assert pc.phase_conv.launches == before + 1
    assert got.shape == (1, h, w, 256) and got.dtype == getattr(torch, out)
    _phase_close(got, pc.phase_conv_plain(xb, k3, bias, relu=relu,
                                          out_dtype=getattr(torch, out)), out)


@pytest.mark.cuda
def test_phase_conv_takes_the_planar_callers_view():
    """The planar engine hands B5 ``z.permute(0, 2, 3, 1).to(bf16)`` of a
    channels-last float32 tensor: the kernel reads that view as the plain
    version does."""
    _need_card()
    xb, k3, bias = _phase_case(7, 9, 20)
    z = xb.float().permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).cuda()
    view = z.permute(0, 2, 3, 1).to(torch.bfloat16)
    got = pc.phase_conv3x3_amajor_blocked(view, k3.cuda(), bias.cuda(),
                                          relu=True)
    torch.cuda.synchronize()
    _phase_close(got, pc.phase_conv_plain(xb, k3, bias, relu=True),
                 "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_tiled_kernel_matches_plain(store, mm):
    _need_card()
    vol, meta, sg, tg, scale, offset, bmax, iso = make_tiled_inputs(store)
    args = [torch.from_numpy(a).cuda() for a in (vol, meta, sg, tg)]
    bm = torch.from_numpy(bmax).cuda()
    kw = dict(tile=TILE, dtype=getattr(torch, mm), scale=scale,
              offset=offset)
    before = PT.march_tiled_kernel.launches
    got = PT.march_tiled(*args, TSN, TTN, bm, 8, iso, **kw)
    torch.cuda.synchronize()
    assert PT.march_tiled_kernel.launches == before + 1
    want = PT.march_tiled_plain(*[a.cpu() for a in args], TSN, TTN,
                                bm.cpu(), 8, iso, **kw)
    # same operands rounded at the same points; float32 sums of two taps
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    assert (want[0].numpy() >= 0).mean() > 0.5
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=0)


# (field storage, field downsample, resample type), as in the CPU tests
AO_CASES = [("float32", 1, "float32"), ("bfloat16", 1, "bfloat16"),
            ("uint8", 1, "float32"), ("uint8", 1, "bfloat16"),
            ("uint8", 2, "bfloat16"), ("float32", 2, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("field,fd,mm", AO_CASES)
def test_ao_capture_tiled_kernel_matches_plain(field, fd, mm):
    _need_card()
    vol, meta, sg, tg, scale, offset, bmax, iso = make_tiled_inputs("uint8")
    cpu = [torch.from_numpy(a) for a in (vol, meta, sg, tg)]
    m_hit = PT.march_tiled_plain(*cpu, TSN, TTN, torch.from_numpy(bmax), 8,
                                 iso, tile=TILE, scale=scale,
                                 offset=offset)[0]
    ao, a_scale, a_offset = make_tiled_ao_field(fd, field == "uint8")
    # the field as a permuted (Z', 4, X', Y') view of an (X', Y', Z', 4)
    # array, as the renderer hands it over: the kernel reads strides
    xyzc = torch.from_numpy(np.ascontiguousarray(ao.transpose(2, 3, 0, 1)))
    if field == "bfloat16":
        xyzc = xyzc.to(torch.bfloat16)
    view = xyzc.permute(2, 3, 0, 1)
    kw = dict(tile=8, dtype=getattr(torch, mm), ao_scale=a_scale,
              ao_offset=a_offset, field_downsample=fd)
    before = PT.ao_capture_tiled_kernel.launches
    got = PT.ao_capture_tiled(view.cuda(), *[a.cuda() for a in cpu[1:]],
                              TSN, TTN, m_hit.cuda(),
                              torch.from_numpy(bmax).cuda(), 8, iso, **kw)
    torch.cuda.synchronize()
    assert PT.ao_capture_tiled_kernel.launches == before + 1
    want = PT.ao_capture_tiled_plain(view, *cpu[1:], TSN, TTN, m_hit,
                                     torch.from_numpy(bmax), 8, iso, **kw)
    hit = m_hit.numpy() >= 0
    got = got.cpu().numpy()
    assert (got[:, ~hit] == 0).all() and (want.numpy()[:, hit] != 0).all()
    # the same per-pair sums in the same order: float32 within rounding
    # (1e-6); bf16 within one bf16 step of a term (2^-8 relative)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6,
                               rtol=0 if mm == "float32" else 2.0 ** -8)


def _capture_close(got, want, m_hit, mm):
    """A capture against its plain version on a hit pattern: 0 wherever
    no pixel hits; bf16 resampling bit for bit (exact products, sums of
    at most two terms, the kernel's order is the plain version's, as
    `test_torch_port_ao_lanes.py` shows on the CPU); float32 within
    rounding (1e-6: the plain version's matmuls may fuse a product into
    a sum)."""
    hit = m_hit.numpy() >= 0
    got, want = got.cpu().numpy(), want.numpy()
    assert (got[:, ~hit] == 0).all()
    if mm == "bfloat16":
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "all", "mixed"])
@pytest.mark.parametrize("field,fd,mm", AO_CASES)
def test_ao_capture_tiled_kernel_on_hit_patterns(field, fd, mm, kind):
    """No hit, every pixel a hit, and blocks with more hits than their
    warps take at a time (`make_hit_pattern`), over three blocks of the
    kernel, the last ragged, with taps outside the volume."""
    _need_card()
    _, meta, _, _, _, _, bmax, iso = make_tiled_inputs("uint8")
    sg, tg = make_hit_grids()
    m_hit = torch.from_numpy(make_hit_pattern(kind, meta.shape[0]))
    cpu = [torch.from_numpy(a) for a in (meta, sg, tg)]
    ao, a_scale, a_offset = make_tiled_ao_field(fd, field == "uint8")
    xyzc = torch.from_numpy(np.ascontiguousarray(ao.transpose(2, 3, 0, 1)))
    if field == "bfloat16":
        xyzc = xyzc.to(torch.bfloat16)
    view = xyzc.permute(2, 3, 0, 1)
    kw = dict(tile=8, dtype=getattr(torch, mm), ao_scale=a_scale,
              ao_offset=a_offset, field_downsample=fd)
    before = PT.ao_capture_tiled_kernel.launches
    got = PT.ao_capture_tiled(view.cuda(), *[a.cuda() for a in cpu], HSN,
                              HTN, m_hit.cuda(),
                              torch.from_numpy(bmax).cuda(), 8, iso, **kw)
    torch.cuda.synchronize()
    assert PT.ao_capture_tiled_kernel.launches == before + 1
    want = PT.ao_capture_tiled_plain(view, *cpu, HSN, HTN, m_hit,
                                     torch.from_numpy(bmax), 8, iso, **kw)
    _capture_close(got, want, m_hit, mm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "all", "mixed"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_ao_capture_packed_kernel_on_hit_patterns(mm, kind):
    _need_card()
    _, meta, _, _, _, _, _, _ = make_packed_inputs("uint8")
    sg, tg = make_hit_grids()
    m_hit = torch.from_numpy(make_hit_pattern(kind, meta.shape[0]))
    cpu = [torch.from_numpy(a) for a in (meta, sg, tg)]
    pao = PP.pack_ao_axis(torch.from_numpy(make_packed_ao_field()), tile=8)
    gpu = PP.PackedAOAxisVolume(pao.atlas.cuda(), pao.slots.cuda(),
                                pao.shape)
    before = PT.ao_capture_packed_kernel.launches
    got = PT.ao_capture_packed(gpu, *[a.cuda() for a in cpu], HSN, HTN,
                               m_hit.cuda(), dtype=getattr(torch, mm))
    torch.cuda.synchronize()
    assert PT.ao_capture_packed_kernel.launches == before + 1
    want = PT.ao_capture_packed_plain(pao, *cpu, HSN, HTN, m_hit,
                                      dtype=getattr(torch, mm))
    _capture_close(got, want, m_hit, mm)


def _packed_case(store, tol):
    vol, meta, sg, tg, scale, offset, bmax, iso = make_packed_inputs(store)
    pa = PP.pack_axis(torch.from_numpy(vol).cuda(), tile=TILE,
                      tolerance=tol)
    args = [torch.from_numpy(a).cuda() for a in (meta, sg, tg)]
    return vol, pa, args, torch.from_numpy(bmax).cuda(), scale, offset, iso


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_packed_kernel_matches_plain(store, mm):
    """f32, bf16 and uint8 atlases; float ones packed with a tolerance."""
    _need_card()
    _, pa, args, bm, scale, offset, iso = _packed_case(
        store, 0.0 if store == "uint8" else 1e-3)
    kw = dict(dtype=getattr(torch, mm), scale=scale, offset=offset)
    before = PT.march_packed_kernel.launches
    got = PT.march_packed(pa, *args, TSN, TTN, bm, 8, iso, **kw)
    torch.cuda.synchronize()
    assert PT.march_packed_kernel.launches == before + 1
    cpu = PP.PackedAxisVolume(pa.atlas.cpu(), pa.slots.cpu(),
                              pa.slice_max.cpu(), pa.shape)
    want = PT.march_packed_plain(cpu, *[a.cpu() for a in args], TSN, TTN,
                                 bm.cpu(), 8, iso, **kw)
    # same operands rounded at the same points; float32 sums of two taps
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    assert (want[0].numpy() >= 0).mean() > 0.5
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_packed_kernel_lossless_equals_tiled_kernel(store, mm):
    """On a lossless packing B3 reads the values B2 reads, in the same
    order: bit for bit."""
    _need_card()
    vol, pa, args, bm, scale, offset, iso = _packed_case(store, 0.0)
    kw = dict(dtype=getattr(torch, mm), scale=scale, offset=offset)
    got = PT.march_packed(pa, *args, TSN, TTN, bm, 8, iso, **kw)
    want = PT.march_tiled(torch.from_numpy(vol).cuda(), *args, TSN, TTN, bm,
                          8, iso, tile=TILE, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_ao_capture_packed_kernel_matches_plain(mm):
    _need_card()
    vol, meta, sg, tg, scale, offset, bmax, iso = make_packed_inputs("uint8")
    cpu = [torch.from_numpy(a) for a in (meta, sg, tg)]
    m_hit = PT.march_packed_plain(
        PP.pack_axis(torch.from_numpy(vol), tile=TILE), *cpu, TSN, TTN,
        torch.from_numpy(bmax), 8, iso, scale=scale, offset=offset)[0]
    pao = PP.pack_ao_axis(torch.from_numpy(make_packed_ao_field()), tile=8)
    gpu = PP.PackedAOAxisVolume(pao.atlas.cuda(), pao.slots.cuda(),
                                pao.shape)
    before = PT.ao_capture_packed_kernel.launches
    got = PT.ao_capture_packed(gpu, *[a.cuda() for a in cpu], TSN, TTN,
                               m_hit.cuda(), dtype=getattr(torch, mm))
    torch.cuda.synchronize()
    assert PT.ao_capture_packed_kernel.launches == before + 1
    want = PT.ao_capture_packed_plain(pao, *cpu, TSN, TTN, m_hit,
                                      dtype=getattr(torch, mm))
    hit = m_hit.numpy() >= 0
    got = got.cpu().numpy()
    assert (got[:, ~hit] == 0).all() and (want.numpy()[:, hit] != 0).any()
    # the same per-pair sums in the same order: float32 within rounding
    # (1e-6); bf16 within one bf16 step of a term (2^-8 relative)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6,
                               rtol=0 if mm == "float32" else 2.0 ** -8)


def _conv_case(seed, shape, cout):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (torch.from_numpy((rng.rand(*shape) - 0.5).astype(np.float32)),
            torch.from_numpy(((rng.rand(3, 3, c, cout) - 0.5) * 0.1)
                             .astype(np.float32)),
            torch.from_numpy((rng.rand(cout) - 0.5).astype(np.float32)))


def _conv_close(got, want, out):
    """Exact bf16 products, float32 sums (up to 2304 terms) in another
    order: 1e-5 of the output's scale; a bf16 output may round the other
    way, one step (2^-7 relative)."""
    got, want = got.cpu().to(torch.float32), want.to(torch.float32)
    tol = 1e-5 * float(want.abs().max()) + (
        2.0 ** -7 * want.abs() if out == "bfloat16" else 0.0)
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c,cout,h,w", [(128, 128, 11, 24),
                                        (256, 128, 9, 40),
                                        (128, 256, 5, 16),
                                        (256, 256, 17, 8),
                                        (128, 128, 96, 512),
                                        (128, 128, 1, 40),
                                        (384, 384, 7, 16),
                                        (256, 256, 72, 256)])
def test_conv3x3_p128_kernel_matches_plain(c, cout, h, w, relu, out):
    """B6: partial tiles on both axes, one and two 128-channel output
    blocks; then the persistent kernel's edges: more tiles than an H100
    has SMs (192 of 256 pixels x 128 channels; 144 of 128 pixels x 256
    channels), so blocks walk several; one image row in a single partial
    tile; 384 -> 384 as three 128-channel blocks."""
    _need_card()
    x, wt, b = _conv_case(c + cout + h, (1, h, w, c), cout)
    odt = getattr(torch, out)
    before = PC.conv3x3_p128_kernel.launches
    got = PC.conv3x3_pallas_p128(x.cuda(), wt.cuda(), b.cuda(), relu=relu,
                                 out_dtype=odt)
    torch.cuda.synchronize()
    assert PC.conv3x3_p128_kernel.launches == before + 1
    assert got.dtype == odt and got.shape == (1, h, w, cout)
    _conv_close(got, PC.conv3x3_p128_plain(x, wt, b, relu=relu,
                                           out_dtype=odt), out)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w2", [(11, 12), (6, 40), (3, 8), (9, 240)])
def test_packed_conv3x3_kernel_matches_plain(h, w2, relu, out):
    """B7 on the packed memory: unpacked widths 24, 80, 16 and the
    trunk's 480."""
    _need_card()
    x, k3, b = _conv_case(h + w2, (1, h, w2, 128), 64)
    k3 = k3[:, :, :64]
    odt = getattr(torch, out)
    before = PK.packed_conv3x3_kernel.launches
    got = PK.packed_conv3x3(x.cuda(), k3.cuda(), b.cuda(), relu=relu,
                            out_dtype=odt)
    torch.cuda.synchronize()
    assert PK.packed_conv3x3_kernel.launches == before + 1
    assert got.dtype == odt and got.shape == (1, h, w2, 128)
    _conv_close(got, PK.packed_conv3x3_plain(x, k3, b, relu=relu,
                                             out_dtype=odt), out)


@pytest.mark.cuda
def test_conv_kernels_launch_on_the_current_stream():
    """B6, B7 and B5 launched under a side stream run on it: each reads an
    input that the side stream fills only after a long sleep, into a
    buffer that holds NaN until then, so a launch on any other stream
    would read NaN."""
    _need_card()
    x6, w6, b6 = _conv_case(6, (1, 9, 40, 128), 128)
    x7, k7, b7 = _conv_case(7, (1, 9, 40, 128), 64)
    k7 = k7[:, :, :64]
    buf6 = torch.full(x6.shape, float("nan"), dtype=torch.bfloat16,
                      device="cuda")
    buf7 = torch.full(x7.shape, float("nan"), dtype=torch.bfloat16,
                      device="cuda")
    src6, src7 = x6.cuda().to(torch.bfloat16), x7.cuda().to(torch.bfloat16)
    w6c, b6c = w6.cuda().to(torch.bfloat16), b6.cuda()
    k7c, b7c = k7.cuda().to(torch.bfloat16), b7.cuda()
    x5, k5, b5 = _phase_case(8, 9, 40)
    buf5 = torch.full(x5.shape, float("nan"), dtype=torch.bfloat16,
                      device="cuda")
    src5, k5c, b5c = x5.cuda(), k5.cuda(), b5.cuda()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        buf6.copy_(src6)
        y6 = PC.conv3x3_pallas_p128(buf6, w6c, b6c, relu=True)
        torch.cuda._sleep(100_000_000)
        buf7.copy_(src7)
        y7 = PK.packed_conv3x3(buf7, k7c, b7c, relu=True)
        torch.cuda._sleep(100_000_000)
        buf5.copy_(src5)
        y5 = pc.phase_conv(buf5, k5c, b5c, relu=True)
    side.synchronize()
    _conv_close(y6, PC.conv3x3_p128_plain(x6, w6, b6, relu=True),
                "bfloat16")
    _conv_close(y7, PK.packed_conv3x3_plain(x7, k7, b7, relu=True),
                "bfloat16")
    _phase_close(y5, pc.phase_conv_plain(x5, k5, b5, relu=True), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [16, 13])
def test_conv3x3_dispatch_on_card(width):
    """`conv3x3` on CUDA tensors: W % 8 == 0 runs B6 over 128-padded
    channels (the plain version's function of the padded operands); else
    the stock conv (float32, TF32 off), as on the CPU."""
    _need_card()
    x, wt, b = _conv_case(width, (1, 7, width, 24), 40)
    before = PC.conv3x3_p128_kernel.launches
    got = port_ops.conv3x3(x.cuda(), wt.cuda(), b.cuda(), relu=True)
    torch.cuda.synchronize()
    kernel = width % 8 == 0
    assert PC.conv3x3_p128_kernel.launches == before + int(kernel)
    if kernel:
        want = PC.conv3x3_p128_plain(
            PC.pad_lanes(x), PC.pad_lanes(PC.pad_lanes(wt, axis=2), axis=3),
            PC.pad_lanes(b), relu=True, out_dtype=torch.float32)[..., :40]
    else:
        want = port_ops.conv3x3(x, wt, b, relu=True)
    _conv_close(got, want, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["SAME", "VALID", ((1, 0), (1, 1))])
def test_int8_conv_on_card_equals_cpu(pad):
    """The int8 conv's int32 sums on the card (`torch._int_mm` per tap)
    equal the CPU's, with channels that need padding (24 -> 20) and the
    planar widths (256 -> 128); the output within 1e-6 of its scale."""
    _need_card()
    rng = np.random.RandomState(9)
    kh = 3 if isinstance(pad, str) else 2
    for cin, cout, h, w in ((24, 20, 7, 9), (256, 128, 12, 20)):
        x = torch.from_numpy(rng.randn(1, h, w, cin).astype(np.float32))
        k = torch.from_numpy((rng.randn(kh, 3, cin, cout) * 0.1)
                             .astype(np.float32))
        b = torch.from_numpy(rng.randn(cout).astype(np.float32))
        q, qc = PL.int8_conv(k, b), PL.int8_conv(k.cuda(), b.cuda())
        xq, _ = PL.quantize_activation(x)
        xqc, _ = PL.quantize_activation(x.cuda())
        assert torch.equal(xqc.cpu(), xq) and torch.equal(qc.taps.cpu(),
                                                          q.taps)
        pads = PL._nchw_pad(pad)
        sums = PL.int8_conv_sums(xqc, qc.taps, pads)
        assert sums.dtype == torch.int32
        assert torch.equal(sums.cpu(), PL.int8_conv_sums(xq, q.taps, pads))
        got = PL._conv_int8(x.cuda(), k.cuda(), b.cuda(), pad,
                            torch.float32).cpu()
        want = PL._conv_int8(x, k, b, pad, torch.float32)
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("planar", ["on", "off"])
def test_float32_frame_ignores_the_global_tf32_flag(planar, monkeypatch):
    """A float32 frame (64 features, seeded weights) gives the same output
    with cuDNN's TF32 allowed globally and not; a bare conv at that width
    does not, so the frame's pin is what holds it."""
    _need_card()
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, ModelConfig, RenderConfig)
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        FusedFrame, initial_state)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        EnhanceNet)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    torch.manual_seed(0)
    x = torch.randn(1, 64, 96, 128, device="cuda")
    w = torch.randn(64, 64, 3, 3, device="cuda") * 0.05
    bare = []
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        bare.append(torch.nn.functional.conv2d(x, w, padding=1))
    assert not torch.equal(bare[0], bare[1])
    mcfg = ModelConfig(num_residual_blocks=2, num_features=64)
    net = EnhanceNet(mcfg).cuda().eval()
    cfg = Config(model=mcfg)
    rcfg = RenderConfig(width=64, height=48, isovalue=0.5, ao_samples=0,
                        renderer="sweep_pallas", sweep_dtype="float32")
    grid = analytic.blobs_volume(32, num_blobs=5, device="cuda")
    cam = CameraParams.create((0.3, 0.9, -1.5))
    outs = []
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        frame = FusedFrame(net, cfg, rcfg, planar=planar, device="cuda")
        state = initial_state(cfg, rcfg, planar=planar, device="cuda")
        for _ in range(2):
            rgb, _, state = frame(grid, cam, cam, state)
        outs.append(rgb)
        assert torch.backends.cudnn.allow_tf32 == flag
    assert torch.equal(outs[0], outs[1])


ZOO = {
    "enhancenet_bn": dict(use_bn=True),
    "enhancenet_sn": dict(use_sn=True),
    "enhancenet_pixelshuffle": dict(upsample="pixelShuffle"),
    "enhancenet_bicubic": dict(upsample="bicubic"),
    "enhancenet_fused": dict(fused_upsample=True),
    "rcan": dict(model="RCAN"),
    "tecogan": dict(model="TecoGAN"),
    "subpixelnet": dict(model="SubpixelNet"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_card_matches_cpu(name):
    """Each generator option and zoo model (2 blocks, 16 features, RCAN
    with 2 groups of 2 blocks) on the card against the CPU on the same
    seeded weights and input: float32 convs without TF32 in other
    algorithms, 1e-4 on outputs of O(1)."""
    _need_card()
    from isosurfacesuperresolution_tpu_torch.config import ModelConfig
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import fp32_convs
    from isosurfacesuperresolution_tpu_torch.models import generators as G
    from isosurfacesuperresolution_tpu_torch.utils.spectral_norm import (
        SpectralNormalizedModule)
    cfg = ModelConfig(num_residual_blocks=2, num_features=16, **ZOO[name])
    torch.manual_seed(0)
    if cfg.model == "RCAN":
        net = G.RCAN(cfg, num_groups=2, num_blocks=2)
    else:
        net = G.create_network(cfg)
    for t in net.state_dict().values():
        if t.dtype.is_floating_point and t.dim() == 1:
            t.uniform_(0.5, 1.5)          # biases, BN scales and statistics
    if isinstance(net, SpectralNormalizedModule):
        net.load_state_dict(net.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 16, 16, G.network_input_channels(cfg)).astype(np.float32))
    with torch.no_grad(), fp32_convs():
        want = net.eval()(x)[0]
        got = net.cuda()(x.cuda())[0]
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, 64, 64, 6)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_exact_warp_and_bicubic_card_match_cpu():
    """`warp_upscale` (`F.grid_sample`) and the bicubic resize on the card
    against the CPU: float32, 1e-6."""
    _need_card()
    from isosurfacesuperresolution_tpu_torch.models.videotools import (
        warp_upscale)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.rand(1, 64, 96, 6).astype(np.float32))
    flow = torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 16, 24, 2)).astype(
        np.float32))
    for fn in (lambda a, f: warp_upscale(a, f, 4, special_mask=True),
               lambda a, f: resize(a, size=(256, 384), method="bicubic")):
        want = fn(img, flow)
        got = fn(img.cuda(), flow.cuda())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-6, rtol=0)


def _oracle_frames(renderer, device, **kw):
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    grid = analytic.torus_volume(32, device=device)
    cfg = RenderConfig(width=32, height=24, isovalue=0.5, renderer=renderer,
                       **kw)
    out = []
    for eye in ((0.0, 1.2, -0.25), (1.6, 0.5, -0.4)):
        cam = CameraParams.create(eye)
        out.append(render_frame_gbuffer(grid, cam, cam, cfg).cpu().numpy())
    return out


def _close_frames(got, want, samples):
    """Card against CPU: the same float32 ops in the same order; a
    grazing ray may flip (1% of the pixels), and an AO ray's flip moves
    AO by 1/samples."""
    for g, w in zip(got, want):
        assert (g[..., 3] != w[..., 3]).mean() <= 0.01
        both = (g[..., 3] > 0.5) & (w[..., 3] > 0.5)
        d = np.abs(g - w)[both]
        assert d[:, [c for c in range(12) if c != 10]].max() < 1e-4
        assert d[:, 10].max() < 1.0 / max(samples, 1) + 1e-4
        assert (d[:, 10] > 1e-4).mean() <= 0.02
        if samples:
            assert (w[..., 10][both] < 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [0, 8])
def test_march_oracle_card_matches_cpu(samples):
    _need_card()
    kw = dict(ao_samples=samples, ao_radius=0.2, step_voxels=0.5)
    _close_frames(_oracle_frames("march", "cuda", **kw),
                  _oracle_frames("march", "cpu", **kw), samples)


@pytest.mark.cuda
def test_sweep_ray_ao_on_b1_card_matches_cpu():
    """``ao_mode="ray"`` on the flat march: B1 on the card, its plain
    version on the CPU, then the hemisphere rays on each."""
    _need_card()
    kw = dict(ao_samples=8, ao_radius=0.2, ao_mode="ray")
    before = sweep_march.march.launches
    got = _oracle_frames("sweep_pallas", "cuda", **kw)
    assert sweep_march.march.launches == before + 2
    _close_frames(got, _oracle_frames("sweep_pallas", "cpu", **kw), 8)


@pytest.mark.cuda
def test_march_copies_nothing_from_the_host_per_step():
    """A march of a few hundred steps makes one host-to-device copy (the
    shared origin), whatever its length."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        march_rays)
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    grid = analytic.torus_volume(64, device="cuda")
    rng = np.random.RandomState(0)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    origin = torch.tensor([32.0, 70.0, 20.0])
    dirs = d.cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hit, _ = march_rays(grid, origin, dirs, 0.5, 0.25, 4096)
        torch.cuda.synchronize()
    h2d = [e for e in prof.events() if "HtoD" in e.name]
    assert hit.any() and len(h2d) <= 1, [e.name for e in h2d]


# ---------------------------------------------------------------------------
# training (slice 9): card vs CPU
# ---------------------------------------------------------------------------

def _train_setup(device, losses="l1:mask:1,l1:ao:1,l1:normal:10,"
                 "l1:depth:10,temp-l2:color:0.1", sn=False, gan="bce"):
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, TrainConfig)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    cfg = Config(model=ModelConfig(num_residual_blocks=2, num_features=16),
                 loss=LossConfig(losses=losses, padding=4, gan_type=gan),
                 train=TrainConfig(batch_size=2, crop_size=16, num_frames=3,
                                   learning_rate=1e-3))
    gen = torch.Generator().manual_seed(15)
    model = create_network(cfg.model, generator=gen).to(device)
    crit = LossNetUnshaded(cfg.loss, high_res=64, use_spectral_norm=sn)
    spec = TR.make_optimizer(cfg)
    state = TR.create_train_state(cfg, model, crit, spec, gen,
                                  discr_optimizer=spec)
    return cfg, state, crit, TR


def _train_clip(seed, device):
    rng = np.random.RandomState(seed)
    low = rng.rand(2, 3, 16, 16, 5).astype(np.float32)
    low[..., 0] = np.sign(low[..., 0] - 0.3)
    flow = (rng.rand(2, 3, 16, 16, 2).astype(np.float32) - 0.5) * 0.1
    high = np.repeat(np.repeat(np.concatenate(
        [low, rng.rand(2, 3, 16, 16, 1).astype(np.float32)], -1), 4, 2), 4, 3)
    return [torch.from_numpy(a).to(device) for a in (low, flow, high)]


@pytest.mark.cuda
def test_train_steps_card_match_cpu():
    """Three Adam steps from the same seeded state: losses rel 1e-4, the
    parameters within 1e-2 x lr (a few elements of a leaf may move on a
    gradient known only to float32 rounding: at most 3%, within 0.1 x
    lr), as the CPU tests hold the CPU path against JAX."""
    _need_card()
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg, state, crit, TR = _train_setup(dev)
        step = TR.make_train_step(cfg, state.model, crit)
        losses = [float(step(state, *_train_clip(40 + i, dev))[1])
                  for i in range(3)]
        runs[dev] = (losses, {k: v.cpu() for k, v in
                              state.model.state_dict().items()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    lr = 1e-3
    for k, v in runs["cpu"][1].items():
        d = (runs["cuda"][1][k] - v).abs()
        far = d > 1e-2 * lr
        assert int(far.sum()) <= 0.03 * d.numel() and float(d.max()) < \
            0.1 * lr, (k, int(far.sum()), float(d.max()))


@pytest.mark.cuda
def test_device_dataset_on_card_equals_cpu():
    from isosurfacesuperresolution_tpu_torch.data.dataset import VideoDataset
    from isosurfacesuperresolution_tpu_torch.train.device_data import (
        DeviceVideoDataset)
    _need_card()
    rng = np.random.RandomState(0)
    seqs = [{"low": rng.rand(4, 24, 24, 5).astype(np.float32),
             "high": rng.rand(4, 96, 96, 6).astype(np.float32),
             "flow": rng.rand(4, 24, 24, 2).astype(np.float32)}
            for _ in range(3)]
    samples = VideoDataset(seqs).collect_samples(
        12, 8, 0.0, np.random.RandomState(1))
    for store in (torch.float32, torch.bfloat16):
        got = list(DeviceVideoDataset(seqs, store_dtype=store).batches(
            samples, 4, 8, rng=np.random.RandomState(2)))
        want = list(DeviceVideoDataset(seqs, store_dtype=store,
                                       device="cpu").batches(
            samples, 4, 8, rng=np.random.RandomState(2)))
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.is_cuda and x.dtype == torch.float32
                assert torch.equal(x.cpu(), y)


@pytest.mark.cuda
def test_sn_wgan_gp_discriminator_step_card_matches_cpu():
    """A discriminator step with spectrally normalized critics and the
    gradient penalty (double backward on the card): loss and scores rel
    1e-4, every critic gradient finite."""
    _need_card()
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, state, crit, TR = _train_setup(
            dev, "l1:mask:1,adv:all:0.3,tgan:all:0.2", sn=True,
            gan="wgan-gp")
        d_step, g_step = TR.make_adv_train_steps(cfg, state.model, crit)
        batch = _train_clip(50, dev)
        _, dl, gs, ps = d_step(state, *batch, (0, 7))
        _, gl = g_step(state, *batch)
        out[dev] = [float(v) for v in (dl, gs, ps, gl)]
        assert all(bool(torch.isfinite(p).all())
                   for p in crit.discriminators.parameters())
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# slice 9b: the shaded trainer and the parallel layer on the card
# ---------------------------------------------------------------------------

def _shaded_setup(device):
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, TrainConfig)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as TS
    cfg = Config(model=ModelConfig(num_residual_blocks=2, num_features=16,
                                   input_channels=8, output_channels=3,
                                   channel_mask=(0, 1, 2)),
                 loss=LossConfig(losses="l1:1,temp-l2:0.1", padding=4),
                 train=TrainConfig(batch_size=2, crop_size=16, num_frames=3,
                                   learning_rate=1e-3))
    gen = torch.Generator().manual_seed(16)
    model = create_network(cfg.model, generator=gen).to(device)
    crit = LossNet(cfg.loss, 64, 8, 3, losses=cfg.loss.losses)
    state = TS.create_shaded_train_state(cfg, model, crit,
                                         TR.make_optimizer(cfg), gen)
    return cfg, state, TS.make_shaded_train_step(cfg, model, crit)


def _shaded_clip(seed, device):
    rng = np.random.RandomState(seed)
    low = rng.rand(2, 3, 16, 16, 8).astype(np.float32)
    low[..., 3] = low[..., 3] > 0.3
    flow = (rng.rand(2, 3, 16, 16, 2).astype(np.float32) - 0.5) * 0.1
    high = np.repeat(np.repeat(low[..., :3], 4, 2), 4, 3)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (low, flow, high)]


@pytest.mark.cuda
def test_shaded_train_steps_card_match_cpu():
    """Shaded training from one seeded state, card vs CPU: the first
    step's gradient of every leaf within 5e-4 of the leaf's largest |g|
    (float32 BPTT sums in another order; up to 2.2e-4 measured on an
    H100) and the losses of three Adam steps at rel 1e-4.  The parameters
    themselves are not compared: Adam's first steps move every element by
    about lr whatever its gradient's size, so a gradient known only to
    float32 rounding (27 of block0_conv1's 2304 are below 1e-6 of its
    largest with these seeds) can send an element lr the other way."""
    _need_card()
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        fp32_convs)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
    from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as TS
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg, state, step = _shaded_setup(dev)
        crit = LossNet(cfg.loss, 64, 8, 3, losses=cfg.loss.losses)
        with fp32_convs():
            loss, _ = TS.make_shaded_clip_loss(cfg, state.model, crit)(
                *_shaded_clip(60, dev))
            grads = torch.autograd.grad(loss, state.optimizer.params)
        losses = [float(step(state, *_shaded_clip(60 + i, dev))[1])
                  for i in range(3)]
        runs[dev] = (losses, [g.cpu() for g in grads])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for g_card, g_cpu in zip(runs["cuda"][1], runs["cpu"][1]):
        scale = float(g_cpu.abs().max())
        np.testing.assert_allclose(g_card.numpy(), g_cpu.numpy(), rtol=0,
                                   atol=5e-4 * scale)


@pytest.fixture
def nccl_group(tmp_path):
    """A one-process nccl group on the card, destroyed after the test."""
    _need_card()
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "rdv"), world_size=1, rank=0,
        device_id=torch.device("cuda", 0))
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_sharded_step_equals_the_plain_step(nccl_group):
    """At world 1 the data-parallel step (its all-reduce on the card) is
    the plain step, under `test_train_steps_card_match_cpu`'s bounds (the
    card's float32 conv backward need not repeat itself bit for bit)."""
    from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_train_step)
    mesh = make_mesh(1)
    out = []
    for sharded in (False, True):
        cfg, state, step = _shaded_setup("cuda")
        if sharded:
            step = make_sharded_train_step(step, mesh)
        losses = [float(step(state, *_shaded_clip(70 + i, "cuda"))[1])
                  for i in range(2)]
        out.append((losses, state.model.state_dict()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4)
    lr = 1e-3
    for k, v in out[0][1].items():
        d = (out[1][1][k] - v).abs()
        far = d > 1e-2 * lr
        assert int(far.sum()) <= 0.03 * d.numel() and float(d.max()) < \
            0.1 * lr, (k, int(far.sum()), float(d.max()))


@pytest.mark.cuda
def test_one_rank_nccl_sharded_sweep_and_cameras(nccl_group):
    """The slab sweep at D = 1 (no halo sends; the combine's all-reduces
    on the card), from the grid on the card and from a copy on the host,
    equals the single-device scan on the card, and the multi-camera
    render equals per-camera renders, all bit for bit."""
    import dataclasses
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
        make_mesh, render_cameras_sharded)
    from isosurfacesuperresolution_tpu_torch.parallel.sharded_sweep import (
        render_gbuffer_sweep_sharded)
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.sweep import (
        render_gbuffer_sweep)
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    grid = attach_baked_ao(analytic.blobs_volume(62, num_blobs=5), 0.5, 0.1)
    host = dataclasses.replace(grid, values=grid.values.cpu(),
                               brick_min=grid.brick_min.cpu(),
                               brick_max=grid.brick_max.cpu(),
                               ao_sh=grid.ao_sh.cpu())
    cam = CameraParams.create((0.3, 0.8, -1.7))
    for ao in (0, 64):
        cfg = RenderConfig(width=48, height=40, isovalue=0.5, ao_samples=ao,
                           ao_mode="volume" if ao else "auto")
        want = render_gbuffer_sweep(grid, cam, cam, cfg)
        for g in (grid, host):
            got = render_gbuffer_sweep_sharded(g, cam, cam, cfg,
                                               make_mesh(1, axis_name="z"))
            assert got.device == want.device and torch.equal(got, want)
    eyes = torch.tensor([[1.7, 0.7, 0.0], [0.0, 0.7, -1.7]])
    looks, ups = torch.zeros(2, 3), torch.tensor([[0.0, 1.0, 0.0]] * 2)
    cfg = RenderConfig(width=32, height=24, isovalue=0.5,
                       renderer="sweep_pallas")
    frames = render_cameras_sharded(grid, eyes, looks, ups, cfg,
                                    make_mesh(1))
    for i in range(2):
        c = CameraParams.create(eyes[i], looks[i], ups[i])
        assert torch.equal(frames[i], render_frame_gbuffer(grid, c, c, cfg))


@pytest.mark.cuda
def test_pipe_server_on_the_card():
    """The port's render server in a child process on the card, over the
    pipe protocol: each frame bit for bit the in-process render of the
    same camera (the same march kernel on the same card), and nothing but
    frames on the stream."""
    _need_card()
    import os

    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.infer.pipe_client import (
        PipeRenderer)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    eyes = [(0.0, 1.0, -1.7), (0.31, 0.95, -1.62)]
    r = PipeRenderer.local_server("analytic:blobs:64", 96, 64,
                                  renderer="sweep_pallas", cwd=root)
    try:
        frames = []
        for eye in eyes:
            r.send_command("cameraOrigin", ",".join(map(repr, eye)))
            frames.append(r.render())
        r.proc.stdin.write(b"exit\n")
        r.proc.stdin.flush()
        assert r.proc.wait(timeout=120) == 0
        assert r.proc.stderr.read() == b""
    finally:
        r.close()
    assert r.output[0] == "Enter Pipe mode and wait for commands"
    grid = analytic.blobs_volume(64, device="cuda")
    cfg = RenderConfig(width=96, height=64, ao_samples=0,
                       renderer="sweep_pallas")
    cams = [CameraParams.create(e, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0)
            for e in eyes]
    for i, got in enumerate(frames):
        want = render_frame_gbuffer(grid, cams[i], cams[max(i - 1, 0)], cfg,
                                    RenderParams.from_config(cfg))
        assert (got[..., 3] > 0.5).any()
        np.testing.assert_array_equal(got, want.cpu().numpy())
