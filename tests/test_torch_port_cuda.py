"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: without a card these tests skip (decided inside each
test).  On a machine with one: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT

from isosurfacesuperresolution_tpu_torch.volume import packed as PP

from _torch_port_inputs import (CASES, SN, TILE, TN, TSN, TTN, make_ao_field,
                                make_inputs, make_packed_ao_field,
                                make_packed_inputs, make_tiled_ao_field,
                                make_tiled_inputs)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(11, 21), (37, 45)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_phase_conv_kernel_matches_plain(relu, out, shape):
    _need_card()
    rng = np.random.RandomState(5)
    h, w = shape           # partial tiles on both axes
    x = torch.from_numpy((rng.rand(1, h, w, 256) - 0.5).astype(np.float32))
    k3 = torch.from_numpy(((rng.rand(3, 3, 64, 64) - 0.5) * 0.2
                           ).astype(np.float32))
    bias = torch.from_numpy((rng.rand(64) - 0.5).astype(np.float32))
    xb = x.to(torch.bfloat16)
    before = pc.phase_conv.launches
    got = pc.phase_conv3x3_amajor_blocked(
        xb.cuda(), k3.cuda(), bias.cuda(), relu=relu,
        out_dtype=getattr(torch, out))
    torch.cuda.synchronize()
    assert pc.phase_conv.launches == before + 1
    want = pc.phase_conv_plain(xb, k3, bias, relu=relu,
                               out_dtype=getattr(torch, out))
    got, want = got.cpu().to(torch.float32), want.to(torch.float32)
    # exact bf16 products, float32 sums in another order (2e-5 on O(1)
    # sums); a bf16 output may round the other way, one step (2^-7 rel.)
    tol = 2e-5 + (2.0 ** -7 * want.abs() if out == "bfloat16" else 0.0)
    assert bool(((got - want).abs() <= tol).all()), \
        float((got - want).abs().max())


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
