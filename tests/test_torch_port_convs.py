"""The port's 3x3 convs vs the JAX package's: the 128-lane conv (B6,
`conv3x3_pallas_p128`) and the pixel-pair packed conv (B7,
`packed_conv3x3`) through their plain versions against the Pallas kernels
in TPU interpret mode, their helpers bit for bit, `conv3x3_packed`, and the
dispatcher `conv3x3` on the CPU, on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from isosurfacesuperresolution_tpu.ops import packed_conv as JP
from isosurfacesuperresolution_tpu.ops import pallas_conv as JC
from isosurfacesuperresolution_tpu_torch import ops as port_ops
from isosurfacesuperresolution_tpu_torch.ops import packed_conv as PP
from isosurfacesuperresolution_tpu_torch.ops import pallas_conv as PC

H, W = 10, 16           # H is not a multiple of the Pallas band height 4
TH = 4


def _inputs(seed, shape, cout, exact=False):
    """x (shape), w (3, 3, C, cout), b (cout,).  ``exact``: multiples of
    1/8 and 1/16, bf16-exact, whose products and sums are exact in
    float32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    if exact:
        x = rng.randint(-8, 8, shape) / 8.0
        w = rng.randint(-4, 4, (3, 3, c, cout)) / 16.0
        b = rng.randint(-4, 4, cout) / 4.0
    else:
        x = rng.rand(*shape) - 0.5
        w = (rng.rand(3, 3, c, cout) - 0.5) * 0.1
        b = rng.rand(cout) - 0.5
    return x.astype(np.float32), w.astype(np.float32), b.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref, out):
    """bf16 x bf16 products are exact in float32 on both sides; the sums
    (up to 9 * 256 terms) differ only in order, float32 rounding of a few
    ulps of the largest partial sums: 1e-5 of the output's scale.  A bf16
    output may then round the other way: one bf16 step, at most 2^-7 of
    the value."""
    tol = 1e-5 * np.abs(ref).max()
    if out == "bfloat16":
        tol = tol + 2.0 ** -7 * np.abs(ref)
    d = np.abs(got - ref)
    assert (d <= tol).all(), d.max()


def _b6_jax(x, w, b, **kw):
    with pltpu.force_tpu_interpret_mode():
        y = JC.conv3x3_pallas_p128(*_j(x, w, b), th=TH, **kw)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c,cout", [(128, 128), (128, 256), (256, 128),
                                    (256, 256)])
def test_conv3x3_p128_plain_matches_pallas(c, cout, relu, out):
    x, w, b = _inputs(c + cout, (1, H, W, c), cout)
    ref = _b6_jax(x, w, b, relu=relu, out_dtype=jnp.dtype(out))
    got = PC.conv3x3_pallas_p128(*_t(x, w, b), relu=relu,
                                 out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape == (1, H, W, cout)
    if relu:
        assert (got >= 0).all() and (got == 0).mean() > 0.2
    _close(got, ref, out)


@pytest.mark.parametrize("c,cout", [(128, 256), (256, 128)])
def test_conv3x3_p128_plain_exact_inputs(c, cout):
    """Dyadic inputs whose products and sums are exact in float32: the
    two implementations agree bit for bit."""
    x, w, b = _inputs(1, (1, H, W, c), cout, exact=True)
    ref = _b6_jax(x, w, b, relu=True, out_dtype=jnp.float32)
    got = PC.conv3x3_p128_plain(*_t(x, w, b), relu=True,
                                out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pad_lanes_and_pairs_match_jax():
    rng = np.random.RandomState(2)
    x = rng.rand(1, 3, 8, 64).astype(np.float32)
    w = rng.rand(3, 3, 40, 72).astype(np.float32)
    for axis, a in ((-1, x), (2, w), (3, w)):
        np.testing.assert_array_equal(
            PC.pad_lanes(torch.from_numpy(a), axis=axis).numpy(),
            np.asarray(JC.pad_lanes(jnp.asarray(a), axis=axis)))
    full = torch.zeros((1, 2, 8, 256))
    assert PC.pad_lanes(full) is full             # already 128-aligned
    packed = PC.pack_pairs(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JC.pack_pairs(jnp.asarray(x))))
    for c in (64, 40):
        np.testing.assert_array_equal(
            PC.unpack_pairs(packed, c).numpy(),
            np.asarray(JC.unpack_pairs(jnp.asarray(packed.numpy()), c)))
    for pk, jpk in ((PP.pack_pairs, JP.pack_pairs),
                    (PP.unpack_pairs, JP.unpack_pairs)):
        np.testing.assert_array_equal(pk(torch.from_numpy(x)).numpy(),
                                      np.asarray(jpk(jnp.asarray(x))))


@pytest.mark.parametrize("cout", [64, 48])
def test_pack_weights_pairs_matches_jax(cout):
    _, w, _ = _inputs(3, (1, 2, 2, 64), cout)
    got = PC.pack_weights_pairs(torch.from_numpy(w), 64, 64)
    ref = np.asarray(JC.pack_weights_pairs(jnp.asarray(w), 64, 64))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,relu", [(True, False), (False, True)])
def test_conv3x3_packed_matches_jax(bias, relu, dtype):
    """`conv3x3_packed`: B6 on pair-packed weights (JAX's Pallas kernel in
    interpret mode; the port's plain version on the CPU)."""
    x, w, b = _inputs(4, (1, H, W, 64), 64)
    with pltpu.force_tpu_interpret_mode():
        ref = JC.conv3x3_packed(jnp.asarray(x).astype(jnp.dtype(dtype)),
                                jnp.asarray(w),
                                jnp.asarray(b) if bias else None, relu=relu)
    got = PC.conv3x3_packed(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w),
                            torch.from_numpy(b) if bias else None, relu=relu)
    assert got.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape == (1, H, W, 64)
    _close(got.to(torch.float32).numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [16, 13])
def test_conv3x3_dispatch_on_cpu_matches_jax(width, dtype):
    """On the CPU both packages take their stock conv (JAX's backend is not
    a TPU, the port's tensors are not on the card), W % 8 or not: operands
    in ``x.dtype``, float32 products and sums, bias, ReLU, cast."""
    x, w, b = _inputs(5, (1, 7, width, 24), 40)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert jax.default_backend() == "cpu"
    for bias, relu in ((True, True), (False, False)):
        ref = JC.conv3x3(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                         jnp.asarray(b) if bias else None, relu=relu)
        got = port_ops.conv3x3(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w),
                               torch.from_numpy(b) if bias else None,
                               relu=relu)
        assert got.dtype == tdt and got.shape == (1, 7, width, 40)
        _close(got.to(torch.float32).numpy(),
               np.asarray(ref.astype(jnp.float32)), dtype)


def _b7_jax(x, k, b, **kw):
    y = JP.packed_conv3x3(JP.pack_pairs(jnp.asarray(x)), *_j(k, b), th=TH,
                          interpret=True, **kw)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_packed_conv3x3_plain_matches_pallas(relu, out):
    x, k, b = _inputs(6, (1, H, W, 64), 64)
    ref = _b7_jax(x, k, b, relu=relu, out_dtype=jnp.dtype(out))
    got = PP.packed_conv3x3(PP.pack_pairs(torch.from_numpy(x)), *_t(k, b),
                            relu=relu, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    got = got.to(torch.float32).numpy()
    assert got.shape == ref.shape == (1, H, W // 2, 128)
    _close(got, ref, out)


def test_packed_conv3x3_plain_exact_inputs():
    x, k, b = _inputs(7, (1, H, W, 64), 64, exact=True)
    ref = _b7_jax(x, k, b, relu=True, out_dtype=jnp.float32)
    got = PP.packed_conv3x3_plain(PP.pack_pairs(torch.from_numpy(x)),
                                  *_t(k, b), relu=True,
                                  out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pack_weights_matches_jax():
    _, k, _ = _inputs(8, (1, 2, 2, 64), 64)
    wc, we = PP.pack_weights(torch.from_numpy(k))
    jwc, jwe = JP._pack_weights(jnp.asarray(k))
    assert wc.dtype == we.dtype == torch.bfloat16
    assert wc.shape == (3, 128, 128) and we.shape == (3, 2, 128, 128)
    for got, ref in ((wc, jwc), (we, jwe)):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_packed_plain_equals_direct_conv_of_unpacked():
    """What the CUDA kernel computes, a direct conv of the unpacked
    (H, W, 64) memory, equals the phase-matrix plain version (exact zero
    blocks; float32 sums in another order)."""
    x, k, b = _inputs(9, (1, 5, 12, 64), 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    kb = torch.from_numpy(k).to(torch.bfloat16).to(torch.float32)
    direct = torch.relu(PC.conv3x3_f32(xb[0].to(torch.float32), kb)
                        + torch.from_numpy(b))
    got = PP.packed_conv3x3_plain(PP.pack_pairs(xb), torch.from_numpy(k),
                                  torch.from_numpy(b), relu=True,
                                  out_dtype=torch.float32)
    _close(PP.unpack_pairs(got)[0].numpy(), direct.numpy(), "float32")


def test_conv_wrappers_run_plain_on_cpu_without_counting():
    x, w, b = _t(*_inputs(10, (1, 4, 16, 128), 128))
    xp, k3, b3 = _t(*_inputs(11, (1, 4, 8, 128), 64))
    k3, b3 = k3[:, :, :64], b3
    before = (PC.conv3x3_p128_kernel.launches,
              PP.packed_conv3x3_kernel.launches)
    torch.testing.assert_close(PC.conv3x3_pallas_p128(x, w, b, relu=True),
                               PC.conv3x3_p128_plain(x, w, b, relu=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(PP.packed_conv3x3(xp, k3, b3),
                               PP.packed_conv3x3_plain(xp, k3, b3),
                               rtol=0, atol=0)
    assert PC.conv3x3_packed(x[..., :64], w[:, :, :64, :64],
                             b[:64]).shape == (1, 4, 16, 64)
    assert port_ops.conv3x3(x, w, b).shape == (1, 4, 16, 128)
    assert (PC.conv3x3_p128_kernel.launches,
            PP.packed_conv3x3_kernel.launches) == before


@pytest.mark.parametrize("bad", ["channels", "width", "weights", "bias"])
def test_conv3x3_p128_refuses_what_jax_asserts(bad):
    x, w, b = _t(*_inputs(12, (1, 4, 8, 128), 128))
    args = {"channels": (x[..., :64], w[:, :, :64], b),
            "width": (x[:, :, :6], w, b),
            "weights": (x, w[:, :2], b),
            "bias": (x, w, b[:64])}[bad]
    with pytest.raises(ValueError):
        PC.conv3x3_pallas_p128(*args)
    with pytest.raises(ValueError):
        PP.packed_conv3x3(x[..., :64], w[:, :, :64, :64], b[:64])
