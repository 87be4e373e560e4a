"""The port's phase conv (plain version and wrapper) vs the JAX package's
two Pallas phase-conv kernels in interpret mode, on the same numpy-seeded
inputs, and vs the port's own dense planar tail conv."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.ops.phase_conv import (
    phase_conv3x3_amajor, phase_conv3x3_amajor_blocked)
from isosurfacesuperresolution_tpu_torch.infer.planar import (
    _amajor_cols, planar_tail_conv)
from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc

SITES = {
    "amajor": lambda *a, **k: phase_conv3x3_amajor(*a, th=4, **k),
    "blocked": lambda *a, **k: phase_conv3x3_amajor_blocked(*a, th=4, wb=8,
                                                             **k),
}


def _inputs(seed, h, w, exact=False):
    rng = np.random.RandomState(seed)
    if exact:
        # multiples of 1/8 and 1/16: bf16-exact, products and sums exact
        x = rng.randint(-8, 8, (1, h, w, 256)) / 8.0
        k3 = rng.randint(-4, 4, (3, 3, 64, 64)) / 16.0
        bias = rng.randint(-4, 4, 64) / 4.0
    else:
        x = rng.rand(1, h, w, 256) - 0.5
        k3 = (rng.rand(3, 3, 64, 64) - 0.5) * 0.2
        bias = rng.rand(64) - 0.5
    return (x.astype(np.float32), k3.astype(np.float32),
            bias.astype(np.float32))


def _port(x, k3, bias, **kw):
    return pc.phase_conv_plain(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(k3), torch.from_numpy(bias),
                               **kw).to(torch.float32).numpy()


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("site", sorted(SITES))
def test_phase_conv_plain_matches_pallas(site, relu, out):
    # odd sizes: the Pallas kernels pad rows and columns to their blocks
    x, k3, bias = _inputs(2, 11, 21)
    ref = SITES[site](jnp.asarray(x, jnp.bfloat16), jnp.asarray(k3),
                      jnp.asarray(bias), relu=relu,
                      out_dtype=jnp.dtype(out), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = _port(x, k3, bias, relu=relu, out_dtype=getattr(torch, out))
    assert got.shape == ref.shape == (1, 11, 21, 256)
    if relu:
        assert (got >= 0).all() and (got == 0).mean() > 0.2
    # bf16 x bf16 products are exact in float32 on both sides; the 576-term
    # sums differ only in order (float32 rounding of O(1) sums, 2e-5).  A
    # bf16 output may then round the other way: one bf16 step, at most
    # 2^-7 of the value
    tol = 2e-5 + (2.0 ** -7 * np.abs(ref) if out == "bfloat16" else 0.0)
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("site", sorted(SITES))
def test_phase_conv_plain_exact_inputs(site):
    """bf16-exact inputs whose products and sums are exact in float32: the
    two implementations must agree bit for bit."""
    x, k3, bias = _inputs(1, 6, 8, exact=True)
    ref = np.asarray(SITES[site](jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(k3), jnp.asarray(bias),
                                 out_dtype=jnp.float32, interpret=True))
    got = _port(x, k3, bias, out_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)


def test_phase_conv_plain_equals_dense_tail_up_to_layout():
    """A-major in, B-major out: the same function as the port's dense planar
    tail conv (c-major in and out) on the same bf16 operands."""
    x_c, k3, bias = _inputs(3, 5, 7)
    amaj = _amajor_cols(64)
    comp = amaj[pc.bmajor_from_amajor_cols()]     # x_B = x_C[..., comp]
    xb = torch.from_numpy(x_c).to(torch.bfloat16)
    k3b = torch.from_numpy(k3).to(torch.bfloat16).to(torch.float32)
    dense = planar_tail_conv(xb.to(torch.float32), k3b,
                             torch.from_numpy(bias), torch.float32)
    got = pc.phase_conv_plain(xb[..., torch.from_numpy(amaj)],
                              torch.from_numpy(k3), torch.from_numpy(bias),
                              out_dtype=torch.float32)
    # float32 sums in another order: 2e-5 on O(1) values
    torch.testing.assert_close(got, dense[..., torch.from_numpy(comp)],
                               rtol=0, atol=2e-5)


def test_bmajor_perm_is_block_transpose():
    perm = pc.bmajor_from_amajor_cols()
    assert sorted(perm.tolist()) == list(range(256))
    # B-major block (b, a) holds A-major block (a, b)
    assert perm[64 * 1] == 64 * 2 and perm[64 * 2] == 64 * 1
    assert (perm[:64] == np.arange(64)).all()


def test_phase_conv_wrappers_run_plain_on_cpu_without_counting():
    x, k3, bias = (torch.from_numpy(a) for a in _inputs(4, 3, 5))
    before = pc.phase_conv.launches
    want = pc.phase_conv_plain(x, k3, bias, relu=True)
    for fn in (pc.phase_conv3x3_amajor, pc.phase_conv3x3_amajor_blocked):
        got = fn(x, k3, bias, relu=True)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pc.phase_conv.launches == before
    with pytest.raises(ValueError, match=r"\(1, H, W, 256\)"):
        pc.phase_conv(x[..., :128], k3, bias)


def _views():
    """The low-res decomposition the kernel runs: output phase p = b*2 + a
    reads tap (d, e) from input chunk a'*2+b' at the low-res shift (di,
    dj), with (di, a') = divmod(a + d - 1, 2) and (dj, b') = divmod(b + e -
    1, 2).  {(chunk, di, dj): [(p, d, e), ...]} in the kernel's view order
    (below)."""
    views = {}
    for p in range(4):
        a, b = p & 1, p >> 1
        for d in range(3):
            for e in range(3):
                di, ap = divmod(a + d - 1, 2)
                dj, bp = divmod(b + e - 1, 2)
                views.setdefault((ap * 2 + bp, di, dj), []).append((p, d, e))
    # the kernel's view v = 4 chunk + 2 (dj + b') + (di + a')
    return dict(sorted(views.items(), key=lambda kv: (
        4 * kv[0][0] + 2 * (kv[0][2] + kv[0][0] % 2)
        + kv[0][1] + kv[0][0] // 2)))


def _views_eval(x, k3, bias, relu=False):
    """The kernel's decomposition evaluated in plain torch (float64): for
    each of the 16 views, its input chunk shifted by (di, dj) at the low
    resolution (zero outside) times the tap of each phase it feeds, from
    the kernel's operands, summed into the phases' B-major output
    channels; then bias and ReLU."""
    w, b4 = pc.kernel_operands(k3, bias)
    w = w.to(torch.float64)
    xf = x.to(torch.bfloat16).to(torch.float64)[0]
    h, wd, _ = xf.shape
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    y = torch.zeros((h, wd, 256), dtype=torch.float64)
    for (chunk, di, dj), uses in _views().items():
        view = xp[1 + di:1 + di + h, 1 + dj:1 + dj + wd,
                  64 * chunk:64 * chunk + 64]
        for p, d, e in uses:
            y[..., 64 * p:64 * p + 64] += view @ w[d, e]
    y = y + b4.to(torch.float64)
    return (torch.relu(y) if relu else y)[None]


def test_view_table_covers_each_phase_and_tap_once():
    """16 views (chunk, di, dj) at shifts of at most one low-res pixel: four
    feed all four phases, eight two and four one, each (phase, tap) once;
    the kernel's first view, (0, 0, 0), feeds every phase, so its first
    MMAs zero all accumulators.  The kernel's operands: the bf16 taps in
    k3's own order and the bias once per B-major channel."""
    views = _views()
    assert len(views) == 16
    assert all(abs(di) <= 1 and abs(dj) <= 1 for _, di, dj in views)
    assert sorted(len(u) for u in views.values()) == [1] * 4 + [2] * 8 + [4] * 4
    first, uses = next(iter(views.items()))
    assert first == (0, 0, 0) and sorted(p for p, _, _ in uses) == [0, 1, 2, 3]
    pairs = [(p, 3 * d + e) for u in views.values() for p, d, e in u]
    assert sorted(pairs) == [(p, t) for p in range(4) for t in range(9)]
    k3, bias = torch.randn(3, 3, 64, 64), torch.randn(64)
    w, b4 = pc.kernel_operands(k3, bias)
    assert w.shape == (3, 3, 64, 64) and w.dtype == torch.bfloat16
    assert w.is_contiguous() and torch.equal(w, k3.to(torch.bfloat16))
    assert b4.dtype == torch.float32 and torch.equal(b4, bias.repeat(4))


def test_kernel_operands_are_made_once_per_weight_pair():
    """The planar tail calls B5 with the same post3 weights every frame:
    their bf16 taps and repeated bias are made once, and made anew once a
    tensor changes in place or another pair comes."""
    k3, bias = torch.randn(3, 3, 64, 64), torch.randn(64)
    ops = pc.kernel_operands(k3, bias)
    assert pc.kernel_operands(k3, bias) is ops
    assert pc.kernel_operands(k3.clone(), bias) is not ops
    bias.add_(1.0)
    again = pc.kernel_operands(k3, bias)
    assert again is not ops and torch.equal(again[1], bias.repeat(4))
    assert pc.kernel_operands(k3, bias) is again
    with torch.inference_mode():
        k3i, bi = torch.randn(3, 3, 64, 64), torch.randn(64)
        w, b4 = pc.kernel_operands(k3i, bi)
    assert torch.equal(w, k3i.to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 130)])
def test_view_table_matches_plain(shape):
    """The views and the kernel's operands, evaluated in plain torch on
    ragged shapes, give `phase_conv_plain`'s function (1e-5: float32 sums
    of O(1) values in another order on the plain side)."""
    h, w = shape
    x, k3, bias = (torch.from_numpy(a) for a in _inputs(7 + h, h, w))
    got = _views_eval(x, k3, bias, relu=True).to(torch.float32)
    want = pc.phase_conv_plain(x, k3, bias, relu=True,
                               out_dtype=torch.float32)
    assert got.shape == want.shape == (1, h, w, 256)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_view_table_matches_pallas_bit_for_bit():
    """On bf16-exact inputs whose sums are exact, the views equal the JAX
    package's blocked Pallas kernel (interpret mode) bit for bit."""
    x, k3, bias = _inputs(8, 9, 13, exact=True)
    ref = np.asarray(SITES["blocked"](jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(k3), jnp.asarray(bias),
                                      out_dtype=jnp.float32, interpret=True))
    got = _views_eval(torch.from_numpy(x), torch.from_numpy(k3),
                      torch.from_numpy(bias)).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
