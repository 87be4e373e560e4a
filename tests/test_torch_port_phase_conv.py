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
