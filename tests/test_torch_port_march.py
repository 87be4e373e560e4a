"""The port's sweep march (plain version and wrapper) vs the JAX package's
Pallas march kernel in interpret mode, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.render.sweep_pallas import march_pallas
from isosurfacesuperresolution_tpu_torch.render import sweep_march

from _torch_port_inputs import CASES, SN, TN, make_inputs


@pytest.mark.parametrize("store,mm", CASES)
def test_march_plain_matches_pallas_interpret(store, mm):
    vol, meta, sg, tg, scale, offset = make_inputs(store)
    ref = march_pallas(jnp.asarray(vol), jnp.asarray(meta), jnp.asarray(sg),
                       jnp.asarray(tg), SN, TN, interpret=True,
                       dtype=jnp.dtype(mm), scale=scale, offset=offset)
    ref = [np.asarray(r) for r in ref]
    got = sweep_march.march_plain(
        torch.from_numpy(vol), torch.from_numpy(meta), torch.from_numpy(sg),
        torch.from_numpy(tg), SN, TN, dtype=getattr(torch, mm),
        scale=scale, offset=offset)
    got = [g.numpy() for g in got]
    m_ref, m_got = ref[0], got[0]
    # the inputs cross on the border rows/columns and after the skipped
    # slice, so the periodic roll and the Fm1 reset are both exercised
    assert ((m_ref[-1] > 0) & (ref[2][-1] != 0)).any()
    assert ((m_ref[0] > 0) & (ref[3][0] != 0)).any()
    assert (m_ref == 4).any()
    # both sides round the same operands at the same points and sum the
    # two non-zero taps in float32, so the hit slice agrees exactly; frac
    # and the gradients carry float32 rounding of O(1) values (1e-5)
    np.testing.assert_array_equal(m_got, m_ref)
    for name, a, b in zip(("frac", "g_s", "g_t", "g_z"), got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_march_wrapper_runs_plain_on_cpu_without_counting():
    vol, meta, sg, tg, scale, offset = make_inputs("bfloat16")
    args = (torch.from_numpy(vol), torch.from_numpy(meta),
            torch.from_numpy(sg), torch.from_numpy(tg), SN, TN)
    before = sweep_march.march.launches
    got = sweep_march.march(*args, dtype=torch.bfloat16)
    want = sweep_march.march_plain(*args, dtype=torch.bfloat16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sweep_march.march.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_volume_is_slice_major_contiguous(dtype):
    """The sweep hands the march a permuted view of the (X, Y, Z) grid;
    the kernel reads raw slice-major memory, so the wrapper must copy a
    view even when its type already fits."""
    grid = torch.from_numpy(
        np.random.RandomState(0).rand(5, 4, 3).astype(np.float32))
    view = grid.permute(2, 0, 1)
    vol = sweep_march.kernel_volume(view, dtype)
    assert vol.is_contiguous() and vol.dtype == dtype
    torch.testing.assert_close(vol, view.to(dtype), rtol=0, atol=0)
    same = view.contiguous()
    if dtype == torch.float32:
        assert sweep_march.kernel_volume(same, dtype) is same
    u8 = (view * 255).to(torch.uint8)
    assert sweep_march.kernel_volume(u8, dtype).is_contiguous()
