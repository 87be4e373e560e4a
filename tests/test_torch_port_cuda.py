"""The CUDA march kernel vs its plain version, on the card.

Marked ``cuda``: without a card these tests skip (decided inside each
test).  On a machine with one: ``python -m pytest -m cuda
tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu_torch.render import sweep_march

from _torch_port_inputs import CASES, SN, TN, make_inputs


@pytest.mark.cuda
@pytest.mark.parametrize("store,mm", CASES)
def test_march_kernel_matches_plain(store, mm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
