"""The port's EnhanceNet with the trained run00017 weights (10 blocks x 64
features, full width) vs the Flax model the JAX package loads from the
same run directory."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)

RUN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                   "run00017")


@pytest.fixture(scope="module")
def models():
    return (JLoadedModel.from_run_dir(RUN),
            LoadedModel.from_run_dir(RUN, device="cpu"))


def test_params_from_flax_maps_every_array(models):
    jlm, lm = models
    with np.load(os.path.join(RUN, "params.npz")) as z:
        n_arrays = len(z.files)
    state = params_from_flax(jlm.params)        # the nested Flax tree
    assert n_arrays == len(state) == 50
    assert set(state) == set(lm.model.state_dict())
    k = np.asarray(jlm.params["params"]["pre"]["kernel"])     # HWIO
    np.testing.assert_array_equal(state["pre.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))


def test_enhancenet_matches_flax(models):
    jlm, lm = models
    m = lm.cfg.model
    assert (m.num_residual_blocks, m.num_features) == (10, 64)
    cin = lm.model.pre.in_channels
    x = np.random.RandomState(0).normal(size=(1, 12, 16, cin)
                                        ).astype(np.float32)
    ref_recon, ref_out = (np.asarray(a) for a in
                          jlm.model.apply(jlm.params, jnp.asarray(x)))
    with torch.no_grad():
        recon, out = lm.model(torch.from_numpy(x))
    assert recon.shape == ref_recon.shape == (1, 48, 64, 6)
    # float32 on both sides through 26 convs; XLA's and oneDNN's conv
    # algorithms sum in different orders: 1e-4 absolute on outputs of O(1)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-4, rtol=0)
    np.testing.assert_allclose(recon.numpy(), ref_recon, atol=1e-4, rtol=0)


def test_enhancenet_nearest_upsample_matches_flax():
    """The other ported upsampling mode, on a small numpy-seeded net."""
    from isosurfacesuperresolution_tpu.config import (
        ModelConfig as JModelConfig)
    from isosurfacesuperresolution_tpu.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.config import ModelConfig
    kw = dict(num_residual_blocks=1, num_features=8, upsample="nearest")
    net = EnhanceNet(ModelConfig(**kw))
    rng = np.random.RandomState(1)
    tree = {"params": {}}
    for name, conv in net.named_children():
        cout, cin_, kh, kw_ = conv.weight.shape
        tree["params"][name] = {
            "kernel": rng.normal(0, (kh * kw_ * cin_) ** -0.5,
                                 (kh, kw_, cin_, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32)}
    net.load_state_dict(params_from_flax(tree))
    x = rng.normal(size=(1, 5, 6, net.pre.in_channels)).astype(np.float32)
    ref, _ = create_network(JModelConfig(**kw)).apply(
        {"params": {k: {kk: jnp.asarray(v) for kk, v in d.items()}
                    for k, d in tree["params"].items()}}, jnp.asarray(x))
    with torch.no_grad():
        got, _ = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
