"""The port's generator zoo and EnhanceNet options vs the JAX package's
Flax modules, and its bicubic resize vs `jax.image.resize`.

Every network is small (2 blocks, 8-16 features, a 12x16 input).  Its
weights come from the Flax module's own ``init`` (batch statistics, BN
scales and biases randomized from a numpy seed), go through
`params_from_flax`, and load strictly into the port's module; the same
numpy-seeded input runs through both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.models import generators as JG
from isosurfacesuperresolution_tpu.ops.resize import resize as jresize
from isosurfacesuperresolution_tpu_torch.config import ModelConfig
from isosurfacesuperresolution_tpu_torch.models import generators as G
from isosurfacesuperresolution_tpu_torch.ops.resize import (
    bicubic_matrix, resize)
from isosurfacesuperresolution_tpu_torch.utils.spectral_norm import (
    SpectralNormalizedModule)

SMALL = dict(num_residual_blocks=2, num_features=16)

# name -> (ModelConfig keywords, RCAN groups/blocks or None)
CASES = {
    "enhancenet_bilinear": (dict(SMALL), None),
    "enhancenet_bn": (dict(SMALL, use_bn=True), None),
    "enhancenet_sn": (dict(SMALL, use_sn=True), None),
    "enhancenet_pixelshuffle": (dict(SMALL, upsample="pixelShuffle"), None),
    "enhancenet_bicubic": (dict(SMALL, upsample="bicubic"), None),
    "enhancenet_fused_bilinear": (dict(SMALL, fused_upsample=True), None),
    "enhancenet_fused_nearest": (dict(SMALL, fused_upsample=True,
                                      upsample="nearest"), None),
    # bicubic ignores fused_upsample, as in JAX
    "enhancenet_fused_bicubic": (dict(SMALL, fused_upsample=True,
                                      upsample="bicubic"), None),
    "enhancenet_bn_direct": (dict(SMALL, use_bn=True, recon_type="direct",
                                  num_features=8), None),
    "rcan": (dict(SMALL, model="RCAN"), (2, 2)),
    "rcan_sn": (dict(SMALL, model="RCAN", use_sn=True), (1, 2)),
    "tecogan": (dict(SMALL, model="TecoGAN"), None),
    "tecogan_sn": (dict(SMALL, model="TecoGAN", use_sn=True), None),
    "subpixelnet": (dict(model="SubpixelNet"), None),
}


def _randomize_bn(variables, rng):
    """Batch statistics and BN affine parameters away from their init."""
    out = jax.tree_util.tree_map(np.asarray, variables)
    out = jax.tree_util.tree_map(lambda a: a.copy(), out)
    for layer, stats in out.get("batch_stats", {}).items():
        n = stats["mean"].shape[0]
        stats["mean"] = rng.normal(0, 0.5, n).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        out["params"][layer]["scale"] = rng.uniform(0.5, 1.5, n).astype(
            np.float32)
        out["params"][layer]["bias"] = rng.normal(0, 0.2, n).astype(
            np.float32)
    return out


def _jax_module(kw, groups):
    jcfg = JModelConfig(**kw)
    if groups is None:
        return jcfg, JG.create_network(jcfg)
    module = JG.RCAN(cfg=jcfg, num_groups=groups[0], num_blocks=groups[1])
    if jcfg.use_sn:
        from isosurfacesuperresolution_tpu.utils.spectral_norm import (
            SpectralNormalizedModule as JSN)
        module = JSN(module)
    return jcfg, module


def _port_module(kw, groups):
    cfg = ModelConfig(**kw)
    if groups is None:
        return cfg, G.create_network(cfg)
    net = G.RCAN(cfg, num_groups=groups[0], num_blocks=groups[1])
    return cfg, (SpectralNormalizedModule(net) if cfg.use_sn else net)


def _pair(name, seed=0):
    kw, groups = CASES[name]
    jcfg, jnet = _jax_module(kw, groups)
    cfg, net = _port_module(kw, groups)
    cin = G.network_input_channels(cfg)
    assert cin == JG.network_input_channels(jcfg)
    variables = jnet.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, 8, 8, cin), jnp.float32))
    variables = _randomize_bn(variables, np.random.RandomState(seed + 1))
    net.load_state_dict(G.params_from_flax(variables, cfg))   # strict
    net.eval()
    return jnet, variables, net, cin


@pytest.mark.parametrize("name", sorted(CASES))
def test_generator_matches_flax(name):
    """Both outputs of each generator; float32 on both sides, conv sums
    in different orders (XLA vs oneDNN): 1e-4 absolute on outputs of
    O(1), as `test_torch_port_network.py` holds run00017."""
    jnet, variables, net, cin = _pair(name)
    x = np.random.RandomState(7).normal(size=(2, 12, 16, cin)).astype(
        np.float32)
    ref = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got[0].shape == ref[0].shape
    assert got[0].shape[1:3] == (48, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-4, rtol=0)
    if ref[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-4, rtol=0)


def test_state_dict_maps_flax_one_to_one():
    """One state entry per Flax array, BN statistics and Dense kernels
    included; TecoGAN's transposed kernels are the Flax ones flipped."""
    for name in ("enhancenet_bn", "rcan", "tecogan"):
        _, variables, net, _ = _pair(name)
        n_arrays = len(jax.tree_util.tree_leaves(variables))
        assert len(net.state_dict()) == n_arrays
    k = np.asarray(variables["params"]["up1"]["kernel"])        # HWIO
    np.testing.assert_array_equal(
        net.state_dict()["up1.weight"].numpy(),
        k[::-1, ::-1].transpose(2, 3, 0, 1))


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_fused_matches_unfused_in_the_interior(method):
    """The port's fused EnhanceNet against its unfused one on the same
    weights: equal in the interior; the high-res conv's 1-px border
    (edge-clamped vs zero-padded) reaches ~6 px inward through the post
    convs, as in JAX's own test."""
    cfg0 = ModelConfig(upsample=method, **SMALL)
    cfg1 = dataclasses.replace(cfg0, fused_upsample=True)
    n0, n1 = G.create_network(cfg0), G.create_network(cfg1)
    assert n0.state_dict().keys() == n1.state_dict().keys()
    torch.manual_seed(0)
    n1.load_state_dict(n0.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(
        2, 12, 16, G.network_input_channels(cfg0)).astype(np.float32))
    with torch.no_grad():
        d = (n0(x)[0] - n1(x)[0]).abs()
    assert float(d[:, 8:-8, 8:-8].max()) < 1e-4
    assert float(d.max()) > 1e-3          # the border does differ


@pytest.mark.parametrize("shape", [(12, 16, 48, 64), (5, 7, 20, 28),
                                   (12, 16, 13, 35)])
def test_bicubic_resize_matches_jax(shape):
    """Keys' a = -0.5 with the outside taps dropped and renormalized, as
    `jax.image.resize(..., "cubic")`: borders included, 1e-6 (float32
    products of four taps summed in another order)."""
    h, w, H, W = shape
    x = np.random.RandomState(3).rand(2, h, w, 3).astype(np.float32)
    got = resize(torch.from_numpy(x), size=(H, W), method="bicubic")
    ref = np.asarray(jresize(jnp.asarray(x), size=(H, W), method="bicubic"))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # not torch's bicubic (a = -0.75, clamped edges)
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(H, W),
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert float((torch_bicubic - got).abs().max()) > 1e-2
    np.testing.assert_allclose(bicubic_matrix(h, H).sum(1), 1.0, atol=1e-6)


def test_bicubic_resize_refuses_downsampling():
    with pytest.raises(ValueError, match="only upsampling"):
        resize(torch.zeros((1, 8, 8, 1)), size=(4, 8), method="bicubic")


def test_unknown_model_and_upsample_raise():
    with pytest.raises(ValueError, match="Unknown model"):
        G.create_network(ModelConfig(model="UNet"))
    with pytest.raises(ValueError, match="unknown upsample"):
        G.create_network(ModelConfig(upsample="lanczos"))


def test_fused_kernels_are_composed_once():
    """The fused stages compose their low-res kernels at the first forward
    and reuse them (no per-frame composition or host-to-device copy of
    the stencil); writing the weights composes them again."""
    cfg = ModelConfig(fused_upsample=True, **SMALL)
    net = G.create_network(cfg)
    x = torch.from_numpy(np.random.RandomState(1).rand(
        1, 6, 6, G.network_input_channels(cfg)).astype(np.float32))
    with torch.no_grad():
        first = net(x)[0]
        kernels = {k: v[1] for k, v in net._fused.items()}
        assert sorted(kernels) == ["post1", "post2"]
        assert torch.equal(net(x)[0], first)
        assert all(net._fused[k][1] is v for k, v in kernels.items())
        state = net.state_dict()
        state["post1.weight"] = state["post1.weight"] * 2
        net.load_state_dict(state)
        assert float((net(x)[0] - first).abs().max()) > 1e-3
        assert net._fused["post1"][1] is not kernels["post1"]
