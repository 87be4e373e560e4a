"""The port's adversarial round and its generator initialisation vs the
JAX package's.

- One discriminator/generator round of `make_adv_train_steps` (bce, and
  wgan-gp with spectrally normalized critics), on JAX's initial
  parameters carried across: the critics' loss and scores, their
  parameters after the discriminator step, the generator's loss and
  parameters after the generator step.
- C3, the generators' initialisation: a fresh 10x64 EnhanceNet keeps its
  trunk's activation std within JAX's bound
  (`tests/test_train.py::test_trunk_variance_bounded_at_full_depth`), every
  leaf's std matches JAX's initialiser within sampling error, and the block
  kernels are orthogonal with JAX's gains.

Tolerances.  The round: losses and scores rel 1e-5 (1e-4 for the generator
loss, taken after the critics' update), parameters within 1e-2 x lr but
for a few named elements (see `tests/test_torch_port_train.py`).  Init:
each std within 5 standard errors of the sample std (1/sqrt(2n)) plus 2%;
the orthogonality to 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import (
    assert_params_close, carry_criterion, clip, load_flax, port_layout,
    tiny, to_torch)
from isosurfacesuperresolution_tpu.losses.lossnet_unshaded import (
    LossNetUnshaded as JLossNetUnshaded)
from isosurfacesuperresolution_tpu.models import generators as JG
from isosurfacesuperresolution_tpu.train import trainer as JT
from isosurfacesuperresolution_tpu_torch.config import ModelConfig
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models import generators as PG
from isosurfacesuperresolution_tpu_torch.train import trainer as PT
from isosurfacesuperresolution_tpu_torch.utils import jax_prng

ADV_CASES = {
    "bce": ({"losses": "l1:mask:1,l1:normal:10,temp-l2:color:0.1,"
                       "adv:all:0.3"}, False),
    "wgan-gp sn": ({"losses": "l1:mask:1,l1:normal:10,adv:all:0.3,"
                              "tgan:all:0.2", "gan_type": "wgan-gp"}, True),
}


@pytest.mark.parametrize("case", sorted(ADV_CASES))
def test_adversarial_round_matches_jax(case):
    loss_kw, sn = ADV_CASES[case]
    jcfg, pcfg = tiny(loss=loss_kw)
    res = 32
    jmodel = JG.create_network(jcfg.model)
    jcrit = JLossNetUnshaded(jcfg.loss, high_res=res, use_spectral_norm=sn)
    opt, dopt = JT.make_optimizer(jcfg), JT.make_optimizer(jcfg)
    jstate = JT.create_train_state(jcfg, jmodel, jcrit, opt,
                                   jax.random.PRNGKey(0),
                                   discr_optimizer=dopt)
    jd, jg = JT.make_adv_train_steps(jcfg, jmodel, jcrit, opt, dopt)

    pmodel = load_flax(PG.create_network(pcfg.model), jstate.params)
    pcrit = LossNetUnshaded(pcfg.loss, high_res=res, use_spectral_norm=sn)
    spec = PT.make_optimizer(pcfg)
    pstate = PT.create_train_state(pcfg, pmodel, pcrit, spec,
                                   discr_optimizer=spec)
    carry_criterion(pcrit, jstate.aux_params)
    pd, pg = PT.make_adv_train_steps(pcfg, pmodel, pcrit)

    low, flow, high = clip(30)
    jstate, jdl, jgs, jps = jd(jstate, low, flow, high,
                               jax.random.PRNGKey(5))
    pstate, pdl, pgs, pps = pd(pstate, *to_torch(low, flow, high),
                               jax_prng.prng_key(5))
    for got, want, what in ((pdl, jdl, "discr loss"), (pgs, jgs, "real"),
                            (pps, jps, "fake")):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=what)
    lr = jcfg.train.learning_rate
    for name, d in pcrit.discriminators.items():
        assert_params_close(d, jstate.discr_params[name], lr, None)
    jstate, jgl = jg(jstate, low, flow, high)
    pstate, pgl = pg(pstate, *to_torch(low, flow, high))
    np.testing.assert_allclose(float(pgl), float(jgl), rtol=1e-4)
    assert_params_close(pmodel, jstate.params, lr, jcfg.model)
    assert pstate.discr_optimizer.count == 1 and pstate.optimizer.count == 1


# ---------------------------------------------------------------------------
# C3: initialisation
# ---------------------------------------------------------------------------

def recorded_forward(model, x):
    """Run ``model`` recording each conv's output by layer name."""
    out = {}
    conv = model._conv

    def record(name, y):
        r = conv(name, y)
        out[name] = r
        return r

    model._conv = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        del model._conv
    return out


def test_trunk_variance_bounded_at_full_depth():
    """JAX's regression test on a fresh port EnhanceNet (10 x 64): the
    trunk's activation std stays within 6x the pre-conv's (the reference's
    full-gain init grew it 0.17 -> 29), and the post-upsample gates are
    alive."""
    cfg = ModelConfig(num_residual_blocks=10, num_features=64)
    gen = torch.Generator().manual_seed(0)
    model = PG.create_network(cfg, generator=gen)
    cin = PG.network_input_channels(cfg)
    x = torch.randn((2, 16, 16, cin), generator=gen) * 0.3
    inter = recorded_forward(model, x)
    pre_std = float(inter["pre"].std())
    stds = {k: float(v.std()) for k, v in inter.items()
            if k.startswith("block")}
    assert len(stds) == 20
    assert max(stds.values()) < 6.0 * pre_std, (pre_std, stds)
    for gate in ("post1", "post2", "post3"):
        frac = float((inter[gate] > 0).float().mean())
        assert frac > 0.05, (gate, frac)


ZOO = {
    "EnhanceNet": dict(num_residual_blocks=4, num_features=32),
    "EnhanceNet pixelShuffle": dict(num_residual_blocks=2, num_features=16,
                                    upsample="pixelShuffle"),
    "TecoGAN": dict(model="TecoGAN", num_residual_blocks=4,
                    num_features=32),
    "SubpixelNet": dict(model="SubpixelNet"),
    "RCAN": dict(model="RCAN", num_features=32),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_init_distributions_match_jax(name):
    """Each leaf's std against JAX's own init of the same net (sampling
    error), biases equal (zero; EnhanceNet's AO output bias 1)."""
    from isosurfacesuperresolution_tpu.config import ModelConfig as JMC
    kw = ZOO[name]
    cin = PG.network_input_channels(ModelConfig(**kw))
    gen = torch.Generator().manual_seed(1)
    if kw.get("model") == "RCAN":
        jnet = JG.RCAN(cfg=JMC(**kw), num_groups=2, num_blocks=2)
        pnet = PG.RCAN(ModelConfig(**kw), num_groups=2, num_blocks=2,
                       generator=gen)
    else:
        jnet = JG.create_network(JMC(**kw))
        pnet = PG.create_network(ModelConfig(**kw), generator=gen)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, cin)))
    want = port_layout(jparams, ModelConfig(**kw))
    got = pnet.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith("bias"):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        n = w.size
        tol = 5.0 / math.sqrt(2 * n) + 0.02
        assert abs(g.std() / w.std() - 1) < 2 * tol, (k, g.std(), w.std())
        assert abs(g.mean()) < 5 * w.std() / math.sqrt(n) + 1e-3, k


def test_block_kernels_are_orthogonal_with_jax_gains():
    cfg = ModelConfig(num_residual_blocks=10, num_features=64)
    model = PG.create_network(cfg, generator=torch.Generator().manual_seed(2))
    branch = 1.0 / math.sqrt(10)
    for i in range(10):
        for conv, gain in (("conv1", math.sqrt(2.0)),
                           ("conv2", math.sqrt(2.0) * branch)):
            w = getattr(model, f"block{i}_{conv}").weight.detach()
            m = w.permute(2, 3, 1, 0).reshape(-1, 64).double()   # HWIO
            np.testing.assert_allclose(
                (m.t() @ m).numpy(), gain ** 2 * np.eye(64), atol=1e-5)
    # lecun-normal elsewhere: pre's std is sqrt(1 / fan_in)
    pre = model.pre.weight.detach()
    fan_in = pre.shape[1] * 9
    assert abs(float(pre.std()) * math.sqrt(fan_in) - 1) < 0.03
    np.testing.assert_array_equal(model.out.bias.detach().numpy(),
                                  [0, 0, 0, 0, 0, 1])


def test_generator_seed_gives_the_same_weights():
    cfg = ModelConfig(num_residual_blocks=2, num_features=8)
    a = PG.create_network(cfg, generator=torch.Generator().manual_seed(5))
    b = PG.create_network(cfg, generator=torch.Generator().manual_seed(5))
    c = PG.create_network(cfg, generator=torch.Generator().manual_seed(6))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.pre.weight, c.pre.weight)
