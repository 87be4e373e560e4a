"""The port's trainer vs the JAX package's `train/trainer.py` on a tiny
setup (2 blocks x 8 features, batch 2, crop 8 -> 32, 3 frames, the
default loss DSL): the clip loss and the gradient of every parameter leaf
(temporal, ``disable_temporal``, ``remat``, and ``use_bn``, whose running
statistics JAX's optimizer trains too), three Adam steps, `make_eval_step`
and `make_predict_clip`, and step three after JAX's parameters and Adam
state are carried across after two JAX steps.  JAX's gradients are read
from `make_train_step` itself, through an optax transformation whose
state becomes the gradients.

Tolerances.  Loss values: rel 1e-5 for one clip (float32 sums of the
same terms through float32 convs, oneDNN against XLA); after steps, rel
1e-4.  Gradients: 1e-4 of each leaf's largest |g| (BPTT through three
frames sums many float32 products in another order).  Parameters after
Adam steps: within 1e-2 x lr.  An Adam step is lr * m^/(sqrt(v^) + eps),
about lr in size whatever the gradient's scale, so an element whose
gradient is small against its leaf's (known to 1e-4 of the leaf's
largest), or whose L1 residual changes sign after the first step, can
move differently; the test names the leaves holding such elements and
bounds them (at most 3% of a leaf, each within 0.1 x lr; measured after
three steps: 27 of pre.weight's 7272 elements, 4-10 of the 576 in three
block convs and 1 in post3, up to 0.064 x lr).  Eval
and predict: 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import (
    assert_params_close, carry_criterion, clip, grad_catcher, load_flax,
    port_layout, tiny, to_torch)
from isosurfacesuperresolution_tpu.losses.lossnet_unshaded import (
    LossNetUnshaded as JLossNetUnshaded)
from isosurfacesuperresolution_tpu.models.generators import (
    create_network as j_create_network)
from isosurfacesuperresolution_tpu.train import trainer as JT
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network)
from isosurfacesuperresolution_tpu_torch.train import trainer as PT


def setup(jcfg, pcfg, optimizer=None):
    """JAX's fresh train state and the port's model and criterion carried
    from it."""
    res = jcfg.train.crop_size * jcfg.model.upscale_factor
    jmodel = j_create_network(jcfg.model)
    jcrit = JLossNetUnshaded(jcfg.loss, high_res=res)
    opt = optimizer or JT.make_optimizer(jcfg)
    jstate = JT.create_train_state(jcfg, jmodel, jcrit, opt,
                                   jax.random.PRNGKey(0))
    pmodel = load_flax(create_network(pcfg.model), jstate.params)
    pcrit = carry_criterion(LossNetUnshaded(pcfg.loss, high_res=res),
                            jstate.aux_params)
    return jmodel, jcrit, opt, jstate, pmodel, pcrit


VARIANTS = {
    "temporal": {},
    "disable_temporal": {"train": {"disable_temporal": True}},
    "remat": {"train": {"remat": True}},
    "use_bn": {"model": {"use_bn": True}},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_clip_loss_and_gradients_match_jax(variant):
    jcfg, pcfg = tiny(**VARIANTS[variant])
    catcher = grad_catcher()
    jmodel, jcrit, _, jstate, pmodel, pcrit = setup(jcfg, pcfg, catcher)
    low, flow, high = clip(1)
    step = JT.make_train_step(jcfg, jmodel, jcrit, catcher)
    new, jloss = step(jstate, low, flow, high)
    want = port_layout(new.opt_state, jcfg.model)
    loss, _ = PT.make_clip_loss(pcfg, pmodel, pcrit)(
        *to_torch(low, flow, high))
    names, params = zip(*pmodel.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(names) == sorted(want)
    if variant == "use_bn":
        assert any("running_mean" in n for n in names)
    for n, g in zip(names, grads):
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(g.numpy(), want[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def test_three_train_steps_match_jax():
    jcfg, pcfg = tiny()
    jmodel, jcrit, opt, jstate, pmodel, pcrit = setup(jcfg, pcfg)
    jstep = JT.make_train_step(jcfg, jmodel, jcrit, opt)
    pstate = PT.create_train_state(pcfg, pmodel, pcrit,
                                   PT.make_optimizer(pcfg))
    pstep = PT.make_train_step(pcfg, pmodel, pcrit)
    for i in range(3):
        low, flow, high = clip(10 + i)
        jstate, jloss = jstep(jstate, low, flow, high)
        pstate, ploss = pstep(pstate, *to_torch(low, flow, high))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert pstate.step == int(jstate.step) == 3
    assert pstate.optimizer.count == 3
    assert_params_close(pmodel, jstate.params, jcfg.train.learning_rate,
                        jcfg.model)


def test_spike_guard_skips_the_step_before_it_is_taken():
    """``accept`` sees the loss before the optimizer step; on False the
    parameters, the Adam state and the step count stay as they were."""
    _, pcfg = tiny()
    pmodel = create_network(pcfg.model, generator=torch.Generator())
    pcrit = LossNetUnshaded(pcfg.loss, high_res=32)
    pstate = PT.create_train_state(pcfg, pmodel, pcrit,
                                   PT.make_optimizer(pcfg))
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    seen = []
    step = PT.make_train_step(pcfg, pmodel, pcrit)
    _, loss = step(pstate, *to_torch(*clip(3)),
                   accept=lambda l: seen.append(float(l)) or False)
    assert seen == [float(loss)] and pstate.step == 0
    assert pstate.optimizer.count == 0
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    step(pstate, *to_torch(*clip(3)), accept=lambda l: True)
    assert pstate.step == 1


def test_eval_step_and_predict_clip_match_jax():
    jcfg, pcfg = tiny()
    jmodel, jcrit, _, jstate, pmodel, pcrit = setup(jcfg, pcfg)
    low, flow, high = clip(4)
    jl, jp = JT.make_eval_step(jcfg, jmodel, jcrit)(
        jstate.params, jstate.aux_params, low, flow, high)
    pl, pp = PT.make_eval_step(pcfg, pmodel, pcrit)(
        *to_torch(low, flow, high))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pp), float(jp), rtol=1e-5)
    want = np.asarray(JT.make_predict_clip(jcfg, jmodel)(jstate.params, low,
                                                         flow))
    got = PT.make_predict_clip(pcfg, pmodel)(*to_torch(low, flow)).numpy()
    assert got.shape == want.shape == (2, 3, 32, 32, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_clamp_output_matches_jax():
    x = np.random.RandomState(5).randn(2, 4, 4, 6).astype(np.float32) * 3
    x[0, 0, 0, 1:4] = 0.0
    np.testing.assert_allclose(
        PT.clamp_output(torch.from_numpy(x)).numpy(),
        np.asarray(JT.clamp_output(x)), rtol=0, atol=1e-6)


def test_step_three_after_carrying_jax_state_across():
    """Two JAX Adam steps; its parameters and Adam state (mu, nu, count)
    carried into the port; step three in both."""
    import optax

    from _torch_port_training import find_state
    jcfg, pcfg = tiny()
    jmodel, jcrit, opt, jstate, pmodel, pcrit = setup(jcfg, pcfg)
    jstep = JT.make_train_step(jcfg, jmodel, jcrit, opt)
    for i in range(2):
        jstate, _ = jstep(jstate, *clip(20 + i))
    load_flax(pmodel, jstate.params)
    pstate = PT.create_train_state(pcfg, pmodel, pcrit,
                                   PT.make_optimizer(pcfg))
    adam = find_state(jstate.opt_state, optax.ScaleByAdamState)
    pstate.optimizer.load_optax_state(
        count=int(adam.count), mu=port_layout(adam.mu, jcfg.model),
        nu=port_layout(adam.nu, jcfg.model))
    low, flow, high = clip(22)
    jstate, jloss = jstep(jstate, low, flow, high)
    pstate, ploss = PT.make_train_step(pcfg, pmodel, pcrit)(
        pstate, *to_torch(low, flow, high))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4)
    assert pstate.optimizer.count == 3
    assert_params_close(pmodel, jstate.params, jcfg.train.learning_rate,
                        jcfg.model)
