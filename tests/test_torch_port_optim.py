"""The port's optimizers vs optax as the JAX trainer builds them
(`train/trainer.make_optimizer`): adam, rmsprop and rprop, each with and
without `clip_by_global_norm`, over a fixed sequence of five gradient
trees, with the per-epoch learning rate set between steps as
`set_learning_rate` sets it.  (Without the clip, JAX's
`set_learning_rate` raises: it walks the bare `InjectHyperparamsState`, a
named tuple, as a tuple of its fields; the test sets the injected rate
as it means to.)

Tolerance: rel 1e-6 on parameters and optimizer states.  Both compute the
same float32 operations in the same order; only the global norm's sum
and libm's pow/sqrt may round the last place differently.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import configs, find_state
from isosurfacesuperresolution_tpu.train import trainer as JT
from isosurfacesuperresolution_tpu_torch.train import trainer as PT

SHAPES = {"a": (3, 3, 2, 4), "b": (4,), "c": (5, 2)}
RTOL = 1e-6


def grad_trees(seed, n=5):
    """Five gradient trees whose global norms straddle the clip (1.0),
    with a sign flip per element between steps 2 and 3 for rprop."""
    rng = np.random.RandomState(seed)
    out = []
    for i, scale in enumerate((0.05, 3.0, 0.4, 2.0, 0.02)):
        g = {k: (rng.randn(*s) * scale / np.sqrt(np.prod(s))).astype(
            np.float32) for k, s in SHAPES.items()}
        if i == 2:
            g = {k: -v for k, v in out[-1].items()}
        if i == 3:
            g["b"][:2] = 0.0
        out.append(g)
    return out


def states(rule, opt_state):
    if rule == "adam":
        s = find_state(opt_state, optax.ScaleByAdamState)
        return {"mu": s.mu, "nu": s.nu}, int(s.count)
    if rule == "rmsprop":
        s = find_state(opt_state, optax.ScaleByRmsState)
        return {"nu": s.nu}, None
    s = find_state(opt_state, optax.ScaleByRpropState)
    return {"step_sizes": s.step_sizes, "prev_updates": s.prev_updates}, None


@pytest.mark.parametrize("rule", ["adam", "rmsprop", "rprop"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_optimizer_matches_optax(rule, clip):
    jcfg, pcfg = configs(train={"optimizer": rule, "grad_clip": clip,
                                "learning_rate": 3e-3, "lr_step": 2,
                                "lr_gamma": 0.5})
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = JT.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    popt = PT.make_optimizer(pcfg).init(pparams)
    for step, g in enumerate(grad_trees(1)):
        lr = JT.epoch_learning_rate(jcfg, step)
        assert PT.epoch_learning_rate(pcfg, step) == lr
        if clip:
            JT.set_learning_rate(jstate, lr)
        else:
            # JAX's set_learning_rate walks a bare InjectHyperparamsState
            # as a tuple of its fields and raises; set it as it would
            jstate.hyperparams["learning_rate"] = jnp.asarray(lr)
        PT.set_learning_rate(popt, lr)
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        popt.step([torch.from_numpy(g[k]) for k in popt.names])
        for k in SHAPES:
            np.testing.assert_allclose(
                pparams[k].numpy(), np.asarray(jparams[k]), rtol=RTOL,
                atol=RTOL * float(np.abs(np.asarray(jparams[k])).max()),
                err_msg=f"{rule} clip {clip} step {step} param {k}")
        want, count = states(rule, jstate)
        if count is not None:
            assert popt.count == count
        for name, tree in want.items():
            for i, k in enumerate(popt.names):
                w = np.asarray(tree[k])
                np.testing.assert_allclose(
                    popt.state[name][i].numpy(), w, rtol=RTOL,
                    atol=RTOL * max(float(np.abs(w).max()), 1e-30),
                    err_msg=f"{rule} clip {clip} step {step} {name} {k}")


def test_rprop_first_update_is_zero_and_lr_sets_only_initial_steps():
    """optax.scale_by_rprop returns the previous step's update, so the
    first step moves nothing; injecting another learning rate later does
    not change its step sizes (they were set at init)."""
    _, pcfg = configs(train={"optimizer": "rprop", "grad_clip": 0.0,
                             "learning_rate": 0.01})
    p = {"w": torch.ones(3)}
    opt = PT.make_optimizer(pcfg).init(p)
    opt.step([torch.tensor([1.0, -1.0, 0.0])])
    assert torch.equal(p["w"], torch.ones(3))
    PT.set_learning_rate(opt, 5.0)
    opt.step([torch.tensor([1.0, -1.0, 0.0])])
    np.testing.assert_allclose(p["w"].numpy(), [0.99, 1.01, 1.0], rtol=1e-6)


def test_unknown_optimizer_raises_like_jax():
    jcfg, pcfg = configs(train={"optimizer": "sgd"})
    with pytest.raises(ValueError) as want:
        JT.make_optimizer(jcfg)
    with pytest.raises(ValueError) as got:
        PT.make_optimizer(pcfg)
    assert str(got.value) == str(want.value)


def test_optimizer_state_round_trip():
    _, pcfg = configs(train={"optimizer": "adam"})
    p = {"w": torch.zeros(4), "v": torch.zeros(2, 2)}
    opt = PT.make_optimizer(pcfg).init(p)
    for i in range(3):
        opt.step([torch.full((4,), float(i + 1)), torch.ones(2, 2)])
    sd = opt.state_dict()
    q = {"w": torch.zeros(4), "v": torch.zeros(2, 2)}
    opt2 = PT.make_optimizer(pcfg).init(q)
    opt2.load_state_dict(sd)
    assert opt2.count == 3 and opt2.learning_rate == opt.learning_rate
    for a, b in zip(opt.state["nu"], opt2.state["nu"]):
        assert torch.equal(a, b)
