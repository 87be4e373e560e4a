"""Shared pieces of the training parity tests: configurations built from
the same keywords in both packages, JAX parameter trees carried into the
port's modules, seeded clips, and a JAX "optimizer" that hands back the
gradients (so that a test can read `make_train_step`'s own gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isosurfacesuperresolution_tpu import config as jconfig
from isosurfacesuperresolution_tpu_torch import config as pconfig
from isosurfacesuperresolution_tpu_torch.models.generators import (
    params_from_flax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread.  The suite runs several
    worker processes at once, each with an OpenMP pool as wide as the
    machine; under that oversubscription the trainer's many small CPU ops
    wait for descheduled pool threads (the CPU entry point took 6 s alone
    and over 250 s beside five busy workers; on one thread, 6 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(model=None, loss=None, train=None):
    """(JAX Config, port Config) from the same keywords."""
    out = []
    for mod in (jconfig, pconfig):
        out.append(mod.Config(model=mod.ModelConfig(**(model or {})),
                              loss=mod.LossConfig(**(loss or {})),
                              train=mod.TrainConfig(**(train or {}))))
    return tuple(out)


def tiny(model=None, loss=None, train=None):
    """The tiny training setup of the tests: 2 blocks x 8 features, batch
    2, crop 8 (32 high-res), 3 frames, loss border 2."""
    return configs(
        model={"num_residual_blocks": 2, "num_features": 8, **(model or {})},
        loss={"padding": 2, **(loss or {})},
        train={"batch_size": 2, "crop_size": 8, "num_frames": 3,
               "learning_rate": 2e-3, **(train or {})})


def clip(seed, b=2, t=3, h=8, u=4, flow_scale=0.05):
    """A seeded clip (numpy): low (b, t, h, h, 5) with mask in {-1, 1},
    flow (b, t, h, h, 2), high (b, t, u*h, u*h, 6) the upsampled low with
    noise, AO in [0, 1]."""
    rng = np.random.RandomState(seed)
    low = rng.rand(b, t, h, h, 5).astype(np.float32)
    low[..., 0] = np.sign(low[..., 0] - 0.3)
    low[..., 1:4] = low[..., 1:4] * 2 - 1
    flow = (rng.rand(b, t, h, h, 2).astype(np.float32) * 2 - 1) * flow_scale
    high = np.repeat(np.repeat(low, u, axis=2), u, axis=3)
    high = np.concatenate(
        [high + 0.05 * rng.randn(*high.shape).astype(np.float32),
         rng.rand(b, t, u * h, u * h, 1).astype(np.float32)], -1)
    high[..., 0] = np.clip(high[..., 0], -1, 1)
    return low, flow, high.astype(np.float32)


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def load_flax(module, variables):
    """Carry a Flax variables tree into ``module`` (strict)."""
    module.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables),
        getattr(module, "cfg", None)))
    return module


def carry_criterion(criterion, jparams):
    """Carry JAX's criterion params (``discr`` per name, ``vgg``) into the
    port's `LossNetUnshaded`."""
    for name, tree in jparams.get("discr", {}).items():
        load_flax(criterion.discriminators[name], tree)
    if jparams.get("vgg") is not None:
        load_flax(criterion.vgg, jparams["vgg"])
    return criterion


def flax_flat(tree):
    """A pytree -> {"/".join(key path): numpy leaf}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in leaves}


def port_layout(tree, cfg_model=None):
    """A Flax-shaped pytree (params, grads, Adam moments) -> the port's
    names and layouts."""
    return {k: v.numpy() for k, v in
            params_from_flax(flax_flat(tree), cfg_model).items()}


def grad_catcher():
    """An optax transformation whose state becomes the gradients and
    whose update is zero."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def find_state(opt_state, cls):
    """The first node of type ``cls`` in an optax state."""
    found = []

    def visit(x):
        if isinstance(x, cls):
            found.append(x)
        return x
    jax.tree_util.tree_map(visit, opt_state,
                           is_leaf=lambda x: isinstance(x, cls))
    return found[0]


def assert_params_close(pmodel, jparams, lr, cfg_model):
    """Every parameter within 1e-2 x lr of JAX's, but for a few elements
    (at most 3% of a leaf) that Adam's normalized step moves on a
    gradient known only to the gradient tolerance; those are named and
    held to 0.1 x lr."""
    want = port_layout(jparams, cfg_model)
    named = {}
    for n, p in pmodel.state_dict().items():
        d = np.abs(p.numpy() - want[n])
        far = d > 1e-2 * lr
        if far.any():
            named[n] = (int(far.sum()), d.size, float(d.max() / lr))
    print("leaves with elements beyond 1e-2 x lr (count, size, max/lr):",
          named)
    for n, (count, size, worst) in named.items():
        assert count <= 0.03 * size and worst < 0.1, (n, count, size,
                                                      worst)
