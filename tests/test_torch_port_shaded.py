"""The port's shaded trainer vs the JAX package's on a tiny setup (2
blocks x 8 features, batch 2, crop 8 -> 32, 3 frames, 8 channels in and
3 out, loss border 2): the shaded loss DSL and its errors, every term of
`LossNet` and `train_discriminator` (bce, wgan, wgan-gp), `shade_clip`,
the clip loss and the gradient of every parameter leaf, three Adam steps,
and `main_video_shaded.main` on the CPU.  The discriminators and the VGG
are JAX's, carried into the port.

Tolerances.  Loss values: rel 1e-5 for one call or one clip (float32 sums
of the same terms, oneDNN against XLA); after Adam steps rel 1e-4, and
parameters by `assert_params_close` (`tests/test_torch_port_train.py`
states why).  Gradients: 1e-4 of each leaf's largest |g| (BPTT through
three frames sums many float32 products in another order).  The shaded
clip: 1e-6 (elementwise shading of the same float32 values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import (
    assert_params_close, carry_criterion, grad_catcher, load_flax,
    port_layout, tiny, to_torch)
from isosurfacesuperresolution_tpu.config import (
    ShadingConfig as JShadingConfig)
from isosurfacesuperresolution_tpu.losses import lossnet as JL
from isosurfacesuperresolution_tpu.models.generators import (
    create_network as j_create_network)
from isosurfacesuperresolution_tpu.train import trainer as JT
from isosurfacesuperresolution_tpu.train import trainer_shaded as JS
from isosurfacesuperresolution_tpu_torch.losses import lossnet as PL
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network)
from isosurfacesuperresolution_tpu_torch.train import trainer as PT
from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as PS

SHADED = {"input_channels": 8, "output_channels": 3,
          "channel_mask": (0, 1, 2)}
RES = 32


def shaded_tiny(losses="l1:1,temp-l2:0.1", train=None, loss=None):
    return tiny(model=SHADED, loss={"losses": losses, **(loss or {})},
                train=train)


def shaded_clip(seed, b=2, t=3, h=8, u=4, flow_scale=0.05):
    """A seeded shaded clip: low (b, t, h, h, 8) [rgb, mask in {0, 1},
    normal, depth], flow, high (b, t, u*h, u*h, 3) in [0, 1]."""
    rng = np.random.RandomState(seed)
    low = rng.rand(b, t, h, h, 8).astype(np.float32)
    low[..., 3] = (low[..., 3] > 0.3).astype(np.float32)
    low[..., 4:7] = low[..., 4:7] * 2 - 1
    flow = (rng.rand(b, t, h, h, 2).astype(np.float32) * 2 - 1) * flow_scale
    high = np.repeat(np.repeat(low[..., :3], u, axis=2), u, axis=3)
    high = np.clip(high + 0.05 * rng.randn(*high.shape), 0, 1)
    return low, flow, high.astype(np.float32)


def loss_inputs(seed):
    """gt, pred (2, 32, 32, 3), input_low (2, 8, 8, 8), prev_pred_warped
    (2, 32, 32, 4): the generator loss's arguments."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(2, RES, RES, 3).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    low = shaded_clip(seed, t=1)[0][:, 0]
    prev = np.concatenate([np.clip(gt + 0.05 * rng.randn(*gt.shape), 0, 1),
                           (rng.rand(2, RES, RES, 1) > 0.4)], -1)
    return gt, pred, low, prev.astype(np.float32)


def criteria(spec):
    """JAX's LossNet with its initialised parameters, and the port's with
    them carried across."""
    jcfg, pcfg = shaded_tiny(spec)
    jcrit = JL.LossNet(jcfg.loss, high_res=RES, input_channels=8,
                       output_channels=3, losses=spec)
    jparams = jcrit.init(jax.random.PRNGKey(0))
    pcrit = PL.LossNet(pcfg.loss, high_res=RES, input_channels=8,
                       output_channels=3, losses=spec)
    return jcrit, jparams, carry_criterion(pcrit, jparams)


@pytest.mark.parametrize("spec", [
    "l1:1,temp-l2:0.1", "mse,fft_mse:0.5,gdl:2", "l2:2, tl2:1,inverse_mse:3",
    "l1_loss:1,tgan:0.3", "twgan-gp:1,perceptual:0.1,texture:2",
    "wgan:0.5,l2_loss:1", ""])
def test_shaded_loss_dsl_matches_jax(spec):
    """Weights (``inverse_mse`` kept, ``mse`` defaulted to 0), the GAN
    kind and ``use_previous_image`` as JAX sets them."""
    assert PL.parse_shaded_loss_list(spec) == JL.parse_shaded_loss_list(spec)
    jcfg, pcfg = shaded_tiny(spec)
    j = JL.LossNet(jcfg.loss, RES, 8, 3, losses=spec)
    p = PL.LossNet(pcfg.loss, RES, 8, 3, losses=spec)
    assert p.weights == j.weights
    assert (p.gan_kind, p.use_previous_image) == (j.gan_kind,
                                                  j.use_previous_image)
    assert p.has_discriminator == (j.discriminator is not None)
    if p.has_discriminator:
        assert p.discr_channels == j.discr_channels


@pytest.mark.parametrize("spec,error", [("l1:1,bogus:2", "unknown loss"),
                                        ("l1:one", "could not convert")])
def test_shaded_loss_dsl_errors_match_jax(spec, error):
    jcfg, pcfg = shaded_tiny(spec)
    with pytest.raises(ValueError, match=error):
        JL.LossNet(jcfg.loss, RES, 8, 3, losses=spec)
    with pytest.raises(ValueError, match=error):
        PL.LossNet(pcfg.loss, RES, 8, 3, losses=spec)


TERMS = {
    "mse": "mse:1", "l1": "l1:1", "fft_mse": "fft_mse:0.5", "gdl": "gdl:2",
    "inverse_mse": "inverse_mse:3,l1:1", "perceptual": "perceptual:0.1",
    "texture": "texture:2", "adv_bce": "adv:0.3", "wgan": "wgan:0.4",
    "tgan": "tgan:0.3", "temp-l2": "temp-l2:0.1",
    "first_frame": "l1:1,temp-l2:0.1",
}


@pytest.mark.parametrize("term", sorted(TERMS))
def test_lossnet_terms_match_jax(term):
    """Each term of the generator loss, on the untrained critic and the
    seeded VGG (``first_frame``: no warped previous output, so temp-l2
    drops out)."""
    spec = TERMS[term]
    jcrit, jparams, pcrit = criteria(spec)
    gt, pred, low, prev = loss_inputs(3)
    if term == "first_frame":
        prev = None
    jtotal, jvalues = jcrit(jparams, gt, pred, low, prev)
    args = to_torch(gt, pred, low) + ((None,) if prev is None
                                      else to_torch(prev))
    with torch.no_grad():
        total, values = pcrit(*args)
    assert sorted(values) == sorted(jvalues)
    if term == "inverse_mse":
        assert "inverse_mse" in pcrit.weights and "inverse_mse" not in values
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k, v in jvalues.items():
        np.testing.assert_allclose(float(values[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("spec", ["adv:1", "wgan:1", "wgan-gp:1",
                                  "twgan-gp:1"])
def test_train_discriminator_matches_jax(spec):
    """The critic's loss and scores, and the loss's gradient w.r.t. the
    critic's parameters (wgan-gp: JAX's interpolation draw)."""
    jcrit, jparams, pcrit = criteria(spec)
    gt, pred, low, prev = loss_inputs(4)
    gt_m = np.concatenate([gt, prev[..., 3:]], -1)
    pred_m = np.concatenate([pred, prev[..., 3:]], -1)
    key = jax.random.PRNGKey(7)
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng

    def jloss(dparams):
        p = dict(jparams, discr={"adv": dparams})
        out = jcrit.train_discriminator(p, low, gt_m, prev, pred_m, prev,
                                        rng=key)
        return out[0], out
    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams["discr"]["adv"])
    discr = pcrit.discriminators["adv"]
    out = pcrit.train_discriminator(*to_torch(low, gt_m, prev, pred_m, prev),
                                    rng=jax_prng.prng_key(7))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)
    names, params = zip(*discr.named_parameters())
    grads = torch.autograd.grad(out[0], params)
    want = port_layout(jgrads)
    for n, g in zip(names, grads):
        scale = float(np.abs(want[n]).max())
        np.testing.assert_allclose(g.numpy(), want[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def test_shade_clip_matches_jax():
    from _torch_port_training import clip
    low, _, high = clip(6)
    # JAX's trainer spells its shading out in `apps/main_video_shaded.py`
    jcfg = JShadingConfig(ambient_color=(0.1,) * 3,
                          diffuse_color=(1.0,) * 3,
                          specular_color=(0.0,) * 3, enable_specular=False,
                          material_color=(1.0, 1.0, 1.0))
    pcfg = PS.TRAINING_SHADING
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jlo, jhi = JS.shade_clip(jnp.asarray(low), jnp.asarray(high), jcfg)
    lo, hi = PS.shade_clip(*to_torch(low, high), pcfg)
    assert lo.shape == (2, 3, 8, 8, 8) and hi.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=0,
                               atol=1e-6)


def setup(jcfg, pcfg, optimizer=None):
    """JAX's fresh shaded state and the port's model and criterion carried
    from it."""
    jmodel = j_create_network(jcfg.model)
    jcrit = JL.LossNet(jcfg.loss, RES, 8, 3, losses=jcfg.loss.losses)
    opt = optimizer or JT.make_optimizer(jcfg)
    jstate = JS.create_shaded_train_state(jcfg, jmodel, jcrit, opt,
                                          jax.random.PRNGKey(0))
    pmodel = load_flax(create_network(pcfg.model), jstate.params)
    pcrit = carry_criterion(
        PL.LossNet(pcfg.loss, RES, 8, 3, losses=pcfg.loss.losses),
        jstate.aux_params)
    return jmodel, jcrit, opt, jstate, pmodel, pcrit


VARIANTS = {
    "temporal": {},
    # the VGG to conv_3 (the terms test runs all 16 convs)
    "adv_perceptual": {"losses": "l1:1,temp-l2:0.1,tgan:0.2,perceptual:0.1",
                       "loss": {"perceptual_loss_layers":
                                "conv_1:0.026423,conv_3:0.00671"}},
    "disable_temporal": {"train": {"disable_temporal": True}},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_shaded_clip_loss_and_gradients_match_jax(variant):
    jcfg, pcfg = shaded_tiny(**VARIANTS[variant])
    catcher = grad_catcher()
    jmodel, jcrit, _, jstate, pmodel, pcrit = setup(jcfg, pcfg, catcher)
    low, flow, high = shaded_clip(1)
    step = JS.make_shaded_train_step(jcfg, jmodel, jcrit, catcher)
    new, jloss = step(jstate, low, flow, high)
    want = port_layout(new.opt_state, jcfg.model)
    loss, values0 = PS.make_shaded_clip_loss(pcfg, pmodel, pcrit)(
        *to_torch(low, flow, high))
    assert {"mse", "l1"} <= set(values0)
    names, params = zip(*pmodel.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(g.numpy(), want[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def test_three_shaded_train_steps_match_jax():
    jcfg, pcfg = shaded_tiny()
    jmodel, jcrit, opt, jstate, pmodel, pcrit = setup(jcfg, pcfg)
    jstep = JS.make_shaded_train_step(jcfg, jmodel, jcrit, opt)
    pstate = PS.create_shaded_train_state(pcfg, pmodel, pcrit,
                                          PT.make_optimizer(pcfg))
    pstep = PS.make_shaded_train_step(pcfg, pmodel, pcrit)
    for i in range(3):
        low, flow, high = shaded_clip(10 + i)
        jstate, jloss = jstep(jstate, low, flow, high)
        pstate, ploss = pstep(pstate, *to_torch(low, flow, high))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert pstate.step == int(jstate.step) == 3
    assert_params_close(pmodel, jstate.params, jcfg.train.learning_rate,
                        jcfg.model)


def test_shaded_state_refuses_an_unshaded_network():
    _, pcfg = tiny()
    _, scfg = shaded_tiny()
    model = create_network(pcfg.model, generator=torch.Generator())
    crit = PL.LossNet(scfg.loss, RES, 8, 3, losses="l1:1")
    with pytest.raises(ValueError, match="56 input channels"):
        PS.create_shaded_train_state(scfg, model, crit,
                                     PT.make_optimizer(scfg))


def test_main_video_shaded_runs_on_cpu(tmp_path):
    """One tiny epoch: the run dir, scalars.jsonl under JAX's tag, the
    port's checkpoint, a finite loss; the generator takes 8 + 48 channels
    and gives 3."""
    import json
    import os

    from isosurfacesuperresolution_tpu_torch.apps import main_video_shaded
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    argv = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
            "--numFrames", "3", "--cropSize", "8", "--samples", "16",
            "--batchSize", "2", "--numResidualLayers", "1",
            "--numFeatures", "8", "--aoSamples", "0",
            "--lossBorderPadding", "2", "--epochs", "1",
            "--runDir", str(tmp_path), "--device", "cpu"]
    run_dir = main_video_shaded.main(argv)
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["tag"] for r in rows] == ["train/total_loss"]
    assert np.isfinite(rows[0]["value"]) and rows[0]["step"] == 1
    assert os.path.exists(os.path.join(run_dir, "checkpoints",
                                       "epoch_1.pt"))
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["model.input_channels"], cfg["model.output_channels"],
            cfg["loss.losses"]) == (8, 3, "l1:1,temp-l2:0.1")
    lm = LoadedModel.from_run_dir(run_dir, device="cpu")
    assert lm.model.in_channels == 56
    out = lm.inference(torch.zeros(1, 8, 8, 8), None, torch.zeros(1, 8, 8, 2))
    assert out.shape == (1, 32, 32, 3)
