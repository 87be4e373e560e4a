"""Resuming JAX's runs: the port's `CheckpointManager.restore` on orbax
steps (`train/checkpoint.py`, `train/optim.Optimizer.optax_state_dict`)
against the JAX package's `CheckpointManager.restore`.

- (a) The two in-repo orbax runs at full width (run00022 step 70: Adam
  behind the clip; run00020 step 23: the same and an ``enhanceNetLarge``
  discriminator with its own Adam and clip): every leaf of the restored
  state equal to JAX's, exactly (a copy, through the layout mapping):
  parameters, moments, both counts, the injected learning rate, the
  discriminator and its optimizer, the step.
- (b) A tiny run that JAX trains two steps and saves through its own
  `CheckpointManager`, restored by both packages into states of other
  initial weights, then two more steps in both: adam + clip, adam,
  rmsprop + clip, rprop, and the adversarial round (bce, adam + clip).
  JAX's plain step is `make_train_step`'s gradient, compiled once for the
  four rules, and the rule's update as that step applies it.
- (c) Trees that are not the state's raise, naming the first path that
  differs, and leave the state as it was.
- (d) ``main_video_unshaded --restore`` on a JAX run dir resumes at the
  epoch after the saved one with the saved state.

Tolerances for (b), those of `tests/test_torch_port_train.py`: losses
rel 1e-4, parameters within 1e-2 x lr but for a few named elements.  The
optimizer state after the two steps: counts equal; each moment leaf
within 1e-3 of its largest magnitude but for at most 3% of its elements,
held to 1e-2 (a moment sums the steps' gradients, each known to 1e-4 of
its leaf's largest; rprop's step sizes grow or shrink by the sign of a
gradient product, which can differ where a gradient is near zero).
"""

import json
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import (
    assert_params_close, carry_criterion, clip, find_state, grad_catcher,
    port_layout, tiny, to_torch)
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    config_from_json as j_config_from_json)
from isosurfacesuperresolution_tpu.losses.lossnet_unshaded import (
    LossNetUnshaded as JLossNetUnshaded)
from isosurfacesuperresolution_tpu.models.generators import (
    create_network as j_create_network)
from isosurfacesuperresolution_tpu.train import checkpoint as JC
from isosurfacesuperresolution_tpu.train import trainer as JT
from isosurfacesuperresolution_tpu_torch import config as pconfig
from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network)
from isosurfacesuperresolution_tpu_torch.train import trainer as PT
from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
    CheckpointManager)
from isosurfacesuperresolution_tpu_torch.utils import jax_prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"run00020": ("artifacts/run00020/run00020", 23),
        "run00022": ("artifacts/run00022/run00022", 70)}
MOMENT_STATES = (optax.ScaleByAdamState, optax.ScaleByRmsState,
                 optax.ScaleByRpropState)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def jax_state(jcfg, seed, res):
    """JAX's fresh train state (and its model, criterion, optimizers)."""
    jmodel = j_create_network(jcfg.model)
    jcrit = JLossNetUnshaded(jcfg.loss, high_res=res)
    opt = JT.make_optimizer(jcfg)
    dopt = JT.make_optimizer(jcfg) if jcfg.train.adv_training else None
    state = JT.create_train_state(jcfg, jmodel, jcrit, opt,
                                  jax.random.PRNGKey(seed),
                                  discr_optimizer=dopt)
    return jmodel, jcrit, opt, dopt, state


def abstract_state(jcfg, res):
    """JAX's train state as shapes on the CPU device: the template of a
    restore, without drawing full-width weights."""
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=cpu),
        jax.eval_shape(lambda: jax_state(jcfg, 0, res)[-1]))


def port_state(pcfg, seed, res):
    """The port's fresh train state, weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    pmodel = create_network(pcfg.model, generator=gen)
    pcrit = LossNetUnshaded(pcfg.loss, high_res=res)
    spec = PT.make_optimizer(pcfg)
    state = PT.create_train_state(
        pcfg, pmodel, pcrit, spec, gen,
        discr_optimizer=spec if pcfg.train.adv_training else None)
    return pcrit, state


def linked_run(src, step, dst):
    """A run dir holding ``config.json`` and one step of ``src``, linked
    (JAX's manager may write beside the steps it opens)."""
    os.makedirs(os.path.join(dst, "checkpoints"))
    shutil.copy(os.path.join(src, "config.json"), dst)
    os.symlink(os.path.join(src, "checkpoints", str(step)),
               os.path.join(dst, "checkpoints", str(step)))
    return dst


def moment_trees(opt_state):
    """(count, injected hyperparams, {moment: tree}) of an optax state."""
    found = []
    jax.tree_util.tree_map(
        found.append, opt_state,
        is_leaf=lambda x: hasattr(x, "hyperparams"))
    inject = next(x for x in found if hasattr(x, "hyperparams"))
    for cls in MOMENT_STATES:
        try:
            inner = find_state(opt_state, cls)
        except IndexError:
            continue
        trees = {k: getattr(inner, k) for k in inner._fields
                 if k != "count"}
        return int(inject.count), inject.hyperparams, trees, inner


def port_moments(tree, opt, cfg_model, per_name=False):
    """A moment tree in the port's layout, in ``opt.names``' order."""
    if per_name:
        flat = {}
        for name, sub in tree.items():
            flat.update({f"{name}.{k}": v for k, v in
                         port_layout(sub, None).items()})
    else:
        flat = port_layout(tree, cfg_model)
    return [flat[n] for n in opt.names]


def assert_restored_equal(pstate, jstate, jcfg):
    """Every leaf of the port's restored state equal to JAX's."""
    want = port_layout(jstate.params, jcfg.model)
    got = pstate.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert pstate.step == int(jstate.step)
    pairs = [(pstate.optimizer, jstate.opt_state, False)]
    for name, d in pstate.discriminators.items():
        dwant = port_layout(jstate.discr_params[name], None)
        for k, v in d.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), dwant[k],
                                          err_msg=f"{name}.{k}")
    if pstate.discr_optimizer is not None:
        pairs.append((pstate.discr_optimizer, jstate.discr_opt_state, True))
    for opt, jopt, per_name in pairs:
        count, hyper, trees, inner = moment_trees(jopt)
        assert opt.count == count
        if "count" in inner._fields:
            assert int(inner.count) == count
        assert opt.learning_rate == float(np.float32(
            hyper["learning_rate"]))
        for m, tree in trees.items():
            for n, a, b in zip(opt.names, opt.state[m],
                               port_moments(tree, opt, jcfg.model,
                                            per_name)):
                np.testing.assert_array_equal(a.numpy(), b,
                                              err_msg=f"{m} {n}")


def assert_moments_close(opt, jopt, cfg_model, per_name=False):
    count, _, trees, _ = moment_trees(jopt)
    assert opt.count == count
    for m, tree in trees.items():
        for n, a, b in zip(opt.names, opt.state[m],
                           port_moments(tree, opt, cfg_model, per_name)):
            scale = max(float(np.abs(b).max()), 1e-30)
            d = np.abs(a.numpy() - b)
            far = d > 1e-3 * scale
            assert far.sum() <= 0.03 * d.size, (m, n, int(far.sum()),
                                                d.size)
            assert d.max() <= 1e-2 * scale, (m, n, float(d.max() / scale))


# ---------------------------------------------------------------------------
# (a) the in-repo runs at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", sorted(RUNS))
def test_full_restore_equals_jax(run, tmp_path):
    src, step = RUNS[run]
    d = linked_run(os.path.join(ROOT, src), step, str(tmp_path / run))
    jcfg = j_config_from_json(os.path.join(d, "config.json"))
    pcfg = pconfig.config_from_json(os.path.join(d, "config.json"))
    res = jcfg.train.crop_size * jcfg.model.upscale_factor
    jstate, jepoch = JC.CheckpointManager(d).restore(
        abstract_state(jcfg, res))
    pcrit, pstate = port_state(pcfg, 0, res)
    pstate, pepoch = CheckpointManager(d).restore(pstate)
    assert pepoch == jepoch == step
    assert list(pstate.discriminators) == (
        ["adv"] if run == "run00020" else [])
    assert (pstate.discr_optimizer is None) == (run == "run00022")
    assert_restored_equal(pstate, jstate, jcfg)


# ---------------------------------------------------------------------------
# (b) resume a JAX-saved tiny run and step both
# ---------------------------------------------------------------------------

ADV_LOSSES = "l1:mask:1,l1:normal:10,temp-l2:color:0.1,adv:all:0.3"
CASES = {
    "adam+clip": ({"optimizer": "adam", "grad_clip": 1.0}, None),
    "adam": ({"optimizer": "adam", "grad_clip": 0.0}, None),
    "rmsprop+clip": ({"optimizer": "rmsprop", "grad_clip": 1.0}, None),
    "rprop": ({"optimizer": "rprop", "grad_clip": 0.0}, None),
    "adversarial": ({"optimizer": "adam", "grad_clip": 1.0,
                     "adv_training": True}, {"losses": ADV_LOSSES}),
}


@pytest.fixture(scope="module")
def grad_step():
    """`make_train_step`'s own gradient on the tiny setup, through an
    optax transformation whose state becomes the gradients: compiled once
    for the four plain cases (they differ only in the optimizer)."""
    jcfg, _ = tiny()
    catcher = grad_catcher()
    step = JT.make_train_step(jcfg, j_create_network(jcfg.model),
                              JLossNetUnshaded(jcfg.loss, high_res=32),
                              catcher)
    return step, catcher


def jax_steps(jcfg, jmodel, jcrit, opt, dopt, grad_step):
    """One step of JAX's loop for the case.  The plain step: the gradient
    of `make_train_step`, then ``opt``'s update applied as that step
    applies it; the adversarial round: JAX's discriminator step, then its
    generator step."""
    if not jcfg.train.adv_training:
        gstep, catcher = grad_step

        def plain(s, b, i):
            g, _ = gstep(s._replace(opt_state=catcher.init(s.params)), *b)
            updates, opt_state = opt.update(g.opt_state, s.opt_state,
                                            s.params)
            return s._replace(params=optax.apply_updates(s.params, updates),
                              opt_state=opt_state, step=g.step)
        return plain
    jd, jg = JT.make_adv_train_steps(jcfg, jmodel, jcrit, opt, dopt)

    def adv(s, b, i):
        s = jd(s, *b, jax.random.PRNGKey(100 + i))[0]
        return jg(s, *b)[0]
    return adv


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_and_step_matches_jax(case, tmp_path, grad_step):
    train, loss = CASES[case]
    jcfg, pcfg = tiny(train=train, loss=loss)
    res = 32
    jmodel, jcrit, opt, dopt, jstate = jax_state(jcfg, 0, res)
    jstep = jax_steps(jcfg, jmodel, jcrit, opt, dopt, grad_step)
    for i in range(2):
        jstate = jstep(jstate, clip(40 + i), i)
    JC.CheckpointManager(str(tmp_path)).save(3, jstate)

    *_, jfresh = jax_state(jcfg, 1, res)
    jstate, _ = JC.CheckpointManager(str(tmp_path)).restore(jfresh, 3)
    pcrit, pstate = port_state(pcfg, 1, res)
    carry_criterion(pcrit, jstate.aux_params)      # the VGG, if any
    pstate, epoch = CheckpointManager(str(tmp_path)).restore(pstate)
    assert epoch == 3
    assert_restored_equal(pstate, jstate, jcfg)

    if jcfg.train.adv_training:
        pd, pg = PT.make_adv_train_steps(pcfg, pstate.model, pcrit)
    else:
        pstep = PT.make_train_step(pcfg, pstate.model, pcrit)
    for i in range(2, 4):
        batch = clip(40 + i)
        jstate = jstep(jstate, batch, i)
        if jcfg.train.adv_training:
            pstate = pd(pstate, *to_torch(*batch),
                        jax_prng.prng_key(100 + i))[0]
            pstate = pg(pstate, *to_torch(*batch))[0]
        else:
            pstate = pstep(pstate, *to_torch(*batch))[0]
    lr = jcfg.train.learning_rate
    assert pstate.step == int(jstate.step) == 4
    assert_params_close(pstate.model, jstate.params, lr, jcfg.model)
    assert_moments_close(pstate.optimizer, jstate.opt_state, jcfg.model)
    if jcfg.train.adv_training:
        for name, d in pstate.discriminators.items():
            assert_params_close(d, jstate.discr_params[name], lr, None)
        assert_moments_close(pstate.discr_optimizer, jstate.discr_opt_state,
                             None, per_name=True)


# ---------------------------------------------------------------------------
# (c) mismatched trees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_runs(tmp_path_factory):
    """JAX's fresh tiny states saved at epoch 1: adam + clip, and the
    adversarial one."""
    out = {}
    for name, (train, loss) in (("adam+clip", CASES["adam+clip"]),
                                ("adversarial", CASES["adversarial"])):
        jcfg, _ = tiny(train=train, loss=loss)
        *_, jstate = jax_state(jcfg, 0, 32)
        d = str(tmp_path_factory.mktemp(name.replace("+", "_")))
        JC.CheckpointManager(d).save(1, jstate)
        out[name] = d
    return out


MISMATCHES = {
    # saved run, the port's config (train, loss, model), the path named
    "no clip in the config": ("adam+clip", ({"grad_clip": 0.0}, None, None),
                              r"opt_state\.count: missing"),
    "another rule": ("adam+clip", ({"optimizer": "rmsprop",
                                    "grad_clip": 1.0}, None, None),
                     r"opt_state\.1\.hyperparams\.decay: missing"),
    "other betas": ("adam+clip", ({"grad_clip": 1.0, "beta1": 0.5}, None,
                                  None),
                    r"opt_state\.1\.hyperparams\.b1 = 0\.9"),
    "a wider generator": ("adam+clip", ({"grad_clip": 1.0}, None,
                                        {"num_features": 16}),
                          r"params\.params\.\w+\.\w+: saved shape"),
    "a block more": ("adam+clip", ({"grad_clip": 1.0}, None,
                                   {"num_residual_blocks": 3}),
                     r"params\.params\.block2_conv1\.bias: missing"),
    "a discriminator the config lacks": (
        "adversarial", ({"grad_clip": 1.0}, None, None),
        r"discr_params\.adv: a discriminator the config does not have"),
    "no discriminator state": (
        "adam+clip", ({"grad_clip": 1.0, "adv_training": True},
                      {"losses": ADV_LOSSES}, None),
        r"discr_params\.adv: missing"),
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatched_tree_names_the_path(case, saved_runs):
    run, (train, loss, model) = MISMATCHES[case][:2]
    _, pcfg = tiny(train=train, loss=loss, model=model)
    _, pstate = port_state(pcfg, 0, 32)
    before = {k: v.clone() for k, v in pstate.model.state_dict().items()}
    with pytest.raises(ValueError, match=MISMATCHES[case][2]):
        CheckpointManager(saved_runs[run]).restore(pstate)
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert pstate.step == 0 and pstate.optimizer.count == 0


def test_adam_counts_that_differ_are_refused(saved_runs, tmp_path):
    """Optax's two Adam counts (the injected one and Adam's own) must
    agree; the refusal names both paths."""
    jcfg, pcfg = tiny(train={"grad_clip": 1.0})
    *_, jstate = jax_state(jcfg, 0, 32)
    chain = list(jstate.opt_state)
    inject = chain[1]
    inner = list(inject.inner_state)
    inner[0] = inner[0]._replace(count=inner[0].count + 1)
    chain[1] = inject._replace(inner_state=tuple(inner))
    JC.CheckpointManager(str(tmp_path)).save(
        1, jstate._replace(opt_state=tuple(chain)))
    _, pstate = port_state(pcfg, 0, 32)
    with pytest.raises(ValueError, match=r"opt_state\.1\.inner_state\.0\."
                       r"count = 1 differs from opt_state\.1\.count = 0"):
        CheckpointManager(str(tmp_path)).restore(pstate)


# ---------------------------------------------------------------------------
# (d) the entry point
# ---------------------------------------------------------------------------

TINY = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
        "--numFrames", "3", "--cropSize", "8", "--samples", "16",
        "--batchSize", "2", "--numResidualLayers", "1", "--numFeatures", "8",
        "--aoSamples", "0", "--lossBorderPadding", "2", "--device", "cpu"]


def test_main_resumes_a_jax_run_dir(tmp_path, capsys):
    """A JAX run dir (config.json and an orbax step of epoch 1 whose state
    is JAX's, the step count set to 7) resumed by the port's
    ``--restore``: epoch 2 only, from the saved state (the step count
    goes on from 7, Adam's count with it)."""
    from isosurfacesuperresolution_tpu.apps import (
        main_video_unshaded as jmain)
    jargs = [a for a in TINY if a not in ("--device", "cpu")]
    jcfg = jmain.make_config(jmain.build_parser().parse_args(jargs))
    res = jcfg.train.crop_size * jcfg.model.upscale_factor
    *_, jstate = jax_state(jcfg, 3, res)
    jstate = jstate._replace(step=jstate.step + 7)
    jrun = str(tmp_path / "jax_run")
    os.makedirs(jrun)
    JC.write_info(jrun, jcfg)
    JC.CheckpointManager(jrun).save(1, jstate)

    run = main_video_unshaded.main(TINY + ["--epochs", "2", "--runDir",
                                           str(tmp_path / "runs"),
                                           "--restore", jrun])
    assert "restored epoch 1 from" in capsys.readouterr().out
    assert os.listdir(os.path.join(run, "checkpoints")) == ["epoch_2.pt"]
    with open(os.path.join(run, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["step"] for r in rows} == {2}
    payload = torch.load(os.path.join(run, "checkpoints", "epoch_2.pt"),
                         weights_only=True)
    n_batches = payload["step"] - 7
    assert n_batches > 0
    assert payload["opt_state"]["count"] == n_batches
    lr = dict((r["tag"], r["value"]) for r in rows)["train/lr"]
    assert lr == pytest.approx(jcfg.train.learning_rate * (
        jcfg.train.lr_gamma ** (1 // max(jcfg.train.lr_step, 1))))
