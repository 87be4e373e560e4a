"""The port's model loading vs the JAX package: `LoadedModel` on run00017
with and without ``fast``, `from_params_npz`, `inference` (first frame
and a warped frame), the exact warp (`grid_sample`, `warp_upscale`), the
reference ``.pth`` importer and the exporter, and their refusals.

The reference-layout torch nets below copy the classes of
`tests/test_torch_import.py` (the reference's Sequential/ModuleList
naming); each is saved as the reference saves a training checkpoint, a
dict pickling the whole module, under a module name that is not
importable when the file is read back."""

import dataclasses
import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from isosurfacesuperresolution_tpu.config import Config as JConfig
from isosurfacesuperresolution_tpu.config import ModelConfig as JModelConfig
from isosurfacesuperresolution_tpu.infer import torch_export as JE
from isosurfacesuperresolution_tpu.infer import torch_import as JI
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    config_from_json as j_config_from_json)
from isosurfacesuperresolution_tpu.models import generators as JG
from isosurfacesuperresolution_tpu.models import videotools as JV
from isosurfacesuperresolution_tpu.ops.sampling import (
    grid_sample as j_grid_sample)
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, config_from_json)
from isosurfacesuperresolution_tpu_torch.infer import torch_export as E
from isosurfacesuperresolution_tpu_torch.infer import torch_import as I
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.models import generators as G
from isosurfacesuperresolution_tpu_torch.models.videotools import (
    warp_upscale)
from isosurfacesuperresolution_tpu_torch.ops.sampling import grid_sample

RUN = os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                   "run00017")


def _forward_input(cin, seed=0, shape=(1, 12, 16)):
    return np.random.RandomState(seed).normal(
        size=(*shape, cin)).astype(np.float32)


# ---------------------------------------------------------------------------
# run dirs
# ---------------------------------------------------------------------------

def test_config_from_json_restores_model_and_train():
    cfg, jcfg = config_from_json(os.path.join(RUN, "config.json")), \
        j_config_from_json(os.path.join(RUN, "config.json"))
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jcfg.train)
    assert cfg.train.num_frames == 10 and cfg.train.remat


@pytest.mark.parametrize("fast", [False, True])
def test_run00017_matches_jax(fast):
    """run00017 (10 x 64, full width) as JAX loads it, fused or not: both
    outputs within the 1e-4 of `test_torch_port_network.py`."""
    jlm = JLoadedModel.from_run_dir(RUN, fast=fast)
    lm = LoadedModel.from_run_dir(RUN, fast=fast, device="cpu")
    assert lm.cfg.model.fused_upsample == fast == jlm.cfg.model.fused_upsample
    assert lm.model.fuse == fast
    for attr in ("unshaded", "upscale_factor", "initial_image_mode",
                 "inverse_ao", "bare_input"):
        assert getattr(lm, attr) == getattr(jlm, attr), attr
    x = _forward_input(lm.model.in_channels)
    ref = jlm.model.apply(jlm.params, jnp.asarray(x))
    with torch.no_grad():
        got = lm.model(torch.from_numpy(x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_from_params_npz_matches_jax():
    """A bare ``params.npz`` with a configuration of the caller's (here
    run00017's with nearest upsampling, which the same tree fits)."""
    jcfg = j_config_from_json(os.path.join(RUN, "config.json"))
    jcfg = JConfig(model=dataclasses.replace(jcfg.model, upsample="nearest"))
    cfg = Config(model=ModelConfig(**dataclasses.asdict(jcfg.model)))
    npz = os.path.join(RUN, "params.npz")
    jlm = JLoadedModel.from_params_npz(npz, jcfg)
    lm = LoadedModel.from_params_npz(npz, cfg, device="cpu")
    x = _forward_input(lm.model.in_channels, seed=1)
    ref = jlm.model.apply(jlm.params, jnp.asarray(x))[0]
    with torch.no_grad():
        got = lm.model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_orbax_run_dir_is_refused(tmp_path):
    """Orbax run dirs load since the port reads OCDBT (`train/ocdbt.py`):
    ``checkpoints/5`` holding run00022's step 70 gives that step's
    generator at ``epoch=5``; a digit-named directory that holds no
    OCDBT database is refused, naming orbax."""
    src = os.path.join(os.path.dirname(RUN), "run00022", "run00022")
    shutil.copy(os.path.join(src, "config.json"), tmp_path / "config.json")
    (tmp_path / "checkpoints").mkdir()
    os.symlink(os.path.join(src, "checkpoints", "70"),
               tmp_path / "checkpoints" / "5")
    got = LoadedModel.from_run_dir(str(tmp_path), epoch=5, device="cpu")
    want = LoadedModel.from_run_dir(src, device="cpu")
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    (tmp_path / "checkpoints" / "6").mkdir()
    with pytest.raises(FileNotFoundError, match="not an orbax"):
        LoadedModel.from_run_dir(str(tmp_path), epoch=6, device="cpu")


@pytest.fixture(scope="module")
def run00017():
    return (JLoadedModel.from_run_dir(RUN),
            LoadedModel.from_run_dir(RUN, device="cpu"))


def test_inference_first_and_warped_frames_match_jax(run00017):
    """Two recurrent steps of `inference`: the first from the initial
    image, the second warps the first's prediction with the exact gather
    warp.  float32; the network's 1e-4, carried into step two."""
    jlm, lm = run00017
    rng = np.random.RandomState(2)
    low = [rng.uniform(-1, 1, (1, 12, 16, 5)).astype(np.float32)
           for _ in range(2)]
    flow = rng.uniform(-0.05, 0.05, (1, 12, 16, 2)).astype(np.float32)
    jprev = prev = None
    for step in range(2):
        ref = jlm.inference(jnp.asarray(low[step]), jprev, jnp.asarray(flow))
        got = lm.inference(torch.from_numpy(low[step]), prev,
                           torch.from_numpy(flow))
        assert got.shape == (1, 48, 64, 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)
        jprev, prev = ref, got


# ---------------------------------------------------------------------------
# the exact warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    """Bilinear, zero outside: `F.grid_sample` against JAX's gathers on
    positions reaching past the border; float32 rounding of the weights."""
    rng = np.random.RandomState(3)
    img = rng.rand(2, 9, 13, 4).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 7, 11, 2)).astype(np.float32)
    ref = j_grid_sample(jnp.asarray(img), jnp.asarray(grid), align_corners)
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                      align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    got3 = grid_sample(torch.from_numpy(img[0]), torch.from_numpy(grid[0]),
                       align_corners)
    np.testing.assert_allclose(got3.numpy(), np.asarray(ref)[0], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("special_mask", [False, True])
def test_warp_upscale_matches_jax(special_mask):
    """The reference warp: linspace grid with align_corners=False, flow
    x -2 / y +2, zero padding (mask -1 outside under ``special_mask``).
    The linspace grids of the two libraries differ in the last place
    (1.2e-7, a shift of 4e-6 px at 64 px), the sampling weights by
    float32 rounding (2.7e-6 alone); on noise whose neighbours differ by
    up to 2 that measured 1.6e-5: bound 5e-5."""
    rng = np.random.RandomState(4)
    img = rng.uniform(-1, 1, (1, 48, 64, 6)).astype(np.float32)
    flow = rng.uniform(-0.1, 0.1, (1, 12, 16, 2)).astype(np.float32)
    ref = JV.warp_upscale(jnp.asarray(img), jnp.asarray(flow), 4,
                          special_mask=special_mask)
    got = warp_upscale(torch.from_numpy(img), torch.from_numpy(flow), 4,
                       special_mask=special_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=0)
    if special_mask:      # outside the frame the mask reads back as -1
        assert (got.numpy()[..., 0] == -1.0).any()


# ---------------------------------------------------------------------------
# reference .pth import and export
# ---------------------------------------------------------------------------

def _recon(x, out, cm):
    """Reference residual reconstruction (enhancenet.py:51-90)."""
    resized = tF.interpolate(x[:, :cm], size=out.shape[2:], mode="bilinear")
    if cm < out.shape[1]:
        return torch.cat([resized + out[:, :cm], out[:, cm:]], dim=1)
    return resized + out


class RefEnhanceNet(tnn.Module):
    """Reference-layout EnhanceNet (enhancenet.py:92-125 structure)."""

    def __init__(self, cin, cout, n_blocks=3, use_bn=False, cm=None):
        super().__init__()
        self.cm = min(cin, cout) if cm is None else cm
        self.preblock = tnn.Sequential(tnn.Conv2d(cin, 64, 3, padding=1),
                                       tnn.ReLU())
        blocks = []
        for _ in range(n_blocks):
            if use_bn:
                blocks.append(tnn.Sequential(
                    tnn.Conv2d(64, 64, 3, padding=1), tnn.BatchNorm2d(64),
                    tnn.ReLU(),
                    tnn.Conv2d(64, 64, 3, padding=1), tnn.BatchNorm2d(64)))
            else:
                blocks.append(tnn.Sequential(
                    tnn.Conv2d(64, 64, 3, padding=1), tnn.ReLU(),
                    tnn.Conv2d(64, 64, 3, padding=1)))
        self.blocks = tnn.ModuleList(blocks)
        up = lambda: tnn.Upsample(scale_factor=2, mode="bilinear")
        self.postblock = tnn.Sequential(
            up(), tnn.Conv2d(64, 64, 3, padding=1), tnn.ReLU(),
            up(), tnn.Conv2d(64, 64, 3, padding=1), tnn.ReLU(),
            tnn.Conv2d(64, 64, 3, padding=1), tnn.ReLU(),
            tnn.Conv2d(64, cout, 3, padding=1))

    def forward(self, x):
        f = self.preblock(x)
        for b in self.blocks:
            f = f + b(f)
        return _recon(x, self.postblock(f), self.cm)


class RefTecoGAN(tnn.Module):
    """Reference-layout TecoGAN (tecogan.py:41-62 structure)."""

    def __init__(self, cin, cout, n_blocks=2, cm=None):
        super().__init__()
        self.cm = min(cin, cout) if cm is None else cm
        self.preblock = tnn.Sequential(tnn.Conv2d(cin, 64, 3, padding=1),
                                       tnn.LeakyReLU())
        self.blocks = tnn.ModuleList([
            tnn.Sequential(tnn.Conv2d(64, 64, 3, padding=1),
                           tnn.LeakyReLU(),
                           tnn.Conv2d(64, 64, 3, padding=1))
            for _ in range(n_blocks)])
        self.postblock = tnn.Sequential(
            tnn.ConvTranspose2d(64, 64, 3, stride=2, padding=1,
                                output_padding=1), tnn.LeakyReLU(),
            tnn.ConvTranspose2d(64, 64, 3, stride=2, padding=1,
                                output_padding=1), tnn.LeakyReLU(),
            tnn.Conv2d(64, cout, 3, padding=1), tnn.LeakyReLU())

    def forward(self, x):
        f = self.preblock(x)
        for b in self.blocks:
            f = f + b(f)
        return _recon(x, self.postblock(f), self.cm)


class RefSubpixelNet(tnn.Module):
    """Reference-layout SubpixelNet (subpixelnet.py:7-27 structure)."""

    def __init__(self, cin, cout, r=4):
        super().__init__()
        self.r = r
        self.conv1 = tnn.Conv2d(cin, 64, 5, padding=2)
        self.conv2 = tnn.Conv2d(64, 64, 5, padding=2)
        self.conv3 = tnn.Conv2d(64, 64, 3, padding=1)
        self.conv4 = tnn.Conv2d(64, 32, 3, padding=1)
        self.conv5 = tnn.Conv2d(32, cout * r * r, 3, padding=1)

    def forward(self, x):
        x = tF.relu(self.conv1(x))
        x = tF.relu(self.conv2(x))
        x = tF.relu(self.conv3(x))
        x = tF.relu(self.conv4(x))
        return tF.pixel_shuffle(self.conv5(x), self.r)


def _save_checkpoint(path, module, parameters=None):
    """The reference's checkpoint format, the module claiming to live in
    the reference package ``models.*`` (registered only during the save,
    so the stub unpickler reads it back)."""
    cls = type(module)
    modname = "models." + cls.__name__.lower().replace("ref", "")
    orig = cls.__module__
    cls.__module__ = modname
    fake = types.ModuleType(modname)
    setattr(fake, cls.__qualname__, cls)
    sys.modules["models"] = types.ModuleType("models")
    sys.modules[modname] = fake
    try:
        torch.save({"epoch": 7, "model": module,
                    "parameters": parameters or {}}, str(path))
    finally:
        cls.__module__ = orig
        del sys.modules["models"]
        del sys.modules[modname]
    return str(path)


def _bn_stats(module):
    """Non-trivial running statistics: a few training-mode forwards."""
    module.train()
    with torch.no_grad():
        for b in module.blocks:
            b(torch.randn(2, 64, 8, 8))
    return module


PTH_CASES = {
    "enhancenet": (lambda: RefEnhanceNet(5, 6, n_blocks=3), 5, None),
    "enhancenet_temporal": (lambda: RefEnhanceNet(101, 6, n_blocks=2, cm=5),
                            101, {"initialImage": "unshaded"}),
    "enhancenet_bn": (lambda: _bn_stats(RefEnhanceNet(5, 6, n_blocks=2,
                                                      use_bn=True)), 5, None),
    "state_dict_only": (lambda: RefEnhanceNet(5, 6, n_blocks=2), 5, "sd"),
    "subpixelnet": (lambda: RefSubpixelNet(5, 6), 5, None),
    "tecogan": (lambda: RefTecoGAN(5, 6), 5, None),
}


@pytest.mark.parametrize("name", sorted(PTH_CASES))
def test_reference_pth_import_matches_torch_and_jax(tmp_path, name):
    """Each reference layout through the port's importer: the same
    config and inference settings as JAX's importer, weights equal to the
    reference module's own, and a forward within JAX's import test bound
    (3e-4 absolute, 1e-3 relative) of the reference module, and within
    1e-4 of JAX's imported net."""
    torch.manual_seed(0)
    make, cin, params = PTH_CASES[name]
    ref_net = make().eval()
    if params == "sd":
        path = str(tmp_path / "gen.pth")
        torch.save(ref_net.state_dict(), path)
    else:
        path = _save_checkpoint(tmp_path / "model_epoch_7.pth", ref_net,
                                params)
    lm = LoadedModel.from_run_dir(path, device="cpu")     # the .pth route
    jlm = JI.load_reference_pth(path)
    assert dataclasses.asdict(lm.cfg.model) == dataclasses.asdict(
        jlm.cfg.model)
    for attr in ("initial_image_mode", "inverse_ao", "bare_input",
                 "unshaded"):
        assert getattr(lm, attr) == getattr(jlm, attr), attr
    x = np.random.RandomState(0).rand(2, 12, 12, cin).astype(np.float32)
    with torch.no_grad():
        want = ref_net(torch.from_numpy(x.transpose(0, 3, 1, 2))
                       ).numpy().transpose(0, 2, 3, 1)
        got = lm.model(torch.from_numpy(x))[0].numpy()
    jgot = np.asarray(jlm.model.apply(jlm.params, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got, jgot, atol=1e-4, rtol=0)
    if name == "enhancenet_temporal":
        low = torch.zeros((1, 8, 8, 5))
        out = lm.inference(low, None, torch.zeros((1, 8, 8, 2)))
        assert out.shape == (1, 32, 32, 6) and bool(torch.isfinite(out).all())


def test_rcan_pth_is_refused(tmp_path):
    sd = {"net.pre.weight": torch.zeros((64, 5, 3, 3)),
          "net.pre.bias": torch.zeros((64,))}
    path = str(tmp_path / "rcan.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="RCAN") as err:
        I.load_reference_pth(path, device="cpu")
    with pytest.raises(ValueError) as jerr:
        JI.load_reference_pth(path)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="RCAN"):
        E.reference_state_dict_from_params({}, ModelConfig(model="RCAN"))


EXPORT_CASES = {
    "enhancenet": dict(num_residual_blocks=3, num_features=16),
    "enhancenet_bn": dict(num_residual_blocks=2, num_features=16,
                          use_bn=True),
    "tecogan": dict(model="TecoGAN", num_residual_blocks=2, num_features=16),
    "subpixelnet": dict(model="SubpixelNet"),
}


@pytest.mark.parametrize("name", sorted(EXPORT_CASES))
def test_export_equals_jax_key_by_key(name):
    """The same Flax variables exported by JAX and, through
    `params_from_flax`, by the port: the same keys in the same order and
    equal tensors (layout changes only, no arithmetic)."""
    kw = EXPORT_CASES[name]
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    cin = G.network_input_channels(cfg)
    variables = JG.create_network(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, cin), jnp.float32))
    if "batch_stats" in variables:
        rng = np.random.RandomState(1)
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
            variables)
    want = JE.reference_state_dict_from_params(variables, jcfg)
    net = G.create_network(cfg)
    net.load_state_dict(G.params_from_flax(variables, cfg))
    got = E.reference_state_dict_from_params(net, cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_export_import_roundtrip_of_run00017(tmp_path):
    """run00017 exported as a reference ``.pth`` and read back through
    `from_run_dir`: every weight and the forward bit for bit, and the
    file JAX's importer reads gives JAX's own run00017."""
    lm = LoadedModel.from_run_dir(RUN, device="cpu")
    path = E.export_reference_pth(lm, str(tmp_path / "run00017.pth"))
    back = LoadedModel.from_run_dir(path, device="cpu")
    a, b = lm.model.state_dict(), back.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not back.bare_input and back.cfg.model == lm.cfg.model
    x = torch.from_numpy(_forward_input(lm.model.in_channels, seed=5))
    with torch.no_grad():
        assert torch.equal(lm.model(x)[0], back.model(x)[0])
    jback = JI.load_reference_pth(path)
    jlm = JLoadedModel.from_run_dir(RUN)
    for leaf, jleaf in zip(jax.tree_util.tree_leaves(jback.params),
                           jax.tree_util.tree_leaves(jlm.params)):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(jleaf))
    # the CLI writes the same file
    cli = str(tmp_path / "cli.pth")
    E.main([RUN, cli, "--device", "cpu"])
    c = torch.load(cli, weights_only=False)
    assert c["parameters"]["initialImage"] == "zero"
    assert all(torch.equal(c["model"][k], v) for k, v in
               E.reference_state_dict_from_params(lm.model,
                                                  lm.cfg.model).items())
    assert json.dumps(c["parameters"])          # plain values only
