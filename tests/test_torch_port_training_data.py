"""The port's training data, checkpoints and entry point vs the JAX
package's: `VideoDataset.collect_samples`, `DatasetFromSamples.batches`,
`DeviceVideoDataset` crops and `augment_clip` (bit for bit: the same
numpy draws in the same order, the same slices), the single-image
datasets, ``params.npz`` both ways, run directories and
`CheckpointManager`, and `apps.main_video_unshaded.main` on the CPU,
whose run dir JAX's `LoadedModel` reads to the port's output.

Tolerances: data and draws are equal; a network output read through
both packages' loaders 1e-5 (float32 convs, oneDNN against XLA); the
rendered single frames 1e-4 (the sweep tests' bound).
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from _torch_port_training import clip, port_layout, to_torch
from isosurfacesuperresolution_tpu.data import dataset as JD
from isosurfacesuperresolution_tpu.data import dataset_single as JDS
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu.train import checkpoint as JC
from isosurfacesuperresolution_tpu.train.device_data import (
    DeviceVideoDataset as JDeviceVideoDataset)
from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
from isosurfacesuperresolution_tpu_torch.config import Config, ModelConfig
from isosurfacesuperresolution_tpu_torch.data import dataset as PD
from isosurfacesuperresolution_tpu_torch.data import dataset_single as PDS
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
    LoadedModel)
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network, network_input_channels)
from isosurfacesuperresolution_tpu_torch.train import checkpoint as PC
from isosurfacesuperresolution_tpu_torch.train import trainer as PT
from isosurfacesuperresolution_tpu_torch.train.device_data import (
    DeviceVideoDataset)


def sequences(seed=0, n=3, t=4, h=24, u=4):
    """Seeded clips with a blob-shaped mask so crops pass or fail the
    fill test."""
    rng = np.random.RandomState(seed)
    out = []
    yy, xx = np.mgrid[:h, :h]
    for i in range(n):
        low = rng.rand(t, h, h, 5).astype(np.float32)
        r = (yy - h * (0.3 + 0.1 * i)) ** 2 + (xx - h / 2) ** 2
        low[..., 0] = np.where(r < (h / 2.5) ** 2, 1.0, -1.0)
        high = rng.rand(t, h * u, h * u, 6).astype(np.float32)
        flow = rng.randn(t, h, h, 2).astype(np.float32) * 0.1
        out.append({"low": low, "high": high, "flow": flow})
    return out


@pytest.mark.parametrize("augment", [False, True])
def test_collect_samples_and_batches_equal_jax(augment):
    seqs = sequences()
    jds, pds = JD.VideoDataset(seqs), PD.VideoDataset(seqs)
    want = jds.collect_samples(40, 8, 0.5, np.random.RandomState(3),
                               augment=augment)
    got = pds.collect_samples(40, 8, 0.5, np.random.RandomState(3),
                              augment=augment)
    assert [(s.index, s.x, s.y, s.augmentation) for s in got] == \
        [(s.index, s.x, s.y, s.augmentation) for s in want]
    for test in (False, True):
        jset = JD.DatasetFromSamples(jds, want, 8, test, 0.2)
        pset = PD.DatasetFromSamples(pds, got, 8, test, 0.2)
        assert len(pset) == len(jset)
        jb = list(jset.batches(4, rng=np.random.RandomState(7)))
        pb = list(pset.batches(4, rng=np.random.RandomState(7)))
        assert len(pb) == len(jb) > 0
        for a, b in zip(pb, jb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", range(PD.MAX_AUGMENTATION_MODE))
def test_augment_clip_equals_jax(mode):
    s = sequences(1, n=1)[0]
    for got, want in zip(PD.augment_clip(s["low"], s["high"], s["flow"],
                                         mode),
                         JD.augment_clip(s["low"], s["high"], s["flow"],
                                         mode)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_device_dataset_crops_equal_jax(store):
    """The same epoch's batches, shuffled by the same RandomState, sliced
    on the device; bfloat16 storage rounds as JAX's does."""
    seqs = sequences(2)
    samples = PD.VideoDataset(seqs).collect_samples(
        12, 8, 0.5, np.random.RandomState(4))
    jdd = JDeviceVideoDataset(seqs, store_dtype=jnp.dtype(store))
    pdd = DeviceVideoDataset(seqs, store_dtype=getattr(torch, store),
                             device="cpu")
    assert pdd.nbytes() == jdd.nbytes()
    for shuffle in (True, False):
        want = list(jdd.batches(samples, 4, 8, shuffle=shuffle,
                                rng=np.random.RandomState(5)))
        got = list(pdd.batches(samples, 4, 8, shuffle=shuffle,
                               rng=np.random.RandomState(5)))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == torch.float32
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_npy_dirs_load_as_in_jax(tmp_path):
    seqs = sequences(3, n=2)
    for i, s in enumerate(seqs):
        for k in ("low", "high", "flow"):
            np.save(tmp_path / f"{k}_{i:05d}.npy", s[k].transpose(0, 3, 1, 2))
    (tmp_path / "index.txt").write_text(".\n")
    for path in (str(tmp_path), str(tmp_path / "index.txt")):
        got, want = PD.load_reference_npy_dir(path), \
            JD.load_reference_npy_dir(path)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_exr_loaders_name_slice_10(tmp_path):
    """The EXR loaders slice 10 brought (held against JAX's in
    test_torch_port_io.py): a directory without the legacy files raises
    FileNotFoundError, and a file no codec decodes raises naming it."""
    with pytest.raises(FileNotFoundError, match="high_tmp"):
        PD.load_legacy_exr_dir(str(tmp_path), device="cpu")
    (tmp_path / "x.exr").write_bytes(b"not an EXR image")
    with pytest.raises(RuntimeError, match="could not decode"):
        PD._read_exr(str(tmp_path / "x.exr"))


def test_single_image_datasets_equal_jax(tmp_path):
    rng = np.random.RandomState(6)
    low = rng.rand(3, 16, 16, 5).astype(np.float32)
    low[..., 0] = np.sign(low[..., 0] - 0.2)
    high = rng.rand(3, 64, 64, 6).astype(np.float32)
    want = JDS.collect_samples_rendered(low, high, 10, 6,
                                        rng=np.random.RandomState(8))
    got = PDS.collect_samples_rendered(low, high, 10, 6,
                                       rng=np.random.RandomState(8))
    assert [(s.index, s.x, s.y) for s in got] == \
        [(s.index, s.x, s.y) for s in want]
    jb = list(JDS.SingleImageDataset(low, high, want, 6).batches(
        4, rng=np.random.RandomState(9)))
    pb = list(PDS.SingleImageDataset(low, high, got, 6).batches(
        4, rng=np.random.RandomState(9)))
    assert len(pb) == len(jb) == 2
    for a, b in zip(pb, jb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    import imageio.v2 as imageio
    for i in range(2):
        imageio.imwrite(tmp_path / f"im{i}.png",
                        (rng.rand(5, 7, 3) * 255).astype(np.uint8))
    for a, b in zip(PDS.load_image_folder(str(tmp_path)),
                    JDS.load_image_folder(str(tmp_path))):
        np.testing.assert_array_equal(a, b)


def test_render_single_frames_matches_jax():
    from isosurfacesuperresolution_tpu.config import RenderConfig as JRC
    from isosurfacesuperresolution_tpu.volume import analytic as ja
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    kw = dict(width=8, height=8, isovalue=0.5)
    want = JDS.render_single_frames(ja.sphere_volume(32), 2, JRC(**kw),
                                    seed=3, ao_samples=0)
    got = PDS.render_single_frames(analytic.sphere_volume(32, device="cpu"),
                                   2, RenderConfig(**kw), seed=3,
                                   ao_samples=0)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints and run dirs
# ---------------------------------------------------------------------------

def test_next_run_dir_numbers_as_jax(tmp_path):
    base = tmp_path / "runs"
    (tmp_path / "artifacts" / "run00007").mkdir(parents=True)
    got = PC.next_run_dir(str(base))
    assert os.path.basename(got) == "run00008"
    assert os.path.basename(JC.next_run_dir(str(base))) == "run00009"
    assert os.path.basename(PC.next_run_dir(str(base))) == "run00010"


@pytest.mark.parametrize("kw", [{}, {"use_bn": True},
                                {"upsample": "pixelShuffle"},
                                {"model": "TecoGAN"}])
def test_params_npz_both_ways(tmp_path, kw):
    """A port-written params.npz loads in JAX's `load_params_npz` (same
    keys, layouts and values), and a JAX-written one in the port's."""
    import jax
    from isosurfacesuperresolution_tpu.config import ModelConfig as JMC
    from isosurfacesuperresolution_tpu.models.generators import (
        create_network as j_create)
    cfg = dict(num_residual_blocks=2, num_features=8, **kw)
    model = create_network(ModelConfig(**cfg),
                           generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "p.npz")
    PC.save_params_npz(path, model)
    jnet = j_create(JMC(**cfg))
    cin = network_input_channels(ModelConfig(**cfg))
    x = np.random.RandomState(0).rand(1, 6, 6, cin).astype(np.float32)
    template = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, cin)))
    jparams = JC.load_params_npz(path, template)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jpath = str(tmp_path / "j.npz")
    JC.save_params_npz(jpath, template)
    other = PC.load_params_npz(jpath, create_network(ModelConfig(**cfg)))
    with np.load(jpath) as z:
        assert sorted(z.files) == sorted(np.load(path).files)
    for k, v in port_layout(template, ModelConfig(**cfg)).items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), v)


def test_checkpoint_manager_round_trip(tmp_path):
    from isosurfacesuperresolution_tpu_torch.config import (
        LossConfig, TrainConfig)
    cfg = Config(model=ModelConfig(num_residual_blocks=1, num_features=8),
                 loss=LossConfig(losses="l1:mask:1,adv:all:0.3", padding=2),
                 train=TrainConfig(batch_size=2, crop_size=8, num_frames=2))

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        model = create_network(cfg.model, generator=gen)
        crit = LossNetUnshaded(cfg.loss, high_res=32)
        spec = PT.make_optimizer(cfg)
        return PT.create_train_state(cfg, model, crit, spec, gen,
                                     discr_optimizer=spec), crit

    state, crit = fresh(0)
    d_step, g_step = PT.make_adv_train_steps(cfg, state.model, crit)
    batch = to_torch(*clip(0, t=2))
    d_step(state, *batch, (0, 1))
    g_step(state, *batch)
    mgr = PC.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.save(4, state)
    assert mgr.latest_epoch() == 4 and mgr.epochs() == [1, 4]
    assert os.path.isfile(tmp_path / "checkpoints" / "epoch_4.pt")
    other, _ = fresh(1)
    other, epoch = mgr.restore(other)
    assert epoch == 4 and other.step == state.step == 1
    for a, b in ((other.model, state.model),
                 (other.discriminators, state.discriminators)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert other.optimizer.count == 1 and other.discr_optimizer.count == 1
    for x, y in zip(other.optimizer.state["nu"], state.optimizer.state["nu"]):
        assert torch.equal(x, y)
    model, epoch = mgr.restore_params(create_network(cfg.model), 1)
    assert epoch == 1 and torch.equal(model.pre.weight,
                                      state.model.pre.weight)
    third, _ = fresh(2)
    mgr.restore_discr_params(third.discriminators)
    assert torch.equal(third.discriminators["adv"].fc2.weight,
                       state.discriminators["adv"].fc2.weight)
    PC.CheckpointManager(str(tmp_path), max_to_keep=1).save(5, state)
    assert mgr.epochs() == [5]


def test_orbax_checkpoints_are_refused(tmp_path):
    """A run dir with an orbax step restores in full (run00022's step 70
    into a state of its config: the generator, Adam's state behind the
    clip, the step; held leaf for leaf against JAX's restore in
    `tests/test_torch_port_resume.py`); a digit-named directory without a
    database is refused, naming orbax, by every restore."""
    from isosurfacesuperresolution_tpu_torch.config import config_from_json
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "artifacts", "run00022", "run00022")
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    os.symlink(os.path.join(src, "checkpoints", "70"),
               run / "checkpoints" / "70")
    cfg = config_from_json(os.path.join(src, "config.json"))
    model = create_network(cfg.model, generator=torch.Generator())
    crit = LossNetUnshaded(cfg.loss, high_res=cfg.train.crop_size * 4)
    state = PT.create_train_state(cfg, model, crit, PT.make_optimizer(cfg))
    state, epoch = PC.CheckpointManager(str(run)).restore(state)
    assert epoch == 70 and state.step == state.optimizer.count == 4200
    assert state.optimizer.learning_rate == np.float32(3.125e-06)
    assert all(float(m.abs().max()) > 0 for m in state.optimizer.state["nu"])

    (tmp_path / "checkpoints" / "3").mkdir(parents=True)
    mgr = PC.CheckpointManager(str(tmp_path))
    assert mgr.latest_epoch() == 3
    with pytest.raises(FileNotFoundError, match="orbax"):
        mgr.restore(None)
    with pytest.raises(FileNotFoundError, match="orbax"):
        mgr.restore_params(torch.nn.Linear(1, 1))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

TINY = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
        "--numFrames", "3", "--cropSize", "8", "--samples", "16",
        "--batchSize", "2", "--numResidualLayers", "1", "--numFeatures", "8",
        "--aoSamples", "0", "--lossBorderPadding", "2", "--imageEvery", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny CPU epoch of the port's trainer, then a --restore for a
    second."""
    base = str(tmp_path_factory.mktemp("train") / "runs")
    run1 = main_video_unshaded.main(TINY + ["--epochs", "1",
                                            "--runDir", base])
    run2 = main_video_unshaded.main(TINY + ["--epochs", "2",
                                            "--runDir", base,
                                            "--restore", run1])
    return run1, run2


def test_main_writes_a_run_dir(trained):
    run1, run2 = trained
    assert sorted(os.listdir(run1)) == ["checkpoints", "config.json",
                                        "images", "info.txt", "params.npz",
                                        "scalars.jsonl", "tensorboard"]
    assert os.listdir(os.path.join(run1, "tensorboard"))[0].startswith(
        "events.out.tfevents.")
    assert os.listdir(os.path.join(run1, "checkpoints")) == ["epoch_1.pt"]
    tags = [json.loads(line)["tag"]
            for line in open(os.path.join(run1, "scalars.jsonl"))]
    assert tags == ["train/total_loss", "train/lr", "test/total_loss",
                    "test/psnr"]
    rows = [json.loads(line) for line in open(os.path.join(run1,
                                                           "scalars.jsonl"))]
    assert all(np.isfinite(r["value"]) for r in rows)
    assert "test_shaded_1.npy" in os.listdir(os.path.join(run1, "images"))
    # --restore resumes at the next epoch
    assert os.listdir(os.path.join(run2, "checkpoints")) == ["epoch_2.pt"]
    steps = {json.loads(line)["step"]
             for line in open(os.path.join(run2, "scalars.jsonl"))}
    assert steps == {2}


def test_main_config_json_has_jax_keys(trained, tmp_path):
    from isosurfacesuperresolution_tpu.config import Config as JConfig
    d = JC.next_run_dir(str(tmp_path / "runs"))
    JC.write_info(d, JConfig())
    want = json.load(open(os.path.join(d, "config.json")))
    got = json.load(open(os.path.join(trained[0], "config.json")))
    assert sorted(got) == sorted(want)


def test_port_run_dir_loads_in_both_packages(trained):
    """JAX's `LoadedModel.from_run_dir` reads the port's params.npz (its
    checkpoints/ holds files, not orbax directories) to the port's
    output; the port reads params.npz and checkpoints/epoch_<N>.pt."""
    run1, run2 = trained
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jlm = JLoadedModel.from_run_dir(run2)
    plm = LoadedModel.from_run_dir(run2, device="cpu")
    cin = network_input_channels(plm.cfg.model)
    x = np.random.RandomState(1).rand(1, 8, 8, cin).astype(np.float32)
    want = np.asarray(jlm.model.apply(jlm.params, jnp.asarray(x))[0])
    with torch.no_grad():
        got = plm.model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        ep2 = LoadedModel.from_run_dir(run2, epoch=2, device="cpu").model(
            torch.from_numpy(x))[0].numpy()
        ep1 = LoadedModel.from_run_dir(run1, epoch=1, device="cpu").model(
            torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(ep2, got)
    assert not np.array_equal(ep1, ep2)


@pytest.mark.parametrize("argv,missing", [
    (["--dataset", "volume.dat"], "volume.dat"),
    (["--dataset", "descriptor:list.txt"], "list.txt"),
], ids=["argv0-slice 10", "argv1-slice 10"])
def test_main_refuses_what_later_slices_bring(tmp_path, argv, missing):
    """The datasets slice 10 brought reach the importers (held against
    JAX's in test_torch_port_frontends.py): a missing file is reported
    as missing, not refused."""
    with pytest.raises(FileNotFoundError, match=missing):
        main_video_unshaded.main(TINY + ["--runDir", str(tmp_path)] + argv)


def test_sigterm_checkpoints_then_exits(tmp_path, monkeypatch):
    """SIGTERM during training: the handler only sets a flag, the loop
    stops at the next batch, saves the interrupted epoch's checkpoint and
    params.npz and returns; the old handler is restored."""
    import signal

    make = PT.make_train_step

    def make_and_signal(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = []

        def wrapped(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*a, **k)
        return wrapped

    monkeypatch.setattr(PT, "make_train_step", make_and_signal)
    before = signal.getsignal(signal.SIGTERM)
    run = main_video_unshaded.main(TINY + ["--epochs", "3", "--runDir",
                                           str(tmp_path / "runs")])
    assert signal.getsignal(signal.SIGTERM) is before
    assert os.listdir(os.path.join(run, "checkpoints")) == ["epoch_1.pt"]
    assert os.path.exists(os.path.join(run, "params.npz"))
    mgr = PC.CheckpointManager(run)
    state = torch.load(mgr.path(1), weights_only=True)
    assert state["step"] == 2 and state["epoch"] == 1
