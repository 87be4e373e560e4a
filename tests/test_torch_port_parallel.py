"""The port's parallel layer (`parallel/` on `torch.distributed`) on the
CPU: one gloo group of 4 ranks, spawned once for the module
(`tests/_torch_port_parallel_worker.py`, in a subprocess with a 120 s
limit, so a stuck collective fails the tests instead of hanging them),
and one `main_video_unshaded --dataParallel 2` run.

- Data-parallel steps (flat 4-way, the 2x2 ("dcn", "ici") hybrid, the
  hybrid fed process-local shares, the shaded step) against the port's
  1-way step on the whole batch, which `tests/test_torch_port_train.py`
  and `tests/test_torch_port_shaded.py` hold against JAX.  Tolerance:
  losses rel 1e-6 (the same float32 terms, the batch mean taken as a mean
  of four shard means); parameters after two Adam steps within 1e-3 x lr,
  but for at most 1% of a leaf within 0.1 x lr (gradients equal to
  float32 rounding; Adam's normalized step can move an element whose
  gradient is that small by a visible fraction of lr).
- The slab-sharded sweep at D = 4 over a 62-slice axis (slabs of 16, the
  last padded) with and without the baked AO field: against JAX's
  `render_gbuffer_sweep_sharded` on a 4-device mesh under
  `tests/test_sharded_sweep.py`'s bounds (mask mismatch < 1%; where both
  hit: depth 1e-3, normals 5e-3; AO: 95th percentile < 0.02), and equal
  to the port's single-device sweep bit for bit (the same float32 scan,
  cut at slab boundaries).  The combine is two all-reduces and no
  all-gather.
- `render_cameras_sharded` of 8 cameras: bit for bit the per-camera
  renders.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_port_parallel_worker as W
from _torch_port_training import one_torch_thread  # noqa: F401
from isosurfacesuperresolution_tpu.config import (
    RenderConfig as JRenderConfig)
from isosurfacesuperresolution_tpu.parallel.sharded_sweep import (
    render_gbuffer_sweep_sharded as j_sharded)
from isosurfacesuperresolution_tpu.render.ao_sweep import (
    attach_baked_ao as j_attach_baked_ao)
from isosurfacesuperresolution_tpu.render.camera import (
    CameraParams as JCameraParams)
from isosurfacesuperresolution_tpu.volume import analytic as janalytic
from isosurfacesuperresolution_tpu_torch.parallel.sharded_sweep import HALO
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, {name: array} each."""
    out = tmp_path_factory.mktemp("gloo4")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_port_parallel_worker.py"),
         str(out)], env=_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(W.WORLD)]


def one_way(shaded=False):
    model, state, step = W.dp_setup(shaded)
    losses, _ = W.run_steps(step, state, shaded)
    return losses, W.flat_params(model)


@pytest.fixture(scope="module")
def reference():
    return {False: one_way(False), True: one_way(True)}


def assert_close_after_adam(got, want, lr):
    for k, w in want.items():
        d = np.abs(got[k] - w)
        far = d > 1e-3 * lr
        assert far.sum() <= 0.01 * d.size, (k, int(far.sum()), d.size)
        assert d.max() < 0.1 * lr, (k, float(d.max() / lr))


@pytest.mark.parametrize("kind", ["flat", "hybrid", "local", "shaded"])
def test_data_parallel_step_equals_one_way_step(ranks, reference, kind):
    """Every rank ends with the same parameters, those of the 1-way step
    on the whole batch; the losses are the whole batch's."""
    want_losses, want = reference[kind == "shaded"]
    lr = W.dp_config().train.learning_rate
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{kind}_losses"], want_losses,
                                   rtol=1e-6, err_msg=f"rank {r}")
        got = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith(kind + "/")}
        assert sorted(got) == sorted(want)
        assert_close_after_adam(got, want, lr)
        for k, v in got.items():
            np.testing.assert_array_equal(
                v, ranks[0][f"{kind}/{k}"], err_msg=f"rank {r} {k}")


def test_spike_guard_sees_one_loss_on_every_rank(ranks):
    """The guard reads the all-reduced loss, so every rank decides alike."""
    for res in ranks:
        np.testing.assert_array_equal(res["flat_seen"], ranks[0]["flat_seen"])
        np.testing.assert_array_equal(res["flat_seen"], res["flat_losses"])


def test_hybrid_mesh_is_dcn_by_ici(ranks):
    assert [tuple(res["hybrid_coord"]) for res in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.fixture(scope="module")
def sweep_refs():
    """JAX's sharded sweep on a 4-device mesh and the port's single
    sweep, for each view."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:W.WORLD]), ("z",))
    jgrid = j_attach_baked_ao(janalytic.blobs_volume(W.SWEEP_RES,
                                                     num_blobs=5), 0.5, 0.1)
    grid = W.sweep_grid()
    out = {}
    for name, (eye, ao) in W.SWEEP_VIEWS.items():
        jcam = JCameraParams.create(eye)
        jcfg = JRenderConfig(width=W.SWEEP_W, height=W.SWEEP_H, isovalue=0.5,
                             ao_samples=ao,
                             ao_mode="volume" if ao else "auto")
        cam = CameraParams.create(eye)
        out[name] = (np.asarray(j_sharded(jgrid, jcam, jcam, jcfg, mesh)),
                     render_gbuffer_sweep(grid, cam, cam,
                                          W.sweep_cfg(ao)).numpy())
    return out


@pytest.mark.parametrize("view", sorted(W.SWEEP_VIEWS))
def test_sharded_sweep_matches_jax_and_the_single_sweep(ranks, sweep_refs,
                                                        view):
    jref, single = sweep_refs[view]
    got = ranks[0]["sweep/" + view]
    assert got.shape == jref.shape == (W.SWEEP_H, W.SWEEP_W, 12)
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["sweep/" + view], got)
    np.testing.assert_array_equal(got, single)
    assert np.mean(jref[..., 3] != got[..., 3]) < 0.01
    both = (jref[..., 3] > 0.5) & (got[..., 3] > 0.5)
    assert both.sum() > 50
    for ch, tol in ((7, 1e-3), (4, 5e-3), (5, 5e-3), (6, 5e-3)):
        d = np.abs(jref[..., ch] - got[..., ch])[both]
        assert d.max() < tol, (ch, d.max())
    if W.SWEEP_VIEWS[view][1]:
        d_ao = np.abs(jref[..., 10] - got[..., 10])[both]
        assert np.quantile(d_ao, 0.95) < 0.02, d_ao.max()


@pytest.mark.parametrize("view", sorted(W.SWEEP_VIEWS))
def test_sharded_combine_has_no_all_gather(ranks, view):
    """Per-rank memory must not grow with D: the combine is one MIN and
    one SUM all-reduce, the halo one batch of point-to-point sends per
    field, and nothing gathers a (D, ...) buffer."""
    ao = W.SWEEP_VIEWS[view][1] > 0
    for res in ranks:
        counts = dict(zip(W.CountCollectives.NAMES,
                          res["collectives/" + view].tolist()))
        assert counts == {"all_reduce": 2, "all_gather": 0,
                          "all_gather_into_tensor": 0,
                          "all_gather_object": 0,
                          "batch_isend_irecv": 2 if ao else 1,
                          "broadcast": 0}, counts


@pytest.mark.parametrize("view", sorted(W.SWEEP_VIEWS))
def test_sharded_sweep_scans_only_its_slab(ranks, view):
    """Each rank's one scan gets its slab of ceil(62 / 4) = 16 planes and
    the two halos of ``HALO`` planes, of the volume and of the AO field,
    and nothing of the rest of the volume."""
    slab = -(-W.SWEEP_RES // W.WORLD) + 2 * HALO
    ao = W.SWEEP_VIEWS[view][1] > 0
    for res in ranks:
        assert res["scan_planes/" + view].tolist() == [
            [slab, slab if ao else 0]]


def test_render_cameras_sharded_equals_per_camera_renders(ranks):
    grid = analytic.sphere_volume(32, device="cpu")
    eyes, looks, ups = W.camera_batch()
    want = np.stack([render_frame_gbuffer(
        grid, cam, cam, W.camera_cfg()).numpy()
        for cam in (CameraParams.create(e, l, u) for e, l, u in
                    zip(eyes, looks, ups))])
    for res in ranks:
        assert res["cameras"].shape == (W.N_CAMERAS, 16, 16, 12)
        np.testing.assert_array_equal(res["cameras"], want)
    assert want[..., 3].max() == 1.0


TINY = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
        "--numFrames", "3", "--cropSize", "8", "--samples", "16",
        "--batchSize", "2", "--numResidualLayers", "1", "--numFeatures", "8",
        "--aoSamples", "0", "--lossBorderPadding", "2", "--imageEvery", "0",
        "--epochs", "1", "--device", "cpu"]


def run_both(tmp_path, extra):
    """`main_video_unshaded` with ``extra`` flags twice on one seed:
    ``--dataParallel 1 --hostData`` in this process and ``--dataParallel
    2`` as a command (two spawned workers) -> the two run dirs."""
    from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
    one = main_video_unshaded.main(
        TINY + extra + ["--hostData", "--runDir", str(tmp_path / "one")])
    proc = subprocess.run(
        [sys.executable, "-m",
         "isosurfacesuperresolution_tpu_torch.apps.main_video_unshaded"]
        + TINY + extra + ["--dataParallel", "2", "--runDir",
                          str(tmp_path / "two")],
        env=_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert len(os.listdir(tmp_path / "two")) == 1
    return one, os.path.join(str(tmp_path / "two"),
                             os.listdir(tmp_path / "two")[0])


def scalars(run):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [(r["tag"], r["value"], r["step"]) for r in map(json.loads, f)]


def test_main_video_unshaded_data_parallel_matches_one_way(tmp_path):
    """``--dataParallel 2 --device cpu`` (two spawned workers, host
    batching) against ``--dataParallel 1 --hostData`` on the same seed:
    the same epoch loss and test PSNR, the same parameters after the
    epoch's Adam steps (bounds as above)."""
    one, two = run_both(tmp_path, [])
    a, b = dict((t, v) for t, v, _ in scalars(one)), dict(
        (t, v) for t, v, _ in scalars(two))
    assert sorted(a) == sorted(b)
    for tag in a:
        np.testing.assert_allclose(b[tag], a[tag], rtol=1e-6, err_msg=tag)
    pa = np.load(os.path.join(one, "params.npz"))
    pb = np.load(os.path.join(two, "params.npz"))
    assert_close_after_adam({k: pb[k] for k in pb.files},
                            {k: pa[k] for k in pa.files}, 1e-4)


def test_data_parallel_adversarial_steps_run_once_on_process_0(tmp_path):
    """With ``--advTraining`` the steps stay unsharded, as in JAX: process
    0 runs them alone on the whole batch, so ``--dataParallel 2`` writes
    the 1-way run's scalars and parameters bit for bit (the same
    operations on the same CPU)."""
    one, two = run_both(tmp_path, ["--advTraining", "--losses",
                                   "l1:mask:1,adv:all:0.3"])
    assert scalars(two) == scalars(one)
    assert any(t == "train/discr_loss" for t, _, _ in scalars(one))
    pa = np.load(os.path.join(one, "params.npz"))
    pb = np.load(os.path.join(two, "params.npz"))
    assert sorted(pa.files) == sorted(pb.files)
    for k in pa.files:
        np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)
