"""One rank of the CPU gloo group that `tests/test_torch_port_parallel.py`
spawns (torch and the port only, no JAX): data-parallel steps (flat,
2x2 hybrid, a process-local batch, the shaded step), the slab-sharded
sweep with its collectives counted and the planes each scan received,
and the multi-camera render.  Each
rank writes ``rank<r>.npz`` into the output directory."""

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from isosurfacesuperresolution_tpu_torch import config as pconfig
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network)
from isosurfacesuperresolution_tpu_torch.parallel import mesh as pmesh
from isosurfacesuperresolution_tpu_torch.parallel import multihost
from isosurfacesuperresolution_tpu_torch.parallel import sharded_sweep
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.train import trainer as PT
from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as PS
from isosurfacesuperresolution_tpu_torch.volume import analytic

WORLD = 4
BATCH = 4
STEPS = 2
# the sharded sweep's views: (eye, AO samples); the volume's 62 slices
# do not divide into 4 slabs
SWEEP_VIEWS = {"front": ((0.3, 0.8, -1.7), 0), "side": ((1.8, 0.2, 0.3), 0),
               "front_ao": ((0.3, 0.8, -1.7), 64)}
SWEEP_RES = 62
SWEEP_W, SWEEP_H = 48, 40
N_CAMERAS = 8


def dp_config(shaded=False):
    model = {"num_residual_blocks": 2, "num_features": 8}
    loss = {"padding": 2}
    if shaded:
        model.update(input_channels=8, output_channels=3,
                     channel_mask=(0, 1, 2))
        loss["losses"] = "l1:1,temp-l2:0.1"
    return pconfig.Config(
        model=pconfig.ModelConfig(**model), loss=pconfig.LossConfig(**loss),
        train=pconfig.TrainConfig(batch_size=BATCH, crop_size=8,
                                  num_frames=3, learning_rate=2e-3))


def dp_batch(seed, shaded=False):
    """A seeded global batch (numpy): 4 clips of 3 frames, 8 -> 32."""
    rng = np.random.RandomState(seed)
    cin, cout = (8, 3) if shaded else (5, 6)
    low = rng.rand(BATCH, 3, 8, 8, cin).astype(np.float32)
    if shaded:
        low[..., 3] = (low[..., 3] > 0.3)
    else:
        low[..., 0] = np.sign(low[..., 0] - 0.3)
    flow = (rng.rand(BATCH, 3, 8, 8, 2).astype(np.float32) * 2 - 1) * 0.05
    high = rng.rand(BATCH, 3, 32, 32, cout).astype(np.float32)
    return low, flow, high


def dp_setup(shaded=False):
    """A fresh model, criterion and train state from a fixed seed (the
    same on every rank and in the test's 1-way reference)."""
    cfg = dp_config(shaded)
    gen = torch.Generator().manual_seed(3)
    model = create_network(cfg.model, generator=gen)
    if shaded:
        crit = LossNet(cfg.loss, 32, 8, 3, losses=cfg.loss.losses)
        state = PS.create_shaded_train_state(cfg, model, crit,
                                             PT.make_optimizer(cfg), gen)
        step = PS.make_shaded_train_step(cfg, model, crit)
    else:
        crit = LossNetUnshaded(cfg.loss, high_res=32)
        state = PT.create_train_state(cfg, model, crit,
                                      PT.make_optimizer(cfg), gen)
        step = PT.make_train_step(cfg, model, crit)
    return model, state, step


def run_steps(step, state, shaded=False, local_mesh=None):
    """STEPS steps on seeded batches -> (losses, the losses the guard
    saw); with ``local_mesh`` each batch enters as this rank's share."""
    losses, seen = [], []
    for i in range(STEPS):
        batch = dp_batch(20 + i, shaded)
        if local_mesh is not None:
            r, n = pmesh.shard_index(local_mesh)
            b = BATCH // n
            share = multihost.process_local_batch(
                local_mesh, [x[r * b:(r + 1) * b] for x in batch])
            state, loss = step(state, *share, local=True,
                               accept=lambda l: seen.append(float(l)) or True)
        else:
            state, loss = step(state, *map(torch.from_numpy, batch),
                               accept=lambda l: seen.append(float(l)) or True)
        losses.append(float(loss))
    return np.asarray(losses), np.asarray(seen)


def flat_params(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def sweep_grid():
    return attach_baked_ao(analytic.blobs_volume(SWEEP_RES, num_blobs=5,
                                                 device="cpu"), 0.5, 0.1)


def sweep_cfg(ao):
    return RenderConfig(width=SWEEP_W, height=SWEEP_H, isovalue=0.5,
                        ao_samples=ao, ao_mode="volume" if ao else "auto")


def camera_batch():
    angs = np.linspace(0, 2 * np.pi, N_CAMERAS, endpoint=False)
    eyes = np.stack([1.7 * np.sin(angs), np.full(N_CAMERAS, 0.7),
                     -1.7 * np.cos(angs)], -1).astype(np.float32)
    looks = np.zeros((N_CAMERAS, 3), np.float32)
    ups = np.tile(np.float32([[0.0, 1.0, 0.0]]), (N_CAMERAS, 1))
    return eyes, looks, ups


def camera_cfg():
    return RenderConfig(width=16, height=16, isovalue=0.5, ao_samples=0,
                        renderer="sweep_pallas")


class CountCollectives:
    """Count the collectives called through `torch.distributed` while
    active."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "all_gather_object", "batch_isend_irecv", "broadcast")

    def __enter__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {}
        for name in self.NAMES:
            fn = self.saved[name] = getattr(dist, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.counts[_name] += 1
                return _fn(*a, **k)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


class RecordScans:
    """Record the planes of the volume (and of the AO field) that each
    `scan_march` call of the slab sweep receives while active."""

    def __enter__(self):
        self.planes = []
        self.saved = sharded_sweep.scan_march

        def recorded(vol_zxy, *a, ao_zcxy=None, **k):
            self.planes.append((vol_zxy.shape[0], 0 if ao_zcxy is None
                                else ao_zcxy.shape[0]))
            return self.saved(vol_zxy, *a, ao_zcxy=ao_zcxy, **k)
        sharded_sweep.scan_march = recorded
        return self

    def __exit__(self, *exc):
        sharded_sweep.scan_march = self.saved


def worker(rank, init_method, out_dir):
    torch.set_num_threads(1)
    multihost.initialize_distributed(init_method, WORLD, rank,
                                     device=torch.device("cpu"))
    res = {}
    try:
        flat_mesh = pmesh.make_mesh(WORLD)
        model, state, step = dp_setup()
        res["flat_losses"], res["flat_seen"] = run_steps(
            pmesh.make_sharded_train_step(step, flat_mesh), state)
        for k, v in flat_params(model).items():
            res["flat/" + k] = v

        hybrid = multihost.make_hybrid_mesh(2)
        res["hybrid_coord"] = np.asarray(hybrid.get_coordinate())
        model, state, step = dp_setup()
        res["hybrid_losses"], _ = run_steps(
            multihost.make_hybrid_train_step(step, hybrid), state)
        for k, v in flat_params(model).items():
            res["hybrid/" + k] = v

        model, state, step = dp_setup()
        res["local_losses"], _ = run_steps(
            multihost.make_hybrid_train_step(step, hybrid), state,
            local_mesh=hybrid)
        for k, v in flat_params(model).items():
            res["local/" + k] = v

        model, state, step = dp_setup(shaded=True)
        res["shaded_losses"], _ = run_steps(
            pmesh.make_sharded_train_step(step, flat_mesh), state,
            shaded=True)
        for k, v in flat_params(model).items():
            res["shaded/" + k] = v

        zmesh = pmesh.make_mesh(WORLD, axis_name="z")
        grid = sweep_grid()
        for name, (eye, ao) in SWEEP_VIEWS.items():
            cam = CameraParams.create(eye)
            with CountCollectives() as c, RecordScans() as scans:
                res["sweep/" + name] = (
                    sharded_sweep.render_gbuffer_sweep_sharded(
                        grid, cam, cam, sweep_cfg(ao), zmesh).numpy())
            res["collectives/" + name] = np.asarray(
                [c.counts[n] for n in CountCollectives.NAMES])
            res["scan_planes/" + name] = np.asarray(scans.planes)

        eyes, looks, ups = camera_batch()
        res["cameras"] = pmesh.render_cameras_sharded(
            analytic.sphere_volume(32, device="cpu"),
            *map(torch.from_numpy, (eyes, looks, ups)), camera_cfg(),
            flat_mesh).numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def launch(out_dir):
    """Spawn the WORLD ranks and wait for them (file rendezvous)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as rdv:
        mp.start_processes(worker, args=("file://" + os.path.join(
            rdv, "rendezvous"), out_dir), nprocs=WORLD, join=True,
            start_method="spawn")


if __name__ == "__main__":
    launch(sys.argv[1])
