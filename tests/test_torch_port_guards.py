"""Guards of the port: it imports nothing of JAX (nor flax, optax, orbax,
tensorstore, tensorboardX, tensorboard or protobuf) or the JAX package,
its entry points run on the card unless asked
for the CPU, and the kernel wrappers never fall back from a CUDA request
to the plain version."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.apps import adv_evidence
from isosurfacesuperresolution_tpu_torch.apps import convert_volume
from isosurfacesuperresolution_tpu_torch.apps import dataset_viewer
from isosurfacesuperresolution_tpu_torch.apps import discr_test
from isosurfacesuperresolution_tpu_torch.apps import image_vis
from isosurfacesuperresolution_tpu_torch.apps import main_comparison
from isosurfacesuperresolution_tpu_torch.apps import main_comparison_video
from isosurfacesuperresolution_tpu_torch.apps import main_gui
from isosurfacesuperresolution_tpu_torch.apps import main_psnr_allangles
from isosurfacesuperresolution_tpu_torch.apps import main_psnr_crops
from isosurfacesuperresolution_tpu_torch.apps import main_psnr_stats
from isosurfacesuperresolution_tpu_torch.apps import main_video_shaded
from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
from isosurfacesuperresolution_tpu_torch.apps import render_cli
from isosurfacesuperresolution_tpu_torch.apps import train_texenc
from isosurfacesuperresolution_tpu_torch.apps import vgg_analysis
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer import pipeline
from isosurfacesuperresolution_tpu_torch.infer import torch_export
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.models.generators import EnhanceNet
from isosurfacesuperresolution_tpu_torch import ops as port_ops
from isosurfacesuperresolution_tpu_torch.ops import packed_conv
from isosurfacesuperresolution_tpu_torch.ops import pallas_conv
from isosurfacesuperresolution_tpu_torch.ops import phase_conv
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled
from isosurfacesuperresolution_tpu_torch.train.device_data import (
    DeviceVideoDataset)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume import importers
from isosurfacesuperresolution_tpu_torch.volume import vdb
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    PackedAOAxisVolume, PackedAxisVolume, SparseBrickGrid)
from isosurfacesuperresolution_tpu_torch.volume.vdb_write import write_vdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FILES = {}


def _files() -> dict:
    """Tiny volume files for the importers' entry points, written once
    into a temporary directory at first use."""
    if not _FILES:
        d = tempfile.mkdtemp(prefix="guards_")
        vol = (np.arange(8 ** 3) % 251).astype(np.uint8).reshape(8, 8, 8)
        vol.transpose(2, 1, 0).tofile(os.path.join(d, "v.raw"))
        with open(os.path.join(d, "v.dat"), "w") as f:
            f.write("ObjectFileName: v.raw\nResolution: 8 8 8\n"
                    "Format: UCHAR\n")
        np.save(os.path.join(d, "v.npy"), vol / np.float32(255))
        write_vdb(os.path.join(d, "v.vdb"), vol / np.float32(255))
        importers.save_cvol(os.path.join(d, "v.cvol.npz"),
                            BrickGrid.from_dense(vol, device="cpu"))
        _FILES.update(dir=d, **{k: os.path.join(d, f"v.{k}")
                                for k in ("dat", "npy", "vdb")},
                      cvol=os.path.join(d, "v.cvol.npz"))
    return _FILES

_IMPORT_ALL = """
import importlib, pkgutil, sys
import isosurfacesuperresolution_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "tensorstore", "tensorboardX",
                                    "tensorboard",
                                    "isosurfacesuperresolution_tpu")
             or m == "google.protobuf" or m.startswith("google.protobuf."))
print(" ".join(names))
print(bad)
"""

NEW_MODULES = ("infer.planar", "ops.phase_conv", "ops.fused_upsample",
               "render.ao_sweep", "render.sweep_tiled", "volume.grid",
               "volume.packed", "ops.pallas_conv", "ops.packed_conv",
               "utils.spectral_norm", "profile_convs", "ops.sampling",
               "infer.torch_import", "infer.torch_export",
               "render.raycast", "render.volume_render", "render.ssao",
               "data.generation", "utils.jax_prng", "ops.metrics",
               "losses.builder", "losses.vgg", "losses.discriminators",
               "losses.lossnet_unshaded", "data.dataset",
               "data.dataset_single", "train.optim", "train.trainer",
               "train.checkpoint", "train.device_data",
               "apps.main_video_unshaded", "losses.lossnet",
               "train.trainer_shaded", "apps.main_video_shaded",
               "train.ocdbt", "parallel.mesh", "parallel.multihost",
               "parallel.sharded_sweep", "native.build", "native.volumeio",
               "native.vdbio", "volume.importers", "volume.vdb",
               "volume.vdb_write", "data.exr", "bench.stats",
               "infer.pipe_client", "apps.convert_volume",
               "apps.render_cli", "apps.render_server",
               "apps.main_psnr_stats", "utils.profiling", "apps.main_gui",
               "apps.image_vis", "apps.main_comparison",
               "apps.main_comparison_video", "apps.main_psnr_allangles",
               "apps.main_psnr_crops", "apps.vgg_analysis",
               "apps.discr_test", "losses.learned_features",
               "apps.train_texenc", "apps.adv_evidence",
               "apps.dataset_viewer", "apps.delete_empty_runs",
               "utils.tensorboard")


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().splitlines()
    names = names.split()
    assert len(names) >= 78          # every module of the port was imported
    for mod in NEW_MODULES:
        assert f"isosurfacesuperresolution_tpu_torch.{mod}" in names
    assert bad == "[]"


_WRITE_EVENTS = """
import sys, tempfile
import numpy as np
from isosurfacesuperresolution_tpu_torch.apps.main_video_unshaded import (
    ScalarWriter)
w = ScalarWriter(tempfile.mkdtemp())
w.add_scalar("train/total_loss", 0.5, 1)
w.add_image("test/shaded", np.zeros((3, 4, 12), np.float32), 1)
w.close()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("tensorboardX", "tensorboard")
             or m == "google.protobuf" or m.startswith("google.protobuf.")))
"""


def test_event_writer_imports_no_tensorboard_or_protobuf():
    """The trainers' writer writes a scalar and an image into its event
    file without tensorboardX, tensorboard or protobuf, also not lazily."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WRITE_EVENTS], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


ENTRY_POINTS = {
    "blobs_volume": lambda: analytic.blobs_volume(8),
    "sphere_volume": lambda: analytic.sphere_volume(8),
    "LoadedModel.from_run_dir": lambda: LoadedModel.from_run_dir(
        os.path.join(ROOT, "artifacts", "run00017")),
    "LoadedModel.from_run_dir fast": lambda: LoadedModel.from_run_dir(
        os.path.join(ROOT, "artifacts", "run00017"), fast=True),
    "LoadedModel.from_params_npz": lambda: LoadedModel.from_params_npz(
        os.path.join(ROOT, "artifacts", "run00017", "params.npz"), Config()),
    "export_reference_pth": lambda: torch_export.export_reference_pth(
        os.path.join(ROOT, "artifacts", "run00017"), os.devnull),
    "initial_state": lambda: pipeline.initial_state(
        Config(), RenderConfig(width=8, height=8)),
    "FusedFrame": lambda: pipeline.FusedFrame(
        None, Config(), RenderConfig(), upscale_mode="bilinear"),
    "DeviceVideoDataset": lambda: DeviceVideoDataset(
        [{"low": np.zeros((1, 4, 4, 5), np.float32),
          "high": np.zeros((1, 16, 16, 6), np.float32),
          "flow": np.zeros((1, 4, 4, 2), np.float32)}]),
    "main_video_unshaded.main": lambda: main_video_unshaded.main(
        ["--dataset", "analytic:sphere", "--runDir", os.devnull]),
    "main_video_unshaded.main dataParallel": lambda: main_video_unshaded.main(
        ["--dataset", "analytic:sphere", "--runDir", os.devnull,
         "--dataParallel", "2"]),
    "main_video_shaded.main": lambda: main_video_shaded.main(
        ["--dataset", "analytic:sphere", "--runDir", os.devnull]),
    "LoadedModel.from_run_dir orbax": lambda: LoadedModel.from_run_dir(
        os.path.join(ROOT, "artifacts", "run00022", "run00022")),
    "importers.import_raw": lambda: importers.import_raw(_files()["dat"]),
    "importers.import_npy": lambda: importers.import_npy(_files()["npy"]),
    "importers.load_cvol": lambda: importers.load_cvol(_files()["cvol"]),
    "vdb.load_vdb": lambda: vdb.load_vdb(_files()["vdb"]),
    "convert_volume.main": lambda: convert_volume.main(
        [_files()["dat"], os.path.join(_files()["dir"], "o.cvol.npz")]),
    "render_cli.main": lambda: render_cli.main(
        ["--volume", "analytic:sphere:16", "--res", "16,16", "--output",
         os.path.join(_files()["dir"], "cli")]),
    "main_psnr_stats.main": lambda: main_psnr_stats.main(
        ["--volumes", "analytic:sphere:16", "--numSequences", "1",
         "--numFrames", "1", "--highRes", "144", "--aoSamples", "0",
         "--output", os.path.join(_files()["dir"], "stats")]),
    "main_gui.main": lambda: main_gui.main(
        ["--volume", "analytic:sphere:16", "--resX", "8", "--resY", "8",
         "--frames", "1", "--output", os.path.join(_files()["dir"], "gui")]),
    "image_vis.main": lambda: image_vis.main(
        ["--volume", "analytic:sphere:16", "--lowRes", "8", "--output",
         os.path.join(_files()["dir"], "fig")]),
    "main_comparison.main": lambda: main_comparison.main(
        ["--volume", "analytic:sphere:16", "--width", "32", "--height", "32",
         "--warmup", "1", "--timed", "1", "--output",
         os.path.join(_files()["dir"], "cmp")]),
    "main_comparison_video.main": lambda: main_comparison_video.main(
        ["--volume", "analytic:sphere:16", "--frames", "1", "--lowRes", "8",
         "--pngs", "--output", os.path.join(_files()["dir"], "vid")]),
    "main_psnr_allangles.main": lambda: main_psnr_allangles.main(
        ["--volume", "analytic:sphere:16", "--cameras", "1", "--rolls", "1",
         "--lowRes", "8", "--output", os.path.join(_files()["dir"], "aa")]),
    "main_psnr_crops.main": lambda: main_psnr_crops.main(
        ["--dataset", _files()["dir"]]),
    "vgg_analysis.main": lambda: vgg_analysis.main(
        ["--volume", "analytic:sphere:16", "--images", "1", "--res", "16",
         "--layers", "2"]),
    "discr_test.main": lambda: discr_test.main(
        [os.path.join(ROOT, "artifacts", "run00020", "run00020"),
         "--volume", "analytic:sphere:16", "--crops", "1"]),
    "train_texenc.main": lambda: train_texenc.main(
        ["--dataset", _files()["dir"], "--steps", "1", "--output",
         os.path.join(_files()["dir"], "texenc.npz")]),
    "adv_evidence.main": lambda: adv_evidence.main(
        ["--dataset", _files()["dir"], "--models", "bilinear", "--output",
         os.path.join(_files()["dir"], "adv")]),
    "dataset_viewer.main": lambda: dataset_viewer.main(
        [_files()["dir"], "--output", os.path.join(_files()["dir"], "pv")]),
    "dataset_viewer.clip_preview": lambda: dataset_viewer.clip_preview(
        {"high": np.zeros((1, 16, 16, 6), np.float32),
         "flow": np.zeros((1, 4, 4, 2), np.float32)}),
    "InferencePipeline": lambda: pipeline.InferencePipeline(
        EnhanceNet(ModelConfig(num_residual_blocks=1, num_features=8)),
        Config(model=ModelConfig(num_residual_blocks=1, num_features=8)),
        RenderConfig(width=8, height=8)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    """Without ``device`` an entry point runs on the card; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        ENTRY_POINTS[name]()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ENTRY_POINTS[name]()


def test_march_raises_for_cuda_request_without_library(monkeypatch,
                                                        tmp_path):
    """A CUDA request with no buildable library raises; it neither runs the
    plain version nor counts a launch."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(sweep_march, "_FN", None)
    monkeypatch.setattr(sweep_march, "march_plain", plain)
    before = sweep_march.march.launches
    with FakeTensorMode():
        vol = torch.empty((4, 6, 5), device="cuda")
        meta = torch.empty((8, 8), device="cuda")
        sg = torch.empty(7, device="cuda")
        tg = torch.empty(3, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_march.march(vol, meta, sg, tg, 7, 3)
    assert sweep_march.march.launches == before


def _no_library(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(sweep_march, "_FN", None)
    monkeypatch.setattr(sweep_march, "march_plain", plain)
    monkeypatch.setattr(phase_conv, "phase_conv_plain", plain)
    monkeypatch.setattr(sweep_tiled, "_FNS", {})
    monkeypatch.setattr(sweep_tiled, "march_tiled_plain", plain)
    monkeypatch.setattr(sweep_tiled, "ao_capture_tiled_plain", plain)
    monkeypatch.setattr(sweep_tiled, "march_packed_plain", plain)
    monkeypatch.setattr(sweep_tiled, "ao_capture_packed_plain", plain)
    monkeypatch.setattr(pallas_conv, "_FNS", {})
    monkeypatch.setattr(pallas_conv, "conv3x3_p128_plain", plain)
    monkeypatch.setattr(packed_conv, "packed_conv3x3_plain", plain)


def _tiled_args(device):
    """Fake tensors of a tiled march call: (Z, X, Y) volume, table,
    grids and the (bx, by, bz) brick max."""
    return [torch.empty((4, 32, 16), device=device),
            torch.empty((8, 8), device=device),
            torch.empty(7, device=device), torch.empty(3, device=device),
            7, 3, torch.empty((4, 2, 1), device=device), 8, 0.5]


def test_march_tiled_raises_for_cuda_request_without_library(monkeypatch,
                                                             tmp_path):
    _no_library(monkeypatch, tmp_path)
    before = sweep_tiled.march_tiled_kernel.launches
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_tiled.march_tiled(*_tiled_args("cuda"), tile=16)
    assert sweep_tiled.march_tiled_kernel.launches == before


def test_ao_capture_tiled_raises_for_cuda_request_without_library(
        monkeypatch, tmp_path):
    _no_library(monkeypatch, tmp_path)
    before = sweep_tiled.ao_capture_tiled_kernel.launches
    with FakeTensorMode():
        field = torch.empty((2, 4, 16, 8), dtype=torch.uint8, device="cuda")
        _, meta, sg, tg, Sn, Tn, bmax, b, iso = _tiled_args("cuda")
        m_hit = torch.empty((Sn, Tn), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_tiled.ao_capture_tiled(field, meta, sg, tg, Sn, Tn, m_hit,
                                         bmax, b, iso, field_downsample=2)
    assert sweep_tiled.ao_capture_tiled_kernel.launches == before


def test_tiled_kernels_refuse_other_devices():
    args = _tiled_args("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_tiled.march_tiled(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_tiled.ao_capture_tiled(
            torch.empty((2, 4, 16, 8), device="meta"), *args[1:6],
            torch.empty((7, 3), device="meta"), *args[6:])


def _packed(device):
    """Fake packed volume and AO field on ``device``: (4, 32, 16) in
    tiles of (16, 8)."""
    slots = torch.empty((4, 2, 2), dtype=torch.int32, device=device)
    return (PackedAxisVolume(torch.empty((3, 16, 8), dtype=torch.uint8,
                                         device=device), slots,
                             torch.empty(4, device=device), (4, 32, 16)),
            PackedAOAxisVolume(torch.empty((3, 4, 16, 8), device=device),
                               slots, (4, 32, 16)))


def test_march_packed_raises_for_cuda_request_without_library(monkeypatch,
                                                              tmp_path):
    _no_library(monkeypatch, tmp_path)
    before = sweep_tiled.march_packed_kernel.launches
    with FakeTensorMode():
        pa, _ = _packed("cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_tiled.march_packed(pa, *_tiled_args("cuda")[1:])
    assert sweep_tiled.march_packed_kernel.launches == before


def test_ao_capture_packed_raises_for_cuda_request_without_library(
        monkeypatch, tmp_path):
    _no_library(monkeypatch, tmp_path)
    before = sweep_tiled.ao_capture_packed_kernel.launches
    with FakeTensorMode():
        _, pao = _packed("cuda")
        _, meta, sg, tg, Sn, Tn, *_ = _tiled_args("cuda")
        m_hit = torch.empty((Sn, Tn), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_tiled.ao_capture_packed(pao, meta, sg, tg, Sn, Tn, m_hit)
    assert sweep_tiled.ao_capture_packed_kernel.launches == before


def test_packed_kernels_refuse_other_devices():
    pa, pao = _packed("meta")
    args = _tiled_args("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_tiled.march_packed(pa, *args[1:])
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_tiled.ao_capture_packed(pao, *args[1:6],
                                      torch.empty((7, 3), device="meta"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_grid_device_is_where_its_tensors_live(device):
    """`BrickGrid.device` and `SparseBrickGrid.device`, which the entry
    points read for either grid."""
    grid = analytic.sphere_volume(8, device="cpu")
    sparse = SparseBrickGrid.from_brick_grid(grid, tile=4)
    assert grid.device == sparse.device == torch.device("cpu")
    moved = SparseBrickGrid(
        per_axis=(_packed(device)[0],) * 3, brick_min=grid.brick_min,
        brick_max=grid.brick_max, bbox_min=grid.bbox_min,
        bbox_max=grid.bbox_max, resolution=(16, 32, 4))
    assert moved.device == torch.device(device)


def test_fused_frame_refuses_a_packed_grid_on_another_device():
    sparse = SparseBrickGrid.from_brick_grid(
        analytic.sphere_volume(8, device="cpu"), tile=4)
    frame = pipeline.FusedFrame(None, Config(), RenderConfig(),
                                upscale_mode="bilinear", device="meta")
    state = pipeline.FrameState(torch.empty(0), False)
    with pytest.raises(ValueError, match="grid is on cpu, the frame runs "
                                         "on meta"):
        frame(sparse, None, None, state)


def test_march_ao_raises_for_cuda_request_without_library(monkeypatch,
                                                           tmp_path):
    _no_library(monkeypatch, tmp_path)
    before = (sweep_march.march.launches, sweep_march.march.ao_launches)
    with FakeTensorMode():
        vol = torch.empty((4, 6, 5), device="cuda")
        ao = torch.empty((4, 4, 6, 5), device="cuda")
        meta = torch.empty((8, 8), device="cuda")
        sg = torch.empty(7, device="cuda")
        tg = torch.empty(3, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sweep_march.march(vol, meta, sg, tg, 7, 3, ao_zcxy=ao)
    assert (sweep_march.march.launches,
            sweep_march.march.ao_launches) == before


@pytest.mark.parametrize("name", ["phase_conv3x3_amajor",
                                  "phase_conv3x3_amajor_blocked"])
def test_phase_conv_raises_for_cuda_request_without_library(
        monkeypatch, tmp_path, name):
    _no_library(monkeypatch, tmp_path)
    before = phase_conv.phase_conv.launches
    with FakeTensorMode():
        x = torch.empty((1, 5, 7, 256), dtype=torch.bfloat16, device="cuda")
        k3 = torch.empty((3, 3, 64, 64), device="cuda")
        bias = torch.empty(64, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            getattr(phase_conv, name)(x, k3, bias, relu=True)
    assert phase_conv.phase_conv.launches == before


def test_phase_conv_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        phase_conv.phase_conv(torch.empty((1, 2, 3, 256), device="meta"),
                              torch.empty((3, 3, 64, 64), device="meta"),
                              torch.empty(64, device="meta"))


def _conv_launches():
    return (pallas_conv.conv3x3_p128_kernel.launches,
            packed_conv.packed_conv3x3_kernel.launches)


CONV_CALLS = {
    "conv3x3_pallas_p128": lambda dev: pallas_conv.conv3x3_pallas_p128(
        torch.empty((1, 5, 8, 128), device=dev),
        torch.empty((3, 3, 128, 256), device=dev),
        torch.empty(256, device=dev), relu=True),
    "packed_conv3x3": lambda dev: packed_conv.packed_conv3x3(
        torch.empty((1, 5, 8, 128), dtype=torch.bfloat16, device=dev),
        torch.empty((3, 3, 64, 64), device=dev),
        torch.empty(64, device=dev)),
    "conv3x3": lambda dev: port_ops.conv3x3(
        torch.empty((1, 5, 16, 24), device=dev),
        torch.empty((3, 3, 24, 40), device=dev)),
}


@pytest.mark.parametrize("name", sorted(CONV_CALLS))
def test_convs_raise_for_cuda_request_without_library(monkeypatch,
                                                      tmp_path, name):
    """B6, B7 and their callers on CUDA tensors need the kernel: without a
    buildable library they raise; they neither run a plain version nor
    count a launch."""
    _no_library(monkeypatch, tmp_path)
    before = _conv_launches()
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            CONV_CALLS[name]("cuda")
    assert _conv_launches() == before


def test_conv3x3_dispatch_takes_stock_conv_where_jax_does(monkeypatch,
                                                          tmp_path):
    """On CUDA tensors whose width is not a multiple of 8 `conv3x3` takes
    the stock conv, as JAX does on the TPU; it launches nothing."""
    _no_library(monkeypatch, tmp_path)
    before = _conv_launches()
    with FakeTensorMode():
        y = port_ops.conv3x3(torch.empty((1, 5, 13, 24), device="cuda"),
                             torch.empty((3, 3, 24, 40), device="cuda"),
                             torch.empty(40, device="cuda"), relu=True)
        assert tuple(y.shape) == (1, 5, 13, 40) and y.device.type == "cuda"
    assert _conv_launches() == before


def test_conv3x3_packed_goes_through_the_b6_wrapper(monkeypatch):
    """`conv3x3_packed` calls `conv3x3_pallas_p128` on the pair-packed
    tensor and weights (which launches B6 on CUDA tensors), as JAX's calls
    its Pallas kernel."""
    seen = []

    def spy(x, w, b, relu=False, out_dtype=torch.bfloat16):
        seen.append((tuple(x.shape), tuple(w.shape), relu, out_dtype))
        return torch.zeros((*x.shape[:3], w.shape[3]), dtype=out_dtype)

    monkeypatch.setattr(pallas_conv, "conv3x3_pallas_p128", spy)
    y = pallas_conv.conv3x3_packed(torch.zeros((1, 5, 16, 64)),
                                   torch.zeros((3, 3, 64, 64)), relu=True)
    assert seen == [((1, 5, 8, 128), (3, 3, 128, 128), True, torch.float32)]
    assert tuple(y.shape) == (1, 5, 16, 64)


@pytest.mark.parametrize("name", ["conv3x3_pallas_p128", "packed_conv3x3"])
def test_convs_refuse_other_devices(name):
    with pytest.raises(ValueError, match="cuda or cpu"):
        CONV_CALLS[name]("meta")


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_march_refuses_other_devices():
    t = torch.empty((4, 6, 5), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sweep_march.march(t, torch.empty((8, 8), device="meta"),
                          torch.empty(7, device="meta"),
                          torch.empty(3, device="meta"), 7, 3)


def test_library_name_follows_source_and_flags(monkeypatch):
    a = kernels.library_path("sweep_march")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-g"])
    assert kernels.library_path("sweep_march") != a
    assert a.parent == kernels.BUILD_DIR and a.suffix == ".so"


def test_nvcc_flags_are_per_source(monkeypatch):
    """The march keeps every product and sum rounded on its own; the phase
    conv and the 3x3 convs (exact bf16 products, one source) are built
    without --fmad=false, and each library name hashes its own flags."""
    assert "--fmad=false" in kernels.flags("sweep_march")
    assert "--fmad=false" not in kernels.flags("conv3x3")
    assert set(kernels.SOURCES) == {"sweep_march", "conv3x3"}
    b = kernels.library_path("conv3x3")
    monkeypatch.setitem(kernels.SOURCES, "conv3x3",
                        ("conv3x3.cu", ["--fmad=false"]))
    assert kernels.library_path("conv3x3") != b


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aILi256ELb1ELb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi256ELb1ELb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    24 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 80 registers, 16384 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_entry():
    """Registers, spills, stack and static shared memory per kernel entry
    of an ``-Xptxas -v`` log, in the log's order."""
    a, b = kernels.ptxas_usage(_PTXAS_LOG)
    assert a == {"entry": "_Z1aILi256ELb1ELb0EEvv", "registers": 168,
                 "spill_stores": 0, "spill_loads": 0, "stack": 0,
                 "static_smem": 0}
    assert b == {"entry": "_Z1bv", "registers": 80, "spill_stores": 36,
                 "spill_loads": 40, "stack": 24, "static_smem": 16384}
    assert kernels.ptxas_usage("") == []


def test_build_keeps_the_compiler_log(monkeypatch, tmp_path):
    """`build` keeps each library's compiler output beside it, and
    `build_log` reads it back ("" before a build)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
                    'done\n'
                    'printf "%s" "$LOG"\n'
                    ': > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setenv("LOG", _PTXAS_LOG)
    assert kernels.build_log("conv3x3") == ""
    done = kernels.build(["conv3x3"])
    assert done["conv3x3"]["log"] == _PTXAS_LOG
    assert kernels.library_path("conv3x3").is_file()
    assert kernels.build_log("conv3x3") == _PTXAS_LOG
    assert kernels.build(["conv3x3"]) == {}     # built: nothing to do
