"""Guards of the port: it imports nothing of JAX or the JAX package, its
entry points run on the card unless asked for the CPU, and the march
wrapper never falls back from a CUDA request to the plain version."""

import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, RenderConfig)
from isosurfacesuperresolution_tpu_torch.infer import pipeline
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.models.generators import EnhanceNet
from isosurfacesuperresolution_tpu_torch.render import sweep_march
from isosurfacesuperresolution_tpu_torch.volume import analytic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import isosurfacesuperresolution_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "isosurfacesuperresolution_tpu"
             or m.startswith("isosurfacesuperresolution_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20          # every module of the port was imported
    assert bad == "[]"


ENTRY_POINTS = {
    "blobs_volume": lambda: analytic.blobs_volume(8),
    "sphere_volume": lambda: analytic.sphere_volume(8),
    "LoadedModel.from_run_dir": lambda: LoadedModel.from_run_dir(
        os.path.join(ROOT, "artifacts", "run00017")),
    "initial_state": lambda: pipeline.initial_state(
        Config(), RenderConfig(width=8, height=8)),
    "FusedFrame": lambda: pipeline.FusedFrame(
        None, Config(), RenderConfig(), upscale_mode="bilinear"),
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
