"""The port's volume and image I/O vs the JAX package's: the EXR codec
(`data/exr.py`), the EXR dataset loaders (`data/dataset._read_exr`,
`load_legacy_exr_dir`), the raw/.dat, npy and cvol importers
(`volume/importers.py`) and the native raw reader (`native/volumeio`).

Tolerances.  The EXR writer, zlib and the predictor are the same code in
both packages: the bytes are equal, and each package decodes the other's
files exactly.  The raw decode is the same numpy code (numpy path) or the
same C++ source built with the same flags (native path): equal values,
brick pyramids and boxes; native against numpy, the C++ box filter sums
in another order: 1e-6, the bound JAX's own importer test holds.  The
legacy loader inpaints the flow through `ops/inpaint` (held to JAX's at
1e-6 in `test_torch_port_ops.py`): 1e-6, everything else equal.
"""

# first: builds the JAX package's native readers once, under a lock
import tests._torch_port_native  # noqa: F401,I001

import os

import numpy as np
import pytest
import torch

from isosurfacesuperresolution_tpu.data import dataset as JD
from isosurfacesuperresolution_tpu.data import exr as JE
from isosurfacesuperresolution_tpu.volume import importers as JI
from isosurfacesuperresolution_tpu_torch.data import dataset as PD
from isosurfacesuperresolution_tpu_torch.data import exr as PE
from isosurfacesuperresolution_tpu_torch.native import build as native_build
from isosurfacesuperresolution_tpu_torch.native import volumeio as p_volumeio
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume import importers as PI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _channels(h=13, w=17, seed=0):
    rng = np.random.RandomState(seed)
    return {"R": rng.rand(h, w).astype(np.float32),
            "G": (rng.rand(h, w) * 2 - 1).astype(np.float32),
            "B": np.zeros((h, w), np.float32),
            "Z": rng.rand(h, w).astype(np.float32) * 100}


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("comp", [PE.NO_COMPRESSION, PE.ZIPS_COMPRESSION,
                                  PE.ZIP_COMPRESSION])
def test_write_exr_bytes_equal_jax(tmp_path, comp, half):
    ch = _channels(h=37, seed=comp + 3 * half)
    PE.write_exr(str(tmp_path / "p.exr"), ch, compression=comp, half=half)
    JE.write_exr(str(tmp_path / "j.exr"), ch, compression=comp, half=half)
    assert ((tmp_path / "p.exr").read_bytes()
            == (tmp_path / "j.exr").read_bytes())
    # each package decodes the other's file exactly
    for reader, path in ((PE.read_exr, "j.exr"), (JE.read_exr, "p.exr")):
        back = reader(str(tmp_path / path))
        assert set(back) == set(ch)
        for k in ch:
            want = ch[k].astype(np.float16).astype(np.float32) if half \
                else ch[k]
            np.testing.assert_array_equal(back[k], want)


def test_read_exr_rgba_first_equals_jax(tmp_path):
    ch = _channels(seed=5)
    ch["A"] = np.ones((13, 17), np.float32)
    p = str(tmp_path / "rgba.exr")
    JE.write_exr(p, ch)
    got = PD._read_exr(p)
    np.testing.assert_array_equal(got, JD._read_exr(p))
    np.testing.assert_array_equal(got[..., 3], ch["A"])    # A is 4th
    np.testing.assert_array_equal(got[..., 4], ch["Z"])    # extras after


def _legacy_dir(path, frames=3, h=16, w=16, up=2):
    """A reference-layout EXR clip written with JAX's codec."""
    rng = np.random.RandomState(0)
    H, W = h * up, w * up

    def rand(hh, ww):
        return rng.rand(hh, ww).astype(np.float32)

    for j in range(frames):
        JE.write_exr(str(path / ("high_tmp_%05d.exr" % j)),
                     {"R": rand(H, W), "G": rand(H, W), "B": rand(H, W),
                      "A": (rand(H, W) > 0.4).astype(np.float32)})
        JE.write_exr(str(path / ("high_tmp_%05d_depth.exr" % j)),
                     {"R": rand(H, W), "G": rand(H, W), "B": rand(H, W),
                      "A": rand(H, W)})
        JE.write_exr(str(path / ("high_tmp_%05d_fx.exr" % j)),
                     {"R": rand(H, W), "G": rand(H, W), "B": rand(H, W),
                      "A": np.ones((H, W), np.float32)})
        JE.write_exr(str(path / ("low_tmp_%05d.exr" % j)),
                     {"R": rand(h, w), "G": rand(h, w), "B": rand(h, w),
                      "A": (rand(h, w) > 0.4).astype(np.float32)})
        JE.write_exr(str(path / ("low_tmp_%05d_depth.exr" % j)),
                     {"R": rand(h, w), "G": rand(h, w), "B": rand(h, w),
                      "A": rand(h, w)})
        JE.write_exr(str(path / ("low_tmp_%05d_flow.exr" % j)),
                     {"R": rand(h, w) - 0.5, "G": rand(h, w) - 0.5,
                      "B": np.zeros((h, w), np.float32)})


def test_load_legacy_exr_dir_matches_jax(tmp_path):
    _legacy_dir(tmp_path)
    got = PD.load_legacy_exr_dir(str(tmp_path), num_frames=3, device="cpu")
    want = JD.load_legacy_exr_dir(str(tmp_path), num_frames=3)
    assert len(got) == len(want) == 1
    for k, shape in (("high", (3, 32, 32, 6)), ("low", (3, 16, 16, 5)),
                     ("flow", (3, 16, 16, 2))):
        assert got[0][k].shape == want[0][k].shape == shape
        assert got[0][k].dtype == np.float32
    np.testing.assert_array_equal(got[0]["high"], want[0]["high"])
    np.testing.assert_array_equal(got[0]["low"], want[0]["low"])
    np.testing.assert_allclose(got[0]["flow"], want[0]["flow"], atol=1e-6,
                               rtol=0)
    with pytest.raises(FileNotFoundError):
        PD.load_legacy_exr_dir(str(tmp_path / "none"), device="cpu")


# ------------------------------------------------------------ importers --

@pytest.mark.parametrize("text,match", [
    ("Resolution: 4 4 4\nFormat: UCHAR\n", "does not contain"),
    ("ObjectFileName: v.raw\nFormat: UCHAR\n", "does not contain"),
    ("ObjectFileName: v.raw\nResolution: 4 4 4\n", "does not contain"),
    ("ObjectFileName: v.raw\nResolution: 4 4 4\nFormat: DOUBLE\n",
     "Unknown format"),
])
def test_parse_dat_descriptor_errors_match_jax(tmp_path, text, match):
    p = tmp_path / "v.dat"
    p.write_text(text)
    for parse in (PI.parse_dat_descriptor, JI.parse_dat_descriptor):
        with pytest.raises(ValueError, match=match):
            parse(str(p))


_RAW = {"UCHAR": np.uint8, "USHORT": np.uint16, "FLOAT": np.float32}
_SHAPE = (20, 18, 12)


def _write_raw(path, fmt, header=7):
    rng = np.random.RandomState(len(fmt))
    dt = _RAW[fmt]
    if fmt == "FLOAT":
        vol = rng.rand(*_SHAPE).astype(dt)
    else:
        vol = rng.randint(0, np.iinfo(dt).max, _SHAPE).astype(dt)
    with open(path / "v.raw", "wb") as f:
        f.write(b"h" * header)                 # a header to skip
        f.write(vol.transpose(2, 1, 0).tobytes())
    (path / "v.dat").write_text(
        "ObjectFileName: v.raw\nResolution: 20 18 12\n"
        f"Format: {fmt}\n")
    return str(path / "v.dat")


def _grids_equal(g, j):
    np.testing.assert_array_equal(g.values.numpy(), np.asarray(j.values))
    for k in ("brick_min", "brick_max", "bbox_min", "bbox_max"):
        np.testing.assert_array_equal(getattr(g, k).numpy(),
                                      np.asarray(getattr(j, k)))
    assert g.value_scale == j.value_scale
    assert g.value_offset == j.value_offset


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("ds", [1, 2])
@pytest.mark.parametrize("fmt", ["UCHAR", "USHORT", "FLOAT"])
def test_import_raw_matches_jax(tmp_path, fmt, ds, native):
    dat = _write_raw(tmp_path, fmt)
    got = PI.import_raw(dat, downsampling=ds, use_native=native,
                        device="cpu")
    want = JI.import_raw(dat, downsampling=ds, use_native=native)
    assert got.resolution == tuple(n // ds for n in _SHAPE)
    _grids_equal(got, want)
    if native:
        # the numpy path: the same values to the box filter's summation
        numpy_path = PI.import_raw(dat, downsampling=ds, use_native=False,
                                   device="cpu")
        np.testing.assert_allclose(got.values.numpy(),
                                   numpy_path.values.numpy(), atol=1e-6,
                                   rtol=0)


def test_import_raw_refusals_match_jax(tmp_path):
    dat = _write_raw(tmp_path, "UCHAR", header=0)
    for imp in (lambda p: PI.import_raw(p, device="cpu"), JI.import_raw):
        with pytest.raises(ValueError, match="not the .raw payload"):
            imp(dat[:-4] + ".raw")
        with pytest.raises(ValueError, match="does not point"):
            imp(dat[:-4] + ".txt")
    (tmp_path / "v.raw").write_bytes(b"\0" * 100)
    for imp in (lambda p: PI.import_raw(p, use_native=False, device="cpu"),
                lambda p: JI.import_raw(p, use_native=False)):
        with pytest.raises(ValueError, match="too small"):
            imp(dat)


def test_native_library_lands_in_build_native():
    p_volumeio.load_raw  # the wrapper builds at first use, not at import
    path = native_build.library_path("volumeio")
    native_build.build(["volumeio"])
    assert path.is_file()
    assert path.parent == native_build.BUILD_DIR
    assert native_build.BUILD_DIR.parts[-2:] == ("build", "native")
    assert str(native_build.BUILD_DIR).startswith(ROOT)


def test_native_brick_minmax_matches_numpy():
    from isosurfacesuperresolution_tpu_torch.volume.grid import (
        compute_brick_minmax)
    v = np.random.RandomState(3).rand(19, 16, 10).astype(np.float32)
    for b in (4, 8):
        got = p_volumeio.brick_minmax(v, b)
        want = compute_brick_minmax(v, b)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("ext", ["npy", "npz"])
def test_import_npy_matches_jax(tmp_path, ext):
    vol = np.random.RandomState(2).rand(12, 10, 9).astype(np.float32)
    p = str(tmp_path / f"v.{ext}")
    if ext == "npy":
        np.save(p, vol)
    else:
        np.savez(p, density=vol)
    for kw in ({}, {"lower_threshold": 0.3, "store_dtype": "uint8"}):
        _grids_equal(PI.import_npy(p, device="cpu", **kw),
                     JI.import_npy(p, **kw))


@pytest.fixture(scope="module")
def baked_grid():
    """A small uint8 torus with a baked float32 field."""
    g = analytic.torus_volume(24, store_dtype="uint8", device="cpu")
    return attach_baked_ao(g, 0.5, 0.2, num_dirs=8, num_steps=4)


def test_cvol_port_written_loads_in_jax(tmp_path, baked_grid):
    p = str(tmp_path / "p.cvol.npz")
    PI.save_cvol(p, baked_grid)
    j = JI.load_cvol(p)
    np.testing.assert_array_equal(np.asarray(j.values),
                                  baked_grid.values.numpy())
    np.testing.assert_array_equal(np.asarray(j.ao_sh),
                                  baked_grid.ao_sh.numpy())
    np.testing.assert_array_equal(np.asarray(j.brick_max),
                                  baked_grid.brick_max.numpy())
    assert j.value_scale == pytest.approx(baked_grid.value_scale, rel=1e-7)
    assert j.brick_size == baked_grid.brick_size


def test_cvol_jax_written_loads_in_port(tmp_path, baked_grid):
    p = str(tmp_path / "j.cvol.npz")
    JI.save_cvol(p, JI.load_cvol(_port_saved(tmp_path, baked_grid)))
    g = PI.load_cvol(p, device="cpu")
    assert g.values.dtype == torch.uint8 and g.device.type == "cpu"
    for k in ("values", "ao_sh", "brick_min", "brick_max", "bbox_min",
              "bbox_max"):
        assert torch.equal(getattr(g, k), getattr(baked_grid, k)), k
    assert g.value_scale == pytest.approx(baked_grid.value_scale, rel=1e-7)
    assert g.value_offset == baked_grid.value_offset
    # a grid without a field, and a bfloat16 one (JAX stores it as |V2)
    plain = analytic.sphere_volume(16, store_dtype="bfloat16", device="cpu")
    PI.save_cvol(str(tmp_path / "b.cvol.npz"), plain)
    back = PI.load_cvol(str(tmp_path / "b.cvol.npz"), device="cpu")
    assert back.ao_sh is None and back.values.dtype == torch.bfloat16
    assert torch.equal(back.values, plain.values)


def _port_saved(tmp_path, grid):
    p = str(tmp_path / "first.cvol.npz")
    PI.save_cvol(p, grid)
    return p
