"""The port's `.vdb` writer and reader vs the JAX package's:
`volume/vdb_write.write_vdb`, the native decoder (`native/vdbio`) and
`volume/vdb.load_vdb`, on seeded volumes and on the byte-level fixtures
hand-assembled from the OpenVDB format in `tests/test_vdb_spec_fixtures.py`
(imported as a module: its helpers, none of its tests).

Tolerances.  The writer is the same pure-Python code (fixed uuid, zlib):
the bytes are equal.  The decoder is the same C++ source built with the
same flags: each file decodes to the same array and voxel size in both
packages, or fails with the same error message; half-float files decode
to the float16 values exactly.
"""

# first: builds the JAX package's native readers once, under a lock
import tests._torch_port_native as jax_native  # noqa: I001

import struct
import subprocess
import sys

import numpy as np
import pytest

import tests.test_vdb_spec_fixtures as fx
from isosurfacesuperresolution_tpu.volume import vdb as JV
from isosurfacesuperresolution_tpu.volume import vdb_write as JW
from isosurfacesuperresolution_tpu_torch.native import vdbio as p_vdbio
from isosurfacesuperresolution_tpu_torch.volume import vdb as PV
from isosurfacesuperresolution_tpu_torch.volume import vdb_write as PW

ZIP, MASK = fx.ZIP, fx.MASK


def _jax_vdbio():
    """The JAX package's native decoder; the test fails, naming it, when
    it could not be loaded (it does not skip)."""
    if fx.vdbio is None:
        pytest.fail("the JAX package's native .vdb decoder "
                    "(isosurfacesuperresolution_tpu/native/_vdbio.so) could "
                    "not be loaded: "
                    + (str(jax_native.ERRORS) if jax_native.ERRORS else
                       "it was built, but importing it raised"))
    return fx.vdbio


def _volume(seed=0, shape=(21, 17, 10)):
    rng = np.random.RandomState(seed)
    v = rng.rand(*shape).astype(np.float32)
    v[v < 0.45] = 0.0                      # inactive voxels
    return v


@pytest.mark.parametrize("origin", [(0, 0, 0), (3, -5, 130)])
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("compression", ["zip", "none"])
def test_write_vdb_bytes_equal_jax(tmp_path, compression, half, origin):
    v = _volume(seed=len(compression) + half)
    kw = dict(grid_name="density", voxel_size=0.5, origin=origin,
              compression=compression, half=half)
    PW.write_vdb(str(tmp_path / "p.vdb"), v, **kw)
    JW.write_vdb(str(tmp_path / "j.vdb"), v, **kw)
    blob = (tmp_path / "p.vdb").read_bytes()
    assert blob == (tmp_path / "j.vdb").read_bytes()
    # each package's decoder reads the file back
    want = v.astype(np.float16).astype(np.float32) if half else v
    for load in (p_vdbio.load, _jax_vdbio().load):
        dense, vox = load(str(tmp_path / "p.vdb"))
        assert vox == (0.5, 0.5, 0.5)
        # the active bounding box: trailing/leading all-zero planes drop
        nz = np.nonzero(want)
        crop = want[nz[0].min():nz[0].max() + 1,
                    nz[1].min():nz[1].max() + 1,
                    nz[2].min():nz[2].max() + 1]
        np.testing.assert_array_equal(dense, crop)


def test_load_vdb_matches_jax(tmp_path):
    v = _volume(seed=4, shape=(24, 20, 16))
    JW.write_vdb(str(tmp_path / "v.vdb"), v, grid_name="smoke")
    grid, name = PV.load_vdb(str(tmp_path / "v.vdb"), device="cpu")
    jgrid, jname = JV.load_vdb(str(tmp_path / "v.vdb"))
    assert name == jname == "smoke"
    np.testing.assert_array_equal(grid.values.numpy(),
                                  np.asarray(jgrid.values))
    for k in ("brick_min", "brick_max", "bbox_min", "bbox_max"):
        np.testing.assert_array_equal(getattr(grid, k).numpy(),
                                      np.asarray(getattr(jgrid, k)))
    with pytest.raises(ValueError, match="not in"):
        PV.load_vdb(str(tmp_path / "v.vdb"), grid_name="other",
                    device="cpu")
    with pytest.raises(ValueError, match="max_resolution"):
        PV.load_vdb(str(tmp_path / "v.vdb"), max_resolution=8, device="cpu")
    (tmp_path / "bad.vdb").write_bytes(b"\0" * 64)
    with pytest.raises(OSError, match="bindings are not installed"):
        PV.load_vdb(str(tmp_path / "bad.vdb"), device="cpu")
    assert p_vdbio.grid_names(str(tmp_path / "v.vdb")) == ["smoke"]


def _metadata_code_file(code, inactive, with_selection):
    """Two leaves, the first written with metadata ``code``, the second
    with sentinel actives (`test_metadata_codes_consume_exact_bytes`)."""
    rng = np.random.RandomState(40 + code)
    a1 = rng.rand(512) > 0.5
    a1[:2] = True
    v1 = np.where(a1, rng.rand(512).astype(np.float32) + 0.25,
                  0.0).astype(np.float32)
    sel = (rng.rand(512) > 0.5) & ~a1 if with_selection else None
    a2 = np.zeros(512, bool)
    a2[[0, 17, 511]] = True
    v2 = np.zeros(512, np.float32)
    v2[[0, 17, 511]] = [2.5, -3.25, 7.75]
    comp = ZIP | MASK
    i4 = fx.internal_topology(4, [fx.child_offset(4, 0, 0, 0),
                                  fx.child_offset(4, 1, 0, 0)], comp, False)
    root = fx.B(struct.pack("<f", 0.0), struct.pack("<II", 0, 1),
                struct.pack("<iii", 0, 0, 0))
    topo = fx.B(root, fx.internal_topology(5, [0], comp, False), i4,
                fx.leaf_topology(a1), fx.leaf_topology(a2))
    buf = fx.B(fx.leaf_buffer(v1, a1, comp, False, code=code,
                              inactive=inactive, selection=sel),
               fx.leaf_buffer(v2, a2, comp, False))
    return fx.assemble(224, comp, topo, buf)


def _tile_file(root_tile):
    comp = ZIP | MASK
    vals, active = fx.leaf_vals(seed=31)
    if root_tile:                          # an inactive root tile
        root = fx.B(struct.pack("<f", 0.0), struct.pack("<II", 1, 1),
                    struct.pack("<iii", 4096, 0, 0), struct.pack("<f", 9.0),
                    b"\x00", struct.pack("<iii", 0, 0, 0))
        i4 = fx.internal_topology(4, [0], comp, False)
    else:                                  # an active Internal4 tile
        root = fx.B(struct.pack("<f", 0.0), struct.pack("<II", 0, 1),
                    struct.pack("<iii", 0, 0, 0))
        off = fx.child_offset(4, 1, 0, 0)
        i4 = fx.internal_topology(4, [fx.child_offset(4, 0, 0, 0)], comp,
                                  False, tile_vals={off: 0.625},
                                  tile_active_offsets=[off])
    topo = fx.B(root, fx.internal_topology(5, [0], comp, False), i4,
                fx.leaf_topology(active))
    return fx.assemble(224, comp, topo,
                       fx.leaf_buffer(vals, active, comp, False))


def _spec_files():
    """name -> bytes of every fixture of the spec suite."""
    out = {}
    for version in (222, 224):
        for comp in (0, ZIP, ZIP | MASK, MASK):
            vals, active = fx.leaf_vals(seed=version + comp)
            out[f"v{version}-c{comp}"] = fx.single_leaf_file(
                version, comp, vals, active)
    vals, active = fx.leaf_vals(seed=5)
    out["half-inactive"] = fx.single_leaf_file(
        224, ZIP | MASK, vals, active, half=True, code=2, inactive=(0.125,))
    vals, active = fx.leaf_vals(seed=20)
    out["v220"] = fx.single_leaf_file(220, 0, vals, active)
    out["v220-zip"] = fx.single_leaf_file(220, ZIP, vals, active,
                                          global_compressed=True)
    vals, active = fx.leaf_vals(seed=41)
    out["voxel"] = fx.single_leaf_file(224, ZIP | MASK, vals, active,
                                       voxel=0.125)
    for code, inactive, sel in ((0, (), False), (1, (), False),
                                (2, (0.125,), False), (3, (), True),
                                (4, (0.125,), True),
                                (5, (0.125, 0.875), True), (6, (), False)):
        out[f"code{code}"] = _metadata_code_file(code, inactive, sel)
    out["internal-tile"] = _tile_file(False)
    out["root-tile"] = _tile_file(True)
    vals, active = fx.leaf_vals(seed=50)
    out["blosc"] = fx.single_leaf_file(224, 0x4 | MASK, vals, active)
    good = fx.single_leaf_file(224, ZIP | MASK, vals, active)
    out["old-version"] = good[:8] + struct.pack("<I", 219) + good[12:]
    out["bad-magic"] = b"\x00" * 8 + good[8:]
    return out


SPEC = _spec_files()
FAILING = ("blosc", "old-version", "bad-magic")


def _decode(load, path):
    try:
        dense, vox = load(path)
        return ("ok", dense, vox)
    except OSError as e:
        return ("error", str(e), None)


@pytest.mark.parametrize("name", sorted(SPEC))
def test_spec_fixtures_decode_like_jax(tmp_path, name):
    path = tmp_path / f"{name}.vdb"
    path.write_bytes(SPEC[name])
    got = _decode(p_vdbio.load, str(path))
    want = _decode(_jax_vdbio().load, str(path))
    assert got[0] == want[0] == ("error" if name in FAILING else "ok")
    if got[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert np.isfinite(got[1]).all() and got[1].size >= 512
    else:
        assert got[1] == want[1]


_FUZZ = r"""
import sys
import numpy as np
from isosurfacesuperresolution_tpu.native import vdbio as jv
from isosurfacesuperresolution_tpu_torch.native import vdbio as pv

blob = open(sys.argv[1], 'rb').read()
tmp = sys.argv[1] + '.fuzz'

def outcome(mod):
    try:
        mod.probe(tmp)
        dense, vox = mod.load(tmp)
        return ('ok', dense.tobytes(), dense.shape, vox)
    except Exception as e:
        return ('error', type(e).__name__, str(e))

rng = np.random.RandomState(1)
variants = [blob[:cut] for cut in range(0, len(blob), 13)]
for _ in range(120):
    b = bytearray(blob)
    for off in rng.randint(0, len(b), rng.randint(1, 6)):
        b[off] = rng.randint(256)
    variants.append(bytes(b))
same = 0
for b in variants:
    open(tmp, 'wb').write(b)
    if outcome(pv) != outcome(jv):
        print('differ', len(b))
        sys.exit(1)
    same += 1
print('same', same)
"""


def test_corrupted_files_decode_like_jax(tmp_path):
    """Truncated and corrupted variants of one file: both decoders give
    the same array or the same error, and neither crashes (a child
    process, so a crash fails this test, not the worker)."""
    path = tmp_path / "f.vdb"
    path.write_bytes(SPEC["code5"])
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "same" in out.stdout

