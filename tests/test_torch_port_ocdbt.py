"""The port's orbax reader (`train/ocdbt.py`, no orbax or tensorstore)
against orbax and tensorstore on the CPU, and the loader's rules for run
dirs (C5 among them).

- Both in-repo orbax run dirs: every leaf of the newest step equal to
  orbax's restore, bit for bit and dtype for dtype, by ``param_name``;
  `LoadedModel.from_run_dir` gives JAX's frame (the network's 1e-4, as
  `tests/test_torch_port_loader.py` holds run00017).
- Synthetic stores written by tensorstore in ``tmp_path``: inline and
  out-of-line values, B+trees of several levels, zstd and uncompressed
  nodes, zarr v2 and v3 arrays of several chunks with a missing chunk and
  edge chunks; every key and value equal to tensorstore's, every array
  equal to what was written.  A flipped byte fails the CRC-32C; the
  system libzstd decodes as the zstandard module does; without either
  the reader names both.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_training import one_torch_thread  # noqa: F401
from isosurfacesuperresolution_tpu.infer.loadedmodel import (
    LoadedModel as JLoadedModel)
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.train import ocdbt
from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
    CheckpointManager)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"run00020": ("artifacts/run00020/run00020", 23),
        "run00022": ("artifacts/run00022/run00022", 70)}


def orbax_restore(step_dir):
    """{param name: array} by orbax's own restore, to numpy on the CPU."""
    import jax
    import orbax.checkpoint as ocp
    ck = ocp.PyTreeCheckpointer()
    tree = ck.metadata(step_dir).item_metadata.tree

    def is_leaf(x):
        return hasattr(x, "name") and hasattr(x, "shape")
    args = jax.tree_util.tree_map(
        lambda m: ocp.RestoreArgs(restore_type=np.ndarray), tree,
        is_leaf=is_leaf)
    out = ck.restore(step_dir, args=ocp.args.PyTreeRestore(
        restore_args=args))
    names = {}
    jax.tree_util.tree_map(lambda m, v: names.__setitem__(m.name, v), tree,
                           out, is_leaf=is_leaf)
    return names


@pytest.mark.parametrize("run", sorted(RUNS))
def test_newest_step_equals_orbax_restore(run):
    rel, step = RUNS[run]
    ckpts = os.path.join(ROOT, rel, "checkpoints")
    assert ocdbt.orbax_steps(ckpts)[-1] == step
    step_dir = os.path.join(ckpts, str(step), "default")
    want = orbax_restore(step_dir)
    got = ocdbt.read_orbax_step(step_dir)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    gen, s = ocdbt.read_orbax_generator(ckpts)
    assert s == step and len(gen) == 50
    for key, arr in gen.items():
        np.testing.assert_array_equal(
            arr, want["params." + key.replace("/", ".")])


@pytest.fixture(scope="module")
def frame_input():
    rng = np.random.RandomState(8)
    return (rng.uniform(-1, 1, (1, 12, 16, 5)).astype(np.float32),
            rng.uniform(-0.05, 0.05, (1, 12, 16, 2)).astype(np.float32))


def assert_frame_matches_jax(jlm, lm, frame_input):
    low, flow = frame_input
    ref = np.asarray(jlm.inference(jnp.asarray(low), None,
                                   jnp.asarray(flow)))
    got = lm.inference(torch.from_numpy(low), None, torch.from_numpy(flow))
    assert got.shape == ref.shape == (1, 48, 64, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_loaded_model_on_orbax_run_dir_matches_jax(run, frame_input):
    """JAX restores the newest orbax step's generator (before the run
    dir's params.npz, which both runs also hold); so does the port."""
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        params_from_flax)
    path = os.path.join(ROOT, RUNS[run][0])
    lm = LoadedModel.from_run_dir(path, device="cpu")
    assert_frame_matches_jax(JLoadedModel.from_run_dir(path), lm,
                             frame_input)
    gen, _ = ocdbt.read_orbax_generator(os.path.join(path, "checkpoints"))
    want = params_from_flax(gen, lm.cfg.model)
    for k, v in lm.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_epoch_on_a_params_npz_run_dir_is_ignored_as_in_jax(frame_input):
    """C5: run00017 holds config.json and params.npz only; JAX ignores
    ``epoch`` there and loads params.npz, and so does the port."""
    path = os.path.join(ROOT, "artifacts", "run00017")
    lm = LoadedModel.from_run_dir(path, epoch=3, device="cpu")
    assert_frame_matches_jax(JLoadedModel.from_run_dir(path, epoch=3), lm,
                             frame_input)
    plain = LoadedModel.from_run_dir(path, device="cpu")
    for a, b in zip(lm.model.state_dict().values(),
                    plain.model.state_dict().values()):
        assert torch.equal(a, b)


def test_checkpoint_manager_reads_orbax_steps(tmp_path):
    """An orbax run dir: the newest epoch is its newest step, the
    generator and the discriminator restore from it, and so does the full
    state (step, both optimizers); the port's own file is written beside
    the steps and read by its epoch."""
    from isosurfacesuperresolution_tpu_torch.config import config_from_json
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network, params_from_flax)
    from isosurfacesuperresolution_tpu_torch.train import trainer as PT
    src = os.path.join(ROOT, RUNS["run00020"][0])
    shutil.copy(os.path.join(src, "config.json"), tmp_path / "config.json")
    (tmp_path / "checkpoints").mkdir()
    os.symlink(os.path.join(src, "checkpoints", "23"),
               tmp_path / "checkpoints" / "23")
    cfg = config_from_json(os.path.join(src, "config.json"))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_epoch() == 23 and mgr.epochs() == []
    model = create_network(cfg.model)
    _, epoch = mgr.restore_params(model)
    gen, _ = ocdbt.read_orbax_generator(os.path.join(src, "checkpoints"))
    want = params_from_flax(gen, cfg.model)
    assert epoch == 23
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    crit = LossNetUnshaded(cfg.loss, high_res=cfg.train.crop_size * 4)
    assert list(crit.discriminators) == ["adv"]
    mgr.restore_discr_params(crit.discriminators)
    arrays = ocdbt.read_orbax_step(os.path.join(src, "checkpoints", "23"),
                                   "discr_params.adv.")
    conv0 = arrays["discr_params.adv.params.conv0.kernel"]
    np.testing.assert_array_equal(
        crit.discriminators["adv"].conv0.weight.detach().numpy(),
        conv0.transpose(3, 2, 0, 1))
    spec = PT.make_optimizer(cfg)
    state = PT.create_train_state(cfg, model, crit, spec,
                                  discr_optimizer=spec)
    state, epoch = mgr.restore(state)
    assert epoch == 23 and state.step == 4537
    assert state.optimizer.count == state.discr_optimizer.count == 4537
    assert state.discr_optimizer.learning_rate == np.float32(1e-5)
    np.testing.assert_array_equal(
        state.discriminators["adv"].conv0.weight.detach().numpy(),
        conv0.transpose(3, 2, 0, 1))
    mgr.save(24, state)
    assert mgr.epochs() == [24] and mgr.latest_epoch() == 24
    restored, epoch = mgr.restore(state)
    assert epoch == 24


# ---------------------------------------------------------------------------
# synthetic stores
# ---------------------------------------------------------------------------

def ts_kvstore(path, **config):
    import tensorstore as ts
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                            "config": config}).result()


STORES = {
    "zstd_multilevel": {"max_inline_value_bytes": 8,
                        "max_decoded_node_bytes": 256,
                        "compression": {"id": "zstd", "level": 3}},
    "raw_nodes": {"max_inline_value_bytes": 16,
                  "max_decoded_node_bytes": 512,
                  "compression": None},
    "one_leaf_inline": {"max_inline_value_bytes": 1024},
}


@pytest.mark.parametrize("kind", sorted(STORES))
def test_synthetic_store_equals_tensorstore(tmp_path, kind):
    """300 keys of 0-40 bytes (inline or out of line by the store's
    limit), written in two transactions (two versions); the reader gives
    the newest version's keys and values."""
    import tensorstore as ts
    kv = ts_kvstore(tmp_path, **STORES[kind])
    rng = np.random.RandomState(0)
    for gen in range(2):
        with ts.Transaction() as txn:
            for i in range(gen * 100, 300):
                kv.with_transaction(txn)[f"k/{i % 7}/{i:05d}"] = (
                    rng.bytes(rng.randint(0, 40)))
    want = {k: kv[k] for k in kv.list().result()}
    with ocdbt.OcdbtStore(str(tmp_path)) as store:
        if kind == "zstd_multilevel":
            assert store.root_height >= 2
        assert store.num_keys == len(want) == 300
        got = store.read_all()
    assert got == want


@pytest.mark.parametrize("zarr", ["zarr", "zarr3"])
def test_synthetic_zarr_arrays_equal_what_was_written(tmp_path, zarr):
    """Chunked arrays on an OCDBT store (edge chunks cut; one chunk never
    written reads as the fill value), float32, int32, bfloat16 (read as
    float32) and a 0-d array."""
    import ml_dtypes
    import tensorstore as ts
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_inline_value_bytes": 64,
                       "max_decoded_node_bytes": 512}}
    rng = np.random.RandomState(1)
    arrays = {"a.f32": rng.randn(7, 10, 3).astype(np.float32),
              "b.i32": rng.randint(-9, 9, (5, 6)).astype(np.int32),
              "c.bf16": rng.randn(4, 9).astype(np.float32),
              "d.scalar": np.asarray(2.5, np.float32)}
    chunks = {"a.f32": [3, 4, 3], "b.i32": [2, 6], "c.bf16": [4, 4],
              "d.scalar": []}
    for name, a in arrays.items():
        dtype = "bfloat16" if name == "c.bf16" else a.dtype.name
        spec = {"driver": zarr, "kvstore": dict(base, path=name + "/")}
        if zarr == "zarr":
            spec["metadata"] = {"chunks": chunks[name],
                                "compressor": {"id": "zstd", "level": 1}}
        else:
            spec["metadata"] = {"chunk_grid": {
                "name": "regular",
                "configuration": {"chunk_shape": chunks[name]}},
                "codecs": [{"name": "bytes",
                            "configuration": {"endian": "little"}},
                           {"name": "zstd",
                            "configuration": {"level": 1}}]}
        t = ts.open(spec, create=True, dtype=dtype, shape=a.shape).result()
        if name == "a.f32":
            t[:, :4].write(a[:, :4]).result()   # chunks of columns 4.. unset
            a[:, 4:] = 0
        elif name == "c.bf16":
            t.write(a.astype(ml_dtypes.bfloat16)).result()
            arrays[name] = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        else:
            t.write(a).result()
    with ocdbt.OcdbtStore(str(tmp_path)) as store:
        got = ocdbt.read_zarr_arrays(store.read_all())
    assert sorted(got) == sorted(arrays)
    for name, a in arrays.items():
        assert got[name].shape == a.shape
        np.testing.assert_array_equal(got[name], a, err_msg=name)


_V2 = {"zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4",
       "compressor": {"id": "zstd", "level": 1}, "order": "C",
       "filters": None, "fill_value": 0}
_V3 = {"zarr_format": 3, "node_type": "array", "shape": [4],
       "data_type": "float32", "fill_value": 0,
       "chunk_grid": {"name": "regular",
                      "configuration": {"chunk_shape": [4]}},
       "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                  {"name": "zstd", "configuration": {"level": 1}}]}


@pytest.mark.parametrize("meta,what", [
    (dict(_V2, compressor={"id": "zlib", "level": 1}), "compressor 'zlib'"),
    (dict(_V2, order="F"), "order 'F'"),
    (dict(_V2, dtype=">f4"), "big-endian"),
    (dict(_V2, dimension_separator="/"), "dimension separator"),
    (dict(_V3, codecs=[_V3["codecs"][0], {"name": "gzip"}]), "codecs"),
    (dict(_V3, codecs=[{"name": "bytes",
                        "configuration": {"endian": "big"}}]), "big-endian"),
    (dict(_V3, chunk_key_encoding={"name": "v2"}), "chunk key encoding"),
])
def test_other_zarr_layouts_are_refused_by_name(meta, what):
    """Only orbax's layouts are read: zarr v2 or v3, C order,
    little-endian, zstd or no compressor."""
    with pytest.raises(ocdbt.OcdbtError, match=what):
        ocdbt.read_zarr_arrays({b"x/" + (b".zarray" if meta["zarr_format"]
                                         == 2 else b"zarr.json"):
                                json.dumps(meta).encode()})


@pytest.mark.parametrize("meta", [_V2, dict(_V2, compressor=None), _V3,
                                  dict(_V3, codecs=_V3["codecs"][:1])])
def test_zstd_and_uncompressed_chunks_are_read(meta):
    import zstandard
    a = np.float32([1.5, -2.0, 3.25, 0.0])
    raw = a.tobytes()
    zstd = (meta["compressor"] if meta["zarr_format"] == 2
            else len(meta["codecs"]) > 1)
    v2 = meta["zarr_format"] == 2
    got = ocdbt.read_zarr_arrays({
        b"x/" + (b".zarray" if v2 else b"zarr.json"):
            json.dumps(meta).encode(),
        b"x/" + (b"0" if v2 else b"c/0"):
            zstandard.ZstdCompressor().compress(raw) if zstd else raw})
    np.testing.assert_array_equal(got["x"], a)


def test_a_flipped_byte_fails_the_crc(tmp_path):
    kv = ts_kvstore(tmp_path, max_inline_value_bytes=1024)
    kv["key"] = b"value"
    path = tmp_path / "manifest.ocdbt"
    raw = bytearray(path.read_bytes())
    raw[20] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(tmp_path))


def test_system_libzstd_decodes_as_zstandard_does(monkeypatch):
    """Without the zstandard module the reader uses libzstd.so.1: the
    ctypes path decodes frames with and without their content size (the
    nodes' are without), refuses one past the bound, and reads run00022's
    generator as the zstandard path does."""
    import sys

    import zstandard
    data = np.random.RandomState(2).bytes(1 << 20) * 3
    frames = [zstandard.ZstdCompressor(level=3).compress(data),
              zstandard.ZstdCompressor(level=3, write_content_size=False)
              .compress(data)]
    ckpts = os.path.join(ROOT, RUNS["run00022"][0], "checkpoints")
    want, _ = ocdbt.read_orbax_generator(ckpts)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setattr(ocdbt, "_ZSTD", [])
    decode = ocdbt._load_zstd()
    assert isinstance(getattr(decode, "__self__", None), ocdbt._LibZstd)
    for frame in frames:
        assert decode(frame, 1 << 30) == data
        with pytest.raises(ocdbt.OcdbtError, match="exceeds"):
            decode(frame, 1000)
    with pytest.raises(ocdbt.OcdbtError, match="truncated"):
        decode(frames[1][:-10], 1 << 30)
    got, _ = ocdbt.read_orbax_generator(ckpts)
    assert isinstance(ocdbt._ZSTD[0].__self__, ocdbt._LibZstd)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


def test_no_zstd_decoder_names_both(monkeypatch):
    import ctypes
    import ctypes.util
    import sys

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(RuntimeError, match="'zstandard' module or the "
                                           "system library libzstd.so.1"):
        ocdbt._load_zstd()
