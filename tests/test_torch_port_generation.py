"""The port's clip generator vs the JAX package's `data/generation.py`:
the numpy draws (cameras, render settings) for several seeds, whole
clips with and without AO through both sweep renderers, and the ``.npy``
layout of `generate_sequences`.

Tolerances.  The draws are the same numpy calls in the same order:
equal.  The clips are sweep renders (held to JAX's at 1e-4 by the sweep
tests), the baked field's bake (1e-6) and the flow inpainting: 1e-4, and
the masks equal.
"""

import os

import numpy as np
import pytest

from isosurfacesuperresolution_tpu.config import RenderConfig as JRenderConfig
from isosurfacesuperresolution_tpu.data import generation as JG
from isosurfacesuperresolution_tpu.volume import analytic as j_analytic
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.data import generation as PG
from isosurfacesuperresolution_tpu_torch.volume import analytic

MAX_DIFF = 1e-4


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_draws_match_jax(seed):
    kw = dict(num_frames=4, iso_range=(0.3, 0.6), camera_light_prob=0.5)
    r_j, r_p = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        want = JG.random_camera_path(r_j, JG.SequenceConfig(**kw))
        got = PG.random_camera_path(r_p, PG.SequenceConfig(**kw))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            for name in ("eye", "look_at_pt", "up"):
                np.testing.assert_array_equal(getattr(a, name).numpy(),
                                              np.asarray(getattr(b, name)))
            assert a.fov_y_degrees == b.fov_y_degrees
        jcfg, jrp = JG.random_render_settings(
            r_j, JG.SequenceConfig(**kw), JRenderConfig(isovalue=0.4))
        cfg, rp = PG.random_render_settings(
            r_p, PG.SequenceConfig(**kw), RenderConfig(isovalue=0.4))
        assert cfg.camera_light == jcfg.camera_light
        for name in rp._fields:
            np.testing.assert_array_equal(
                np.float32(getattr(rp, name)),
                np.asarray(getattr(jrp, name), np.float32))
    assert r_p.randint(1 << 30) == r_j.randint(1 << 30)   # same draws


@pytest.fixture(scope="module")
def spheres():
    return (j_analytic.sphere_volume(32),
            analytic.sphere_volume(32, device="cpu"))


def _check(got, want, ao):
    for k, shape in (("low", (3, 8, 8, 5)), ("high", (3, 32, 32, 6)),
                     ("flow", (3, 8, 8, 2))):
        assert got[k].shape == want[k].shape == shape
        np.testing.assert_allclose(got[k], want[k], atol=MAX_DIFF, rtol=0)
    for k in ("low", "high"):
        np.testing.assert_array_equal(got[k][..., 0], want[k][..., 0])
    hit = got["high"][..., 0] > 0
    assert hit.any() and (got["high"][..., 5][~hit] == 1).all()
    assert (got["high"][..., 5][hit] < 1).any() == bool(ao)
    assert np.abs(got["flow"]).max() > 0


def test_render_sequence_without_ao_matches_jax(spheres):
    """One clip on the scan without AO (with AO: the next test, where
    each clip bakes the field once, as JAX does)."""
    jg, pg = spheres
    kw = dict(num_frames=3, high_res=32, ao_samples=0,
              distance_range=(1.4, 1.8))
    cams_j = JG.random_camera_path(np.random.RandomState(5),
                                   JG.SequenceConfig(**kw))
    cams_p = PG.random_camera_path(np.random.RandomState(5),
                                   PG.SequenceConfig(**kw))
    want = JG.render_sequence(jg, cams_j, JRenderConfig(isovalue=0.5),
                              JG.SequenceConfig(**kw))
    got = PG.render_sequence(pg, cams_p, RenderConfig(isovalue=0.5),
                             PG.SequenceConfig(**kw))
    _check(got, want, 0)


def test_generate_sequences_matches_jax_and_writes_nchw(spheres, tmp_path):
    """Two clips with AO through B1-ao's plain version (the high-res
    frames, the field baked once a clip; the caller's grid keeps none)
    and B1's (the low-res frames), saved as NCHW ``.npy``."""
    jg, pg = spheres
    kw = dict(num_frames=3, high_res=32, ao_samples=8, ao_radius=0.15,
              distance_range=(1.4, 1.8))
    jgrids = [(jg, (0.4, 0.6)), (jg, (0.5, 0.5))]
    pgrids = [(pg, (0.4, 0.6)), (pg, (0.5, 0.5))]
    want = JG.generate_sequences(
        jgrids, 2, JG.SequenceConfig(**kw),
        base_render_cfg=JRenderConfig(renderer="sweep_pallas"), seed=3)
    got = PG.generate_sequences(
        pgrids, 2, PG.SequenceConfig(**kw),
        base_render_cfg=RenderConfig(renderer="sweep_pallas"), seed=3,
        out_dir=str(tmp_path / "clips"))
    assert len(got) == len(want) == 2 and pg.ao_sh is None
    for g, w in zip(got, want):
        _check(g, w, 8)
    names = sorted(os.listdir(tmp_path / "clips"))
    assert names == [f"{k}_{i:05d}.npy" for k in ("flow", "high", "low")
                     for i in range(2)]
    for i, seq in enumerate(got):
        for k in ("low", "high", "flow"):
            arr = np.load(tmp_path / "clips" / f"{k}_{i:05d}.npy")
            np.testing.assert_array_equal(arr, seq[k].transpose(0, 3, 1, 2))
