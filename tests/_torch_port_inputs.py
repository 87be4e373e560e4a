"""Numpy-seeded march inputs shared by the port's CPU and card tests
(no JAX import, so the card tests run where JAX is not installed)."""

import numpy as np

Z, X, Y = 6, 12, 11
SN, TN = 10, 8


def make_inputs(store: str, seed: int = 0):
    """A smooth field plus noise, one skipped slice, grids that overhang
    the volume, and an isovalue that puts crossings on the image border."""
    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                          indexing="ij")
    field = (0.15 * z + 0.04 * x + 0.02 * y
             + 0.05 * rng.rand(X, Y, Z)).astype(np.float32)
    vol = np.ascontiguousarray(np.transpose(field, (2, 0, 1)))  # (Z, X, Y)
    scale, offset = 1.0, 0.0
    if store == "uint8":
        scale, offset = float(field.max()) / 255.0, 0.01
        vol = np.clip(np.round(vol / scale), 0, 255).astype(np.uint8)
    K = 2 * Z
    zc = (np.arange(K) + 0.5) / 2.0
    lam = 0.8 + 0.05 * np.arange(K)
    zf = np.clip(np.floor(zc - 0.5), 0, Z - 2)
    fz = np.clip(zc - 0.5 - zf, 0.0, 1.0)
    flag = np.ones(K)
    flag[3] = 0.0                                  # a culled slice
    iso = 0.55
    meta = np.stack([zc, lam, zf, fz, flag, np.full(K, iso),
                     np.full(K, 6.0), np.full(K, 5.5)], 1).astype(np.float32)
    s_grid = np.linspace(1.0, X - 0.2, SN).astype(np.float32)
    t_grid = np.linspace(0.3, Y + 0.6, TN).astype(np.float32)
    return vol, meta, s_grid, t_grid, scale, offset


CASES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("uint8", "float32"), ("uint8", "bfloat16")]


def make_ao_field(quantize: bool = False, seed: int = 1):
    """A smooth (Z, 4, X, Y) SH-like field for the march inputs above:
    float32, or uint8 with per-channel scale and offset (4-tuples) when
    ``quantize``; returns (field, physical float32 field, scale, offset)."""
    rng = np.random.RandomState(seed)
    z, x, y = np.meshgrid(np.arange(Z), np.arange(X), np.arange(Y),
                          indexing="ij")
    chans = [0.3 + 0.02 * x + 0.01 * z, 0.1 * np.sin(0.5 * y),
             0.05 * np.cos(0.3 * x + 0.2 * z), -0.04 + 0.01 * y]
    field = np.stack(chans, 1) + 0.01 * rng.rand(Z, 4, X, Y)
    field = field.astype(np.float32)
    if not quantize:
        return field, field, 1.0, 0.0
    lo = field.min(axis=(0, 2, 3))
    scale = np.maximum((field.max(axis=(0, 2, 3)) - lo) / 255.0, 1e-8)
    q = np.clip(np.round((field - lo[:, None, None])
                         / scale[:, None, None]), 0, 255).astype(np.uint8)
    phys = (q.astype(np.float32) * scale.astype(np.float32)[:, None, None]
            + lo.astype(np.float32)[:, None, None])
    return q, phys, tuple(float(s) for s in scale), tuple(float(v) for v in lo)
