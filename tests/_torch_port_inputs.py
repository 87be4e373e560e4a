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
