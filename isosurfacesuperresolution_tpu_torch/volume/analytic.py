"""Analytic test volumes, built in numpy exactly as the JAX package's
`volume/analytic.py` builds them: a sphere, metaballs, and the sparse
families that stand in for the reference's datasets (torus, gyroid,
turbulence for Clouds, ejecta for Ejecta, interface for
Richtmyer-Meshkov, skull and thorax for the CT volumes).  Each takes
``store_dtype`` and ``device`` as `BrickGrid.from_dense`."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.device import DeviceLike
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid


def _grid_coords(resolution: int):
    """Cell-centered world coordinates of every voxel of the unit box
    [-0.5, 0.5]^3."""
    c = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution - 0.5
    return np.meshgrid(c, c, c, indexing="ij")


def _grid(d: np.ndarray, brick_size: int, store_dtype: str,
          device: DeviceLike) -> BrickGrid:
    return BrickGrid.from_dense(d, brick_size=brick_size,
                                store_dtype=store_dtype, device=device)


def sphere_volume(resolution: int = 64, radius: float = 0.3,
                  center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                  sharpness: float = 8.0,
                  brick_size: int = 8,
                  store_dtype: str = "float32",
                  device: DeviceLike = None) -> BrickGrid:
    """Radial ramp through 0.5 at ``radius``."""
    x, y, z = _grid_coords(resolution)
    cx, cy, cz = center
    r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
    d = np.clip(0.5 - sharpness * (r - radius), 0.0, 1.0).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)


def torus_volume(resolution: int = 64, major_radius: float = 0.3,
                 minor_radius: float = 0.12, sharpness: float = 8.0,
                 brick_size: int = 8, store_dtype: str = "float32",
                 device: DeviceLike = None) -> BrickGrid:
    """Torus around the z axis; the density ramps through 0.5 at its
    surface."""
    x, y, z = _grid_coords(resolution)
    q = np.sqrt(x ** 2 + y ** 2) - major_radius
    r = np.sqrt(q ** 2 + z ** 2)
    d = np.clip(0.5 - sharpness * (r - minor_radius), 0.0,
                1.0).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)


def gyroid_volume(resolution: int = 64, frequency: float = 4.0,
                  thickness: float = 0.15, brick_size: int = 8,
                  store_dtype: str = "float32",
                  device: DeviceLike = None) -> BrickGrid:
    """A triply periodic gyroid shell inside a sphere."""
    x, y, z = _grid_coords(resolution)
    w = 2.0 * np.pi * frequency
    g = (np.sin(w * x) * np.cos(w * y)
         + np.sin(w * y) * np.cos(w * z)
         + np.sin(w * z) * np.cos(w * x))
    d = np.clip(1.0 - np.abs(g) / (1.5 * thickness * frequency), 0.0, 1.0)
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    d = d * (r < 0.45)
    return _grid(d.astype(np.float32), brick_size, store_dtype, device)


def _spectral_noise(resolution: int, rng: np.random.RandomState,
                    beta: float = 3.0,
                    min_period_voxels: float = 0.0) -> np.ndarray:
    """Smooth random field of zero mean and unit std: white noise shaped
    by a 1/f^(beta/2) amplitude spectrum; ``min_period_voxels`` > 0 zeroes
    the content of shorter period."""
    white = rng.randn(resolution, resolution, resolution)
    spec = np.fft.rfftn(white)
    kx = np.fft.fftfreq(resolution)[:, None, None]
    ky = np.fft.fftfreq(resolution)[None, :, None]
    kz = np.fft.rfftfreq(resolution)[None, None, :]
    k = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    k[0, 0, 0] = 1.0
    shaped = spec / k ** (beta / 2.0)
    if min_period_voxels > 0:
        shaped = np.where(k > 1.0 / min_period_voxels, 0.0, shaped)
    field = np.fft.irfftn(shaped, s=(resolution,) * 3)
    field -= field.mean()
    field /= field.std() + 1e-12
    return field.astype(np.float32)


def turbulence_volume(resolution: int = 64, seed: int = 0, beta: float = 3.5,
                      coverage: float = 0.35,
                      min_feature_voxels: float = 6.0, brick_size: int = 8,
                      store_dtype: str = "float32",
                      device: DeviceLike = None) -> BrickGrid:
    """Cloud-like band-limited fBm density with a radial falloff (the
    Clouds analogue); about ``coverage`` of the in-sphere voxels exceed
    0.5."""
    rng = np.random.RandomState(seed)
    n = _spectral_noise(resolution, rng, beta,
                        min_period_voxels=min_feature_voxels)
    x, y, z = _grid_coords(resolution)
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    falloff = np.clip(1.0 - (r / 0.45) ** 2, 0.0, 1.0)
    inside = n[r < 0.45]
    thresh = np.quantile(inside, 1.0 - coverage)
    d = 0.5 + 0.35 * (n - thresh)
    d = np.clip(d * falloff, 0.0, 1.0).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)


def ejecta_volume(resolution: int = 64, num_particles: int = 400,
                  seed: int = 0, brick_size: int = 8,
                  store_dtype: str = "float32",
                  device: DeviceLike = None) -> BrickGrid:
    """Radial particle burst (the Ejecta analogue): a dense core and
    hundreds of small Gaussian clumps shot outward, each rasterized only
    inside its +-3 sigma window."""
    rng = np.random.RandomState(seed)
    res = resolution
    d = np.zeros((res, res, res), np.float32)
    x, y, z = _grid_coords(res)
    r2c = x ** 2 + y ** 2 + z ** 2
    d += np.exp(-r2c / (2 * 0.06 ** 2)).astype(np.float32)
    del x, y, z, r2c
    coords = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    for _ in range(num_particles):
        dirv = rng.randn(3)
        dirv /= np.linalg.norm(dirv)
        dist = 0.12 + 0.33 * rng.uniform() ** 0.7
        c = dirv * dist
        rad = rng.uniform(0.008, 0.03) * (1.2 - dist)
        w = 3.0 * rad
        idx = []
        for ax in range(3):
            lo = int(np.searchsorted(coords, c[ax] - w))
            hi = int(np.searchsorted(coords, c[ax] + w)) + 1
            lo, hi = max(lo, 0), min(hi, res)
            if hi <= lo:
                break
            idx.append((lo, hi))
        if len(idx) != 3:
            continue
        (x0, x1), (y0, y1), (z0, z1) = idx
        gx = coords[x0:x1, None, None] - c[0]
        gy = coords[None, y0:y1, None] - c[1]
        gz = coords[None, None, z0:z1] - c[2]
        r2 = gx ** 2 + gy ** 2 + gz ** 2
        d[x0:x1, y0:y1, z0:z1] += np.exp(-r2 / (2 * (rad / 1.5) ** 2)
                                         ).astype(np.float32)
    d = np.clip(d, 0.0, 1.0)
    return _grid(d, brick_size, store_dtype, device)


def interface_volume(resolution: int = 64, seed: int = 0,
                     roughness: float = 0.12,
                     min_feature_voxels: float = 6.0, brick_size: int = 8,
                     store_dtype: str = "float32",
                     device: DeviceLike = None) -> BrickGrid:
    """Crumpled-interface slab (the Richtmyer-Meshkov analogue): a dense
    layer whose top is displaced by band-limited 2D noise and torn by 3D
    noise."""
    rng = np.random.RandomState(seed)
    res = resolution
    white = rng.randn(res, res)
    spec = np.fft.rfft2(white)
    kx = np.fft.fftfreq(res)[:, None]
    ky = np.fft.rfftfreq(res)[None, :]
    k = np.sqrt(kx ** 2 + ky ** 2)
    k[0, 0] = 1.0
    shaped = spec / k ** 1.5
    if min_feature_voxels > 0:
        shaped = np.where(k > 1.0 / min_feature_voxels, 0.0, shaped)
    h = np.fft.irfft2(shaped, s=(res, res))
    h = (h - h.mean()) / (h.std() + 1e-12)
    x, y, z = _grid_coords(res)
    surface = -0.05 + roughness * h[:, :, None]
    n3 = _spectral_noise(res, rng, 3.0,
                         min_period_voxels=min_feature_voxels)
    d = 0.5 + 4.0 * (surface - z) + 0.35 * n3
    d = np.where(z < -0.35, 0.0, d)
    lateral = np.maximum(np.abs(x), np.abs(y))
    d = d * np.clip((0.45 - lateral) / 0.05, 0.0, 1.0)
    d = np.clip(d, 0.0, 1.0).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)


def skull_volume(resolution: int = 64, shell_thickness: float = 0.022,
                 sharpness: float = 10.0, brick_size: int = 8,
                 store_dtype: str = "float32",
                 device: DeviceLike = None) -> BrickGrid:
    """CT-head analogue: a thin ellipsoid bone shell carved by the foramen
    magnum, eye sockets and a nasal opening, a lower jaw arc, and a brain
    of peak density 0.45 inside."""
    x, y, z = _grid_coords(resolution)

    def ellipsoid_sdf(cx, cy, cz, ax, ay, az):
        q = np.sqrt(((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2
                    + ((z - cz) / az) ** 2)
        return (q - 1.0) * min(ax, ay, az)

    cran = ellipsoid_sdf(0.0, 0.06, 0.0, 0.27, 0.32, 0.29)
    shell = np.abs(cran) - shell_thickness

    def sphere_sdf(cx, cy, cz, r):
        return np.sqrt((x - cx) ** 2 + (y - cy) ** 2
                       + (z - cz) ** 2) - r

    cutters = [
        np.maximum(np.sqrt(x ** 2 + z ** 2) - 0.07, -(y + 0.18)),
        sphere_sdf(-0.11, 0.10, 0.27, 0.075),
        sphere_sdf(+0.11, 0.10, 0.27, 0.075),
        sphere_sdf(0.0, -0.02, 0.29, 0.045),
    ]
    for c in cutters:
        shell = np.maximum(shell, -c)
    jaw_q = np.sqrt(x ** 2 + (z - 0.05) ** 2) - 0.17
    jaw = np.sqrt(jaw_q ** 2 + (y + 0.24) ** 2) - 0.025
    jaw = np.maximum(jaw, -(z + 0.02))
    bone = np.minimum(shell, jaw)
    d = np.clip(0.5 - sharpness * bone, 0.0, 1.0)
    brain_sdf = ellipsoid_sdf(0.0, 0.08, 0.0, 0.21, 0.25, 0.23)
    w = 2.0 * np.pi * 7.0
    wrinkle = 0.012 * (np.sin(w * x) * np.sin(w * y + 1.3)
                       + np.cos(w * z + 0.7))
    brain = np.clip(0.45 * np.clip(0.5 - 9.0 * (brain_sdf + wrinkle),
                                   0.0, 1.0), 0.0, 0.45)
    d = np.maximum(d, brain).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)


def thorax_volume(resolution: int = 64, num_ribs: int = 7,
                  sharpness: float = 12.0, brick_size: int = 8,
                  store_dtype: str = "float32",
                  device: DeviceLike = None) -> BrickGrid:
    """CT-chest analogue: thin rib rings around two lung cavities, a
    vertebra-bumped spine, a sternum bar, and a soft-tissue body of
    density 0.35."""
    x, y, z = _grid_coords(resolution)
    res = resolution
    bq = (np.abs(x / 0.33) ** 3 + np.abs(y / 0.43) ** 3
          + np.abs(z / 0.23) ** 3)
    body = 0.35 * np.clip(1.6 * (1.0 - bq), 0.0, 1.0)
    for sx in (-1.0, 1.0):
        lq = (((x - sx * 0.13) / 0.11) ** 2 + ((y - 0.05) / 0.24) ** 2
              + (z / 0.13) ** 2)
        body = np.where(lq < 1.0, np.minimum(body, 0.1 + 0.25 * lq), body)
    bone = np.full_like(x, 1e9)
    coords = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    rib_r = 0.013
    for k in range(num_ribs):
        yk = -0.22 + 0.50 * (k + 0.5) / num_ribs
        s = np.clip(1.0 - np.abs(yk / 0.43) ** 3, 0.0, None) ** (1.0 / 3.0)
        ax_k, az_k = 0.29 * s, 0.20 * s
        if min(ax_k, az_k) < 0.05:
            continue
        lo = int(np.searchsorted(coords, yk - 4 * rib_r))
        hi = int(np.searchsorted(coords, yk + 4 * rib_r)) + 1
        lo, hi = max(lo, 0), min(hi, res)
        xs = x[:, lo:hi, :]
        ys = y[:, lo:hi, :]
        zs = z[:, lo:hi, :]
        f = np.sqrt((xs / ax_k) ** 2 + (zs / az_k) ** 2) - 1.0
        ring = np.sqrt((f * 0.5 * (ax_k + az_k)) ** 2 + (ys - yk) ** 2)
        bone[:, lo:hi, :] = np.minimum(bone[:, lo:hi, :], ring - rib_r)
    vert = 0.006 * np.cos(2.0 * np.pi * y / 0.055)
    spine = (np.sqrt(x ** 2 + (z + 0.165) ** 2) - (0.035 + vert))
    spine = np.maximum(spine, np.abs(y - 0.03) - 0.30)
    bone = np.minimum(bone, spine)
    stern = np.maximum.reduce([np.abs(x) - 0.025,
                               np.abs(y - 0.06) - 0.17,
                               np.abs(z - 0.185) - 0.018])
    bone = np.minimum(bone, stern)
    d = np.maximum(np.clip(0.5 - sharpness * bone, 0.0, 1.0), body)
    return _grid(d.astype(np.float32), brick_size, store_dtype, device)


def blobs_volume(resolution: int = 64, num_blobs: int = 6, seed: int = 0,
                 brick_size: int = 8, store_dtype: str = "float32",
                 device: DeviceLike = None) -> BrickGrid:
    """Random metaballs from ``seed``."""
    rng = np.random.RandomState(seed)
    x, y, z = _grid_coords(resolution)
    d = np.zeros_like(x)
    for _ in range(num_blobs):
        c = rng.uniform(-0.25, 0.25, size=3)
        rad = rng.uniform(0.08, 0.2)
        r2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        d += np.exp(-r2 / (2 * (rad / 2) ** 2))
    d = np.clip(d, 0.0, 1.0).astype(np.float32)
    return _grid(d, brick_size, store_dtype, device)
