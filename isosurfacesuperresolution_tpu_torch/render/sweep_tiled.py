"""The occupancy-gated tiled march (B2, and B3 over packed storage) and
the tiled AO capture (B4, and B4p over a packed field).

Counterpart of the JAX package's `render/sweep_pallas_tiled.py`
(`march_pallas_tiled`, `ao_capture_tiled`, and their packed forms
`march_pallas_packed`, `ao_capture_packed`).  The renderer takes this path
for large volumes and for every `volume/packed.SparseBrickGrid`
(`render/sweep.py`): the slice plane is cut into an (NTX, NTY) grid of
(TX, TY) tiles, and the brick pyramid (`BrickGrid.brick_max`) decides per
slice which tiles can hold the isosurface.

* `march_tiled` returns the flat march's ``m_hit, frac, g_s, g_t, g_z``
  (`render/sweep_march.py`), but a slice with no occupied tile (or a
  do-flag of 0) only resets Fm1 to 0, and on a working slice a tap counts
  only when its tile is occupied.
* `ao_capture_tiled` samples the baked SH field at the hits that
  `march_tiled` found (a second pass), over field tiles kept by the
  3x3-dilated occupancy, summing per tile pair in increasing pair id;
  uint8 fields are dequantized per channel inside, and a coarse field
  (``field_downsample`` > 1) is sampled natively.

* `march_packed` is `march_tiled` over a `PackedAxisVolume`: a tap reads
  ``atlas[slots[z, x / TX, y / TY]]`` at (x % TX, y % TY) for the two
  planes z = zf, zf + 1, slot 0 being the background tile; the tiles are
  the atlas's.
* `ao_capture_packed` is `ao_capture_tiled` over a `PackedAOAxisVolume`
  at full resolution: a tile pair is kept when its AO slot is non-zero on
  plane zf or zf + 1 (no brick test, no dilation), with no dequant.

Each wrapper launches its CUDA kernel (``csrc/sweep_march.cu``, through
`march_tiled_kernel`, `ao_capture_tiled_kernel`, `march_packed_kernel`
and `ao_capture_packed_kernel`, which count the launches) for CUDA
tensors, runs its plain version (`march_tiled_plain` and so on) for CPU
tensors and raises for any other device.  The plain versions build the
JAX package's per-frame tables (`tile_occupancy`, `pair_tables`,
`dilate_tiles`, `slice_has_hit`, the packed forms' `slot_rows`); the
kernels read a `tile_table` instead, which depends only on the brick
pyramid, the axis order and the tile, not on the camera (the renderer
builds it once per grid, and a kernel compares a slice's row with the
isovalue itself), and the packed kernels read the slot table directly.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np

import torch

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.render import sweep_march as sm

_F32 = torch.float32
_FNS: dict = {}

ChannelFloats = Union[float, Tuple[float, ...]]


def pick_tile(extent: int, tile: int) -> int:
    """The largest divisor of ``extent`` that does not exceed ``tile``."""
    for cand in range(min(tile, extent), 0, -1):
        if extent % cand == 0:
            return cand
    return extent


def tile_max(brick_max_p: torch.Tensor, brick_size: int, X: int, Y: int,
             TX: int, TY: int) -> torch.Tensor:
    """(NTX, NTY, bz) largest brick max of each tile per brick layer.

    ``brick_max_p`` is in the permuted axis order (bx, by, bz); a brick
    that straddles two tiles counts for both."""
    b = brick_size
    NTX, NTY = X // TX, Y // TY
    bx, by, _ = brick_max_p.shape
    dev = brick_max_p.device

    def tile_mask(nt: int, tsize: int, nb: int) -> torch.Tensor:
        starts = torch.arange(nb, device=dev) * b
        t0 = torch.arange(nt, device=dev) * tsize
        return ((starts[None, :] < (t0 + tsize)[:, None])
                & ((starts + b)[None, :] > t0[:, None]))

    mx, my = tile_mask(NTX, TX, bx), tile_mask(NTY, TY, by)
    tx = torch.where(mx[:, :, None, None], brick_max_p[None],
                     -torch.inf).amax(1)                 # (NTX, by, bz)
    return torch.where(my[None, :, :, None], tx[:, None],
                       -torch.inf).amax(2)               # (NTX, NTY, bz)


def _layers(zfs: torch.Tensor, brick_size: int, bz: int):
    """The brick layers of slice floors ``zfs`` and ``zfs`` + 1."""
    return (torch.clamp(zfs // brick_size, 0, bz - 1),
            torch.clamp((zfs + 1) // brick_size, 0, bz - 1))


def _iso32(iso: float) -> float:
    """The float32 isovalue, as a Python float."""
    return torch.tensor(iso, dtype=_F32).item()


def tile_occupancy(brick_max_p: torch.Tensor, brick_size: int,
                   zfs: torch.Tensor, iso: float, X: int, Y: int, TX: int,
                   TY: int) -> torch.Tensor:
    """(K, NTX, NTY) occupancy from the brick pyramid.

    ``brick_max_p`` is in the permuted axis order (bx, by, bz), ``zfs``
    the (K,) slice floor z indices.  A tile is occupied on a slice when a
    brick that touches it (a brick straddling two tiles touches both) in
    the brick layer of zf or zf + 1 reaches the physical isovalue."""
    tm = tile_max(brick_max_p, brick_size, X, Y, TX, TY)
    zb0, zb1 = _layers(zfs, brick_size, tm.shape[2])
    tm = torch.maximum(tm[:, :, zb0], tm[:, :, zb1])
    return (tm >= _iso32(iso)).permute(2, 0, 1)


def tile_table(brick_max_p: torch.Tensor, brick_size: int, X: int, Y: int,
               TX: int, TY: int, dilate: bool = False) -> torch.Tensor:
    """What the kernels read in place of the per-frame occupancy: a
    contiguous (bz * b, P + 1) float32 table.  Row z, column p (pair id
    xt * NTY + yt) is the largest brick max of tile p over the brick
    layers of z and z + 1 (with ``dilate``, over the tile's 3 x 3 tile
    neighbourhood too), and column P is the row's largest.  A slice with
    floor zf is occupied in tile p when row zf, column p reaches the
    isovalue: `tile_occupancy` (or its `dilate_tiles`) exactly, since
    both take maxima before one comparison.  It depends on the brick
    pyramid, the axis order and the tile only."""
    tm = tile_max(brick_max_p, brick_size, X, Y, TX, TY)
    if dilate:
        tm = torch.nn.functional.max_pool2d(tm.permute(2, 0, 1), 3, 1,
                                            1).permute(1, 2, 0)
    NTX, NTY, bz = tm.shape
    zb0, zb1 = _layers(torch.arange(bz * brick_size, device=tm.device),
                       brick_size, bz)
    rows = torch.maximum(tm[:, :, zb0], tm[:, :, zb1]).reshape(NTX * NTY, -1)
    return torch.cat([rows, rows.amax(0, keepdim=True)]).t().contiguous()


def pair_tables(occ: torch.Tensor, meta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The occupancy gated by the do-flag (a skipped slice has no pair),
    the per-slice count of occupied tiles (int32) and the column bits
    (K, NTY): the parts of the TPU kernel's pair lists the port uses."""
    occ = occ & (meta[:, 4] > 0.5)[:, None, None]
    counts = occ.flatten(1).sum(1, dtype=torch.int32)
    return occ, counts, occ.any(1)


def dilate_tiles(occ: torch.Tensor) -> torch.Tensor:
    """3x3 tile-space dilation of a (K, NTX, NTY) mask: a crossing's
    footprint can reach one voxel into a density-empty neighbour tile
    whose baked occlusion is non-zero."""
    K, NTX, NTY = occ.shape
    p = torch.zeros((K, NTX + 2, NTY + 2), dtype=torch.bool,
                    device=occ.device)
    p[:, 1:-1, 1:-1] = occ
    out = torch.zeros_like(occ)
    for dx in range(3):
        for dy in range(3):
            out = out | p[:, dx:dx + NTX, dy:dy + NTY]
    return out


def slice_has_hit(m_hit: torch.Tensor, K: int) -> torch.Tensor:
    """(K,) bool: does any pixel's march hit land on slice k (a scatter
    into K + 1 flags, the last one catching the misses)."""
    idx = torch.where(m_hit >= 0.0, torch.clamp(m_hit.long(), 0, K - 1), K)
    flags = torch.zeros(K + 1, dtype=torch.bool, device=m_hit.device)
    return flags.index_fill_(0, idx.reshape(-1), True)[:K]


def march_tables(vol_shape, meta: torch.Tensor, brick_max_p: torch.Tensor,
                 brick_size: int, iso: float, tile: int):
    """Tile sizes, gated occupancy and counts of the tiled march."""
    _, X, Y = vol_shape
    TX, TY = pick_tile(X, tile), pick_tile(Y, tile)
    occ = tile_occupancy(brick_max_p, brick_size, meta[:, 2].long(), iso,
                         X, Y, TX, TY)
    occ, counts, _ = pair_tables(occ, meta)
    return TX, TY, occ, counts


def march_tiled_plain(vol_zxy: torch.Tensor, meta: torch.Tensor,
                      s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                      Tn: int, brick_max_p: torch.Tensor, brick_size: int,
                      iso: float, tile: int = 256,
                      dtype: torch.dtype = torch.bfloat16,
                      scale: float = 1.0, offset: float = 0.0
                      ) -> Tuple[torch.Tensor, ...]:
    """B2's function as the flat march's plain loop: the do-flag of a
    slice with no occupied tile is cleared, and each working slice's
    values outside its occupied tiles are zeroed before the first factor
    (the TPU kernel's row accumulator sums the same products)."""
    TX, TY, occ, counts = march_tables(vol_zxy.shape, meta, brick_max_p,
                                       brick_size, iso, tile)
    meta = meta.clone()
    meta[:, 4] = (counts > 0).to(_F32)
    return sm.march_plain(vol_zxy, meta, s_grid, t_grid, Sn, Tn, dtype,
                          scale, offset, occ=occ, tile=(TX, TY))


def inv_f32(fd: int) -> float:
    """1 / fd rounded to float32, as the captures scale the hit position
    into a field downsampled ``fd`` times (no tensor: a launch makes it on
    the host every call)."""
    return float(np.float32(1) / np.float32(fd))


def per_channel(v: ChannelFloats) -> Tuple[float, ...]:
    """An AO scale or offset (a float or a 4-tuple) as four float32
    values, on the host."""
    t = torch.tensor(v, dtype=_F32).expand(4)
    return tuple(t.tolist())


def ao_tables(field_shape, meta: torch.Tensor, m_hit: torch.Tensor,
              brick_max_p: torch.Tensor, brick_size: int, iso: float,
              tile: int, fd: int):
    """Tile sizes, the kept field tiles per slice (dilated occupancy on
    slices with a hit, gated by the do-flag; occupancy in fine voxels on
    tiles of TX * fd) and the meta rows with the field's z columns."""
    Z2, _, X2, Y2 = field_shape
    K = meta.shape[0]
    TX, TY = pick_tile(X2, tile), pick_tile(Y2, tile)
    occ = tile_occupancy(brick_max_p, brick_size, meta[:, 2].long(), iso,
                         X2 * fd, Y2 * fd, TX * fd, TY * fd)
    occ = dilate_tiles(occ) & slice_has_hit(m_hit, K)[:, None, None]
    if fd > 1:
        # the fine cell-centered z maps to coarse z / fd (coarse voxel j's
        # center sits at fine (j + 0.5) * fd)
        zc2 = meta[:, 0] / fd
        zf2 = torch.clamp(torch.floor(zc2 - 0.5), 0, Z2 - 2)
        fz2 = torch.clamp(zc2 - 0.5 - zf2, 0.0, 1.0)
        meta = meta.clone()
        meta[:, 2], meta[:, 3] = zf2, fz2
    occ, counts, _ = pair_tables(occ, meta)
    return TX, TY, occ, counts, meta


def _field_store(ao_zcxy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 fields stay uint8; a float field is held in the resample type
    (a cast keeps the view's layout; the kernel reads through strides)."""
    if ao_zcxy.dtype == torch.uint8:
        return ao_zcxy
    sm._store_dtype(ao_zcxy, dtype)          # checks the resample type
    return ao_zcxy.to(dtype)


def ao_capture_tiled_plain(ao_zcxy: torch.Tensor, meta: torch.Tensor,
                           s_grid: torch.Tensor, t_grid: torch.Tensor,
                           Sn: int, Tn: int, m_hit: torch.Tensor,
                           brick_max_p: torch.Tensor, brick_size: int,
                           iso: float, tile: int = 128,
                           dtype: torch.dtype = torch.bfloat16,
                           ao_scale: ChannelFloats = 1.0,
                           ao_offset: ChannelFloats = 0.0,
                           field_downsample: int = 1) -> torch.Tensor:
    """B4's function as the TPU kernel's loop: per slice with kept tiles,
    per kept pair in increasing id, per channel, the x taps inside the
    pair's x tile through wx, rounded, the y taps inside its y tile
    through wy, added to sh where the pixel's hit is on this slice."""
    fd = int(field_downsample)
    TX, TY, occ, counts, meta = ao_tables(ao_zcxy.shape, meta, m_hit,
                                          brick_max_p, brick_size, iso, tile,
                                          fd)
    return _capture_loop(_field_store(ao_zcxy, dtype), meta, s_grid, t_grid,
                         Sn, Tn, m_hit, TX, TY, occ, counts, dtype,
                         per_channel(ao_scale), per_channel(ao_offset), fd)


def _capture_loop(field: torch.Tensor, meta: torch.Tensor,
                  s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                  Tn: int, m_hit: torch.Tensor, TX: int, TY: int,
                  occ: torch.Tensor, counts: torch.Tensor,
                  dtype: torch.dtype, scales: Tuple[float, ...],
                  offs: Tuple[float, ...], fd: int) -> torch.Tensor:
    """The TPU capture kernel's loop over ``field`` (Z', 4, X', Y') for
    the kept tile pairs ``occ`` (K, NTX, NTY) and their ``counts``, with
    ``meta``'s z columns in the field's slabs."""
    _, _, X2, Y2 = field.shape
    NTY = Y2 // TY
    dev = field.device
    rows = meta.cpu().tolist()
    cnt = counts.cpu().tolist()
    occ_h = occ.flatten(1).cpu()
    inv_f = inv_f32(fd)
    jx = torch.arange(X2, dtype=_F32, device=dev) + 0.5
    jy = torch.arange(Y2, dtype=_F32, device=dev) + 0.5
    sh = torch.zeros((4, Sn, Tn), dtype=_F32, device=dev)
    for k, (_, lam, zf, fz, _, _, eye_s, eye_t) in enumerate(rows):
        if cnt[k] == 0:
            continue
        cross = m_hit == float(k)
        zf = int(zf)
        asl = ((1.0 - fz) * field[zf].to(_F32)
               + fz * field[zf + 1].to(_F32))               # (4, X2, Y2)
        chans = [sm._round(asl[c] * scales[c] + offs[c], dtype)
                 for c in range(4)]
        s_pos = (eye_s + lam * (s_grid - eye_s)) * inv_f
        t_pos = (eye_t + lam * (t_grid - eye_t)) * inv_f
        wx = sm._round(torch.clamp(1.0 - torch.abs(s_pos[:, None] - jx),
                                   min=0.0), dtype)
        wy = sm._round(torch.clamp(1.0 - torch.abs(t_pos[:, None] - jy),
                                   min=0.0), dtype)
        for pid in torch.nonzero(occ_h[k]).flatten().tolist():
            xt, yt = divmod(pid, NTY)
            xs = slice(xt * TX, (xt + 1) * TX)
            ys = slice(yt * TY, (yt + 1) * TY)
            for c in range(4):
                tc = wx[:, xs] @ chans[c][xs, ys]
                fc = sm._round(tc, dtype) @ wy[:, ys].t()
                sh[c] = sh[c] + torch.where(cross, fc, 0.0)
    return sh


def _kernel(name: str, argtypes: list):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(kernels.load("sweep_march"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)


def _device(x: torch.Tensor, name: str) -> torch.device:
    dev = x.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    return dev


def _check_table(table: torch.Tensor, brick_max_p: torch.Tensor,
                 brick_size: int, P: int, dev: torch.device) -> torch.Tensor:
    shape = (brick_max_p.shape[2] * brick_size, P + 1)
    if (tuple(table.shape) != shape or table.dtype != _F32
            or table.device != dev or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous float32 {shape} "
                         f"tile_table on {dev}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    return table


def march_tiled(vol_zxy: torch.Tensor, meta: torch.Tensor,
                s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int, Tn: int,
                brick_max_p: torch.Tensor, brick_size: int, iso: float,
                tile: int = 256, dtype: torch.dtype = torch.bfloat16,
                scale: float = 1.0, offset: float = 0.0,
                table: "torch.Tensor | None" = None
                ) -> Tuple[torch.Tensor, ...]:
    """Run the tiled march: the CUDA kernel (`march_tiled_kernel`) for
    CUDA tensors, `march_tiled_plain` for CPU tensors.  ``brick_max_p`` is
    the brick pyramid's max in the march's axis order (bx, by, bz),
    ``iso`` the physical isovalue; ``table`` is its `tile_table` for this
    tile, made here when not given (a renderer keeps one per grid)."""
    if _device(vol_zxy, "march_tiled").type == "cpu":
        return march_tiled_plain(vol_zxy, meta, s_grid, t_grid, Sn, Tn,
                                 brick_max_p, brick_size, iso, tile, dtype,
                                 scale, offset)
    dev = vol_zxy.device
    _march_fn()                 # raises when the library cannot be built
    vol = sm.kernel_volume(vol_zxy, dtype)
    if vol.dim() != 3 or vol.shape[0] < 2:
        raise ValueError(f"vol_zxy must be (Z >= 2, X, Y), got "
                         f"{tuple(vol.shape)}")
    meta, s_grid, t_grid = sm.check_tables(dev, meta, s_grid, t_grid, Sn, Tn)
    if brick_max_p.device != dev:
        raise ValueError(f"brick_max_p is on {brick_max_p.device}, the "
                         f"volume on {dev}")
    _, X, Y = vol.shape
    TX, TY = pick_tile(X, tile), pick_tile(Y, tile)
    if table is None:
        table = tile_table(brick_max_p, brick_size, X, Y, TX, TY)
    table = _check_table(table, brick_max_p, brick_size,
                         (X // TX) * (Y // TY), dev)
    return march_tiled_kernel(vol, meta, s_grid, t_grid, Sn, Tn, table, TX,
                              TY, iso, dtype, scale, offset)


def _march_fn():
    return _kernel("sweep_march_tiled",
                   [_P, _I, _I, _P, _P, _P, _P] + [_I] * 11
                   + [_F, _F, _F] + [_P] * 6)


def march_tiled_kernel(vol: torch.Tensor, meta: torch.Tensor,
                       s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                       Tn: int, table: torch.Tensor, TX: int, TY: int,
                       iso: float, dtype: torch.dtype, scale: float,
                       offset: float) -> Tuple[torch.Tensor, ...]:
    """Launch B2 on inputs `march_tiled` prepared: ``vol`` from
    `sweep_march.kernel_volume`, checked tables and the (rows, P + 1)
    `tile_table` for tiles (TX, TY).  ``march_tiled_kernel.launches``
    counts launches."""
    fn = _march_fn()
    dev = vol.device
    K = meta.shape[0]
    Z, X, Y = vol.shape
    outs = [torch.empty((Sn, Tn), dtype=_F32, device=dev) for _ in range(5)]
    err = fn(vol.data_ptr(), sm._STORE_CODES[vol.dtype],
             int(dtype == torch.bfloat16), meta.data_ptr(),
             s_grid.data_ptr(), t_grid.data_ptr(), table.data_ptr(),
             table.shape[0], K, Z, X, Y, Sn, Tn, table.shape[1] - 1, TX, TY,
             Y // TY, _iso32(iso), float(scale), float(offset),
             *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_march_tiled launch failed: CUDA error "
                           f"{err}")
    march_tiled_kernel.launches += 1
    return tuple(outs)


march_tiled_kernel.launches = 0


def ao_capture_tiled(ao_zcxy: torch.Tensor, meta: torch.Tensor,
                     s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                     Tn: int, m_hit: torch.Tensor, brick_max_p: torch.Tensor,
                     brick_size: int, iso: float, tile: int = 128,
                     dtype: torch.dtype = torch.bfloat16,
                     ao_scale: ChannelFloats = 1.0,
                     ao_offset: ChannelFloats = 0.0,
                     field_downsample: int = 1,
                     table: "torch.Tensor | None" = None) -> torch.Tensor:
    """Run the tiled AO capture: the CUDA kernel
    (`ao_capture_tiled_kernel`) for CUDA tensors, `ao_capture_tiled_plain`
    for CPU tensors.  ``ao_zcxy`` is the (Z', 4, X', Y') baked SH field in
    the march's axis order (a view is fine), at 1/``field_downsample`` of
    the volume per axis, stored uint8 (with per-channel
    ``ao_scale``/``ao_offset``) or float; ``meta`` is the march's slice
    table and ``m_hit`` its (Sn, Tn) output; ``table`` is the dilated
    `tile_table` of the field's tiles in fine voxels, made here when not
    given.  Returns sh (4, Sn, Tn) float32, 0 where there is no hit."""
    if _device(ao_zcxy, "ao_capture_tiled").type == "cpu":
        return ao_capture_tiled_plain(ao_zcxy, meta, s_grid, t_grid, Sn, Tn,
                                      m_hit, brick_max_p, brick_size, iso,
                                      tile, dtype, ao_scale, ao_offset,
                                      field_downsample)
    dev = ao_zcxy.device
    _ao_fn()                    # raises when the library cannot be built
    if ao_zcxy.dim() != 4 or ao_zcxy.shape[1] != 4 or ao_zcxy.shape[0] < 2:
        raise ValueError(f"ao_zcxy must be (Z' >= 2, 4, X', Y'), got "
                         f"{tuple(ao_zcxy.shape)}")
    meta, s_grid, t_grid = sm.check_tables(dev, meta, s_grid, t_grid, Sn, Tn)
    for name, x in (("m_hit", m_hit), ("brick_max_p", brick_max_p)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the field on {dev}")
    if tuple(m_hit.shape) != (Sn, Tn) or m_hit.dtype != _F32:
        raise ValueError(f"m_hit must be float32 {(Sn, Tn)}")
    fd = int(field_downsample)
    field = _field_store(ao_zcxy, dtype)
    _, _, X2, Y2 = field.shape
    TX, TY = pick_tile(X2, tile), pick_tile(Y2, tile)
    if table is None:
        table = tile_table(brick_max_p, brick_size, X2 * fd, Y2 * fd,
                           TX * fd, TY * fd, dilate=True)
    table = _check_table(table, brick_max_p, brick_size,
                         (X2 // TX) * (Y2 // TY), dev)
    return ao_capture_tiled_kernel(field, meta, s_grid, t_grid,
                                   m_hit.contiguous(), table, TX, TY, iso,
                                   dtype, ao_scale, ao_offset, fd)


def _ao_fn():
    return _kernel("ao_capture_tiled",
                   [_P, _I, _I, _L, _L, _L, _L, _P, _P, _P, _P, _P]
                   + [_I] * 12 + [_F] * 10 + [_P, _P])


def ao_capture_tiled_kernel(field: torch.Tensor, meta: torch.Tensor,
                            s_grid: torch.Tensor, t_grid: torch.Tensor,
                            m_hit: torch.Tensor, table: torch.Tensor,
                            TX: int, TY: int, iso: float, dtype: torch.dtype,
                            ao_scale: ChannelFloats,
                            ao_offset: ChannelFloats,
                            fd: int) -> torch.Tensor:
    """Launch B4 on inputs `ao_capture_tiled` prepared: ``field`` in its
    storage type (any strides), the march's ``meta`` (the kernel maps its
    z columns to the field's), contiguous ``m_hit`` and the dilated
    (rows, P + 1) `tile_table` of the field tiles (TX, TY) in fine voxels.
    ``ao_capture_tiled_kernel.launches`` counts launches."""
    fn = _ao_fn()
    dev = field.device
    K = meta.shape[0]
    Sn, Tn = m_hit.shape
    Z2, _, X2, Y2 = field.shape
    sh = torch.empty((4, Sn, Tn), dtype=_F32, device=dev)
    err = fn(field.data_ptr(), sm._STORE_CODES[field.dtype],
             int(dtype == torch.bfloat16), *field.stride(), meta.data_ptr(),
             s_grid.data_ptr(), t_grid.data_ptr(), m_hit.data_ptr(),
             table.data_ptr(), table.shape[0], K, Z2, X2, Y2, Sn, Tn,
             table.shape[1] - 1, TX, TY, Y2 // TY, fd, _iso32(iso),
             inv_f32(fd),
             *per_channel(ao_scale), *per_channel(ao_offset),
             sh.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ao_capture_tiled launch failed: CUDA error "
                           f"{err}")
    ao_capture_tiled_kernel.launches += 1
    return sh


ao_capture_tiled_kernel.launches = 0


# ---------------------------------------------------------------------------
# packed storage: B3 and B4p
# ---------------------------------------------------------------------------

def slot_rows(slots: torch.Tensor, zfs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's per-frame (K, P) slot rows: the atlas slot of
    every tile (pair id xt * NTY + yt) of the planes zf and zf + 1 of each
    slice (plane indices clipped to the volume)."""
    Z = slots.shape[0]
    flat = slots.reshape(Z, -1)
    return (flat[torch.clamp(zfs, 0, Z - 1)],
            flat[torch.clamp(zfs + 1, 0, Z - 1)])


def _slot_planes(atlas: torch.Tensor, rows0: torch.Tensor,
                 rows1: torch.Tensor, keep: torch.Tensor, zfs: torch.Tensor,
                 Z: int) -> torch.Tensor:
    """(Z, P, *tile) planes as the slot rows deliver them: tile p of
    planes zf and zf + 1 of every slice that keeps pair p (``keep``
    (K, NTX, NTY)) read from the atlas, zero elsewhere."""
    K, P = rows0.shape
    k, p = torch.nonzero(keep.reshape(K, P), as_tuple=True)
    planes = torch.zeros((Z, P) + tuple(atlas.shape[1:]), dtype=atlas.dtype,
                         device=atlas.device)
    planes[torch.clamp(zfs, 0, Z - 1)[k], p] = atlas[rows0[k, p].long()]
    planes[torch.clamp(zfs + 1, 0, Z - 1)[k], p] = atlas[rows1[k, p].long()]
    return planes


def march_packed_plain(packed_axis, meta: torch.Tensor,
                       s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                       Tn: int, brick_max_p: torch.Tensor, brick_size: int,
                       iso: float, dtype: torch.dtype = torch.bfloat16,
                       scale: float = 1.0, offset: float = 0.0
                       ) -> Tuple[torch.Tensor, ...]:
    """B3's function as the JAX package builds it per frame: the brick
    occupancy of the atlas's tiles (`tile_occupancy`, `pair_tables`) and
    the (K, P) slot rows (`slot_rows`); each working slice's occupied
    tiles are read from the atlas through its rows, and B2's plain loop
    marches them (the rows are indexed by pair id, not compacted)."""
    Z, X, Y = packed_axis.shape
    TX, TY = packed_axis.tile_shape
    zfs = meta[:, 2].long()
    occ = tile_occupancy(brick_max_p, brick_size, zfs, iso, X, Y, TX, TY)
    occ, counts, _ = pair_tables(occ, meta)
    rows0, rows1 = slot_rows(packed_axis.slots, zfs)
    vol = (_slot_planes(packed_axis.atlas, rows0, rows1, occ, zfs, Z)
           .reshape(Z, X // TX, Y // TY, TX, TY).permute(0, 1, 3, 2, 4)
           .reshape(Z, X, Y))
    meta = meta.clone()
    meta[:, 4] = (counts > 0).to(_F32)
    return sm.march_plain(vol, meta, s_grid, t_grid, Sn, Tn, dtype, scale,
                          offset, occ=occ, tile=(TX, TY))


def ao_packed_tables(packed_ao, meta: torch.Tensor, m_hit: torch.Tensor):
    """B4p's per-frame tables as the JAX package builds them: the AO
    atlas's tile sizes, the kept pairs (on a do-slice with a hit, the
    pair's slot is non-zero on plane zf or zf + 1), their counts, and the
    (K, P) slot rows."""
    _, X, Y = packed_ao.shape
    TX, TY = packed_ao.tile_shape
    K = meta.shape[0]
    rows0, rows1 = slot_rows(packed_ao.slots, meta[:, 2].long())
    occ = ((rows0 > 0) | (rows1 > 0)).reshape(K, X // TX, Y // TY)
    occ, counts, _ = pair_tables(
        occ & slice_has_hit(m_hit, K)[:, None, None], meta)
    return TX, TY, occ, counts, rows0, rows1


def ao_capture_packed_plain(packed_ao, meta: torch.Tensor,
                            s_grid: torch.Tensor, t_grid: torch.Tensor,
                            Sn: int, Tn: int, m_hit: torch.Tensor,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """B4p's function as the JAX package builds it per frame
    (`ao_packed_tables`): the kept tiles come from the atlas (in
    ``dtype``) through the slot rows, and B4's loop sums them at full
    resolution with scale 1 and offset 0."""
    Z, X, Y = packed_ao.shape
    TX, TY, occ, counts, rows0, rows1 = ao_packed_tables(packed_ao, meta,
                                                         m_hit)
    zfs = meta[:, 2].long()
    sm._store_dtype(packed_ao.atlas, dtype)    # checks the resample type
    field = (_slot_planes(packed_ao.atlas.to(dtype), rows0, rows1, occ, zfs,
                          Z)
             .reshape(Z, X // TX, Y // TY, 4, TX, TY)
             .permute(0, 3, 1, 4, 2, 5).reshape(Z, 4, X, Y))
    return _capture_loop(field, meta, s_grid, t_grid, Sn, Tn, m_hit, TX, TY,
                         occ, counts, dtype, (1.0,) * 4, (0.0,) * 4, 1)


def kernel_atlas(packed, store: torch.dtype) -> torch.Tensor:
    """A packed volume's or field's atlas as its kernel reads it:
    contiguous, in ``store``; a cast is made once and kept in
    ``packed.derived``.  (A uint8 density atlas stays uint8.)"""
    atlas = packed.atlas
    if atlas.dtype == store and atlas.is_contiguous():
        return atlas
    key = ("atlas", store)
    out = packed.derived.get(key)
    if out is None:
        out = packed.derived[key] = torch.empty(
            atlas.shape, dtype=store, device=atlas.device).copy_(atlas)
    return out


def _check_slots(packed, dev: torch.device) -> torch.Tensor:
    Z, X, Y = packed.shape
    TX, TY = packed.tile_shape
    slots = packed.slots
    shape = (Z, X // TX, Y // TY)
    if (Z < 2 or X % TX or Y % TY or tuple(slots.shape) != shape
            or slots.dtype != torch.int32 or slots.device != dev
            or not slots.is_contiguous()):
        raise ValueError(f"slots must be a contiguous int32 {shape} table on "
                         f"{dev} (Z >= 2, tiles {(TX, TY)} dividing "
                         f"{(X, Y)}), got {slots.dtype} "
                         f"{tuple(slots.shape)} on {slots.device}")
    return slots


def march_packed(packed_axis, meta: torch.Tensor, s_grid: torch.Tensor,
                 t_grid: torch.Tensor, Sn: int, Tn: int,
                 brick_max_p: torch.Tensor, brick_size: int, iso: float,
                 dtype: torch.dtype = torch.bfloat16, scale: float = 1.0,
                 offset: float = 0.0, table: "torch.Tensor | None" = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Run the packed march: the CUDA kernel (`march_packed_kernel`) for
    CUDA tensors, `march_packed_plain` for CPU tensors.  ``packed_axis`` is
    the `PackedAxisVolume` of the march's axis order, the other arguments
    `march_tiled`'s; ``table`` is the `tile_table` of the atlas's tiles,
    made here when not given."""
    if _device(packed_axis.atlas, "march_packed").type == "cpu":
        return march_packed_plain(packed_axis, meta, s_grid, t_grid, Sn, Tn,
                                  brick_max_p, brick_size, iso, dtype, scale,
                                  offset)
    dev = packed_axis.atlas.device
    _packed_fn()                # raises when the library cannot be built
    slots = _check_slots(packed_axis, dev)
    atlas = kernel_atlas(packed_axis,
                         sm._store_dtype(packed_axis.atlas, dtype))
    meta, s_grid, t_grid = sm.check_tables(dev, meta, s_grid, t_grid, Sn, Tn)
    if brick_max_p.device != dev:
        raise ValueError(f"brick_max_p is on {brick_max_p.device}, the "
                         f"atlas on {dev}")
    _, X, Y = packed_axis.shape
    TX, TY = packed_axis.tile_shape
    if table is None:
        table = tile_table(brick_max_p, brick_size, X, Y, TX, TY)
    table = _check_table(table, brick_max_p, brick_size,
                         (X // TX) * (Y // TY), dev)
    return march_packed_kernel(atlas, slots, meta, s_grid, t_grid, Sn, Tn,
                               table, iso, dtype, scale, offset)


def _packed_fn():
    return _kernel("sweep_march_packed",
                   [_P, _I, _I, _P, _P, _P, _P, _P] + [_I] * 11
                   + [_F, _F, _F] + [_P] * 6)


def march_packed_kernel(atlas: torch.Tensor, slots: torch.Tensor,
                        meta: torch.Tensor, s_grid: torch.Tensor,
                        t_grid: torch.Tensor, Sn: int, Tn: int,
                        table: torch.Tensor, iso: float, dtype: torch.dtype,
                        scale: float, offset: float
                        ) -> Tuple[torch.Tensor, ...]:
    """Launch B3 on inputs `march_packed` prepared: the contiguous
    (N, TX, TY) atlas from `kernel_atlas`, the contiguous int32
    (Z, NTX, NTY) slots, checked tables and the (rows, P + 1) `tile_table`
    of the atlas's tiles.  ``march_packed_kernel.launches`` counts
    launches."""
    fn = _packed_fn()
    dev = atlas.device
    K = meta.shape[0]
    Z, NTX, NTY = slots.shape
    _, TX, TY = atlas.shape
    outs = [torch.empty((Sn, Tn), dtype=_F32, device=dev) for _ in range(5)]
    err = fn(atlas.data_ptr(), sm._STORE_CODES[atlas.dtype],
             int(dtype == torch.bfloat16), slots.data_ptr(), meta.data_ptr(),
             s_grid.data_ptr(), t_grid.data_ptr(), table.data_ptr(),
             table.shape[0], K, Z, NTX * TX, NTY * TY, Sn, Tn,
             table.shape[1] - 1, TX, TY, NTY, _iso32(iso), float(scale),
             float(offset), *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_march_packed launch failed: CUDA error "
                           f"{err}")
    march_packed_kernel.launches += 1
    return tuple(outs)


march_packed_kernel.launches = 0


def ao_capture_packed(packed_ao, meta: torch.Tensor, s_grid: torch.Tensor,
                      t_grid: torch.Tensor, Sn: int, Tn: int,
                      m_hit: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run the packed AO capture: the CUDA kernel
    (`ao_capture_packed_kernel`) for CUDA tensors,
    `ao_capture_packed_plain` for CPU tensors.  ``packed_ao`` is the
    `PackedAOAxisVolume` of the march's axis order, ``meta`` the march's
    slice table and ``m_hit`` its (Sn, Tn) output.  Returns sh
    (4, Sn, Tn) float32, 0 where there is no hit."""
    if _device(packed_ao.atlas, "ao_capture_packed").type == "cpu":
        return ao_capture_packed_plain(packed_ao, meta, s_grid, t_grid, Sn,
                                       Tn, m_hit, dtype)
    dev = packed_ao.atlas.device
    _ao_packed_fn()             # raises when the library cannot be built
    slots = _check_slots(packed_ao, dev)
    sm._store_dtype(packed_ao.atlas, dtype)    # checks the resample type
    atlas = kernel_atlas(packed_ao, dtype)
    if atlas.dim() != 4 or atlas.shape[1] != 4:
        raise ValueError(f"the AO atlas must be (N, 4, TX, TY), got "
                         f"{tuple(atlas.shape)}")
    meta, s_grid, t_grid = sm.check_tables(dev, meta, s_grid, t_grid, Sn, Tn)
    if m_hit.device != dev:
        raise ValueError(f"m_hit is on {m_hit.device}, the atlas on {dev}")
    if tuple(m_hit.shape) != (Sn, Tn) or m_hit.dtype != _F32:
        raise ValueError(f"m_hit must be float32 {(Sn, Tn)}")
    return ao_capture_packed_kernel(atlas, slots, meta, s_grid, t_grid,
                                    m_hit.contiguous(), dtype)


def _ao_packed_fn():
    return _kernel("ao_capture_packed",
                   [_P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P, _P])


def ao_capture_packed_kernel(atlas: torch.Tensor, slots: torch.Tensor,
                             meta: torch.Tensor, s_grid: torch.Tensor,
                             t_grid: torch.Tensor, m_hit: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """Launch B4p on inputs `ao_capture_packed` prepared: the contiguous
    (N, 4, TX, TY) atlas in ``dtype`` from `kernel_atlas`, the contiguous
    int32 (Z, NTX, NTY) slots, the march's ``meta`` and contiguous
    ``m_hit``.  ``ao_capture_packed_kernel.launches`` counts launches."""
    fn = _ao_packed_fn()
    dev = atlas.device
    K = meta.shape[0]
    Sn, Tn = m_hit.shape
    Z, NTX, NTY = slots.shape
    _, _, TX, TY = atlas.shape
    sh = torch.empty((4, Sn, Tn), dtype=_F32, device=dev)
    err = fn(atlas.data_ptr(), int(dtype == torch.bfloat16), slots.data_ptr(),
             meta.data_ptr(), s_grid.data_ptr(), t_grid.data_ptr(),
             m_hit.data_ptr(), K, Z, NTX * TX, NTY * TY, Sn, Tn, TX, TY,
             sh.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ao_capture_packed launch failed: CUDA error "
                           f"{err}")
    ao_capture_packed_kernel.launches += 1
    return sh


ao_capture_packed_kernel.launches = 0
