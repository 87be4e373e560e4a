"""Clip datasets: crop sampling, augmentation, batching, npy loading.

Counterpart of the JAX package's `data/dataset.py` (the reference's
`datasetVideo.py`): random crops accepted by their fill ratio on the
first and last frame, flip augmentation with the normal and flow sign
fixes (off by default), a trailing-fraction test split after sorting the
samples by sequence, and the reference's ``low_%05d.npy`` /
``high_%05d.npy`` / ``flow_%05d.npy`` clips (NCHW on disk, NHWC here).
The numpy draws come in JAX's order (`np.random.RandomState`), so a seed
gives JAX's samples and batch order.  Batches are numpy float32 arrays;
`train/device_data.DeviceVideoDataset` gathers them on the card instead.
The reference's legacy EXR sequence directories load through the port's
EXR codec (`data/exr.py`, `load_legacy_exr_dir`).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)


@dataclass
class Sample:
    """One crop of one sequence."""

    index: int                  # sequence index
    x: int                      # crop origin (low-res pixels)
    y: int
    augmentation: int = 0


# augmentation modes: 0 = none, 1 = flip x (width), 2 = flip y (height),
# 3 = both
MAX_AUGMENTATION_MODE = 4


def augment_clip(low: np.ndarray, high: np.ndarray, flow: np.ndarray,
                 mode: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flip a clip (T, H, W, C) with the channel sign fixes flips require.

    Flipping width negates normal-x and flow-x; flipping height negates
    normal-y and flow-y (channel layout: low/high = [mask, nx, ny, nz,
    depth(, ao)], flow = [fx, fy]).
    """
    if mode & 1:  # flip width
        low = low[:, :, ::-1].copy()
        high = high[:, :, ::-1].copy()
        flow = flow[:, :, ::-1].copy()
        low[..., 1] = -low[..., 1]
        high[..., 1] = -high[..., 1]
        flow[..., 0] = -flow[..., 0]
    if mode & 2:  # flip height
        low = low[:, ::-1].copy()
        high = high[:, ::-1].copy()
        flow = flow[:, ::-1].copy()
        low[..., 2] = -low[..., 2]
        high[..., 2] = -high[..., 2]
        flow[..., 1] = -flow[..., 1]
    return low, high, flow


class VideoDataset:
    """In-memory clip collection with crop sampling and batching."""

    def __init__(self, sequences: Sequence[Dict[str, np.ndarray]],
                 upscale_factor: int = 4):
        assert len(sequences) > 0
        self.sequences = list(sequences)
        self.upscale = upscale_factor
        t, h, w, c = self.sequences[0]["low"].shape
        self.num_frames = t
        self.low_channels = c

    # -- crop sampling -------------------------------------------------------
    def collect_samples(self, num_samples: int, crop_size: int,
                        min_fill_rate: float = 0.5,
                        rng: Optional[np.random.RandomState] = None,
                        augment: bool = False,
                        max_tries: int = 10000) -> List[Sample]:
        """Random crops whose first AND last frame are sufficiently
        filled (mask > 0 on at least ``min_fill_rate`` of the crop),
        sorted by sequence index so that the trailing test fraction
        separates whole sequences."""
        rng = rng or np.random.RandomState(0)
        fill_needed = min_fill_rate * crop_size * crop_size
        samples: List[Sample] = []
        tries = 0
        while len(samples) < num_samples:
            tries += 1
            if tries > max_tries + num_samples:
                raise RuntimeError(
                    f"could not find {num_samples} crops with fill rate "
                    f">= {min_fill_rate}; volume too empty?")
            index = rng.randint(len(self.sequences))
            low = self.sequences[index]["low"]
            t, h, w, _ = low.shape
            if h <= crop_size or w <= crop_size:
                raise ValueError("crop size exceeds frame size")
            y = rng.randint(0, h - crop_size)
            x = rng.randint(0, w - crop_size)
            m_first = low[0, y:y + crop_size, x:x + crop_size, 0] > 0
            m_last = low[t - 1, y:y + crop_size, x:x + crop_size, 0] > 0
            if m_first.sum() >= fill_needed and m_last.sum() >= fill_needed:
                samples.append(Sample(
                    index=index, x=x, y=y,
                    augmentation=(rng.randint(MAX_AUGMENTATION_MODE)
                                  if augment else 0)))
        samples.sort(key=lambda s: s.index)
        return samples

    def get_clip(self, s: Sample, crop_size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seq = self.sequences[s.index]
        u = self.upscale
        lo = seq["low"][:, s.y:s.y + crop_size, s.x:s.x + crop_size]
        fl = seq["flow"][:, s.y:s.y + crop_size, s.x:s.x + crop_size]
        hi = seq["high"][:, s.y * u:(s.y + crop_size) * u,
                         s.x * u:(s.x + crop_size) * u]
        if s.augmentation:
            lo, hi, fl = augment_clip(lo, hi, fl, s.augmentation)
        return lo, fl, hi


class DatasetFromSamples:
    """Train/test view over a sample list: the trailing ``test_fraction``
    is the test set.  Iteration yields batches (low (B,T,h,w,5), flow
    (B,T,h,w,2), high (B,T,4h,4w,6)) as numpy float32.
    """

    def __init__(self, dataset: VideoDataset, samples: Sequence[Sample],
                 crop_size: int, test: bool, test_fraction: float):
        self.dataset = dataset
        self.crop_size = crop_size
        n = len(samples)
        n_test = int(n * test_fraction)
        if test:
            self.samples = list(samples[n - n_test:])
        else:
            self.samples = list(samples[:n - n_test])

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int):
        return self.dataset.get_clip(self.samples[i], self.crop_size)

    def batches(self, batch_size: int, shuffle: bool = True,
                rng: Optional[np.random.RandomState] = None,
                drop_last: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.arange(len(self.samples))
        if shuffle:
            (rng or np.random.RandomState(0)).shuffle(order)
        end = (len(order) // batch_size * batch_size if drop_last
               else len(order))
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            clips = [self[j] for j in idx]
            low = np.stack([c[0] for c in clips]).astype(np.float32)
            flow = np.stack([c[1] for c in clips]).astype(np.float32)
            high = np.stack([c[2] for c in clips]).astype(np.float32)
            yield low, flow, high


def load_reference_npy_dir(path: str) -> List[Dict[str, np.ndarray]]:
    """Load a directory of reference-format npy clips (NCHW -> NHWC), or
    an index file listing such directories (one per line)."""
    if os.path.isfile(path):
        with open(path) as f:
            dirs = [line.strip() for line in f if line.strip()]
        base = os.path.dirname(os.path.abspath(path))
        out: List[Dict[str, np.ndarray]] = []
        for d in dirs:
            out.extend(load_reference_npy_dir(os.path.join(base, d)))
        return out

    sequences = []
    i = 0
    while True:
        lp = os.path.join(path, "low_%05d.npy" % i)
        hp = os.path.join(path, "high_%05d.npy" % i)
        fp = os.path.join(path, "flow_%05d.npy" % i)
        if not os.path.exists(lp):
            break
        low = np.load(lp).transpose(0, 2, 3, 1)
        high = np.load(hp).transpose(0, 2, 3, 1)
        flow = np.load(fp).transpose(0, 2, 3, 1)
        sequences.append({"low": low.astype(np.float32),
                          "high": high.astype(np.float32),
                          "flow": flow.astype(np.float32)})
        i += 1
    if not sequences:
        raise FileNotFoundError(f"no low_%05d.npy clips found in {path}")
    return sequences


def _rgba_first(chans: Dict[str, np.ndarray]) -> np.ndarray:
    """Stack named channels with R,G,B,A leading (the order the legacy
    loaders index by: channel 3 is the alpha/mask), extras sorted after."""
    order = [c for c in ("R", "G", "B", "A") if c in chans]
    order += sorted(c for c in chans if c not in ("R", "G", "B", "A"))
    return np.stack([chans[c] for c in order], -1)


def _read_exr(path: str) -> np.ndarray:
    """Read an EXR image as float32 (H, W, C), channels R,G,B,A-first.

    Tries the built-in scanline codec (`data/exr.py`: float/half,
    none/zip, everything the reference writes) first, then the OpenEXR
    bindings (other compressions), then OpenCV."""
    from isosurfacesuperresolution_tpu_torch.data.exr import (
        read_exr as _builtin)
    try:
        return _rgba_first(_builtin(path))
    except (ValueError, KeyError, IndexError, struct.error, zlib.error):
        pass       # unsupported flavour or corrupt file: try the libraries
    try:
        import Imath
        import OpenEXR
        f = OpenEXR.InputFile(path)
        dw = f.header()["dataWindow"]
        w = dw.max.x - dw.min.x + 1
        h = dw.max.y - dw.min.y + 1
        pt = Imath.PixelType(Imath.PixelType.FLOAT)
        names = list(f.header()["channels"].keys())
        return _rgba_first({
            c: np.frombuffer(f.channel(c, pt), np.float32).reshape(h, w)
            for c in names})
    except ImportError:
        pass
    try:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None:
            img = np.asarray(img, np.float32)
            if img.ndim == 3 and img.shape[2] >= 3:
                img[..., :3] = img[..., 2::-1]       # cv2 loads BGR(A)
            return img
    except Exception:
        pass
    raise RuntimeError(
        f"could not decode {path}: the built-in codec handles scanline "
        "float/half EXRs with none/zip compression; for other flavours "
        "install the OpenEXR bindings or convert to the npy clip layout")


def load_legacy_exr_dir(path: str, num_frames: int = 10,
                        inpaint_iterations: int = 8,
                        device: DeviceLike = None
                        ) -> List[Dict[str, np.ndarray]]:
    """Load a reference legacy EXR sequence directory.

    The EXR branch of `datasetVideo.py:172-258` /
    `DataGeneratorVideo.convertToNumpy`: files ``high_tmp_%05d.exr`` (rgba),
    ``high_tmp_%05d_depth.exr`` (normal+depth), ``high_tmp_%05d_fx.exr``
    (ao), ``low_tmp_%05d{,_depth,_flow}.exr``; masks move to [-1, 1] and
    flow is inpainted over the background (`ops/inpaint.inpaint_flow` on
    ``device``, instead of cv2.INPAINT_NS).  Returns numpy clips.
    """
    import torch

    from isosurfacesuperresolution_tpu_torch.ops.inpaint import (
        inpaint_flow)

    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, "high_tmp_%05d.exr" % 0)):
        raise FileNotFoundError(f"no high_tmp_*.exr in {path}")
    highs, lows, flows = [], [], []
    for j in range(num_frames):
        hi_rgb = np.clip(_read_exr(
            os.path.join(path, "high_tmp_%05d.exr" % j)), 0, 1)
        hi_dn = _read_exr(os.path.join(path, "high_tmp_%05d_depth.exr" % j))
        hi_fx = _read_exr(os.path.join(path, "high_tmp_%05d_fx.exr" % j))
        high = np.concatenate(
            [hi_rgb[..., 3:4] * 2 - 1, hi_dn[..., :4], hi_fx[..., 0:1]], -1)
        lo_rgb = np.clip(_read_exr(
            os.path.join(path, "low_tmp_%05d.exr" % j)), 0, 1)
        lo_dn = _read_exr(os.path.join(path, "low_tmp_%05d_depth.exr" % j))
        low = np.concatenate([lo_rgb[..., 3:4] * 2 - 1, lo_dn[..., :4]], -1)
        fl = _read_exr(
            os.path.join(path, "low_tmp_%05d_flow.exr" % j))[..., :2]
        mask = (lo_rgb[..., 3:4] > 0).astype(np.float32)
        fl = inpaint_flow(
            torch.from_numpy(np.ascontiguousarray(fl, np.float32))[None].to(
                dev),
            torch.from_numpy(mask)[None].to(dev),
            iterations=inpaint_iterations)[0].cpu().numpy()
        highs.append(high.astype(np.float32))
        lows.append(low.astype(np.float32))
        flows.append(fl.astype(np.float32))
    # one sequence a directory, as in JAX
    return [{"high": np.stack(highs), "low": np.stack(lows),
             "flow": np.stack(flows)}]
