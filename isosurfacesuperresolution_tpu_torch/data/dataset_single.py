"""Single-image (non-temporal) datasets.

Counterpart of the JAX package's `data/dataset_single.py` (the
reference's `datasetSingle.py`): random crops of rendered stills and
image folders, for single-image training (``--disableTemporal``).
Stills render through the port's renderer on the grid's device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.data.dataset import Sample


def collect_samples_rendered(frames_low: np.ndarray,
                             frames_high: np.ndarray,
                             num_samples: int, crop_size: int,
                             min_fill_rate: float = 0.5,
                             rng: Optional[np.random.RandomState] = None,
                             max_tries: int = 10000) -> List[Sample]:
    """Crop sampling over single frames (N, h, w, 5)/(N, H, W, 6)."""
    rng = rng or np.random.RandomState(0)
    n, h, w, _ = frames_low.shape
    fill_needed = min_fill_rate * crop_size * crop_size
    out: List[Sample] = []
    tries = 0
    while len(out) < num_samples:
        tries += 1
        if tries > max_tries + num_samples:
            raise RuntimeError("could not find enough filled crops")
        i = rng.randint(n)
        y = rng.randint(0, h - crop_size)
        x = rng.randint(0, w - crop_size)
        if (frames_low[i, y:y + crop_size, x:x + crop_size, 0] > 0
                ).sum() >= fill_needed:
            out.append(Sample(index=i, x=x, y=y))
    out.sort(key=lambda s: s.index)
    return out


class SingleImageDataset:
    """Single-frame crops: yields (low (B,h,w,5), high (B,H,W,6)) batches.

    The temporal axis is materialized as T=1 clips so the video trainer
    consumes these directly with ``--disableTemporal``.
    """

    def __init__(self, frames_low: np.ndarray, frames_high: np.ndarray,
                 samples: Sequence[Sample], crop_size: int,
                 upscale_factor: int = 4):
        self.low = frames_low
        self.high = frames_high
        self.samples = list(samples)
        self.crop = crop_size
        self.upscale = upscale_factor

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        s = self.samples[i]
        c, u = self.crop, self.upscale
        lo = self.low[s.index, s.y:s.y + c, s.x:s.x + c]
        hi = self.high[s.index, s.y * u:(s.y + c) * u,
                       s.x * u:(s.x + c) * u]
        return lo, hi

    def batches(self, batch_size: int, shuffle: bool = True,
                rng: Optional[np.random.RandomState] = None):
        order = np.arange(len(self.samples))
        if shuffle:
            (rng or np.random.RandomState(0)).shuffle(order)
        end = len(order) // batch_size * batch_size
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            lo = np.stack([self[j][0] for j in idx]).astype(np.float32)
            hi = np.stack([self[j][1] for j in idx]).astype(np.float32)
            # T=1 clips with zero flow for the video trainer
            flow = np.zeros(lo.shape[:1] + (1,) + lo.shape[1:3] + (2,),
                            np.float32)
            yield lo[:, None], flow, hi[:, None]


def render_single_frames(grid, num_frames: int, render_cfg, seed: int = 0,
                         ao_samples: int = 64
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Render random-view single frames on the grid's device -> numpy
    (low (N,h,w,5), high (N,H,W,6))."""
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        random_sphere_camera)
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        gbuffer_to_high_target, gbuffer_to_low_input)
    rng = np.random.RandomState(seed)
    high_cfg = render_cfg.replace(
        width=render_cfg.width * 4, height=render_cfg.height * 4,
        ao_samples=ao_samples)
    lows, highs = [], []
    for _ in range(num_frames):
        cam = random_sphere_camera(rng)
        fr_lo = render_frame_gbuffer(grid, cam, cam, render_cfg)
        fr_hi = render_frame_gbuffer(grid, cam, cam, high_cfg)
        lows.append(gbuffer_to_low_input(fr_lo).cpu().numpy())
        highs.append(gbuffer_to_high_target(fr_hi).cpu().numpy())
    return np.stack(lows), np.stack(highs)


def load_image_folder(path: str, extensions=(".png", ".jpg", ".jpeg")
                      ) -> List[np.ndarray]:
    """div2k-style image folder -> list of (H, W, 3) float arrays in
    [0, 1].  Decoded by Pillow, as JAX's imageio reader decodes PNG and
    JPEG (palette images expand to their palette's mode)."""
    from PIL import Image
    out = []
    for name in sorted(os.listdir(path)):
        if name.lower().endswith(extensions):
            with Image.open(os.path.join(path, name)) as im:
                if im.mode == "P":
                    im = im.convert(im.palette.mode)
                img = np.asarray(im)
            out.append(img.astype(np.float32) / 255.0)
    if not out:
        raise FileNotFoundError(f"no images in {path}")
    return out
