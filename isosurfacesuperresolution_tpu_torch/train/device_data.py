"""Device-resident clip dataset: crops gathered on the device by index.

Counterpart of the JAX package's `train/device_data.py`: the clips are
stacked on the device once (``store_dtype`` float32 or bfloat16, crops
cast back to float32), and a batch is gathered there from (sequence, y, x)
triples.  `batches` shuffles with the host's `RandomState` as JAX does and
uploads the whole epoch's triples in one copy at its start, so a batch
makes no host round trip.  Crops are un-augmented, as in JAX (augmented
training batches on the host, `data.dataset.DatasetFromSamples`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.data.dataset import Sample
from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)


class DeviceVideoDataset:
    """Sequences of one (T, h, w) stacked on ``device`` (None: the card);
    low-res crops of (crop, crop), high-res of ``upscale_factor`` times
    that, as `data.dataset.VideoDataset.get_clip` cuts them."""

    def __init__(self, sequences, upscale_factor: int = 4,
                 store_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        dev = resolve_device(device)

        def stack(key):
            return torch.from_numpy(np.stack([s[key] for s in sequences])
                                    ).to(dev, store_dtype)

        self.low = stack("low")
        self.high = stack("high")
        self.flow = stack("flow")
        self.upscale = upscale_factor
        self.num_sequences = self.low.shape[0]
        self.device = dev

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.low, self.high, self.flow))

    def gather_batch(self, idx: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor, crop: int):
        """(B,) device index tensors -> float32 (low (B, T, crop, crop, 5),
        flow (B, T, crop, crop, 2), high (B, T, u*crop, u*crop, 6))."""
        u = self.upscale

        def cut(t, size, y0, x0):
            r = torch.arange(size, device=t.device)
            rows = (y0[:, None] + r)[:, None, :, None]
            cols = (x0[:, None] + r)[:, None, None, :]
            frames = torch.arange(t.shape[1], device=t.device)[
                None, :, None, None]
            return t[idx[:, None, None, None], frames, rows, cols].to(
                torch.float32)

        return (cut(self.low, crop, ys, xs), cut(self.flow, crop, ys, xs),
                cut(self.high, crop * u, ys * u, xs * u))

    def batches(self, samples: Sequence[Sample], batch_size: int,
                crop: int, shuffle: bool = True,
                rng: Optional[np.random.RandomState] = None,
                drop_last: bool = True):
        """Yield device batches for a host-side sample list."""
        order = np.arange(len(samples))
        if shuffle:
            (rng or np.random.RandomState(0)).shuffle(order)
        end = (len(order) // batch_size * batch_size if drop_last
               else len(order))
        table = torch.from_numpy(np.array(
            [[samples[j].index, samples[j].y, samples[j].x]
             for j in order[:end]], np.int64).reshape(-1, 3)).to(
                 self.device)
        for i in range(0, end, batch_size):
            rows = table[i:i + batch_size]
            yield self.gather_batch(rows[:, 0], rows[:, 1], rows[:, 2], crop)
