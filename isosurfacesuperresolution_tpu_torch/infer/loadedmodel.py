"""Run directory -> ready-to-run generator.

Counterpart of `LoadedModel.from_run_dir` in the JAX package's
`infer/loadedmodel.py` for run directories that carry ``config.json`` and
``params.npz`` (both read with numpy; the Flax parameters are mapped by
`models.generators.params_from_flax`).
"""

from __future__ import annotations

import os

from isosurfacesuperresolution_tpu_torch.config import (
    Config, config_from_json)
from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    EnhanceNet, params_from_flax)


class LoadedModel:
    """A generator with its weights, in eval mode on ``device``."""

    def __init__(self, model: EnhanceNet, cfg: Config):
        self.model = model
        self.cfg = cfg
        self.upscale_factor = cfg.model.upscale_factor

    @classmethod
    def from_run_dir(cls, run_dir: str,
                     device: DeviceLike = None) -> "LoadedModel":
        dev = resolve_device(device)
        cfg = config_from_json(os.path.join(run_dir, "config.json"))
        model = EnhanceNet(cfg.model)
        model.load_state_dict(
            params_from_flax(os.path.join(run_dir, "params.npz")))
        model.requires_grad_(False)
        return cls(model.to(dev).eval(), cfg)
