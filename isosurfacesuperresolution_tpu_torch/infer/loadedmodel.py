"""Checkpoint -> ready-to-run generator.

Counterpart of the JAX package's `infer/loadedmodel.py`.  A run directory
carries ``config.json`` (its ``model.*`` and ``train.*`` sections) and
``params.npz`` (the Flax parameters, read with numpy and mapped by
`models.generators.params_from_flax`), and, when the port's trainer
wrote it, ``checkpoints/epoch_<N>.pt`` (`train/checkpoint.py`); JAX's
orbax checkpoints (``checkpoints/<step>/``) are read without orbax
(`train/ocdbt.py`); a ``.pth`` path goes to the reference-checkpoint
importer (`infer/torch_import.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import (
    Config, config_from_json)
from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network, params_from_flax)
from isosurfacesuperresolution_tpu_torch.models.videotools import (
    flatten_high, initial_image, warp_upscale)


def build_model(cfg: Config, state: dict, device: torch.device,
                in_channels: Optional[int] = None) -> nn.Module:
    """`create_network` with ``state`` loaded strictly, frozen, in eval
    mode on ``device``."""
    model = create_network(cfg.model, in_channels=in_channels)
    model.load_state_dict(state)
    model.requires_grad_(False)
    return model.to(device).eval()


class LoadedModel:
    """A generator with its weights and the run's inference settings."""

    def __init__(self, model: nn.Module, cfg: Config,
                 bare_input: bool = False):
        self.model = model
        self.cfg = cfg
        self.unshaded = cfg.model.output_channels == 6
        self.upscale_factor = cfg.model.upscale_factor
        self.initial_image_mode = cfg.train.initial_image_mode
        self.inverse_ao = cfg.train.ao_inverted
        # True only for nets whose first conv takes the low-res channels
        # alone (reference-imported single-frame checkpoints); run dirs
        # trained with disable_temporal still take the temporal channels
        self.bare_input = bare_input

    @classmethod
    def from_run_dir(cls, run_dir: str, epoch: Optional[int] = None,
                     fast: bool = False,
                     device: DeviceLike = None) -> "LoadedModel":
        """``fast=True`` builds the generator with ``fused_upsample`` (the
        state dict is the same, so any checkpoint loads either way).

        The weights, by JAX's rule: a run dir with orbax steps in
        ``checkpoints/`` loads the generator of step ``epoch`` (the newest
        without one); a run dir without them loads ``params.npz`` and
        ignores ``epoch``, as JAX does, unless the port's own
        ``checkpoints/epoch_<N>.pt`` exists for it (JAX never sees those);
        a run dir with neither loads its newest ``epoch_<N>.pt``.  A
        ``.pth`` file goes to `torch_import.load_reference_pth`."""
        dev = resolve_device(device)
        if run_dir.endswith(".pth") and os.path.isfile(run_dir):
            from isosurfacesuperresolution_tpu_torch.infer.torch_import \
                import load_reference_pth
            return load_reference_pth(run_dir, fast=fast, device=dev)
        cfg = config_from_json(os.path.join(run_dir, "config.json"))
        if fast:
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, fused_upsample=True))
        from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
            CheckpointManager)
        from isosurfacesuperresolution_tpu_torch.train.ocdbt import (
            orbax_steps)
        ckpt = os.path.join(run_dir, "checkpoints")
        npz = os.path.join(run_dir, "params.npz")
        own = epoch is not None and os.path.exists(
            os.path.join(ckpt, f"epoch_{epoch}.pt"))
        if not own and not orbax_steps(ckpt) and os.path.exists(npz):
            return cls.from_params_npz(npz, cfg, dev)
        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"{run_dir}: no params.npz and no "
                                    "checkpoints/")
        model = create_network(cfg.model)
        CheckpointManager(run_dir).restore_params(model, epoch)
        return cls(build_model(cfg, model.state_dict(), dev), cfg)

    @classmethod
    def from_params_npz(cls, path: str, cfg: Config,
                        device: DeviceLike = None) -> "LoadedModel":
        """A bare ``params.npz`` with the given configuration."""
        dev = resolve_device(device)
        return cls(build_model(cfg, params_from_flax(path, cfg.model), dev),
                   cfg)

    @torch.no_grad()
    def inference(self, current_low: torch.Tensor,
                  prev_high: Optional[torch.Tensor],
                  flow: torch.Tensor) -> torch.Tensor:
        """One super-resolution step with the exact gather warp.

        current_low : (B, h, w, Cin) network input channels.
        prev_high   : (B, uh, uw, Cout) previous prediction, or None on
                      the first frame (then the initial image).
        flow        : (B, h, w, 2) inpainted flow to the previous camera.
        Float32 convolutions run without TF32, as the frames do."""
        from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
            fp32_convs)
        u = self.upscale_factor
        with fp32_convs():
            if self.bare_input:
                return self.model(current_low)[0]
            if self.cfg.train.disable_temporal:
                # such runs were trained with the flattened initial image
                # concatenated every frame
                prev_high = None
            if prev_high is None:
                previous = initial_image(
                    current_low, self.cfg.model.output_channels,
                    self.initial_image_mode, self.inverse_ao, u)
            else:
                previous = warp_upscale(prev_high, flow, u,
                                        special_mask=True)
            net_in = torch.cat([current_low, flatten_high(previous, u)], -1)
            return self.model(net_in)[0]
