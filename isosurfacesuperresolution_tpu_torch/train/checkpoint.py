"""Run directories and checkpoints.

Counterpart of the JAX package's `train/checkpoint.py`: ``runNNNNN``
numbering, ``info.txt`` and ``config.json`` (the flattened config, the
keys JAX writes), and the generator's ``params.npz`` under JAX's
"/"-joined Flax key names in Flax's layouts, so that each package reads
the other's file.

The full train state (generator, optimizer states, discriminators, step,
epoch) is the port's own format: ``torch.save`` to
``<run_dir>/checkpoints/epoch_<N>.pt``.  A file, not a digit-named
directory, so JAX's loader does not take the run dir for an orbax one and
reads its ``params.npz``.  JAX's orbax checkpoints (``checkpoints/<N>/``)
are read without orbax (`train/ocdbt.py`): the generator's parameters
(``--pretrained``, `infer/loadedmodel.LoadedModel`) and the
discriminators' (``--pretrainedDiscr``); a full-state restore reads the
port's own files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import Config, flatten_config
from isosurfacesuperresolution_tpu_torch.models.generators import (
    flax_from_params, params_from_flax)
from isosurfacesuperresolution_tpu_torch.train.ocdbt import (
    orbax_steps, orbax_tree_paths, read_orbax_generator, read_orbax_step)

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def next_run_dir(base: str, prefix: str = "run") -> str:
    """Allocate the next ``runNNNNN`` directory under ``base``, skipping
    the numbers already used there and in the ``artifacts/`` directory
    beside ``base``."""
    os.makedirs(base, exist_ok=True)
    pattern = re.compile(rf"^{prefix}(\d{{5}})$")
    next_num = 1
    artifacts = os.path.join(os.path.dirname(os.path.abspath(base)),
                             "artifacts")
    for d in (base, artifacts):
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            m = pattern.match(name)
            if m:
                next_num = max(next_num, int(m.group(1)) + 1)
    run_dir = os.path.join(base, f"{prefix}{next_num:05d}")
    os.makedirs(run_dir)
    return run_dir


def write_info(run_dir: str, cfg: Config) -> None:
    """Dump the flattened config to ``info.txt`` and ``config.json``."""
    flat = flatten_config(cfg)
    with open(os.path.join(run_dir, "info.txt"), "w") as f:
        for k, v in sorted(flat.items()):
            f.write(f"{k}: {v}\n")
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in flat.items()}, f, indent=2)


def _model_cfg(model: nn.Module):
    return getattr(model, "cfg", None)


def save_params_npz(path: str, model: nn.Module) -> None:
    """The generator's parameters as JAX's ``params.npz`` (Flax keys and
    layouts, `models.generators.flax_from_params`)."""
    np.savez(path, **flax_from_params(model.state_dict(), _model_cfg(model)))


def load_params_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a ``params.npz`` (either package's) into ``model``, every key
    and shape checked."""
    state = params_from_flax(path, _model_cfg(model))
    own = model.state_dict()
    for k, v in state.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(state)
    return model


class CheckpointManager:
    """Epoch-numbered checkpoints of the full train state,
    ``checkpoints/epoch_<N>.pt``; ``max_to_keep`` keeps the newest.  The
    orbax steps JAX wrote in the same directory (``checkpoints/<N>/``)
    are read for the generator's and the discriminators' parameters; an
    epoch given to a restore names the port's file when there is one,
    else the orbax step, and no epoch the newest of either."""

    def __init__(self, run_dir: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(os.path.join(run_dir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self):
        return sorted(int(m.group(1)) for m in map(
            _EPOCH_FILE.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, state, extra: Optional[Dict[str, Any]] = None
             ) -> None:
        payload = {
            "epoch": epoch,
            "params": state.model.state_dict(),
            "opt_state": state.optimizer.state_dict(),
            "discr_params": state.discriminators.state_dict(),
            "discr_opt_state": (state.discr_optimizer.state_dict()
                                if state.discr_optimizer is not None
                                else None),
            "step": state.step,
        }
        if extra:
            payload["extra"] = extra
        tmp = self.path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(epoch))
        if self.max_to_keep:
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs() + orbax_steps(self.directory)
        return max(epochs) if epochs else None

    def _is_orbax(self, epoch: Optional[int]) -> Tuple[bool, int]:
        """(whether ``epoch`` is read from an orbax step, the epoch)."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        own = os.path.exists(self.path(epoch))
        if not own and epoch not in orbax_steps(self.directory):
            raise FileNotFoundError(f"{self.directory}: no checkpoint of "
                                    f"epoch {epoch}")
        return not own, epoch

    def _load(self, epoch: Optional[int]) -> Tuple[dict, int]:
        orbax, epoch = self._is_orbax(epoch)
        if orbax:
            raise NotImplementedError(
                f"{self.directory}/{epoch}: an orbax step restores the "
                "generator's and the discriminators' parameters "
                "(--pretrained, --pretrainedDiscr); a full-state restore "
                "reads the port's checkpoints/epoch_<N>.pt")
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True), epoch

    def restore_params(self, model: nn.Module, epoch: Optional[int] = None
                       ) -> Tuple[nn.Module, int]:
        """Load ONLY the generator's parameters into ``model`` (the
        reference's ``--pretrained``)."""
        orbax, epoch = self._is_orbax(epoch)
        if orbax:
            flat, _ = read_orbax_generator(self.directory, epoch)
            model.load_state_dict(params_from_flax(flat, _model_cfg(model)))
            return model, epoch
        payload, epoch = self._load(epoch)
        model.load_state_dict(payload["params"])
        return model, epoch

    def restore_discr_params(self, discriminators: nn.Module,
                             epoch: Optional[int] = None
                             ) -> Tuple[nn.Module, int]:
        """Load ONLY the discriminators' parameters (the reference's
        ``--pretrainedDiscr``)."""
        orbax, epoch = self._is_orbax(epoch)
        if orbax:
            step_dir = os.path.join(self.directory, str(epoch))
            paths = orbax_tree_paths(step_dir)
            per_name: Dict[str, dict] = {}
            for name, arr in read_orbax_step(step_dir,
                                             "discr_params.").items():
                path = paths[name]
                per_name.setdefault(path[1], {})["/".join(path[2:])] = arr
            for name, flat in per_name.items():
                discriminators[name].load_state_dict(params_from_flax(flat))
            return discriminators, epoch
        payload, epoch = self._load(epoch)
        discriminators.load_state_dict(payload["discr_params"])
        return discriminators, epoch

    def restore(self, state, epoch: Optional[int] = None):
        """Load a checkpoint into ``state`` (its modules and optimizers, in
        place, on their devices) -> (state, epoch)."""
        payload, epoch = self._load(epoch)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.discriminators.load_state_dict(payload["discr_params"])
        if state.discr_optimizer is not None:
            state.discr_optimizer.load_state_dict(payload["discr_opt_state"])
        state.step = int(payload["step"])
        return state, epoch
