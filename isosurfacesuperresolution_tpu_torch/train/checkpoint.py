"""Run directories and checkpoints.

Counterpart of the JAX package's `train/checkpoint.py`: ``runNNNNN``
numbering, ``info.txt`` and ``config.json`` (the flattened config, the
keys JAX writes), and the generator's ``params.npz`` under JAX's
"/"-joined Flax key names in Flax's layouts, so that each package reads
the other's file.

The port saves the full train state (generator, optimizer states,
discriminators, step, epoch) in its own format: ``torch.save`` to
``<run_dir>/checkpoints/epoch_<N>.pt``.  A file, not a digit-named
directory, so JAX's loader does not take the run dir for an orbax one and
reads its ``params.npz``.  JAX's orbax checkpoints (``checkpoints/<N>/``)
are read without orbax (`train/ocdbt.py`), in full: the generator's
parameters (``--pretrained``, `infer/loadedmodel.LoadedModel`), the
discriminators' (``--pretrainedDiscr``) and, for ``--restore``, the whole
train state (``params``, ``opt_state``, ``discr_params``,
``discr_opt_state``, ``step``), the optimizers' through
`train.optim.Optimizer.optax_state_dict`.  Flax trees go through
`models.generators.params_from_flax`, so BatchNorm's ``batch_stats`` and
the moments of every leaf land where the parameters do.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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

    def _load(self, epoch: int) -> dict:
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)

    def restore_params(self, model: nn.Module, epoch: Optional[int] = None
                       ) -> Tuple[nn.Module, int]:
        """Load ONLY the generator's parameters into ``model`` (the
        reference's ``--pretrained``)."""
        orbax, epoch = self._is_orbax(epoch)
        if orbax:
            flat, _ = read_orbax_generator(self.directory, epoch)
            model.load_state_dict(params_from_flax(flat, _model_cfg(model)))
            return model, epoch
        model.load_state_dict(self._load(epoch)["params"])
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
        discriminators.load_state_dict(self._load(epoch)["discr_params"])
        return discriminators, epoch

    def restore(self, state, epoch: Optional[int] = None):
        """Load a checkpoint, the port's or an orbax step's, into ``state``
        (its modules and optimizers, in place, on their devices) ->
        (state, epoch)."""
        orbax, epoch = self._is_orbax(epoch)
        if orbax:
            return _restore_orbax(
                state, os.path.join(self.directory, str(epoch))), epoch
        payload = self._load(epoch)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.discriminators.load_state_dict(payload["discr_params"])
        if state.discr_optimizer is not None:
            state.discr_optimizer.load_state_dict(payload["discr_opt_state"])
        state.step = int(payload["step"])
        return state, epoch


# -- the full train state of an orbax step -----------------------------------

_STATE_KEYS = ("params", "opt_state", "discr_params", "discr_opt_state",
               "step")


def _flax_state(module: nn.Module, flat: Mapping[str, np.ndarray], cfg,
                where: str) -> Dict[str, torch.Tensor]:
    """Flax keys -> ``module``'s ``state_dict``, after checking that the
    saved keys and shapes are the module's own (the first that differs is
    named as ``where.<key path>``)."""
    own = flax_from_params(module.state_dict(), cfg)
    for key in sorted(set(own) ^ set(flat)):
        path = f"{where}.{key.replace('/', '.')}"
        if key in own:
            raise ValueError(f"{path}: missing from the saved state")
        raise ValueError(f"{path}: not a leaf of the port's "
                         f"{type(module).__name__}")
    for key in sorted(own):
        if tuple(np.shape(flat[key])) != own[key].shape:
            raise ValueError(
                f"{where}.{key.replace('/', '.')}: saved shape "
                f"{tuple(np.shape(flat[key]))}, the port's is "
                f"{own[key].shape}")
    return params_from_flax(flat, cfg)


def _param_names(module: nn.Module) -> Dict[str, str]:
    """{state_dict key: named_parameters name} of ``module``'s parameters
    (they differ under a wrapper such as the spectral-norm one)."""
    by_id = {id(p): n for n, p in module.named_parameters()}
    return {k: by_id[id(v)]
            for k, v in module.state_dict(keep_vars=True).items()
            if id(v) in by_id}


def _split(tree: Mapping[Tuple[str, ...], np.ndarray]) -> Dict[str, dict]:
    """{first key: {rest of the path: leaf}}."""
    out: Dict[str, dict] = {}
    for path, leaf in tree.items():
        out.setdefault(path[0], {})[path[1:]] = leaf
    return out


def _discr_state(discriminators: nn.ModuleDict,
                 tree: Mapping[Tuple[str, ...], np.ndarray],
                 where: str) -> Dict[str, torch.Tensor]:
    """The discriminators' Flax trees (keyed ``<name>/<collection>/...``)
    -> the `nn.ModuleDict`'s ``state_dict``, the names checked against
    the config's."""
    per_name = _split(tree)
    for name in sorted(set(per_name) | set(discriminators)):
        if name not in discriminators:
            raise ValueError(f"{where}.{name}: a discriminator the config "
                             "does not have")
        if name not in per_name:
            raise ValueError(f"{where}.{name}: missing from the saved state")
    out = {}
    for name, sub in per_name.items():
        flat = {"/".join(p): a for p, a in sub.items()}
        for k, v in _flax_state(discriminators[name], flat, None,
                                f"{where}.{name}").items():
            out[f"{name}.{k}"] = v
    return out


def _restore_orbax(state, step_dir: str):
    """The whole train state of an orbax step into ``state``: every part
    is read and checked before any is loaded, so a tree that is not the
    state's raises (naming the first path that differs) and leaves
    ``state`` as it was."""
    paths = orbax_tree_paths(step_dir)
    tree = {}
    for name, leaf in read_orbax_step(step_dir).items():
        if name not in paths:
            raise ValueError(f"{step_dir}: {name} is not a leaf of the "
                             "saved tree")
        tree[paths[name]] = leaf
    parts = _split(tree)
    for key in sorted(parts):
        if key not in _STATE_KEYS:
            first = ".".join(min(p for p in tree if p[0] == key))
            raise ValueError(f"{first}: not part of a train state")
    if () not in parts.get("step", {}):
        raise ValueError("step: missing from the saved state")

    cfg = _model_cfg(state.model)
    model_sd = _flax_state(
        state.model, {"/".join(p): a for p, a in parts.get(
            "params", {}).items()}, cfg, "params")
    discr_sd = _discr_state(state.discriminators,
                            parts.get("discr_params", {}), "discr_params")

    def gen_to_port(flat, where):
        names = _param_names(state.model)
        return {names[k]: v for k, v in _flax_state(
            state.model, flat, cfg, where).items() if k in names}

    def discr_to_port(flat, where):
        names = _param_names(state.discriminators)
        return {names[k]: v for k, v in _discr_state(
            state.discriminators, {tuple(k.split("/")): v
                                   for k, v in flat.items()}, where).items()
            if k in names}

    opt_sd = state.optimizer.optax_state_dict(parts.get("opt_state", {}),
                                              gen_to_port, "opt_state")
    saved_dopt = parts.get("discr_opt_state", {})
    if state.discr_optimizer is not None:
        dopt_sd = state.discr_optimizer.optax_state_dict(
            saved_dopt, discr_to_port, "discr_opt_state")
    elif saved_dopt:
        raise ValueError(
            f"{'.'.join(('discr_opt_state',) + min(saved_dopt))}: the "
            "state has no discriminator optimizer")

    state.model.load_state_dict(model_sd)
    state.discriminators.load_state_dict(discr_sd)
    state.optimizer.load_state_dict(opt_sd)
    if state.discr_optimizer is not None:
        state.discr_optimizer.load_state_dict(dopt_sd)
    state.step = int(parts["step"][()])
    return state
