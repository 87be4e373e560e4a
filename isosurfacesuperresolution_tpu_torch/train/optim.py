"""The trainer's optimizers: optax's update rules over PyTorch tensors.

The JAX trainer builds ``optax.inject_hyperparams(<rule>)(learning_rate=...)``
(Adam also with ``b1``, ``b2``), behind ``optax.clip_by_global_norm`` when
``grad_clip`` > 0.  Those rules differ from `torch.optim`'s defaults, so
they are reproduced here, operation for operation, in float32:

- clip: ``g`` kept when ``|g| < max_norm``, else ``(g / |g|) * max_norm``
  (a select on the device, no host sync), ``|g|`` the global norm;
- adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, count +1,
  ``u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + 1e-8)``; the injected
  ``b1``, ``b2`` and learning rate are float32 scalars;
- rmsprop: decay 0.9, ``u = g * rsqrt(nu + 1e-8)`` (epsilon inside the
  root);
- rprop (eta 0.5 / 1.2, steps in [1e-6, 50], initial step the learning
  rate): the update applied is the PREVIOUS step's ``step * sign(g)``
  (zero where the gradient changed sign), as ``optax.scale_by_rprop``
  returns it, so the first update is zero; the learning rate only sets
  the initial step sizes, so a later `set_learning_rate` leaves rprop as
  it is (as injecting it does in optax);
- the update ``-lr * u`` (rprop ``-u``) is added to the parameter.

``count`` is the injected rule's count, one more each step whatever the
rule; Adam's bias correction reads it (optax keeps a second, equal count
in Adam's own state).

The state lives with the optimizer (`state_dict`, `load_state_dict`);
`load_optax_state` takes optax's arrays (``count``, ``mu``, ``nu`` ...)
keyed by the port's parameter names, and `optax_state_dict` reads a whole
optax state tree as an orbax step saved it into a `load_state_dict`
payload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

RULES = ("adam", "rmsprop", "rprop")
ADAM_EPS = 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8
RPROP_ETA_MINUS, RPROP_ETA_PLUS = 0.5, 1.2
RPROP_MIN_STEP, RPROP_MAX_STEP = 1e-6, 50.0

#: The hyperparameters optax injects beside the learning rate, per rule,
#: and the values the port's update rules hold (None: the spec's own).
INJECTED = {
    "adam": {"b1": None, "b2": None, "eps": ADAM_EPS, "eps_root": 0.0},
    "rmsprop": {"decay": RMS_DECAY, "eps": RMS_EPS, "initial_scale": 0.0},
    "rprop": {"eta_minus": RPROP_ETA_MINUS, "eta_plus": RPROP_ETA_PLUS,
              "min_step_size": RPROP_MIN_STEP,
              "max_step_size": RPROP_MAX_STEP},
}
#: Each rule's per-parameter state, in optax's field order.
MOMENTS = {"adam": ("mu", "nu"), "rmsprop": ("nu",),
           "rprop": ("step_sizes", "prev_updates")}


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


class Optimizer:
    """One optax rule bound to named parameters, updated in place."""

    def __init__(self, spec: "OptimizerSpec",
                 params: Mapping[str, torch.Tensor]):
        self.spec = spec
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.learning_rate = _f32(spec.learning_rate)
        self.count = 0
        self.state: Dict[str, list] = {}
        zeros = [torch.zeros_like(p) for p in self.params]
        if spec.rule == "adam":
            self.state = {"mu": zeros,
                          "nu": [torch.zeros_like(p) for p in self.params]}
        elif spec.rule == "rmsprop":
            self.state = {"nu": zeros}
        else:
            self.state = {"step_sizes": [torch.full_like(
                p, self.learning_rate) for p in self.params],
                "prev_updates": zeros}

    @property
    def clipped(self) -> bool:
        return bool(self.spec.grad_clip and self.spec.grad_clip > 0)

    def _clip(self, grads: Sequence[torch.Tensor]) -> list:
        max_norm = self.spec.grad_clip
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (in the parameters' order)."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        if self.clipped:
            grads = self._clip(grads)
        rule = self.spec.rule
        lr = self.learning_rate
        self.count += 1
        if rule == "adam":
            b1, b2 = np.float32(self.spec.b1), np.float32(self.spec.b2)
            c1 = float(np.float32(1) - b1 ** np.float32(self.count))
            c2 = float(np.float32(1) - b2 ** np.float32(self.count))
            for p, g, mu, nu in zip(self.params, grads, self.state["mu"],
                                    self.state["nu"]):
                mu.copy_(float(np.float32(1) - b1) * g + float(b1) * mu)
                nu.copy_(float(np.float32(1) - b2) * (g * g) + float(b2) * nu)
                u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
                p.add_(-lr * u)
        elif rule == "rmsprop":
            for p, g, nu in zip(self.params, grads, self.state["nu"]):
                nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
                p.add_(-lr * (torch.rsqrt(nu + RMS_EPS) * g))
        else:
            for i, (p, g) in enumerate(zip(self.params, grads)):
                step = self.state["step_sizes"][i]
                prev = self.state["prev_updates"][i]
                s = g * prev
                grown = torch.clamp(step * torch.where(
                    s > 0, RPROP_ETA_PLUS, RPROP_ETA_MINUS),
                    min=RPROP_MIN_STEP, max=RPROP_MAX_STEP)
                step.copy_(torch.where(s == 0, step, grown))
                flipped = s < 0
                update = torch.where(flipped, torch.zeros_like(prev), prev)
                prev.copy_(torch.where(flipped, torch.zeros_like(g),
                                       step * torch.sign(g)))
                p.add_(-update)

    def state_dict(self) -> dict:
        return {"rule": self.spec.rule, "learning_rate": self.learning_rate,
                "count": self.count, "names": list(self.names),
                "state": {k: [t.detach().clone() for t in v]
                          for k, v in self.state.items()}}

    def load_state_dict(self, sd: Mapping) -> None:
        if sd["rule"] != self.spec.rule or list(sd["names"]) != self.names:
            raise ValueError("optimizer state of another rule or other "
                             "parameters")
        self.learning_rate = _f32(sd["learning_rate"])
        self.count = int(sd["count"])
        with torch.no_grad():
            for k, v in self.state.items():
                for t, src in zip(v, sd["state"][k]):
                    t.copy_(src)

    def load_optax_state(self, count: Optional[int] = None,
                         **leaves: Mapping[str, np.ndarray]) -> None:
        """Take optax's state: ``count`` (Adam) and, per state name
        (``mu``, ``nu``, ``step_sizes``, ``prev_updates``), arrays keyed
        by this optimizer's parameter names in the parameters' layout."""
        if count is not None:
            self.count = int(count)
        with torch.no_grad():
            for k, arrays in leaves.items():
                for n, t in zip(self.names, self.state[k]):
                    t.copy_(torch.as_tensor(np.asarray(arrays[n])))

    def optax_state_dict(self, leaves: Mapping[Tuple[str, ...], np.ndarray],
                         to_port: Callable[[Dict[str, np.ndarray], str],
                                           Mapping[str, np.ndarray]],
                         where: str = "opt_state") -> dict:
        """A `load_state_dict` payload from optax's state tree as an orbax
        step holds it: ``leaves`` keyed by their key paths below the state
        (`train.ocdbt.orbax_tree_paths` without its first key).

        With ``grad_clip`` the state is ``optax.chain``'s pair: ``'0'`` the
        clip's (empty, no leaves), ``'1'`` the injected rule's; without, the
        injected rule's is the root.  That holds ``count``, ``hyperparams``
        (``learning_rate`` and `INJECTED`'s names) and ``inner_state``,
        whose ``'0'`` is the rule's own state (Adam's ``count``, then
        `MOMENTS`, each a tree in the parameters' Flax layout).
        ``to_port(flat, where)`` maps one such tree, flattened to
        "/"-joined keys, to arrays keyed by this optimizer's names.  A
        missing leaf, a leaf of another rule, an injected value that is not
        the port's, or Adam's count unlike the injected one raises
        ValueError naming the path (``where`` and the keys joined by
        ".")."""
        rule = self.spec.rule
        rest = dict(leaves)
        root = ("1",) if self.clipped else ()

        def name(path):
            return ".".join((where,) + tuple(path))

        def take(path):
            path = root + path
            if path not in rest:
                first = sorted(rest)[0] if rest else None
                raise ValueError(
                    f"{name(path)}: missing from the saved state (the "
                    f"port's {rule}{' behind the clip' * self.clipped}"
                    + (f"; the saved state has {name(first)}"
                       if first else "; the saved state is empty") + ")")
            return np.asarray(rest.pop(path))

        count = int(take(("count",)))
        lr = _f32(take(("hyperparams", "learning_rate")))
        for hp, held in INJECTED[rule].items():
            want = np.float32(getattr(self.spec, hp) if held is None
                              else held)
            got = np.float32(take(("hyperparams", hp)))
            if got != want:
                raise ValueError(
                    f"{name(root + ('hyperparams', hp))} = {got!s}: "
                    f"the port's {rule} runs with {hp} = {want!s}")
        inner = ("inner_state", "0")
        if rule == "adam":
            adam_count = int(take(inner + ("count",)))
            if adam_count != count:
                raise ValueError(
                    f"{name(root + inner + ('count',))} = {adam_count} "
                    f"differs from {name(root + ('count',))} = {count}")
        state = {}
        for m in MOMENTS[rule]:
            prefix = root + inner + (m,)
            n = len(prefix)
            flat = {"/".join(p[n:]): rest.pop(p) for p in sorted(rest)
                    if p[:n] == prefix}
            arrays = to_port(flat, name(prefix))
            tensors = []
            for pname, p in zip(self.names, self.params):
                if pname not in arrays:
                    raise ValueError(f"{name(prefix)}: no leaf for the "
                                     f"parameter {pname}")
                a = torch.as_tensor(np.asarray(arrays[pname]))
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{name(prefix)}: {pname} of shape "
                        f"{tuple(a.shape)}, the parameter's is "
                        f"{tuple(p.shape)}")
                tensors.append(a)
            state[m] = tensors
        if rest:
            raise ValueError(f"{name(sorted(rest)[0])}: not a leaf of the "
                             f"port's {rule} state")
        return {"rule": rule, "learning_rate": lr, "count": count,
                "names": list(self.names), "state": state}


@dataclass(frozen=True)
class OptimizerSpec:
    """An optax rule and its hyperparameters; ``init`` binds it to named
    parameters."""

    rule: str = "adam"
    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 0.0

    def init(self, params: Mapping[str, torch.Tensor]) -> Optimizer:
        return Optimizer(self, params)


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    """Set the injected learning rate (float32), as `inject_hyperparams`
    sets ``hyperparams["learning_rate"]``."""
    optimizer.learning_rate = _f32(lr)
