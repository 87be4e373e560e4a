"""Import the reference's PyTorch ``.pth`` checkpoints.

Counterpart of the JAX package's `infer/torch_import.py`.  The reference
distributes its networks as a training checkpoint dict ``{'epoch',
'model': <whole nn.Module>, 'parameters': <arg dict>, ...}``
(`mainVideoUnshaded.py:799-811`) or as a bare/nested ``state_dict``
(``--pretrained``, `mainVideoUnshaded.py:317-319`).  Both load here
without the reference code on ``sys.path``: whole-module pickles are read
with a stub unpickler that substitutes attribute-bag classes for the
reference's own classes (tensors and torch containers unpickle through
the real torch machinery), and the flat state dict is then recovered by
walking ``_parameters`` / ``_buffers`` / ``_modules``.

The port's layers are torch layers, so the weights keep their layout;
only the names change (``preblock.0`` -> ``pre``, ``blocks.N.0`` ->
``blockN_conv1``, ``postblock.N`` -> ``postJ`` / ``upJ`` / ``out``).
TecoGAN's ``ConvTranspose2d`` weights go over as they are: the port's
``up1``/``up2`` are the same layer.  Supported generators: EnhanceNet
(with the BatchNorm variant), TecoGAN, SubpixelNet.  The reference's RCAN
is refused by design, as in JAX: it feeds ``nn.PixelShuffle(4)`` with 64
features so its output conv sees 4 channels (`rcan.py:100-110`), while
this framework has a pre-shuffle expansion conv.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import (
    Config, ModelConfig, TrainConfig)
from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)


class _Stub:
    """Attribute bag standing in for an unimportable pickled class."""

    def __repr__(self) -> str:
        return f"<stub {type(self).__module__}.{type(self).__name__}>"


_STUB_CACHE: Dict[Tuple[str, str], type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"__module__": module})
    return _STUB_CACHE[key]


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        # real classes where importable (torch internals, stdlib
        # containers); a stub for anything else, i.e. the reference's own
        # model, criterion and option classes
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _stub_class(module, name)


def _stub_pickle_module() -> types.ModuleType:
    """A pickle-compatible module whose Unpickler stubs unknown classes
    (`torch.load` duck-types ``pickle_module``)."""
    mod = types.ModuleType("isosr_stub_pickle")
    mod.Unpickler = _StubUnpickler
    mod.load = lambda f, **kw: _StubUnpickler(f, **kw).load()
    mod.loads = lambda b, **kw: _StubUnpickler(io.BytesIO(b), **kw).load()
    return mod


def _torch_load_stubbed(path: str):
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle_module())


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _flatten_module(obj: Any, prefix: str, out: Dict[str, np.ndarray]):
    """Recover a flat state dict from a (possibly stubbed) module tree."""
    d = getattr(obj, "__dict__", None)
    if d is None:
        return
    for k, v in (d.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = _to_np(v)
    for k, v in (d.get("_buffers") or {}).items():
        if v is not None:
            out[prefix + k] = _to_np(v)
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            _flatten_module(v, prefix + k + ".", out)


def _looks_like_state_dict(d: dict) -> bool:
    return bool(d) and all(hasattr(v, "shape") or hasattr(v, "detach")
                           for v in d.values())


def reference_state_dict(path: str
                         ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a reference ``.pth`` -> (flat numpy state dict, parameters)."""
    obj = _torch_load_stubbed(path)
    meta: Dict[str, Any] = {}
    model = obj
    if isinstance(obj, dict) and not _looks_like_state_dict(obj):
        raw_meta = obj.get("parameters", {})
        if not isinstance(raw_meta, dict):
            raw_meta = dict(getattr(raw_meta, "__dict__", {}) or {})
        meta = raw_meta
        model = obj.get("model", obj)
    if isinstance(model, dict):          # already a state dict
        sd = {k: _to_np(v) for k, v in model.items()}
    else:                                # whole (stubbed) module object
        sd = {}
        _flatten_module(model, "", sd)
    if not sd:
        raise ValueError(f"{path}: no parameters found (unsupported layout)")
    return sd, meta


def sniff_model_kind(sd: Dict[str, np.ndarray]) -> str:
    if "net.pre.weight" in sd:
        raise ValueError(
            "reference RCAN checkpoints are not importable: the reference "
            "feeds PixelShuffle(4) with 64 features so its post conv sees "
            "4 channels (rcan.py:100-110); this framework fixes that with "
            "a pre-shuffle expansion conv, so the layouts are incompatible."
            "  Retrain with --model RCAN instead.")
    if "conv5.weight" in sd:
        return "SubpixelNet"
    if "postblock.8.weight" in sd:
        return "EnhanceNet"
    if "postblock.0.weight" in sd and "postblock.4.weight" in sd:
        return "TecoGAN"
    raise ValueError(f"unrecognized generator state dict "
                     f"(keys: {sorted(sd)[:8]}...)")


def _count_blocks(sd) -> int:
    n = 0
    while f"blocks.{n}.0.weight" in sd:
        n += 1
    return n


def config_from_reference(sd: Dict[str, np.ndarray],
                          meta: Dict[str, Any]) -> ModelConfig:
    """The ModelConfig of a reference checkpoint, sniffed as the reference
    does (`inference/loadedmodel.py:36-55`: in_channels == 5 + 6*16 is
    the unshaded temporal net) plus the saved arg dict when present."""
    kind = sniff_model_kind(sd)
    upscale = int(meta.get("upscaleFactor", 4))
    if kind == "SubpixelNet":
        cin_total = sd["conv1.weight"].shape[1]
        cout = sd["conv5.weight"].shape[0] // upscale ** 2
        nblocks = 0
        use_bn = False
    else:
        cin_total = sd["preblock.0.weight"].shape[1]
        out_key = "postblock.8" if kind == "EnhanceNet" else "postblock.4"
        cout = sd[out_key + ".weight"].shape[0]
        nblocks = _count_blocks(sd)
        use_bn = "blocks.0.1.running_mean" in sd
    # temporal nets take the flattened warped previous frame as well:
    # Cin = input_channels + output_channels * r^2
    warped = cout * upscale ** 2
    input_channels = cin_total - warped if cin_total > warped else cin_total
    return ModelConfig(
        model=kind,
        upscale_factor=upscale,
        input_channels=input_channels,
        output_channels=cout,
        channel_mask=tuple(range(min(input_channels, cout))),
        upsample=str(meta.get("upsample", "bilinear")),
        recon_type=str(meta.get("reconType", "residual")),
        use_bn=use_bn,
        num_residual_blocks=nblocks if nblocks else 10,
        num_features=(sd["preblock.0.weight"].shape[0]
                      if kind != "SubpixelNet" else 64),
    )


def params_from_reference(sd: Dict[str, np.ndarray], cfg: ModelConfig
                          ) -> Dict[str, torch.Tensor]:
    """Flat reference state dict -> the port's generator ``state_dict``
    (`models/generators.py`), weights in their torch layout."""
    out: Dict[str, torch.Tensor] = {}

    def put(ours: str, ref: str, leaves=("weight", "bias")):
        for leaf in leaves:
            out[f"{ours}.{leaf}"] = torch.from_numpy(
                np.array(sd[f"{ref}.{leaf}"], dtype=np.float32))

    if cfg.model == "SubpixelNet":
        for i in range(1, 6):
            put(f"conv{i}", f"conv{i}")
        return out
    put("pre", "preblock.0")
    # Sequential indices shift when BN layers are present
    i_conv2 = 3 if cfg.use_bn else 2
    for i in range(cfg.num_residual_blocks):
        put(f"block{i}_conv1", f"blocks.{i}.0")
        put(f"block{i}_conv2", f"blocks.{i}.{i_conv2}")
        if cfg.use_bn:
            for j, which in ((1, "bn1"), (4, "bn2")):
                put(f"block{i}_{which}", f"blocks.{i}.{j}",
                    ("weight", "bias", "running_mean", "running_var"))
    if cfg.model == "EnhanceNet":
        for ours, j in (("post1", 1), ("post2", 4), ("post3", 6),
                        ("out", 8)):
            put(ours, f"postblock.{j}")
    elif cfg.model == "TecoGAN":
        for ours, j in (("up1", 0), ("up2", 2), ("out", 4)):
            put(ours, f"postblock.{j}")
    else:
        raise ValueError(cfg.model)
    return out


def load_reference_pth(path: str, fast: bool = False,
                       device: DeviceLike = None):
    """Reference ``.pth`` -> ready-to-run `LoadedModel` on ``device``."""
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel, build_model)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network, network_input_channels)

    dev = resolve_device(device)
    sd, meta = reference_state_dict(path)
    mcfg = config_from_reference(sd, meta)
    if fast:
        mcfg = dataclasses.replace(mcfg, fused_upsample=True)
    unshaded = mcfg.output_channels == 6
    # temporal nets were trained with the flattened warped previous frame
    # concatenated (Cin = input + out*r^2); single-frame nets were not
    first = ("conv1.weight" if mcfg.model == "SubpixelNet"
             else "preblock.0.weight")
    temporal = (sd[first].shape[1] >
                mcfg.output_channels * mcfg.upscale_factor ** 2)
    # the reference's default initial-image modes (`loadedmodel.py:57-64`)
    initial = str(meta.get("initialImage", "input" if unshaded else "zero"))
    cfg = Config(model=mcfg, train=TrainConfig(
        initial_image_mode=initial, disable_temporal=not temporal,
        ao_inverted=bool(meta.get("aoInverted", False))))
    cin = network_input_channels(mcfg, temporal=temporal)
    state = params_from_reference(sd, mcfg)
    # the same entries and shapes as the module's own state
    want = create_network(mcfg, in_channels=cin).state_dict()
    for key, leaf in want.items():
        if key not in state:
            raise ValueError(f"imported params miss {key}")
        if tuple(state[key].shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(state[key].shape)} vs "
                             f"{tuple(leaf.shape)}")
    extra = set(state) - set(want)
    if extra:
        raise ValueError(f"imported params have extra leaves: {extra}")
    return LoadedModel(build_model(cfg, state, dev, in_channels=cin), cfg,
                       bare_input=not temporal)
