"""Export the port's generators as reference-format PyTorch ``.pth`` files.

Counterpart of the JAX package's `infer/torch_export.py` and the inverse
of `infer/torch_import.py`: a flat ``state_dict`` under the reference's
module names (``preblock.0.weight``, ``blocks.N.{0,2}.*``,
``postblock.N.*``, the Sequential/ModuleList layout of
`models/enhancenet.py:92-125`, `models/tecogan.py:41-62`,
`models/subpixelnet.py:7-27`), so a net of this framework loads straight
into the reference through its ``--pretrained`` path
(`mainVideoUnshaded.py:317-319`).  The port's layers are torch layers:
weights keep their layout (TecoGAN's transposed convs included) and only
the names change; BatchNorm gains ``num_batches_tracked``.  RCAN has no
reference-compatible layout, as in JAX.

Run as ``python -m isosurfacesuperresolution_tpu_torch.infer.torch_export
RUN_DIR OUT.pth [--device cpu]``.
"""

from __future__ import annotations

import collections
from typing import Mapping, Optional, Union

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import ModelConfig
from isosurfacesuperresolution_tpu_torch.device import DeviceLike


def reference_state_dict_from_params(
        params: Union[nn.Module, Mapping[str, torch.Tensor]],
        cfg: ModelConfig) -> "collections.OrderedDict[str, torch.Tensor]":
    """The port's generator (or its ``state_dict``) -> reference-named
    float32 CPU ``state_dict``, in the order JAX's exporter writes it."""
    p = params.state_dict() if isinstance(params, nn.Module) else params
    kind = cfg.model
    sd: "collections.OrderedDict[str, torch.Tensor]" = (
        collections.OrderedDict())

    def put(key: str, ours: str,
            leaves=(("weight", "weight"), ("bias", "bias"))):
        for leaf, our_leaf in leaves:
            sd[f"{key}.{leaf}"] = p[f"{ours}.{our_leaf}"].detach().to(
                "cpu", torch.float32).clone()

    if kind == "SubpixelNet":
        for i in range(1, 6):
            put(f"conv{i}", f"conv{i}")
        return sd
    if kind not in ("EnhanceNet", "TecoGAN"):
        raise ValueError(
            f"{kind} checkpoints have no reference-compatible layout "
            "(RCAN differs by design: rcan.py:100-110 vs our pre-shuffle "
            "expansion conv)")
    put("preblock.0", "pre")
    use_bn = any(k.split(".")[0].endswith("_bn1") for k in p)
    i_conv2 = 3 if use_bn else 2
    n = 0
    while f"block{n}_conv1.weight" in p:
        put(f"blocks.{n}.0", f"block{n}_conv1")
        put(f"blocks.{n}.{i_conv2}", f"block{n}_conv2")
        if use_bn:
            for j, which in ((1, "bn1"), (4, "bn2")):
                put(f"blocks.{n}.{j}", f"block{n}_{which}",
                    tuple((leaf, leaf) for leaf in (
                        "weight", "bias", "running_mean", "running_var")))
                sd[f"blocks.{n}.{j}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
        n += 1
    if kind == "EnhanceNet":
        for key, ours in (("postblock.1", "post1"), ("postblock.4", "post2"),
                          ("postblock.6", "post3"), ("postblock.8", "out")):
            put(key, ours)
    else:
        for key, ours in (("postblock.0", "up1"), ("postblock.2", "up2"),
                          ("postblock.4", "out")):
            put(key, ours)
    return sd


def export_reference_pth(run_dir_or_model, out_path: str,
                         device: DeviceLike = None) -> str:
    """Run dir (loaded on ``device``) or `LoadedModel` -> a
    reference-loadable ``.pth``: a training-checkpoint dict whose
    ``model`` entry is the bare state dict, with the ``parameters`` the
    reference's loader reads (`loadedmodel.py:16-68`)."""
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    lm = (run_dir_or_model if isinstance(run_dir_or_model, LoadedModel)
          else LoadedModel.from_run_dir(run_dir_or_model, device=device))
    m = lm.cfg.model
    meta = {
        "model": m.model,
        "upscaleFactor": m.upscale_factor,
        "upsample": m.upsample,
        "reconType": m.recon_type,
        "numResidualBlocks": m.num_residual_blocks,
        "initialImage": lm.cfg.train.initial_image_mode,
        "aoInverted": lm.cfg.train.ao_inverted,
    }
    sd = reference_state_dict_from_params(lm.model, m)
    torch.save({"epoch": 0, "model": sd, "parameters": meta}, out_path)
    return out_path


def main(argv: Optional[list] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Export a run dir as a reference-format .pth")
    ap.add_argument("run_dir")
    ap.add_argument("output", help="output .pth path")
    ap.add_argument("--device", default=None,
                    help="where the run dir is loaded (default: cuda)")
    args = ap.parse_args(argv)
    export_reference_pth(args.run_dir, args.output, device=args.device)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
