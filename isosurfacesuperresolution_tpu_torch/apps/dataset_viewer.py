"""Dataset viewer: browse or export previews of clip datasets.

Counterpart of the JAX package's `apps/dataset_viewer.py`
(`mainDatasetViewer.py`).  The default exports a PNG contact sheet per
clip (rows: frames; columns: shaded color, mask, normal, depth, AO and
the flow's magnitude); ``--tk`` opens the interactive browser (left and
right arrows step through the clips) where a display exists.  The
shading runs on the card unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.dataset_viewer \\
      <clip-dir> --output preview_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def clip_preview(seq, shading_cfg=None, device=None) -> np.ndarray:
    """A clip's contact sheet (rows = frames, columns = channels) as
    uint8; the color is shaded on ``device`` (the card by default)."""
    from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)

    device = resolve_device(device)
    cfg = shading_cfg or ShadingConfig(diffuse_color=(1.0, 1.0, 1.0),
                                       material_color=(1.0, 0.3, 0.0))
    high = seq["high"]
    with torch.no_grad():
        colors = screen_space_shading(
            torch.as_tensor(np.ascontiguousarray(high), device=device),
            cfg).cpu().numpy()
    rows = []
    for t in range(high.shape[0]):
        color = colors[t]
        mask = np.repeat((high[t, ..., 0:1] * 0.5 + 0.5), 3, -1)
        normal = high[t, ..., 1:4] * 0.5 + 0.5
        depth = np.repeat(np.clip(high[t, ..., 4:5], 0, 1), 3, -1)
        ao = np.repeat(np.clip(high[t, ..., 5:6], 0, 1), 3, -1)
        H = color.shape[0]
        flow_mag = np.linalg.norm(seq["flow"][t], axis=-1, keepdims=True)
        flow_img = np.repeat(np.clip(flow_mag * 20, 0, 1), 3, -1)
        f = H // flow_img.shape[0]
        flow_img = np.kron(flow_img, np.ones((f, f, 1)))
        rows.append(np.concatenate(
            [color, mask, normal, depth, ao, flow_img[:H, :H]], axis=1))
    sheet = np.concatenate(rows, axis=0)
    return (np.clip(sheet, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    """Returns the PNGs written (none with ``--tk``)."""
    p = argparse.ArgumentParser()
    p.add_argument("path", help="clip directory or index file")
    p.add_argument("--output", type=str, default="preview_out")
    p.add_argument("--maxClips", type=int, default=8)
    p.add_argument("--tk", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_gui import write_png
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        load_reference_npy_dir)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    sequences = load_reference_npy_dir(args.path)[:args.maxClips]
    if args.tk:
        _tk_browser(sequences, device)
        return []

    os.makedirs(args.output, exist_ok=True)
    written = []
    for i, seq in enumerate(sequences):
        out = os.path.join(args.output, f"clip_{i:03d}.png")
        write_png(out, clip_preview(seq, device=device))
        print("wrote", out)
        written.append(out)
    return written


def _tk_browser(sequences, device):
    import tkinter as tk

    from PIL import Image, ImageTk

    root = tk.Tk()
    root.title("Dataset viewer")
    state = {"clip": 0}
    label = tk.Label(root)
    label.pack()

    def show():
        sheet = clip_preview(sequences[state["clip"]], device=device)
        img = ImageTk.PhotoImage(Image.fromarray(sheet))
        label.configure(image=img)
        label.image = img
        root.title(f"clip {state['clip'] + 1}/{len(sequences)}")

    def step(delta):
        state["clip"] = (state["clip"] + delta) % len(sequences)
        show()

    root.bind("<Right>", lambda _=None: step(1))
    root.bind("<Left>", lambda _=None: step(-1))
    show()
    root.mainloop()


if __name__ == "__main__":
    main()
