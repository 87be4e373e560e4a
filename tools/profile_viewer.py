"""Where a viewer frame spends its time on the card: a development tool,
not part of the package.  From the repository root:

    python tools/profile_viewer.py [--modes gt,bicubic] [--frames 3]

Builds `apps.main_gui.Viewer` on `chip_smoke.py`'s volume
(`blobs_volume(256, num_blobs=8)`, 480x270 -> 1920x1080,
``renderer="sweep_pallas"``), prints the ground truth's render settings
(the view-adaptive oversampling of its first camera), then, for each
mode, renders 3 warm-up frames and ``--frames`` frames under
`torch.profiler` (CPU and CUDA): the wall ms a frame (the frame's copy to
the host included), the device ms busy a frame, and the profiler's tables
sorted by CPU time and by device time, with the card's name and power
limit.
"""

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from isosurfacesuperresolution_tpu_torch.apps.main_gui import (  # noqa: E402
    Viewer)
from isosurfacesuperresolution_tpu_torch.render.api import (  # noqa: E402
    adaptive_sweep_cfg)
from isosurfacesuperresolution_tpu_torch.volume import analytic  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--modes", type=str, default="gt,bicubic")
    p.add_argument("--frames", type=int, default=3)
    args = p.parse_args(argv)
    print(chip_smoke.card_line(), flush=True)
    grid = analytic.blobs_volume(256, num_blobs=8, device="cuda")
    v = Viewer(grid, {}, res_x=480, res_y=270, isovalue=0.5,
               renderer="sweep_pallas")
    cfg = v._high_cfg()
    print("ground truth", cfg)
    print("view-adaptive oversampling",
          adaptive_sweep_cfg(v.camera.params(), cfg).sweep_oversample)
    for mode in args.modes.split(","):
        v.set_mode(mode)
        for _ in range(3):
            v.render_frame()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(args.frames):
                v.camera.start_move()
                v.camera.move(20, 0)
                v.render_frame()
            torch.cuda.synchronize()
            wall = (time.time() - t) / args.frames
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"== {mode}: wall {wall * 1e3:.1f} ms a frame, device busy "
              f"{busy / 1e3 / args.frames:.2f} ms")
        print(prof.key_averages().table(sort_by="cpu_time_total",
                                        row_limit=25))
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=12))


if __name__ == "__main__":
    main()
