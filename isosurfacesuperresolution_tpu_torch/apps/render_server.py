"""Line-oriented renderer pipe protocol (reference interop).

Counterpart of the JAX package's `apps/render_server.py`: the PIPE mode of
the reference renderers (`CPURenderer.cpp:688-787`,
`GPURenderer.cpp:858-966`).  Text commands on stdin (``key=value`` and
``render``), binary float32 frames on **stderr** (channel-major
``[12][H][W]`` + one trailing float32 with the render seconds, the device
work and the copy to the host included), the banner and all logging on
stdout, as consumed by `inference/renderer.py:16-76` and
`infer/pipe_client.PipeRenderer`.

The frame stream carries frames and nothing else: at start the process
keeps a duplicate of file descriptor 2 for the frames and points fd 2 at
stdout, so whatever else writes to fd 2 (Python, the CUDA runtime, a
library, a compiler) lands on stdout.

Commands (`GPURendererDirect.cpp:395-428`, `CPURenderer.cpp:750-785`):
  cameraOrigin=x,y,z   cameraLookAt=x,y,z   cameraUp=x,y,z   fov=v
  resolution=w,h       isovalue=v           aosamples=n      aoradius=v
  viewport=x0,y0,x1,y1 render               exit

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.render_server \\
      --volume analytic:blobs [--renderer sweep_pallas] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--renderer", type=str, default=None,
                   help="override sweep|sweep_pallas|march")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    # the frames go to a duplicate of fd 2; fd 2 itself (and so Python's
    # sys.stderr, warnings, logging's default stream) now reaches stdout
    sys.stderr.flush()
    out = os.fdopen(os.dup(2), "wb")
    os.dup2(1, 2)

    import numpy as np

    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)

    grid, _ = load_volume(args.volume, device=resolve_device(args.device))
    state = {
        "origin": (0.0, 1.0, -1.7), "look_at": (0.0, 0.0, 0.0),
        "up": (0.0, 1.0, 0.0), "fov": 45.0,
        "cfg": RenderConfig(width=320, height=240, ao_samples=0,
                            **({"renderer": args.renderer}
                               if args.renderer else {})),
        "last_cam": None,
    }

    print("Enter Pipe mode and wait for commands", flush=True)
    with out:
        for line in sys.stdin:
            command = line.strip()
            if not command:
                continue
            if command == "exit":
                print("Exit program", flush=True)
                return
            if command == "render":
                cfg = state["cfg"]
                cam = CameraParams.create(state["origin"], state["look_at"],
                                          state["up"], state["fov"])
                cam_prev = state["last_cam"] or cam
                t0 = time.time()
                frame = render_frame_gbuffer(grid, cam, cam_prev, cfg,
                                             RenderParams.from_config(cfg))
                # channel-major; the copy to the host waits for the card
                payload = frame.permute(2, 0, 1).contiguous().cpu().numpy()
                seconds = time.time() - t0
                state["last_cam"] = cam
                out.write(payload.astype("<f4").tobytes())
                out.write(np.float32(seconds).tobytes())
                out.flush()
                continue
            if not _set(state, command):
                return


def _set(state: dict, command: str) -> bool:
    """Apply one ``key=value`` command; False (after a message on stdout)
    ends the session, as the reference does on a bad command."""
    if "=" not in command:
        print(f"Unknown command format: {command}, exit", flush=True)
        return False
    cmd, value = command.split("=", 1)
    try:
        if cmd == "cameraOrigin":
            state["origin"] = tuple(map(float, value.split(",")))
        elif cmd == "cameraLookAt":
            state["look_at"] = tuple(map(float, value.split(",")))
        elif cmd == "cameraUp":
            state["up"] = tuple(map(float, value.split(",")))
        elif cmd in ("fov", "cameraFoV"):
            state["fov"] = float(value)
        elif cmd == "resolution":
            w, h = map(int, value.split(","))
            state["cfg"] = state["cfg"].replace(width=w, height=h)
        elif cmd == "isovalue":
            state["cfg"] = state["cfg"].replace(isovalue=float(value))
        elif cmd == "aosamples":
            state["cfg"] = state["cfg"].replace(ao_samples=int(value))
        elif cmd == "aoradius":
            state["cfg"] = state["cfg"].replace(ao_radius=float(value))
        elif cmd == "viewport":
            vp = tuple(map(int, value.split(",")))
            state["cfg"] = state["cfg"].replace(
                viewport=None if min(vp) < 0 else vp)
        elif cmd == "unshaded":
            pass   # output always carries both shaded + unshaded channels
        else:
            print(f"Unknown command: '{cmd}', exit", flush=True)
            return False
    except ValueError as e:
        print(f"Bad value for {cmd}: {e}", flush=True)
        return False
    return True


if __name__ == "__main__":
    main()
