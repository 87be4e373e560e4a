"""Pipe-protocol renderer client.

Counterpart of the JAX package's `infer/pipe_client.py`
(`inference/renderer.py:16-76`): spawn a renderer process, send
``key=value`` commands on its stdin, read binary channel-major float
frames (+ trailing render seconds) from its stderr.  Works against the
port's `apps/render_server.py` or any reference-compatible renderer
binary.  The server's stdout (its banner and logging) is read on a
thread into `output`, so a chatty server never blocks on a full pipe.
"""

from __future__ import annotations

import struct
import subprocess
import sys
import threading
from typing import Optional, Sequence

import numpy as np


class PipeRenderer:
    """Client for the line-oriented renderer pipe protocol."""

    def __init__(self, command: Sequence[str],
                 width: int = 320, height: int = 240, **popen_kw):
        self.proc = subprocess.Popen(
            list(command), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, **popen_kw)
        self.width = width
        self.height = height
        self.last_time: float = 0.0
        self.output: list = []      # the server's stdout lines
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()
        self.send_command("resolution", f"{width},{height}")

    @classmethod
    def local_server(cls, volume: str, width: int = 320, height: int = 240,
                     renderer: Optional[str] = None,
                     device: Optional[str] = None,
                     **popen_kw) -> "PipeRenderer":
        """The port's `apps.render_server` in a child process."""
        cmd = [sys.executable, "-m",
               "isosurfacesuperresolution_tpu_torch.apps.render_server",
               "--volume", volume]
        if renderer:
            cmd += ["--renderer", renderer]
        if device:
            cmd += ["--device", device]
        return cls(cmd, width, height, **popen_kw)

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.output.append(line.decode(errors="replace").rstrip("\n"))

    def send_command(self, key: str, value: str) -> None:
        """(`inference/renderer.py:49-57`)"""
        if key == "resolution":
            w, h = value.split(",")
            self.width, self.height = int(w), int(h)
        self.proc.stdin.write(f"{key}={value}\n".encode())
        self.proc.stdin.flush()

    def render(self) -> np.ndarray:
        """Request one frame -> (H, W, 12) float32; time in `last_time`.

        (`inference/renderer.py:58-71`)"""
        self.proc.stdin.write(b"render\n")
        self.proc.stdin.flush()
        n = 12 * self.height * self.width * 4 + 4
        data = b""
        while len(data) < n:
            chunk = self.proc.stderr.read(n - len(data))
            if not chunk:
                raise RuntimeError("renderer process closed the pipe")
            data += chunk
        frame = np.frombuffer(data[:-4], "<f4").reshape(
            12, self.height, self.width)
        self.last_time = struct.unpack("<f", data[-4:])[0]
        return frame.transpose(1, 2, 0).copy()

    def close(self) -> None:
        """Send ``exit`` and wait for the process (killed after 5 s);
        close the pipes."""
        try:
            self.proc.stdin.write(b"exit\n")
            self.proc.stdin.flush()
        except OSError:
            pass                    # the server is gone already
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=5)
        for f in (self.proc.stdin, self.proc.stdout, self.proc.stderr):
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
