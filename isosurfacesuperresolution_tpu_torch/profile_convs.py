"""Time the port's conv kernels (B6, B7, B5) beside cuDNN on the card.

    python -m isosurfacesuperresolution_tpu_torch.profile_convs [--reps N]

The port of the JAX package's `scripts/profile_pallas.py` and
`scripts/profile_packed.py`, at their shapes and with their inputs (numpy
``RandomState(0)``, drawn in their order):

* B6 (`conv3x3_pallas_p128`) at the planar post3 shape, x (1, 540, 960,
  256) and w (3, 3, 256, 256) in bf16, zero bias;
* B6 at the padded trunk shape, x (1, 270, 480, 128), w (3, 3, 128, 128);
* a chain of 20 B7 convs (`packed_conv3x3`, ReLU, zero bias) on
  (1, 270, 480, 64) bf16 activations packed in pixel pairs;
* the phase conv B5 (`phase_conv`, bf16 out, zero bias) at the shape of
  `scripts/profile_phase_blocked.py`, x (1, 540, 960, 256) bf16 A-major
  and k3 (3, 3, 64, 64) scaled by 0.05 (drawn from its own
  ``RandomState(0)``), and the host microseconds one `phase_conv` call
  takes to enqueue its work while the card is busy (mean of 200 calls
  behind a long spin, no sync between them: weight preparation, checks,
  tensor maps and launch).

Each is printed beside cuDNN computing the same function: `F.conv2d` in
bf16 on channels-last tensors (the chain: conv then ReLU, 20 times; B5:
on the shuffled (1, 64, 1080, 1920) tensor).  The JAX scripts' sweeps
over the TPU band height and block width have no counterpart.  Times
are the median of ``--reps`` CUDA-event timings after a warm-up call, each
call enqueued behind a spin of a few milliseconds so that the card runs it
without waiting for the host (device time, the host's launch cost
excluded), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch.ops.packed_conv import (
    pack_pairs, packed_conv3x3)
from isosurfacesuperresolution_tpu_torch.ops.pallas_conv import (
    conv3x3_pallas_p128)
from isosurfacesuperresolution_tpu_torch.ops.phase_conv import phase_conv

_BF16 = torch.bfloat16


def dense_inputs(device="cuda"):
    """`profile_pallas.py`'s two B6 cases: [(name, x, w, b), ...] with x
    and w bf16 (NHWC, HWIO) and b float32 zeros."""
    rng = np.random.RandomState(0)

    def bf16(a, scale=None):
        t = torch.from_numpy((a - 0.5).astype(np.float32)).to(_BF16)
        return (t if scale is None else t * scale).to(device)

    x = bf16(rng.rand(1, 540, 960, 256))
    k = bf16(rng.rand(3, 3, 256, 256), 0.05)
    x2 = bf16(rng.rand(1, 270, 480, 128))
    k2 = bf16(rng.rand(3, 3, 128, 128), 0.05)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return [("post3 (540, 960) 256 -> 256", x, k, zeros(256)),
            ("trunk (270, 480) 128 -> 128", x2, k2, zeros(128))]


def packed_chain_inputs(device="cuda"):
    """`profile_packed.py`'s chain: x (1, 270, 480, 64) bf16, 20 float32
    kernels (3, 3, 64, 64) scaled by 0.1, zero bias (64,)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(1, 270, 480, 64) - 0.5)
                         .astype(np.float32)).to(_BF16).to(device)
    ks = [torch.from_numpy((rng.rand(3, 3, 64, 64) - 0.5)
                           .astype(np.float32)).to(device) * 0.1
          for _ in range(20)]
    return x, ks, torch.zeros(64, dtype=torch.float32, device=device)


def phase_inputs(device="cuda"):
    """`profile_phase_blocked.py`'s phase conv operands: x (1, 540, 960,
    256) bf16 A-major, k3 (3, 3, 64, 64) float32 scaled by 0.05, zero bias
    (64,)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(1, 540, 960, 256) - 0.5)
                         .astype(np.float32)).to(_BF16).to(device)
    k3 = torch.from_numpy((rng.rand(3, 3, 64, 64) - 0.5)
                          .astype(np.float32)).to(device) * 0.05
    return x, k3, torch.zeros(64, dtype=torch.float32, device=device)


def conv_flops(h: int, w: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * cin * cout * 9


def cudnn_input(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` as the channels-last bf16 NCHW tensor cuDNN's
    tensor-core convs read."""
    return x.permute(0, 3, 1, 2).to(_BF16).contiguous(
        memory_format=torch.channels_last)


def cudnn_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``w`` as a channels-last bf16 OIHW tensor."""
    return w.permute(3, 2, 0, 1).to(_BF16).contiguous(
        memory_format=torch.channels_last)


def time_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``reps`` calls after one warm-up call,
    each behind a spin (about 5 ms) that keeps the card busy while the host
    enqueues it."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds one call of ``fn`` takes to enqueue its work while
    the card is busy: ``n`` calls on the host clock behind a spin of about
    100 ms, with no sync between them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return dt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_convs needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    def report(name, ms, flops):
        print(f"{name:56s} {ms:8.3f} ms  {flops / ms / 1e9:7.1f} TFLOP/s",
              flush=True)

    for name, x, k, b in dense_inputs():
        _, h, w, cin = x.shape
        flops = conv_flops(h, w, cin, k.shape[3])
        report(f"B6 {name}", time_ms(
            lambda: conv3x3_pallas_p128(x, k, b), args.reps), flops)
        xc, kc = cudnn_input(x), cudnn_weight(k)
        report(f"cuDNN {name}", time_ms(
            lambda: F.conv2d(xc, kc, padding=1), args.reps), flops)
        del x, k, xc, kc

    x, ks, b = packed_chain_inputs()
    flops = 20 * conv_flops(270, 480, 64, 64)
    kb = [k.to(_BF16) for k in ks]

    def packed_chain():
        y = pack_pairs(x)
        for k in kb:
            y = packed_conv3x3(y, k, b, relu=True)
        return y

    report("B7 chain of 20 (270, 480) 64 -> 64", time_ms(
        packed_chain, args.reps), flops)
    xc, kc = cudnn_input(x), [cudnn_weight(k) for k in ks]

    def cudnn_chain():
        y = xc
        for k in kc:
            y = torch.relu(F.conv2d(y, k, padding=1))
        return y

    report("cuDNN chain of 20 (270, 480) 64 -> 64", time_ms(
        cudnn_chain, args.reps), flops)


    x, k3, b = phase_inputs()
    h, w = x.shape[1:3]
    flops = conv_flops(2 * h, 2 * w, 64, 64)
    report(f"B5 phase conv ({h}, {w}) 4 x 64 -> 4 x 64", time_ms(
        lambda: phase_conv(x, k3, b), args.reps), flops)
    xs = x[0].reshape(h, w, 2, 2, 64).permute(4, 0, 2, 1, 3).reshape(
        1, 64, 2 * h, 2 * w)
    xc, kc = cudnn_input(xs.permute(0, 2, 3, 1)), cudnn_weight(k3)
    report(f"cuDNN on the shuffled (1, 64, {2 * h}, {2 * w})", time_ms(
        lambda: F.conv2d(xc, kc, padding=1), args.reps), flops)
    kb = k3.to(_BF16)
    print(f"B5 host time a call (phase_conv, mean of 200, card busy): "
          f"k3 float32 {host_us(lambda: phase_conv(x, k3, b)):.1f} us, "
          f"k3 bf16 as the planar tail passes it "
          f"{host_us(lambda: phase_conv(x, kb, b)):.1f} us", flush=True)


if __name__ == "__main__":
    main()
