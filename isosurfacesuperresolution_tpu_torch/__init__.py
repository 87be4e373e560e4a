"""PyTorch/CUDA port of the isosurface super-resolution system for one
NVIDIA H100.

The JAX package `isosurfacesuperresolution_tpu` is the reference; this
package mirrors its subpackage and module names (``render/sweep.py`` <->
``render/sweep.py`` and so on) and keeps its public layouts: NHWC images and
(X, Y, Z) volumes.  It imports nothing from the JAX package.

Entry points (`volume.analytic`, `infer.loadedmodel.LoadedModel`,
`infer.pipeline`) run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.  Each hand-written
CUDA kernel lives under ``csrc/`` and is built with ``nvcc`` at first use
(`kernels.py`); on CPU tensors its wrapper runs the kernel's plain PyTorch
version instead.

Ported so far: the fused interactive frames (`infer/pipeline.FusedFrame`,
`InferencePipeline`): the sweep-rendered G-buffer through the CUDA march
kernel (`render/sweep_march.py`), optionally with a baked SH occlusion
field (`render/ao_sweep.py`), flow inpainting, and either the interleaved
network (the shift-blend warp of the 4x state, the trained EnhanceNet) or
the sub-pixel-planar engine (`infer/planar.py`, whose post3 layer may run
through the CUDA phase conv, `ops/phase_conv.py`), then clamp and
screen-space shading.  Large volumes render through the occupancy-gated
tiled march (`render/sweep_tiled.py`), over a dense grid or one packed
into per-axis atlases of occupied slice tiles (`volume/packed.py`).
"""
