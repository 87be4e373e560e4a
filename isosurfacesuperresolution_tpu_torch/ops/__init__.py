"""Image operations of the fused frame, and the 3x3 conv entry point."""

from isosurfacesuperresolution_tpu_torch.ops.pallas_conv import conv3x3

__all__ = ["conv3x3"]
