"""The training losses: primitives, discriminators, VGG features and the
unshaded loss stack."""

from isosurfacesuperresolution_tpu_torch.losses import builder
from isosurfacesuperresolution_tpu_torch.losses.discriminators import (
    build_discriminator)
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.losses.vgg import (
    VGG19Features, load_vgg19_params)

__all__ = ["builder", "build_discriminator", "LossNetUnshaded",
           "VGG19Features", "load_vgg19_params"]
