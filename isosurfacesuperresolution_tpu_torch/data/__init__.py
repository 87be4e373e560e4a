"""Training data: the renderer-in-the-loop clip generator."""

from isosurfacesuperresolution_tpu_torch.data.generation import (
    SequenceConfig, generate_sequences, random_camera_path,
    random_render_settings, render_sequence)

__all__ = ["SequenceConfig", "generate_sequences", "random_camera_path",
           "random_render_settings", "render_sequence"]
