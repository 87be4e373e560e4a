"""Training data: the renderer-in-the-loop clip generator and the clip
datasets."""

from isosurfacesuperresolution_tpu_torch.data.dataset import (
    DatasetFromSamples, Sample, VideoDataset, augment_clip,
    load_reference_npy_dir)
from isosurfacesuperresolution_tpu_torch.data.generation import (
    SequenceConfig, generate_sequences, random_camera_path,
    random_render_settings, render_sequence)

__all__ = ["DatasetFromSamples", "Sample", "VideoDataset", "augment_clip",
           "load_reference_npy_dir", "SequenceConfig", "generate_sequences",
           "random_camera_path", "random_render_settings", "render_sequence"]
