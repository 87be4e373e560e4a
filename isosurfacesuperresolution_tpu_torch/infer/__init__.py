"""Model loading and the fused interactive frame."""
