"""Image operations of the fused frame."""
