"""Sweep renderer: camera, G-buffer march and shading."""
