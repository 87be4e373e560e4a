"""Volumes: the dense grid and the analytic test volumes."""
