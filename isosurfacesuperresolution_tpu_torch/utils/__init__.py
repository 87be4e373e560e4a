"""Parameter transforms."""
