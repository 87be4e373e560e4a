"""Quality statistics of super-resolved frames."""
