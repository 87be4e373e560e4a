"""Generator networks and temporal helpers."""
