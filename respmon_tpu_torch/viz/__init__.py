"""Visualization backends of the port (host-side, optional)."""
