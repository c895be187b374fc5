"""Helpers of the port: bounding boxes and the tag timer on the host, and
the FFT diagnostics."""
