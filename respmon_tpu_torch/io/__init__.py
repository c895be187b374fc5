"""Frame sources of the port; so far the synthetic known-BPM generator."""
