"""Host-side I/O of the port: capture sources, fault injection, session
recording, the native frame ring and the synthetic known-BPM generator."""
