"""Pipeline stages of the port: calibrate (evm), measure (motion, scan),
estimate (bpm)."""
