# Copied from respmon_tpu/version.py:1-3.
"""Version of respmon_tpu_torch (the reference exposes __version__ at
__init__.py:1)."""

__version__ = "0.1.0"
