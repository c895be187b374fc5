"""The multi-stream fleet on one device (the stream axis as a batch
dimension).  The JAX package's sharded functions (``parallel/mesh``,
``spatial``, ``temporal`` and the ``make_sharded_*`` factories) are not
ported yet."""
