"""Weight conversion between the JAX package, the reference layout and
the port (counterpart of ``showo_tpu.utils``)."""
