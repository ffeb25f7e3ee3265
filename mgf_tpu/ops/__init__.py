"""Pallas kernels for hot ops; the jnp paths they fuse stay the source of
truth."""
