"""The plain reference: PyTorch in f32 with TF32 off, written from the
published architectures and the map-building semantics.  It imports
nothing of the port (``avlmaps_torch``), nor ``jax`` nor the JAX package,
and takes weights and inputs only from the benchmark; it reads the
port's outputs only to judge them."""
