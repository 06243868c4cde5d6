"""Low-level batched block kernels (the framework's BLAS, in jax.numpy/lax)."""
