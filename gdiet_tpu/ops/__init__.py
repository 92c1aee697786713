"""Device compute kernels (JAX/XLA, and the CUDA DP kernel in cuda/)."""
