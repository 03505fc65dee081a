"""Pure-JAX compute kernels for stereo SLAM."""
