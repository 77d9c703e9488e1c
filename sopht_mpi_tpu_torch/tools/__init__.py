"""Scripts run by hand on a machine with a CUDA device."""
