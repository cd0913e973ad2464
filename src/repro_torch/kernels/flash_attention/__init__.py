"""Flash-attention forward: CUDA C++ kernel, plain version and public wrapper."""
