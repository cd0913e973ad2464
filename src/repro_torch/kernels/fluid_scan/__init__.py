"""The fluid surrogate's scan (K3): the plain version, the CUDA kernel and its
wrapper."""
