"""AdamW's global norm and update (K4): the plain version, the CUDA kernels
and their wrapper."""
