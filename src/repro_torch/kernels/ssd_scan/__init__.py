"""Mamba-2 SSD chunked scan: plain versions, the CUDA kernel and its wrapper."""
