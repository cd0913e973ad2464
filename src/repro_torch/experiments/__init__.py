"""Sweep grids, their cache, paired statistics, and the fluid surrogate's
sweeps."""
