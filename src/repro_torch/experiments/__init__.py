"""Sweep grids, their cache, paired statistics, the event engine's and the
fluid surrogate's sweeps, the surrogate's calibration, and the CLI
(``python -m repro_torch.experiments``)."""
