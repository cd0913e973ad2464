"""Step factories and launchers of the port."""
