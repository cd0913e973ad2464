"""Model families of the port (dense decoder-only transformer so far)."""
