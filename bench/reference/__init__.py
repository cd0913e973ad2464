"""Plain PyTorch references of the model families, one module each.  They
import nothing of the program (``repro_torch``), nor ``repro`` or JAX."""
