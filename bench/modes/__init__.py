"""The loops that drive a traffic mix, one a ``mode``: each module's ``run``
returns the metrics, the counts and the numbers that decide ``correct``."""
