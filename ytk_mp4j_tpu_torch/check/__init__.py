"""Check programs of the port (``checkdist``: the multi-process plane)."""
