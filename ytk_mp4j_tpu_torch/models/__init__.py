"""Model families of the port (GBDT so far)."""
