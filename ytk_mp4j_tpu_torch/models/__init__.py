"""Model families of the port (GBDT and its quantile binning so far)."""
