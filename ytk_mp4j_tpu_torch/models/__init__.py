"""Model families of the port: GBDT with its quantile binning, FM/FFM and
linear."""
