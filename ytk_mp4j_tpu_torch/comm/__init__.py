"""Device-path collective drivers of the port."""
