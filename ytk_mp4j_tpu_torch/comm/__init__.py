"""Collective backends of the port: the single-controller device cluster
(``gpu_comm``) and the multi-process plane (``distributed``)."""
