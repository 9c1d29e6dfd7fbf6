"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``) with a
plain torch version beside each, and the ``ops`` dispatch."""
