"""Solvers of the port (PyTorch counterparts of caliscope_tpu/solvers)."""
