"""Tensor operations of the port (PyTorch counterparts of caliscope_tpu/ops)."""
