"""Geometry of the ChESS-style ring response, shared by the response kernel's
wrapper (detect/cuda_kernels.py) and the host code that reads the response
(the ChArUco tracker keeps no corner inside its zeroed border). Plain
constants: importing this module loads no kernel."""

N_TAPS = 16
RADIUS = 4.0  # of the sampling ring, px
PAD = 6  # width of the zeroed border: ceil(RADIUS) + 2
