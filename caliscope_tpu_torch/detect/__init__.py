"""Detection of the port (PyTorch counterparts of caliscope_tpu/detect):
threshold, connected components and quad extraction (kernels.py, ccl.py),
ArUco bit sampling and dictionary decode (aruco.py, dictionaries.py),
X-corner response, NMS and subpixel refinement (corners.py, cuda_kernels.py).
Everything batches over a (frames, H, W) stack in float32."""

from caliscope_tpu_torch.detect.dictionaries import ArucoDictionary, get_dictionary  # noqa: F401
