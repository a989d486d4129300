"""Export formats: wide labelled CSV, OpenSim TRC, Blender scene.

Port of caliscope_tpu/export/ (host code). The JAX package builds the wide
table with pandas; the port builds it with numpy, and writes the same TRC
bytes.
"""

from caliscope_tpu_torch.export.trc import WideTable, xyz_to_trc, xyz_to_wide_labelled  # noqa: F401
from caliscope_tpu_torch.export.blender import write_blender_scene  # noqa: F401
