"""Estimators: markerless gravity (vertical) estimation.

Port of caliscope_tpu/estimators/: the GeoCalib perspective-field network
(`geocalib_arch`, exported and run through the port's ONNX executor), the
per-frame gravity fit (`vertical_solver`, an LM on the sphere with a Huber
loss, one frame per call) and the per-camera aggregation (`vertical`).
"""

from caliscope_tpu_torch.estimators.vertical_solver import fit_gravity, GravityFit  # noqa: F401
from caliscope_tpu_torch.estimators.vertical import (  # noqa: F401
    VerticalEstimate,
    estimate_vertical,
    estimate_vertical_from_fields,
    estimate_vertical_from_frames,
)
