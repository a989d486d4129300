"""Markerless pose tracking: model cards, the ONNX stack, decoding.

Port of caliscope_tpu/pose/: the first-party ONNX reader and writer
(`onnx_proto`), the exporter (`torch_onnx`) and the RTMPose family
(`rtmpose_arch`), the port's executor (`onnx_torch.OnnxTorchSession`, in
place of the JAX package's XLA executor), SimCC / heatmap decoding on the
device (`decode`), the model-card-driven `onnx_tracker.OnnxTracker` and the
tracker registry. The model cards in `model_cards/` are copies of the JAX
package's. Not ported yet: the model downloader (ROADMAP.md item 23).
"""

from caliscope_tpu_torch.pose.model_card import ModelCard  # noqa: F401
from caliscope_tpu_torch.pose.decode import decode_simcc, decode_heatmap  # noqa: F401
