"""Media I/O + temporal synchronization.

Port of caliscope_tpu/media/ (reference src/caliscope/recording/). The port
reads uncompressed 8-bit QuickTime video with its own container reader
(media/quicktime.py), on the host, feeding the device pipelines; the sync
algorithm is pure logic, the JAX package's.
"""

from caliscope_tpu_torch.media.frame_timestamps import FrameTimestamps  # noqa: F401
from caliscope_tpu_torch.media.synchronized_timestamps import SynchronizedTimestamps  # noqa: F401
from caliscope_tpu_torch.media.video import FrameSource, read_video_properties, VideoProperties  # noqa: F401
