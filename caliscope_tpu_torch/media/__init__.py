"""Media I/O + temporal synchronization.

Port of caliscope_tpu/media/ (reference src/caliscope/recording/). The port
reads QuickTime / MP4 with its own container reader (media/quicktime.py):
uncompressed 8-bit video on the host, MJPEG through nvJPEG on the card
(media/nvjpeg.py) or in numpy on the CPU (media/jpeg.py), MPEG-4 Part 2
and H.264 through the card's NVDEC (media/nvdec.py); the sync algorithm is
pure logic, the JAX package's.
"""

from caliscope_tpu_torch.media.frame_timestamps import FrameTimestamps  # noqa: F401
from caliscope_tpu_torch.media.synchronized_timestamps import SynchronizedTimestamps  # noqa: F401
from caliscope_tpu_torch.media.video import FrameSource, read_video_properties, VideoProperties  # noqa: F401
