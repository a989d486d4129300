"""Write the compressed clips that the decode tests and chip_smoke.py read.

    python tests/data/video/make_clips.py

Needs OpenCV (cv2) with FFmpeg, and the repository on the path (it runs
from the repository's root). The frames are the workspace recipe's
1280x720 renders of the 5x7 ChArUco board (chip_smoke.py's `ws_*`
functions: camera 0 of the ring, the extrinsic sweep's poses where that
camera sees the board), written as BGR with grey content:

- `board_mjpeg.mov`: MJPEG under QuickTime's 'jpeg' entry, MJPEG_FRAMES
  frames at OpenCV's quality MJPEG_QUALITY;
- `board_mp4v.mp4`: MPEG-4 Part 2 under 'mp4v' (I frames every 12, P frames
  between, so the file has a sync sample table), MP4V_FRAMES frames;
- `board_mp4v_cv2_gray.npz`: OpenCV's own decode of the mp4v clip
  (VideoCapture.read, then cvtColor(BGR2GRAY)) at the frames KEPT (I and P
  frames of both groups of pictures): `frames` (len(KEPT), 720, 1280) uint8
  and `index`, their frame numbers.

The clips are committed (about 1 MB in all); rerun this only to change them.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
MJPEG_FRAMES = 6
MJPEG_QUALITY = 75
MP4V_FRAMES = 16
KEPT = (0, 1, 6, 11, 12, 15)


def board_frames(n: int) -> list[np.ndarray]:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cam = cs.ws_cameras()[0]
    board_img = cs.ws_board().board_image(px_per_square=cs.WS_SQ_PX, margin_squares=0.5)
    frames = []
    for pose in cs.ws_station_poses(cs.WS_STATIONS, cs.WS_PER_STATION):
        frame = cs.ws_render(board_img, cs.WS_SQ_PX, cam, pose, cs.WS_WH)
        if frame.min() < 128:  # the board is in view
            frames.append(frame)
        if len(frames) == n:
            return frames
    raise RuntimeError(f"camera 0 sees the board in fewer than {n} frames")


def write(path: Path, fourcc: str, frames, quality=None) -> None:
    h, w = frames[0].shape
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30.0, (w, h))
    if not out.isOpened():
        raise RuntimeError(f"OpenCV cannot write {fourcc} to {path}")
    if quality is not None:
        out.set(cv2.VIDEOWRITER_PROP_QUALITY, quality)
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    out.release()


def main() -> None:
    frames = board_frames(max(MJPEG_FRAMES, MP4V_FRAMES))
    write(HERE / "board_mjpeg.mov", "MJPG", frames[:MJPEG_FRAMES], MJPEG_QUALITY)
    write(HERE / "board_mp4v.mp4", "mp4v", frames[:MP4V_FRAMES])
    cap = cv2.VideoCapture(str(HERE / "board_mp4v.mp4"))
    decoded = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        decoded.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    cap.release()
    if len(decoded) != MP4V_FRAMES:
        raise RuntimeError(f"OpenCV decoded {len(decoded)} of {MP4V_FRAMES} frames")
    np.savez_compressed(HERE / "board_mp4v_cv2_gray.npz", frames=np.stack([decoded[i] for i in KEPT]),
                        index=np.array(KEPT))
    for p in sorted(HERE.glob("board_*")):
        print(f"{p.name}: {p.stat().st_size} bytes")


if __name__ == "__main__":
    main()
