"""Shared inputs of the port's detection tests (tests/test_torch_*.py):
seeded ChArUco views rendered without OpenCV, and small converters."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from caliscope_tpu_torch import convert
from caliscope_tpu_torch.targets import render

FRAME_WH = (320, 240)
PX_PER_SQUARE = 60
# board outlines (TL, TR, BR, BL) that keep the board >= 10 px inside the frame
QUAD_FRONT = [[24.3, 16.2], [300.7, 22.8], [292.5, 224.9], [30.1, 218.4]]
QUAD_SECOND = [[30.1, 20.6], [305.2, 14.3], [296.4, 226.2], [18.7, 200.8]]


def port_board(jax_charuco):
    """The port's Charuco built from the reference dataclass's fields."""
    return convert.charuco(dataclasses.asdict(jax_charuco))


def board_frame(charuco, quad, mirror: bool = False, wh=FRAME_WH, px=PX_PER_SQUARE, noise_seed: int = 11):
    """(frame uint8 (h, w), true corner positions (n_corners, 2)) of the
    port's rendered board warped onto `quad`, with seeded sensor noise of
    1.5 gray levels (a noise-free render is full of exactly equal response
    values, and which of equal values a top-k keeps is not part of any
    contract). mirror: the back-face print, with the truth mirrored too."""
    board = charuco.board_image(px_per_square=px)
    corners = render.board_corner_pixels(charuco, px)
    if mirror:
        board = np.ascontiguousarray(board[:, ::-1])
        corners[:, 0] = board.shape[1] - 1 - corners[:, 0]
    frame, H = render.board_view(board, quad, wh)
    noise = np.random.default_rng(noise_seed).normal(scale=1.5, size=frame.shape)
    frame = np.clip(np.rint(frame.astype(np.float64) * (235.0 / 255.0) + 10.0 + noise), 0, 255).astype(np.uint8)
    return frame, render.project(H, corners)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))
