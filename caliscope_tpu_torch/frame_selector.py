"""The board-plane homography fit of caliscope_tpu/frame_selector.py.

Only `_frame_homography` is here: the ChArUco tracker fits its board
homographies with it. The rest of that module (orientation bins, grid
coverage, the two-phase frame selection and its report) belongs to
intrinsic calibration and is ported with it.
"""

from __future__ import annotations

import numpy as np


def _frame_homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray | None:
    """Plain-numpy DLT homography (board plane -> pixels); None if degenerate."""
    n = len(obj_xy)
    if n < 4:
        return None
    # normalize for conditioning
    mo, mi = obj_xy.mean(0), img_xy.mean(0)
    od = obj_xy - mo
    pd = img_xy - mi
    so = np.sqrt(2) / max(float(np.sqrt((od * od).sum(1)).mean()), 1e-9)
    si = np.sqrt(2) / max(float(np.sqrt((pd * pd).sum(1)).mean()), 1e-9)
    o = od * so
    p = pd * si
    # Null vector via the 9x9 normal matrix, assembled blockwise: with
    # a = [x, y, 1] per point and DLT rows r1 = [-a, 0, u*a],
    # r2 = [0, -a, v*a], AtA has the 3x3 block structure
    #   [[ M,  0, -Mu], [ 0,  M, -Mv], [-Mu', -Mv', Muu+Mvv]]
    # built from four (n,3) products; no (2n, 9) A is materialized. After
    # normalization the system is well-conditioned, and eigh of the 9x9
    # costs O(9^3) against a full SVD's O(n * 81).
    a = np.empty((n, 3))
    a[:, :2] = o
    a[:, 2] = 1.0
    u = p[:, 0:1]
    v = p[:, 1:2]
    au = a * u
    av = a * v
    M = a.T @ a
    Mu = a.T @ au
    Mv = a.T @ av
    Muv = au.T @ au + av.T @ av
    AtA = np.zeros((9, 9))
    AtA[0:3, 0:3] = M
    AtA[3:6, 3:6] = M
    AtA[0:3, 6:9] = -Mu
    AtA[6:9, 0:3] = -Mu.T
    AtA[3:6, 6:9] = -Mv
    AtA[6:9, 3:6] = -Mv.T
    AtA[6:9, 6:9] = Muv
    _, vecs = np.linalg.eigh(AtA)
    Hn = vecs[:, 0].reshape(3, 3)
    # denormalize: H = Ti^-1 @ Hn @ To with the similitudes' closed forms
    Ti_inv = np.array([[1.0 / si, 0, mi[0]], [0, 1.0 / si, mi[1]], [0, 0, 1]])
    To = np.array([[so, 0, -so * mo[0]], [0, so, -so * mo[1]], [0, 0, 1]])
    H = Ti_inv @ Hn @ To
    if abs(H[2, 2]) < 1e-12:
        return None
    return H / H[2, 2]
