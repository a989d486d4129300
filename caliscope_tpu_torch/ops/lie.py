"""SO(3)/SE(3) operations on torch tensors.

Port of caliscope_tpu/ops/lie.py. Same branch-free formulas (where-selects
with safe denominators, Taylor series at theta -> 0), so the two packages
agree to roundoff. Convention: x_cam = R @ X + t with world->camera R.

Host bookkeeping uses the numpy twins (`*_host`): cameras.py's rvecs
through `so3_exp_host` / `so3_log_host`, the JAX package's own numpy path
op for op (so that camera TOML files written by the two packages match
byte for byte), and the pose network's graph algebra on tiny per-pair
arrays (solvers/pose_network.py), which the JAX package also runs in
float64 on the host; the quaternion and angle twins run this module's
torch ops on float64 CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def _safe_norm(v, dim=-1, keepdim=False):
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim, keepdim=keepdim), min=_EPS))


def skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coefficients(theta2):
    """a = sin(t)/t and b = (1-cos t)/t^2 with the series fallback near 0."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    return theta, small, a, b


def so3_exp(rvec):
    """Rodrigues vector (...,3) -> rotation matrix (...,3,3)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)[..., None, None]
    _theta, _small, a, b = _exp_coefficients(theta2)
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def so3_exp_jacobian(rvec):
    """d so3_exp(rvec) / d rvec as (...,3,3,3), the last axis the rvec
    component. Closed form of the derivative of so3_exp's own formula
    (including its series branch), so it equals forward-mode autodiff of
    so3_exp to roundoff."""
    theta2 = torch.sum(rvec * rvec, dim=-1)[..., None, None]
    theta, small, a, b = _exp_coefficients(theta2)
    s, c = torch.sin(theta), torch.cos(theta)
    # da/d(theta^2) and db/d(theta^2)
    da = torch.where(small, torch.full_like(theta2, -1.0 / 6.0), (theta * c - s) / (2.0 * theta**3))
    db = torch.where(small, torch.full_like(theta2, -1.0 / 24.0), (0.5 * theta * s - (1.0 - c)) / theta2**2)
    K = skew(rvec)
    K2 = K @ K
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    cols = []
    for k in range(3):
        E = skew(eye[k]).expand(K.shape)
        vk = rvec[..., k][..., None, None]
        cols.append(2.0 * vk * da * K + a * E + 2.0 * vk * db * K2 + b * (E @ K + K @ E))
    return torch.stack(cols, dim=-1)


def quat_from_matrix(R):
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) [w,x,y,z]
    (branchless Shepperd-style pivot selection, sign canonicalized w >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (...,4cand,4comp)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / _safe_norm(q, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_from_quat(q):
    """Unit quaternion (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    q = q / _safe_norm(q, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_geodesic_angle(R_a, R_b):
    """Geodesic angle (radians) between two rotations, batched."""
    R_rel = R_a @ R_b.transpose(-1, -2)
    cos = (torch.diagonal(R_rel, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def quaternion_average(quats, weights=None):
    """Average rotations by the eigenvector method (Markley et al. 2007):
    quats (N,4) [w,x,y,z] -> (4,), the principal eigenvector of
    sum w_i q_i q_i^T with w >= 0 (sign-invariant)."""
    if weights is None:
        weights = torch.ones(quats.shape[0], dtype=quats.dtype, device=quats.device)
    M = torch.einsum("n,ni,nj->ij", weights, quats, quats)
    _, vecs = torch.linalg.eigh(M)
    q = vecs[:, -1]
    return q * torch.where(q[0] < 0, -1.0, 1.0)


def so3_log(R):
    """Rotation matrix (...,3,3) -> Rodrigues vector (...,3), through the
    quaternion: rvec = 2 * atan2(|v|, w) * v/|v|."""
    q = quat_from_matrix(R)
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = _safe_norm(v)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vnorm)
    return v * scale[..., None]


def se3_matrix(R, t):
    """(...,3,3),(...,3) -> (...,4,4) homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand(*batch, 4)
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def se3_compose(R_ab, t_ab, R_bc, t_bc):
    """Compose T_ab (x_a = R_ab x_b + t_ab) with T_bc -> T_ac."""
    return R_ab @ R_bc, (R_ab @ t_bc[..., None])[..., 0] + t_ab


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, X):
    """Apply x' = R @ X + t. X: (...,3) broadcastable against R (...,3,3)."""
    return torch.einsum("...ij,...j->...i", R, X) + t


def so3_exp_host(rvec) -> np.ndarray:
    """numpy twin of so3_exp for one host Rodrigues vector (3,) -> (3,3)."""
    rvec = np.asarray(rvec, dtype=np.float64)
    theta2 = np.sum(rvec * rvec, axis=-1)[..., None, None]
    theta = np.sqrt(np.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    b = np.where(small, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / np.maximum(theta2, _EPS))
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = np.zeros_like(x)
    K = np.stack(
        [np.stack([zero, -z, y], axis=-1), np.stack([z, zero, -x], axis=-1), np.stack([-y, x, zero], axis=-1)],
        axis=-2,
    )
    return np.broadcast_to(np.eye(3), K.shape) + a * K + b * (K @ K)


def quat_from_matrix_host(R) -> np.ndarray:
    """numpy twin of quat_from_matrix: (...,3,3) -> (...,4) [w,x,y,z]."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    pivots = np.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    best = np.argmax(pivots, axis=-1)
    cands = np.stack([qw, qx, qy, qz], axis=-2)
    idx = best[..., None, None].astype(np.int32) * np.ones((1, 4), np.int32)
    q = np.take_along_axis(cands, idx, axis=-2)[..., 0, :]
    q = q / np.sqrt(np.maximum(np.sum(q * q, axis=-1, keepdims=True), _EPS))
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log_host(R) -> np.ndarray:
    """numpy twin of so3_log: (...,3,3) -> (...,3)."""
    q = quat_from_matrix_host(R)
    w, v = q[..., 0], q[..., 1:]
    vnorm = np.sqrt(np.maximum(np.sum(v * v, axis=-1), _EPS))
    theta = 2.0 * np.arctan2(vnorm, w)
    scale = np.where(vnorm < 1e-8, 2.0 / np.maximum(w, _EPS), theta / vnorm)
    return v * scale[..., None]


def _on_host(fn, *arrays) -> np.ndarray:
    """`fn` (a torch op of this module) on numpy arrays, as float64 CPU
    tensors: the host twins below share the device versions' formulas."""
    return fn(*(torch.from_numpy(np.asarray(a, dtype=np.float64)) for a in arrays)).numpy()


def matrix_from_quat_host(q) -> np.ndarray:
    """numpy twin of matrix_from_quat: (...,4) -> (...,3,3)."""
    return _on_host(matrix_from_quat, q)


def rotation_geodesic_angle_host(R_a, R_b) -> np.ndarray:
    """numpy twin of rotation_geodesic_angle."""
    return _on_host(rotation_geodesic_angle, R_a, R_b)


def quaternion_average_host(quats, weights=None) -> np.ndarray:
    """numpy twin of quaternion_average: (N,4) -> (4,)."""
    if weights is None:
        weights = np.ones(len(quats))
    return _on_host(quaternion_average, quats, weights)


def se3_inverse_host(R, t) -> tuple[np.ndarray, np.ndarray]:
    """numpy twin of se3_inverse."""
    Rt = np.swapaxes(np.asarray(R), -1, -2)
    return Rt, -(Rt @ np.asarray(t)[..., None])[..., 0]
