"""Similarity (sim(3)) transforms and Umeyama alignment on torch tensors.

Port of caliscope_tpu/ops/similarity.py. The camera update rule is the
subtle part: for a world-frame similarity X' = s R X + t, camera centers
move as C' = s R C + t while orientations update as R_cam' = R_cam R^T —
scale must not enter the rotation.

The functions take tensors or array-likes (array-likes become float64 CPU
tensors) and return tensors on the inputs' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _t(a, like=None):
    if isinstance(a, torch.Tensor):
        return a
    if like is not None:
        return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@dataclass(frozen=True)
class SimilarityParams:
    """s, R (3,3), t (3,): X' = s * R @ X + t."""

    scale: float
    rotation: np.ndarray
    translation: np.ndarray

    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.scale * np.asarray(self.rotation)
        m[:3, 3] = np.asarray(self.translation)
        return m

    def inverse(self) -> "SimilarityParams":
        R = np.asarray(self.rotation)
        s = float(self.scale)
        Rt = R.T
        return SimilarityParams(1.0 / s, Rt, -Rt @ np.asarray(self.translation) / s)

    def apply(self, X):
        X = np.asarray(X)
        return (self.scale * (np.asarray(self.rotation) @ X.T)).T + np.asarray(self.translation)


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity aligning src -> dst (both (N,3)).

    Returns (s, R, t) with dst ~= s R src + t (Umeyama 1991 closed form with
    the reflection guard)."""
    src = _t(src)
    dst = _t(dst, like=src)
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc.T @ sc) / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    var_s = torch.mean(torch.sum(sc * sc, dim=1))
    s = torch.sum(S * torch.diagonal(D)) / var_s if with_scale else torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_similarity_to_points(s, R, t, X):
    R = _t(R)
    return s * torch.einsum("ij,...j->...i", R, _t(X, like=R)) + _t(t, like=R)


def apply_similarity_to_extrinsics(s, R, t, R_cams, t_cams):
    """Update world->camera extrinsics for a world-frame similarity transform.

    Camera center C = -R_cam^T t_cam moves to C' = s R C + t;
    orientation R_cam' = R_cam R^T; then t_cam' = -R_cam' C'.
    """
    R = _t(R)
    R_cams = _t(R_cams, like=R)
    t_cams = _t(t_cams, like=R)
    C = -torch.einsum("...ji,...j->...i", R_cams, t_cams)
    C_new = s * torch.einsum("ij,...j->...i", R, C) + _t(t, like=R)
    R_new = R_cams @ R.T
    t_new = -torch.einsum("...ij,...j->...i", R_new, C_new)
    return R_new, t_new
