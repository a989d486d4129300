"""Essential-matrix estimation, RANSAC and pose recovery on torch tensors.

Port of caliscope_tpu/ops/epipolar.py: fixed-iteration hypothesize-and-
verify with every hypothesis of a RANSAC evaluated in one batch.

- `essential_ransac` — 8-point hypotheses (masked normalized DLT on random
  minimal samples, rank-2 projection), scored by Sampson distance, the
  winner refit on its inliers.
- `recover_pose` — E -> 4 (R, t) candidates, cheirality vote by two-view
  triangulation, batched over candidates.
- `pnp_ransac` — 6-point DLT hypotheses + damped-GN polish on inliers.

Each RANSAC is split into a sampler and a scorer. The JAX package draws its
minimal samples as top_k(gumbel + logits) from threefry keys, which
PyTorch's generator cannot reproduce; the port draws the same kind of
sample (`sample_indices`: Gumbel top-k over the valid rows) from an explicit
`torch.Generator` on the tensors' device seeded with `seed`, and the
scorers (`essential_ransac_scored`, `pnp_ransac_scored`) take the sample
indices, so that the tests can feed both packages the same hypotheses.

Inputs are normalized undistorted coordinates (K = I).
"""

from __future__ import annotations

import torch

from caliscope_tpu_torch.ops.pnp import _det3, projection_dlt, refine_pose_gn
from caliscope_tpu_torch.ops.projection import project_normalized
from caliscope_tpu_torch.ops.triangulate import _eigh_batched, triangulate_dlt


def sample_indices(mask, n_iters: int, k: int, seed: int):
    """(n_iters, k) int64 minimal samples over the rows of `mask` (N,):
    per hypothesis the top k of Gumbel noise plus a -1e9 logit on invalid
    rows, drawn from a torch.Generator on mask's device seeded with `seed`."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(int(seed))
    u = torch.rand((n_iters, mask.shape[0]), generator=gen, device=mask.device, dtype=torch.float64)
    gumbel = -torch.log(-torch.log(u))
    logits = torch.where(mask, 0.0, -1e9).to(torch.float64)
    return torch.topk(gumbel + logits, k, dim=-1).indices


def _eight_point(xa, xb, w):
    """Masked/weighted 8-point algorithm. xa, xb: (..., N, 2) normalized
    coords; w: (..., N) weights. Returns E (..., 3, 3), rank-2 projected."""
    xa1 = torch.cat([xa, torch.ones_like(xa[..., :1])], dim=-1)
    xb1 = torch.cat([xb, torch.ones_like(xb[..., :1])], dim=-1)
    # rows: kron(xb, xa) -> [xb_i * xa_j] flattened, E as 9-vector (row-major)
    A = (xb1[..., :, None] * xa1[..., None, :]).reshape(*xa.shape[:-1], 9)
    A = A * w[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    _, vecs = _eigh_batched(AtA)
    E = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    # rank-2 projection with equal leading singular values
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    S2 = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * S2[..., None, :]) @ Vt


def sampson_distance(E, xa, xb):
    """Squared Sampson distance per correspondence (normalized units)."""
    xa1 = torch.cat([xa, torch.ones_like(xa[..., :1])], dim=-1)
    xb1 = torch.cat([xb, torch.ones_like(xb[..., :1])], dim=-1)
    Ex = torch.einsum("...ij,...nj->...ni", E, xa1)  # (..., N, 3)
    Etxp = torch.einsum("...ji,...nj->...ni", E, xb1)
    num = torch.einsum("...ni,...ni->...n", xb1, Ex) ** 2
    den = Ex[..., 0] ** 2 + Ex[..., 1] ** 2 + Etxp[..., 0] ** 2 + Etxp[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def essential_ransac_scored(xa, xb, mask, threshold: float, idx):
    """Essential-matrix RANSAC on given minimal samples idx (n_iters, 8).
    Returns (E (3,3), inliers (N,) bool, n_inliers)."""
    ones = torch.ones(idx.shape, dtype=xa.dtype, device=xa.device)
    Es = _eight_point(xa[idx], xb[idx], ones)  # (n_iters, 3, 3)
    d2 = sampson_distance(Es, xa[None], xb[None])
    scores = ((d2 < threshold**2) & mask).sum(dim=-1)
    E_best = Es[torch.argmax(scores)]  # the first of equal scores, as jnp.argmax
    inl = (sampson_distance(E_best, xa, xb) < threshold**2) & mask
    # refit on inliers (weighted full 8-point)
    E_refit = _eight_point(xa, xb, inl.to(xa.dtype))
    inl2 = (sampson_distance(E_refit, xa, xb) < threshold**2) & mask
    use_refit = inl2.sum() >= inl.sum()
    E_final = torch.where(use_refit, E_refit, E_best)
    inl_final = torch.where(use_refit, inl2, inl)
    return E_final, inl_final, inl_final.sum()


def essential_ransac(xa, xb, mask, threshold: float, n_iters: int = 256, seed: int = 0):
    """Fixed-iteration batched RANSAC for the essential matrix.

    Args:
        xa, xb: (N, 2) normalized correspondences (padded rows allowed).
        mask:   (N,) validity.
        threshold: inlier gate on sqrt(Sampson) in normalized units.
        n_iters: hypothesis count (all evaluated in one batch).

    Returns (E (3,3), inliers (N,) bool, n_inliers).
    """
    return essential_ransac_scored(xa, xb, mask, threshold, sample_indices(mask, n_iters, 8, seed))


def decompose_essential(E):
    """E -> (R1, R2, t) with ||t|| = 1 (Hartley-Zisserman)."""
    U, _, Vt = torch.linalg.svd(E)
    # ensure proper rotations
    Vt = Vt * torch.where(_det3(U @ Vt) < 0, -1.0, 1.0)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def _cheirality(R, t, xa, xb, mask):
    """Positive-depth mask for poses (..., 3, 3), (..., 3) over masked
    correspondences (N,), and the triangulated points (..., N, 3)."""
    N = xa.shape[0]
    lead = R.shape[:-2]
    P = torch.zeros(*lead, 2, 3, 4, dtype=xa.dtype, device=xa.device)
    P[..., 0, :3, :3] = torch.eye(3, dtype=xa.dtype, device=xa.device)
    P[..., 1, :3, :3] = R
    P[..., 1, :3, 3] = t
    Pb = P[..., None, :, :, :].expand(*lead, N, 2, 3, 4)
    xn = torch.stack([xa, xb], dim=1).expand(*lead, N, 2, 2)
    m2 = mask[:, None].expand(*lead, N, 2)
    X = triangulate_dlt(Pb, xn, m2)  # (..., N, 3)
    za = X[..., 2]
    zb = torch.einsum("...j,...nj->...n", R[..., 2, :], X) + t[..., 2:3]
    return (za > 0) & (zb > 0) & mask, X


def recover_pose(E, xa, xb, mask):
    """Choose the (R, t) candidate with the best cheirality vote.

    Returns (R, t, cheirality_inlier_mask) — mirrors cv2.recoverPose.
    """
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    front, _ = _cheirality(cands_R, cands_t, xa, xb, mask)
    best = torch.argmax(front.sum(dim=-1))
    R_best, t_best = cands_R[best], cands_t[best]
    cheir, _ = _cheirality(R_best, t_best, xa, xb, mask)
    return R_best, t_best, cheir


def _nanmedian(x):
    """Median of the non-NaN entries of a 1-D tensor, averaging the two
    middle values of an even count (numpy's and jnp.nanmedian's rule, where
    torch.nanmedian returns the lower one); NaN when none is left. No host
    synchronisation."""
    v = torch.sort(x).values  # NaN sorts last
    n = (~torch.isnan(x)).sum()
    lo = v[torch.clamp((n - 1) // 2, min=0)]
    hi = v[torch.clamp(n // 2, max=x.numel() - 1)]
    return (lo + hi) / 2


def pnp_ransac_scored(obj_pts, img_xn, mask, threshold: float, idx, gn_iters: int = 10):
    """Robust resection on given minimal samples idx (n_iters, 6).

    Returns (rvec, tvec, inliers (N,), median error over valid rows)."""
    ones = torch.ones(idx.shape, dtype=obj_pts.dtype, device=obj_pts.device)
    rvs, tvs = projection_dlt(obj_pts[idx], img_xn[idx], ones)  # (n_iters, 3) each
    uv = project_normalized(obj_pts[None], rvs[:, None], tvs[:, None])
    err = torch.linalg.vector_norm(uv - img_xn[None], dim=-1)
    best = torch.argmax(((err < threshold) & mask).sum(dim=-1))  # the first of equal scores
    rv0, tv0 = rvs[best], tvs[best]
    uv = project_normalized(obj_pts, rv0, tv0)
    inl = (torch.linalg.vector_norm(uv - img_xn, dim=-1) < threshold) & mask
    theta = refine_pose_gn(obj_pts, img_xn, inl.to(obj_pts.dtype), rv0, tv0, iters=gn_iters)
    rvec, tvec = theta[:3], theta[3:]
    err = torch.linalg.vector_norm(project_normalized(obj_pts, rvec, tvec) - img_xn, dim=-1)
    inl_final = (err < threshold) & mask
    med = _nanmedian(torch.where(mask, err, torch.full_like(err, float("nan"))))
    return rvec, tvec, inl_final, med


def pnp_ransac(obj_pts, img_xn, mask, threshold: float, n_iters: int = 128, seed: int = 0, gn_iters: int = 10):
    """Robust resection: 6-point DLT hypotheses + GN polish on the consensus.

    Returns (rvec, tvec, inliers (N,), median_err over valid rows).
    """
    idx = sample_indices(mask, n_iters, 6, seed)
    return pnp_ransac_scored(obj_pts, img_xn, mask, threshold, idx, gn_iters)

