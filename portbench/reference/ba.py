"""Plain NumPy bundle adjustment: the reference of the calibrate cells.

It solves the pipeline's bundle-adjustment problems again: reprojection
residuals through Brown cameras whose intrinsics stay fixed, each divided
by the camera's focal length (the residual units of the port's solver),
under a linear or a soft-L1 loss (scipy's convention, element by element:
cost 0.5 f^2 sum 2 (sqrt(1 + r^2 / f^2) - 1), Gauss-Newton weighted by
rho'), and, for a constrained run, the board's distance rows
(|Xa - Xb| - d) * (1 / f_median) / sigma under a linear loss. Levenberg-Marquardt with
the Schur complement onto the cameras; points are grouped by sync index,
so a frame's distance rows couple only its own points. Jacobians are
analytic; a camera's rotation is updated as R <- exp(w) R.

`round_to` names the precision the arithmetic keeps: None for float64,
"bfloat16" for the control, which rounds the inputs, every residual,
Jacobian, normal-equation block, step and the state to bfloat16 (the
small linear solves then run in float64 on the rounded blocks).

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def bf16(x):
    """`x` rounded to the nearest bfloat16 (ties to even), as float64."""
    a = np.asarray(x, np.float64).astype(np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def rodrigues(rv):
    """(..., 3) rotation vectors -> (..., 3, 3) rotation matrices."""
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = rv / np.maximum(np.linalg.norm(rv, axis=-1, keepdims=True), 1e-300)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K[..., 1, 0], K[..., 2, 0], K[..., 2, 1] = k[..., 2], -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def project(X, R, t, K, dist):
    """Brown (k1, k2, p1, p2, k3) projection: X (M,3), R (M,3,3), t (M,3),
    K (M,3,3), dist (M,5) -> (M,2) pixels."""
    xc = np.einsum("mij,mj->mi", R, X) + t
    x, y = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
    k1, k2, p1, p2, k3 = dist.T
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * K[:, 0, 0] + K[:, 0, 2], yd * K[:, 1, 1] + K[:, 1, 2]], 1)


def _segsum(idx, vals, n):
    """Sums of the rows of `vals` (M, ...) by `idx` (M,) into (n, ...)."""
    flat = vals.reshape(len(vals), -1)
    out = np.stack([np.bincount(idx, weights=flat[:, j], minlength=n) for j in range(flat.shape[1])], 1)
    return out.reshape((n,) + vals.shape[1:])


class Problem:
    """cam (M,) and pt (M,) indices of the observations, uv (M,2) pixels, K
    (C,3,3), dist (C,5), group (P,) the sync index slot of each point, and
    optionally constraint rows (a (Q,), b (Q,), target (Q,), weight (Q,)).
    `loss` is "linear" or "soft_l1" with the inlier scale `f_scale` in
    residual units."""

    def __init__(self, cam, pt, uv, K, dist, group, constraints=None, round_to=None, loss="linear", f_scale=1.0):
        if loss not in ("linear", "soft_l1"):
            raise ValueError(f"unknown loss {loss!r}")
        self.loss, self.f_scale = loss, f_scale
        self.q = bf16 if round_to == "bfloat16" else (lambda x: x)
        self.cam, self.pt = np.asarray(cam), np.asarray(pt)
        self.uv = self.q(uv)
        self.K, self.dist = K, dist
        self.Ko, self.do = K[self.cam], dist[self.cam]
        self.ifx = self.q(1.0 / K[self.cam, 0, 0])
        self.C, self.P = len(K), len(group)
        # points by group: slot (P,) within the group, groups (G,)
        self.group = np.asarray(group)
        order = np.argsort(self.group, kind="stable")
        gid, start, counts = np.unique(self.group[order], return_index=True, return_counts=True)
        self.G, self.n = len(gid), int(counts.max())
        self.gindex = np.searchsorted(gid, self.group)
        slot = np.empty(self.P, np.int64)
        slot[order] = np.arange(self.P) - np.repeat(start, counts)
        self.slot = slot
        if len(np.unique(self.cam * self.P + self.pt)) != len(self.cam):
            raise ValueError("the reference takes one observation a (camera, point) pair")
        self.con = None
        if constraints is not None and len(constraints[0]):
            a, b, target, weight = (np.asarray(v) for v in constraints)
            if np.any(self.group[a] != self.group[b]):
                raise ValueError("a distance row joins points of two groups")
            self.con = (a, b, self.q(target), self.q(weight))

    # ---- residuals -----------------------------------------------------------
    def obs_residuals(self, R, t, X):
        r = (project(X[self.pt], R[self.cam], t[self.cam], self.Ko, self.do) - self.uv) * self.ifx[:, None]
        return self.q(r)

    def con_residuals(self, X):
        a, b, target, weight = self.con
        d = np.linalg.norm(X[a] - X[b], axis=1)
        return self.q((d - target) * weight)

    def _robust(self, r):
        """(cost, weights rho' (M,2)) of the observation residuals r (M,2)."""
        if self.loss == "linear":
            return 0.5 * np.sum(r**2), np.ones_like(r)
        z = r**2 / self.f_scale**2
        return 0.5 * self.f_scale**2 * np.sum(2.0 * (np.sqrt(1.0 + z) - 1.0)), self.q(1.0 / np.sqrt(1.0 + z))

    def cost(self, R, t, X):
        c = self._robust(self.obs_residuals(R, t, X))[0]
        if self.con is not None:
            c += 0.5 * np.sum(self.con_residuals(X) ** 2)
        return c

    # ---- normal equations ----------------------------------------------------
    def _jacobians(self, R, t, X):
        """(r (M,2), Jc (M,2,6), Jp (M,2,3)): the analytic Jacobians of the
        residuals in a camera's rotation (R <- exp(w) R), its translation and
        the point."""
        r = self.obs_residuals(R, t, X)
        Rc = R[self.cam]
        RX = np.einsum("mij,mj->mi", Rc, X[self.pt])
        xc = RX + t[self.cam]
        z = xc[:, 2]
        x, y = xc[:, 0] / z, xc[:, 1] / z
        k1, k2, p1, p2, k3 = self.do.T
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dR = k1 + r2 * (2 * k2 + 3 * k3 * r2)
        a = radial + 2 * x * x * dR + 2 * p1 * y + 6 * p2 * x
        b = 2 * x * y * dR + 2 * p1 * x + 2 * p2 * y
        c = 2 * x * y * dR + 2 * p1 * x + 2 * p2 * y
        d = radial + 2 * y * y * dR + 6 * p1 * y + 2 * p2 * x
        fx, fy = self.Ko[:, 0, 0] * self.ifx, self.Ko[:, 1, 1] * self.ifx
        J = np.zeros((len(r), 2, 3))  # d r / d xc
        J[:, 0, 0], J[:, 0, 1], J[:, 0, 2] = fx * a / z, fx * b / z, -fx * (a * x + b * y) / z
        J[:, 1, 0], J[:, 1, 1], J[:, 1, 2] = fy * c / z, fy * d / z, -fy * (c * x + d * y) / z
        skew = np.zeros((len(r), 3, 3))  # d xc / d w = -[RX]x
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = RX[:, 2], -RX[:, 1], RX[:, 0]
        skew[:, 1, 0], skew[:, 2, 0], skew[:, 2, 1] = -RX[:, 2], RX[:, 1], -RX[:, 0]
        Jc = np.concatenate([J @ skew, J], axis=2)
        return r, self.q(Jc), self.q(J @ Rc)

    def _system(self, R, t, X):
        q = self.q
        r, Jc, Jp = self._jacobians(R, t, X)
        # the loss's weights as a square-root scaling of the rows
        sw = np.sqrt(self._robust(r)[1])
        r, Jc, Jp = q(r * sw), q(Jc * sw[:, :, None]), q(Jp * sw[:, :, None])
        C, G, n = self.C, self.G, self.n
        Jct = Jc.transpose(0, 2, 1)
        U = q(_segsum(self.cam, Jct @ Jc, C))  # (C,6,6)
        gc = q(_segsum(self.cam, (Jct @ r[:, :, None])[:, :, 0], C))  # (C,6)
        Jpt = Jp.transpose(0, 2, 1)
        V = np.zeros((G, n, 3, n, 3))
        V[self.gindex, self.slot, :, self.slot, :] = q(_segsum(self.pt, Jpt @ Jp, self.P))
        gp = np.zeros((G, n, 3))
        gp[self.gindex, self.slot] = q(_segsum(self.pt, (Jpt @ r[:, :, None])[:, :, 0], self.P))
        W = np.zeros((G, C, 6, n, 3))
        W[self.gindex[self.pt], self.cam, :, self.slot[self.pt], :] = q(Jct @ Jp)
        if self.con is not None:
            a, b, _target, weight = self.con
            rc = self.con_residuals(X)
            diff = X[a] - X[b]
            u = diff / np.linalg.norm(diff, axis=1, keepdims=True)
            Ja = q(weight[:, None] * u)  # d rc / d Xa; d rc / d Xb = -Ja
            g, sa, sb = self.gindex[a], self.slot[a], self.slot[b]
            outer = q(Ja[:, :, None] * Ja[:, None, :])
            for s1, s2, sign in ((sa, sa, 1), (sb, sb, 1), (sa, sb, -1), (sb, sa, -1)):
                np.add.at(V, (g, s1, slice(None), s2, slice(None)), sign * outer)
            np.add.at(gp, (g, sa), Ja * rc[:, None])
            np.add.at(gp, (g, sb), -Ja * rc[:, None])
        # padding slots of short groups: identity, so they solve to 0
        filled = np.zeros((G, n), bool)
        filled[self.gindex, self.slot] = True
        ii = np.nonzero(~filled)
        for k in range(3):
            V[ii[0], ii[1], k, ii[1], k] = 1.0
        return U, gc, V.reshape(G, 3 * n, 3 * n), gp.reshape(G, 3 * n), W.reshape(G, 6 * C, 3 * n)

    def step(self, system, lam):
        """(camera step (C,6), point step (P,3)) of the damped system."""
        q = self.q
        U, gc, V, gp, W = system
        C, G = self.C, self.G
        Vd = V + lam * np.einsum("gii->gi", V)[:, :, None] * np.eye(V.shape[1])
        Vinv = q(np.linalg.inv(Vd))
        Y = q(W @ Vinv)  # (G, 6C, 3n)
        S = np.zeros((6 * C, 6 * C))
        for c in range(C):
            S[6 * c : 6 * c + 6, 6 * c : 6 * c + 6] = U[c] * (1 + lam * np.eye(6))
        YW = Y.transpose(1, 0, 2).reshape(6 * C, -1) @ W.transpose(1, 0, 2).reshape(6 * C, -1).T
        S = q(S - q(YW))
        rhs = q(-gc.reshape(-1) + Y.transpose(1, 0, 2).reshape(6 * C, -1) @ gp.reshape(-1))
        dc = q(np.linalg.solve(S, rhs))
        dp = q((Vinv @ (-gp - (W.transpose(0, 2, 1) @ dc))[:, :, None])[:, :, 0])
        dp = dp.reshape(G, self.n, 3)[self.gindex, self.slot]
        return dc.reshape(C, 6), dp

    def solve(self, R, t, X, max_iter=50, ftol=1e-12):
        """Levenberg-Marquardt from (R (C,3,3) world->camera, t (C,3), X
        (P,3)). Returns (R, t, X, cost, iterations)."""
        q = self.q
        R, t, X = q(R), q(t), q(X)
        cost, lam, it = self.cost(R, t, X), 1e-6, 0
        for it in range(1, max_iter + 1):
            system = self._system(R, t, X)
            for _ in range(12):
                dc, dp = self.step(system, lam)
                R2, t2, X2 = q(rodrigues(dc[:, :3]) @ R), q(t + dc[:, 3:]), q(X + dp)
                cost2 = self.cost(R2, t2, X2)
                if cost2 < cost:
                    break
                lam *= 10
            else:
                return R, t, X, cost, it
            done = (cost - cost2) <= ftol * cost
            R, t, X, cost, lam = R2, t2, X2, cost2, max(lam * 0.1, 1e-12)
            if done:
                break
        return R, t, X, cost, it


def umeyama(src, dst, with_scale):
    """(s, R, t) minimising |s R src + t - dst|^2 over the rows."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(a * a, 1)) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def rig_gaps(R_a, t_a, X_a, R_b, t_b, X_b, with_scale):
    """Rig a moved onto rig b by the similarity (or rigid motion) that best
    maps a's camera centres and points onto b's. Returns (max centre gap,
    max rotation gap in degrees, RMS point gap), lengths in b's units."""
    ca = -np.einsum("cji,cj->ci", R_a, t_a)
    cb = -np.einsum("cji,cj->ci", R_b, t_b)
    s, Rs, ts = umeyama(np.vstack([ca, X_a]), np.vstack([cb, X_b]), with_scale)
    ca2, Xa2 = s * ca @ Rs.T + ts, s * X_a @ Rs.T + ts
    Ra2 = R_a @ Rs.T  # world->camera after the move
    rel = np.einsum("cij,ckj->cik", Ra2, R_b)
    # the angle from the skew part (|R - R^T| = 2 sqrt(2) sin angle): exact for small angles, where the trace's is not
    skew = np.linalg.norm(rel - np.swapaxes(rel, 1, 2), axis=(1, 2)) / (2 * np.sqrt(2))
    ang = np.degrees(np.where(np.trace(rel, axis1=1, axis2=2) >= 1, np.arcsin(np.clip(skew, 0, 1)),
                              np.pi - np.arcsin(np.clip(skew, 0, 1))))
    return (float(np.max(np.linalg.norm(ca2 - cb, axis=1))), float(np.max(ang)),
            float(np.sqrt(np.mean(np.sum((Xa2 - X_b) ** 2, 1)))))
