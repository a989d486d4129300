"""Shared inputs of the port's bundle-adjustment tests: a small ring rig as
numpy arrays, its sparse rows with repeated (point, camera) pairs, and
distance-constraint rows, made from a seed."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def ring_rig(rng, C=4, P=120, fill=0.7):
    """A ring rig with noisy observations of ~`fill` of the (point, camera)
    grid, perturbed starting cameras and points, one fisheye camera:
    (cam_idx, pt_idx, uv, K0, dist0, fisheye, cam9_0, X0, X_true)."""
    from caliscope_tpu.ops.lie import so3_log
    from caliscope_tpu.ops.reprojection import project_with_block

    K0, dist0, Rs, ts = [], [], [], []
    for i in range(C):
        a = 2 * np.pi * i / C
        c = np.array([2.5 * np.cos(a), 2.5 * np.sin(a), 0.8])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
        K0.append([[800.0, 0, 640], [0, 800.0, 360], [0, 0, 1]])
        dist0.append([0.05, -0.02, 0.001, 0.0005, 0.0] if i != 1 else [0.02, -0.01, 0.003, -0.001, 0.0])
    K0, dist0, fe = np.asarray(K0), np.asarray(dist0), np.arange(C) == 1
    X = rng.uniform(-0.6, 0.6, size=(P, 3))
    grid = rng.uniform(size=(P, C)) < fill
    grid[:, :2] = True
    pt_idx, cam_idx = np.nonzero(grid)
    cam9 = np.concatenate(
        [np.asarray(so3_log(jnp.asarray(np.stack(Rs)))), np.asarray(ts), np.ones((C, 1)), dist0[:, :2]], axis=1
    )
    uv = np.asarray(
        project_with_block(
            jnp.asarray(X[pt_idx]), jnp.asarray(cam9[cam_idx]), jnp.asarray(K0[cam_idx]),
            jnp.asarray(dist0[cam_idx]), jnp.asarray(fe[cam_idx]),
        )
    ) + rng.normal(scale=0.5, size=(len(pt_idx), 2))
    cam9_0 = cam9 + np.concatenate([rng.normal(scale=0.01, size=(C, 6)), np.zeros((C, 3))], axis=1)
    X0 = X + rng.normal(scale=0.01, size=X.shape)
    return cam_idx, pt_idx, uv, K0, dist0, fe, cam9_0, X0, X


def sparse_rows(rng, rig, n_static=3, repeats=5, n_pad=7):
    """The rig's observation rows shuffled, with `repeats` extra noisy
    observations of every (point, camera) pair of the first `n_static`
    points (a static marker's corners seen in many frames: duplicate pairs),
    and `n_pad` masked padding rows pointing at the last point:
    (cam_idx, pt_idx, uv, obs_mask)."""
    cam_idx, pt_idx, uv = rig[0], rig[1], rig[2]
    dup = np.isin(pt_idx, np.arange(n_static))
    extra = np.repeat(np.nonzero(dup)[0], repeats)
    cam = np.concatenate([cam_idx, cam_idx[extra], np.zeros(n_pad, np.int64)])
    pt = np.concatenate([pt_idx, pt_idx[extra], np.full(n_pad, rig[7].shape[0] - 1)])
    xy = np.concatenate([uv, uv[extra] + rng.normal(scale=0.3, size=(len(extra), 2)), np.zeros((n_pad, 2))])
    mask = np.arange(len(cam)) < len(cam) - n_pad
    order = rng.permutation(len(cam))
    return cam[order], pt[order], xy[order], mask[order]


def constraint_rows(rng, X_true, Q=40, f=800.0, pixel_sigma=1.0, sigma=0.002):
    """Q distance rows between random pairs of points at their true
    distance (one in four a centroid row over four points at 0.25 each),
    weighted as CaptureVolume.optimize weighs them:
    (pa_idx, pa_w, pb_idx, pb_w, target, weight)."""
    P = X_true.shape[0]
    pa_idx = np.zeros((Q, 4), np.int32)
    pb_idx = np.zeros((Q, 4), np.int32)
    pa_w = np.zeros((Q, 4))
    pb_w = np.zeros((Q, 4))
    for q in range(Q):
        if q % 4 == 3:
            pa_idx[q], pb_idx[q] = rng.choice(P, 4, replace=False), rng.choice(P, 4, replace=False)
            pa_w[q] = pb_w[q] = 0.25
        else:
            a, b = rng.choice(P, 2, replace=False)
            pa_idx[q], pb_idx[q] = a, b
            pa_w[q, 0] = pb_w[q, 0] = 1.0
    pa = np.einsum("qk,qkj->qj", pa_w, X_true[pa_idx])
    pb = np.einsum("qk,qkj->qj", pb_w, X_true[pb_idx])
    target = np.linalg.norm(pa - pb, axis=1)
    weight = np.full(Q, (pixel_sigma / f) / sigma)
    return pa_idx, pa_w, pb_idx, pb_w, target, weight


def jax_counted(fn, *args, **static):
    """fn(*args, **static) under jax.jit with its lax.while_loop counted:
    (fn's outputs, the final iteration counter of the last while-loop it
    ran, as an int). The JAX package's CG solvers keep their count inside
    the loop state; this reads it out for the port's tests."""
    import jax

    original = jax.lax.while_loop
    stash = []

    def counting(cond, body, init):
        out = original(cond, body, init)
        stash.append(out[-1])
        return out

    jax.lax.while_loop = counting
    try:
        out, count = jax.jit(lambda *a: (fn(*a, **static), stash[-1]))(*args)
    finally:
        jax.lax.while_loop = original
    return out, int(count)

