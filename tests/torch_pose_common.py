"""Shared helpers of the port's bootstrap and pipeline tests
(tests/test_torch_{pnp,epipolar,pose_network,pipeline}.py): the JAX
package's RANSAC samples for the port's scorers, and the JAX package's
state carried across to the port as plain numpy arrays."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caliscope_tpu_torch import convert


def jax_sample_indices(mask, n_iters: int, k: int, seed: int):
    """The minimal samples the JAX package's RANSACs draw (threefry keys
    split from PRNGKey(seed), top_k of Gumbel noise plus a -1e9 logit on
    invalid rows; caliscope_tpu/ops/epipolar.py), for a torch mask, as the
    port's sampler returns them: (n_iters, k) int64 on mask's device."""
    m = jnp.asarray(mask.cpu().numpy())
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iters)
    idx = jax.vmap(lambda key: jax.lax.top_k(jax.random.gumbel(key, (m.shape[0],)) + logits, k)[1])(keys)
    return torch.as_tensor(np.array(idx), dtype=torch.int64, device=mask.device)


def port_cameras(jax_cameras):
    return convert.camera_array(
        {cid: {f: getattr(c, f) for f in convert.CAMERA_FIELDS} for cid, c in jax_cameras.cameras.items()}
    )


def port_points(jax_points):
    return convert.image_points({f: getattr(jax_points, f) for f in convert.IMAGE_POINT_FIELDS})


def port_world(jax_world):
    return convert.world_points({f: getattr(jax_world, f) for f in convert.WORLD_POINT_FIELDS})


def network_pairs(jax_network):
    """A JAX PairedPoseNetwork's pairs as plain numpy dicts."""
    return {
        key: {f: np.asarray(getattr(sp, f)) if f in ("rotation", "translation") else getattr(sp, f)
              for f in convert.STEREO_PAIR_FIELDS}
        for key, sp in jax_network.pairs.items()
    }


def assert_same_rig(port_cameras_, jax_cameras_, atol):
    """The same cameras posed (and unposed), rotations and translations
    within atol."""
    assert sorted(port_cameras_.cameras) == sorted(jax_cameras_.cameras)
    for cid, jc in jax_cameras_.cameras.items():
        tc = port_cameras_.cameras[cid]
        assert tc.is_posed == jc.is_posed, cid
        if jc.is_posed:
            np.testing.assert_allclose(tc.rotation, jc.rotation, atol=atol, rtol=0)
            np.testing.assert_allclose(tc.translation, jc.translation, atol=atol, rtol=0)


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test: the port's small CPU ops
    (one frame, one RANSAC at a time) gain nothing from a thread pool, and
    under xdist's parallel workers a pool per worker spins against the
    others. The worker's setting is restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

