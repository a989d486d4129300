"""The port's extrinsic coverage analysis (caliscope_tpu_torch.coverage):
the coverage matrix, link quality and structural warnings identical to the
JAX package's on the JAX suite's hand-made rigs
(tests/test_coverage_scale_tasks.py) and on synthetic scenes, carried
across with `convert.image_points`. Host numpy on both sides, so equality
is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from caliscope_tpu import coverage as JC
from caliscope_tpu.observations import ImagePoints as JaxImagePoints
from caliscope_tpu.synthetic.factories import default_ring_scene, sparse_coverage_scene
from caliscope_tpu_torch import convert
from caliscope_tpu_torch import coverage as TC
from test_coverage_scale_tasks import _shared_obs

RIGS = {
    "shared_identity_only": lambda: _shared_obs(
        {0: [(0, 0), (0, 1), (1, 0)], 1: [(0, 0), (0, 1), (1, 0), (2, 5)], 2: [(2, 5), (3, 9)]}
    ),
    "isolated_camera": lambda: _shared_obs({0: [(0, 0), (0, 1)], 1: [(0, 0), (0, 1)], 2: [(5, 7)]}),
    "leaf_few": lambda: _shared_obs(
        {
            0: [(i, 0) for i in range(150)],
            1: [(i, 0) for i in range(150)] + [(200 + i, 1) for i in range(20)],
            2: [(200 + i, 1) for i in range(20)],
        }
    ),
    "leaf_many": lambda: _shared_obs(
        {
            0: [(i, 0) for i in range(150)],
            1: [(i, 0) for i in range(150)] + [(300 + i, 1) for i in range(120)],
            2: [(300 + i, 1) for i in range(120)],
        }
    ),
    "two_cameras": lambda: _shared_obs({0: [(0, 0)], 1: [(0, 0)]}),
    "two_groups_and_a_leaf": lambda: _shared_obs(
        {
            0: [(i, 0) for i in range(60)],
            1: [(i, 0) for i in range(60)],
            4: [(100 + i, 2) for i in range(40)],
            7: [(100 + i, 2) for i in range(40)] + [(200, 3)],
            9: [(200, 3)],
        }
    ),
    "empty": JaxImagePoints.empty,
    "ring_scene": lambda: default_ring_scene(n_cameras=4, n_frames=6).image_points_noisy(),
    "sparse_coverage_scene": lambda: sparse_coverage_scene(n_cameras=6, n_frames=12).image_points_noisy(),
}


def _port_points(jip):
    return convert.image_points({f: getattr(jip, f) for f in convert.IMAGE_POINT_FIELDS})


def _warnings(ws):
    return [(w.severity.value, w.message) for w in ws]


@pytest.mark.parametrize("name", sorted(RIGS))
def test_coverage_and_warnings_match_jax(name):
    jip = RIGS[name]()
    want = JC.analyze_multi_camera_coverage(jip)
    got = TC.analyze_multi_camera_coverage(_port_points(jip))
    np.testing.assert_array_equal(got.pairwise_observations, want.pairwise_observations)
    assert got.pairwise_observations.dtype == want.pairwise_observations.dtype
    assert (got.cam_ids, got.isolated_cameras, got.n_connected_components, got.leaf_cameras) == (
        want.cam_ids, want.isolated_cameras, want.n_connected_components, want.leaf_cameras,
    )
    assert (got.n_cameras, got.has_critical_issues) == (want.n_cameras, want.has_critical_issues)
    for n_cameras in (2, len(want.cam_ids)):
        for min_leaf in (100, 10):
            assert _warnings(TC.detect_structural_warnings(got, n_cameras, min_leaf)) == _warnings(
                JC.detect_structural_warnings(want, n_cameras, min_leaf)
            )


def test_coverage_matrix_on_a_camera_subset_matches_jax():
    jip = RIGS["sparse_coverage_scene"]()
    index = {5: 0, 1: 1, 3: 2}
    np.testing.assert_array_equal(
        TC.compute_coverage_matrix(_port_points(jip), index), JC.compute_coverage_matrix(jip, index)
    )


def test_link_quality_matches_jax():
    for n in (0, 10, 49, 50, 199, 200, 10_000):
        assert TC.classify_link_quality(n).value == JC.classify_link_quality(n).value
    assert (TC.GOOD_OBSERVATION_THRESHOLD, TC.MARGINAL_OBSERVATION_THRESHOLD) == (
        JC.GOOD_OBSERVATION_THRESHOLD, JC.MARGINAL_OBSERVATION_THRESHOLD,
    )
