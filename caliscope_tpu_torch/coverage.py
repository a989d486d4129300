"""Multi-camera coverage analysis + structural warnings.

Host-only copy of caliscope_tpu/coverage.py. Reference
src/caliscope/core/coverage_analysis.py (compute_coverage_matrix:91, connected components :129, leaf cameras :166,
LinkQuality:26, ExtrinsicCoverageReport:59, detect_structural_warnings:250).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from caliscope_tpu_torch.observations import ImagePoints


class LinkQuality(Enum):
    GOOD = "good"  # >= 200 shared observations
    MARGINAL = "marginal"  # 50-200
    INSUFFICIENT = "insufficient"  # < 50


GOOD_OBSERVATION_THRESHOLD = 200
MARGINAL_OBSERVATION_THRESHOLD = 50


class WarningSeverity(Enum):
    CRITICAL = "critical"
    WARNING = "warning"
    INFO = "info"


@dataclass(frozen=True)
class StructuralWarning:
    severity: WarningSeverity
    message: str


@dataclass(frozen=True)
class ExtrinsicCoverageReport:
    pairwise_observations: np.ndarray  # (C,C) symmetric shared-obs counts
    cam_ids: tuple[int, ...]
    isolated_cameras: list[int]
    n_connected_components: int
    leaf_cameras: list[tuple[int, int, int]]  # (cam_id, connected_to, obs_count)

    @property
    def n_cameras(self) -> int:
        return len(self.pairwise_observations)

    @property
    def has_critical_issues(self) -> bool:
        return bool(self.isolated_cameras) or self.n_connected_components > 1


def compute_coverage_matrix(image_points: ImagePoints, cam_id_to_index: dict[int, int]) -> np.ndarray:
    """(C,C) count of shared (sync, obj, kp) observations per camera pair —
    one vectorized pass (bincount over pair codes), no per-point loop."""
    C = len(cam_id_to_index)
    mat = np.zeros((C, C), np.int64)
    if len(image_points) == 0 or C == 0:
        return mat
    known = np.isin(image_points.cam_id, list(cam_id_to_index.keys()))
    ip = image_points.select(known)
    pt_idx, _ = ip.point_index()
    cam_idx = np.array([cam_id_to_index[int(c)] for c in ip.cam_id])
    order = np.argsort(pt_idx, kind="stable")
    p_sorted, c_sorted = pt_idx[order], cam_idx[order]
    starts = np.searchsorted(p_sorted, np.unique(p_sorted))
    bounds = np.append(starts, len(p_sorted))
    for s, e in zip(bounds[:-1], bounds[1:]):
        cams = np.unique(c_sorted[s:e])
        mat[np.ix_(cams, cams)] += 1
    return mat


def _connected_components(adjacency: np.ndarray) -> list[set[int]]:
    n = len(adjacency)
    seen: set[int] = set()
    comps = []
    for i in range(n):
        if i in seen:
            continue
        stack, comp = [i], set()
        while stack:
            v = stack.pop()
            if v in comp:
                continue
            comp.add(v)
            stack.extend(j for j in range(n) if adjacency[v, j] > 0 and j not in comp and j != v)
        seen |= comp
        comps.append(comp)
    return comps


def _leaf_cameras(mat: np.ndarray, index_to_cam_id: dict[int, int]) -> list[tuple[int, int, int]]:
    out = []
    n = len(mat)
    for i in range(n):
        links = [j for j in range(n) if j != i and mat[i, j] > 0]
        if len(links) == 1:
            j = links[0]
            out.append((index_to_cam_id[i], index_to_cam_id[j], int(mat[i, j])))
    return out


def analyze_multi_camera_coverage(image_points: ImagePoints) -> ExtrinsicCoverageReport:
    cam_ids = sorted(int(c) for c in np.unique(image_points.cam_id)) if len(image_points) else []
    idx = {cid: i for i, cid in enumerate(cam_ids)}
    rev = {i: cid for cid, i in idx.items()}
    mat = compute_coverage_matrix(image_points, idx)
    isolated = [rev[i] for i in range(len(cam_ids)) if not any(mat[i, j] > 0 for j in range(len(cam_ids)) if j != i)]
    comps = _connected_components(mat)
    leaves = _leaf_cameras(mat, rev)
    return ExtrinsicCoverageReport(
        pairwise_observations=mat,
        cam_ids=tuple(cam_ids),
        isolated_cameras=isolated,
        n_connected_components=len(comps),
        leaf_cameras=leaves,
    )


def classify_link_quality(observation_count: int) -> LinkQuality:
    if observation_count >= GOOD_OBSERVATION_THRESHOLD:
        return LinkQuality.GOOD
    if observation_count >= MARGINAL_OBSERVATION_THRESHOLD:
        return LinkQuality.MARGINAL
    return LinkQuality.INSUFFICIENT


def detect_structural_warnings(
    report: ExtrinsicCoverageReport,
    n_cameras: int,
    min_leaf_observations: int = 100,
) -> list[StructuralWarning]:
    warnings: list[StructuralWarning] = []
    for cam_id in report.isolated_cameras:
        warnings.append(
            StructuralWarning(
                WarningSeverity.CRITICAL,
                f"Camera C{cam_id} never sees the target at the same instant as any other camera",
            )
        )
    if report.n_connected_components > 1:
        warnings.append(
            StructuralWarning(
                WarningSeverity.CRITICAL,
                f"The rig splits into {report.n_connected_components} camera groups with no shared views between them",
            )
        )
    if n_cameras > 2:
        for cam_id, connected_to, obs_count in report.leaf_cameras:
            if obs_count < min_leaf_observations:
                warnings.append(
                    StructuralWarning(
                        WarningSeverity.WARNING,
                        f"Camera C{cam_id} links to the rig solely via C{connected_to}, on just {obs_count} shared observations",
                    )
                )
            else:
                warnings.append(
                    StructuralWarning(
                        WarningSeverity.INFO,
                        f"Camera C{cam_id} reaches the rest of the rig only via C{connected_to}",
                    )
                )
    order = {WarningSeverity.CRITICAL: 0, WarningSeverity.WARNING: 1, WarningSeverity.INFO: 2}
    warnings.sort(key=lambda w: order[w.severity])
    return warnings
