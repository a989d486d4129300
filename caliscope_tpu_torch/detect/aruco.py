"""ArUco marker detection: the batched device pipeline + host assembly.

Port of caliscope_tpu/detect/aruco.py, which stands in for
cv2.aruco.ArucoDetector.detectMarkers. The device pipeline (plain functions
over a frame stack on one device) runs threshold -> connected components
-> candidate selection -> patch extraction -> quad fitting -> subpixel edge
refinement -> projective bit sampling; the host then matches bit grids
against the dictionary and canonicalizes corner order. Corner convention
matches OpenCV: [TL, TR, BR, BL] of the canonical (rotation-corrected)
marker, pixel coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from caliscope_tpu_torch.detect.ccl import connected_components
from caliscope_tpu_torch.detect.dictionaries import ArucoDictionary, get_dictionary, match_bits
from caliscope_tpu_torch.detect.kernels import (
    adaptive_threshold,
    component_candidates_sorted,
    extract_patches,
    integral_image,
    quad_corners_from_mask,
    refine_quad_edges,
    sample_marker_bits,
)
from caliscope_tpu_torch.device import resolve_device


@dataclass
class MarkerDetections:
    """Per-frame detection results (host side)."""

    ids: np.ndarray  # (M,) marker ids
    corners: np.ndarray  # (M, 4, 2) pixel coords, canonical [TL, TR, BR, BL]
    hamming: np.ndarray  # (M,)

    def __len__(self) -> int:
        return len(self.ids)


def marker_graph(imgs, n_bits: int, k_max: int, patch: int, min_area: int, ccl_iters: int):
    """The marker-candidate graph: (B, H, W) float32 frames on their device
    -> candidate quads + sampled bit grids. Composable into larger device
    programs (the ChArUco tracker runs this and the X-corner graph per
    chunk).

    Connectivity runs at full resolution: pooling the mask before labeling
    bridges the 1-px diagonal contacts of chessboard squares and swallows
    the quiet zones of ~24 px markers on real footage. Labeling is the CUDA
    kernel of detect/ccl.py on CUDA frames; per-component statistics come
    from a sort + segmented scans over a pooled grid
    (component_candidates_sorted), and patches are contiguous windows from
    a pyramid atlas (extract_patches)."""
    # multi-scale threshold union: small radius outlines small markers
    # sharply; the large radius keeps the interiors of big blobs foreground
    integral = integral_image(imgs)
    binary = adaptive_threshold(imgs, radius=10, c=7.0, integral=integral) | adaptive_threshold(
        imgs, radius=26, c=7.0, integral=integral
    )
    labels = connected_components(binary.contiguous(), n_iters=ccl_iters)
    sel, areas, bbox, valid = component_candidates_sorted(binary, labels, k_max, float(min_area))
    gray, mask, origin, scale = extract_patches(imgs, binary, labels, sel, bbox, patch)
    quads0 = quad_corners_from_mask(mask)
    quads = refine_quad_edges(gray, quads0)
    cells = sample_marker_bits(gray, quads, n_bits)
    # map to image coordinates
    quads_img = origin[..., None, :] + quads * scale[..., None, :]
    # quad geometric sanity: signed area (shoelace) well above zero
    x = quads[..., 0]
    y = quads[..., 1]
    area2 = torch.abs(torch.sum(x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y, dim=-1)) * 0.5
    valid = valid & (area2 > float(min_area) * 0.3)
    return quads_img, cells, valid, areas


def _canonical_roll(corners: np.ndarray, rotation: int) -> np.ndarray:
    """Reorder sampled-grid corners so index 0 is the canonical marker's TL.

    match_bits compares the sampled grid against rot90(dict, k=rotation), so
    dict == rot90(sampled, k=-rotation); the canonical TL sits at sampled
    corner index (4 - rotation) % 4 — a BACKWARD roll of the corner list.
    (The sign only matters for rotation 1/3; synthetic near-axis renders all
    hit rotation 0, which is why real 90/270-degree views exposed this.)
    """
    return np.roll(corners, rotation, axis=0)


def detect_markers(
    images: np.ndarray,
    dictionary: str | ArucoDictionary,
    *,
    k_max: int = 64,
    # patch 96: edge refinement runs in patch coordinates, so large markers
    # (200+ px) need the resolution to hold sub-0.5 px corners
    patch: int = 96,
    min_area: int = 49,
    # 4 row/col propagation rounds: marker blobs are convex, which converges
    # in 2-3 rounds; more only merges snake-like background clutter that the
    # border and dictionary gates reject anyway
    ccl_iters: int = 4,
    border_frac: float = 0.80,
    device=None,
) -> list[MarkerDetections]:
    """Detect ArUco markers in a (B, H, W) gray frame stack.

    Returns one MarkerDetections per frame. The heavy work runs over the
    full stack on the CUDA device unless `device` names another (raises
    without one); one device->host copy brings the candidates back.
    """
    dev = resolve_device(device)
    d = get_dictionary(dictionary) if isinstance(dictionary, str) else dictionary
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    # Intensity contract: the device graph (threshold offsets, the packed
    # patch atlas's 8-bit gray field) assumes a 0..255 scale. Normalized
    # float frames (0..1) would silently lose all contrast in the atlas, so
    # rescale them here at the host boundary.
    if np.issubdtype(images.dtype, np.floating) and images.size and float(np.nanmax(images)) <= 1.5:
        images = images * 255.0
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev).to(torch.float32)
    quads, cells, valid, _areas = marker_graph(imgs, d.marker_size, k_max, patch, min_area, ccl_iters)
    K = quads.shape[1]
    packed = torch.cat(
        [quads.reshape(-1, K * 8), cells.reshape(quads.shape[0], -1), valid.to(torch.float32)], dim=1
    ).cpu().numpy()
    nc = d.marker_size + 2
    quads_h = packed[:, : K * 8].reshape(-1, K, 4, 2)
    cells_h = packed[:, K * 8 : K * 8 + K * nc * nc].reshape(-1, K, nc, nc)
    valid_h = packed[:, K * 8 + K * nc * nc :] > 0.5
    return assemble_marker_detections(quads_h, cells_h, valid_h, d, border_frac)


def assemble_marker_detections(
    quads: np.ndarray, cells: np.ndarray, valid: np.ndarray, d: ArucoDictionary, border_frac: float = 0.80
) -> list[MarkerDetections]:
    """Host-side decode of the device program's candidate outputs: per-
    candidate bit threshold, border blackness + contrast gates, dictionary
    match, canonical corner roll, duplicate-id dedupe by hamming."""
    B = quads.shape[0]
    n = d.marker_size
    out: list[MarkerDetections] = []
    for b in range(B):
        ids_f, corners_f, ham_f = [], [], []
        v = valid[b]
        if v.any():
            # per-candidate bit threshold: midpoint of cell-mean extremes
            c = cells[b]  # (K, n+2, n+2)
            lo = c.reshape(len(c), -1).min(axis=1)
            hi = c.reshape(len(c), -1).max(axis=1)
            thr = (lo + hi) * 0.5
            bits = c > thr[:, None, None]
            border = np.concatenate(
                [
                    bits[:, 0, :], bits[:, -1, :],
                    bits[:, 1:-1, 0], bits[:, 1:-1, -1],
                ],
                axis=1,
            )
            border_ok = (1.0 - border.mean(axis=1)) >= border_frac  # border mostly black
            contrast_ok = (hi - lo) > 20.0
            inner = bits[:, 1:-1, 1:-1].astype(np.float32)
            ids, rots, ham = match_bits(inner, d)
            keep = v & border_ok & contrast_ok & (ids >= 0)
            for k in np.where(keep)[0]:
                ids_f.append(int(ids[k]))
                corners_f.append(_canonical_roll(quads[b, k], int(rots[k])))
                ham_f.append(int(ham[k]))
        if ids_f:
            ids_a = np.asarray(ids_f)
            ham_a = np.asarray(ham_f)
            corners_a = np.asarray(corners_f)
            # dedupe repeated ids: keep lowest hamming
            keep_rows = []
            for mid in np.unique(ids_a):
                rows = np.where(ids_a == mid)[0]
                keep_rows.append(rows[np.argmin(ham_a[rows])])
            keep_rows = np.asarray(sorted(keep_rows))
            out.append(MarkerDetections(ids_a[keep_rows], corners_a[keep_rows], ham_a[keep_rows]))
        else:
            out.append(MarkerDetections(np.zeros(0, np.int64), np.zeros((0, 4, 2)), np.zeros(0, np.int64)))
    return out
