"""ChArUco corner tracker: markers -> board homography -> X-corner snap.

Port of caliscope_tpu/trackers/charuco_tracker.py. Corner identity
(object_id 0, keypoint_id = chessboard corner index), mirror detection with
a per-camera hint cache, two-sided identity split (back face = object_id 1
at obj_loc z = +thickness).

Pipeline (in place of cv2.aruco.CharucoDetector.detectBoard + cornerSubPix):
1. detect ArUco markers (detect/aruco.py::marker_graph on the device);
2. fit the board->image homography from decoded marker corners (the board is
   planar, so one homography is exact);
3. project expected chessboard corners, snap each to the nearest detected
   X-corner (detect/corners.py response + NMS + saddle subpixel);
4. unmatched expected corners are simply not emitted (partial boards fine).

The device program runs in float32 on the tracker's device: the CUDA device
unless `device` names another (it raises without one). On CUDA frames its
labeling, ring response and both window gathers are the hand-written
kernels of csrc/ccl.cu, csrc/corner_response.cu and csrc/extract_windows.cu.

What the reference has and this port drops, and why. The reference ran its
device behind a slow remote link, so it fetched chunk results on a
background thread and through a two-thread pool, concatenated up to three
chunks on the device to pay one round trip, and padded a short last chunk
to reuse a compiled program. CUDA launches are asynchronous and PyTorch
runs eagerly: here every chunk is enqueued on the stream first, each
chunk's outputs then come to the host in one packed copy as the consumer
asks for them, and a short last chunk runs at its own size. For the same
reason `detect_scale="auto"` and `upload_bits="auto"` resolve to full
resolution and 8-bit uploads on both devices (the reference's choice on
its CPU backend); the coarse first pass (`detect_scale` 2 or 4, with the
full-resolution host polish and the quality-gated retry) and the 4-bit
packed upload remain as explicit options, and with "auto" fixed the
reference's per-camera coarse-scale hint has nothing to adapt and is not
carried over.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from caliscope_tpu_torch.detect.aruco import assemble_marker_detections, detect_markers, marker_graph
from caliscope_tpu_torch.detect.corners import detect_x_corners_device, xcorner_graph
from caliscope_tpu_torch.detect.dictionaries import get_dictionary
from caliscope_tpu_torch.detect.ring import PAD
from caliscope_tpu_torch.device import resolve_device
from caliscope_tpu_torch.tracing import span
from caliscope_tpu_torch.packets import PixelFormat, PointPacket
from caliscope_tpu_torch.targets.charuco import Charuco
from caliscope_tpu_torch.tracker import Tracker

logger = logging.getLogger(__name__)

MIN_MARKERS_FOR_BOARD = 1
X_CORNER_KMAX = 256
MARKER_KMAX = 64
MARKER_PATCH = 96
CCL_ITERS = 4
_RUN_CHUNK = 8  # frames per device dispatch in _run_stack_chunks


def _charuco_device_program(
    images,
    n_bits: int,
    k_max: int,
    patch: int,
    min_area: int,
    ccl_iters: int,
    x_kmax: int,
    packed4: bool = False,
):
    """Markers + X-corners for a chunk of frames already on the device,
    as one packed (B, N) float32 tensor.

    images: (B, H, W) uint8 or float32 gray in 0..255; the cast to float32
    happens on the device, so uint8 frames upload at a quarter of the bytes.

    packed4: the input is (B, H, W // 2) uint8 holding two 4-bit pixels per
    byte (host `_pack4`); unpacked on the device back to (B, H, W) gray in
    0..255 (q -> q * 17). 16 gray levels are enough for a coarse first pass:
    bit decode averages whole cells, and X-corner candidates are snapped and
    then polished at full resolution on the host.

    All five outputs go into one tensor so that the host pays one
    device->host copy (one synchronisation) per chunk; the host unpacks by
    the statically known shapes (_unpack_device_program).
    """
    if packed4:
        hi = (images >> 4).to(torch.float32) * 17.0
        lo = (images & 0xF).to(torch.float32) * 17.0
        B_, H_, W2 = images.shape
        imgs = torch.stack([hi, lo], dim=-1).reshape(B_, H_, W2 * 2)
    else:
        imgs = images.to(torch.float32)
    imgs = imgs.contiguous()
    quads, cells, valid, _areas = marker_graph(imgs, n_bits, k_max, patch, min_area, ccl_iters)
    xy, _score, xvalid = xcorner_graph(imgs, x_kmax)
    B = imgs.shape[0]
    return torch.cat(
        [
            quads.reshape(B, -1),
            cells.reshape(B, -1),
            valid.reshape(B, -1).to(torch.float32),
            xy.reshape(B, -1),
            xvalid.reshape(B, -1).to(torch.float32),
        ],
        dim=1,
    )


def _unpack_device_program(packed: np.ndarray, n_bits: int, k_max: int, x_kmax: int):
    """Split the packed (B, :) device output back into
    (quads, cells, valid, xy, xvalid) by the program's static shapes."""
    B = packed.shape[0]
    nc = n_bits + 2
    sizes = [k_max * 4 * 2, k_max * nc * nc, k_max, x_kmax * 2, x_kmax]
    assert packed.shape[1] == sum(sizes), "packed layout drifted from the device program"
    offs = np.cumsum([0] + sizes)
    quads = packed[:, offs[0] : offs[1]].reshape(B, k_max, 4, 2)
    cells = packed[:, offs[1] : offs[2]].reshape(B, k_max, nc, nc)
    valid = packed[:, offs[2] : offs[3]].reshape(B, k_max) > 0.5
    xy = packed[:, offs[3] : offs[4]].reshape(B, x_kmax, 2)
    xvalid = packed[:, offs[4] : offs[5]].reshape(B, x_kmax) > 0.5
    return quads, cells, valid, xy, xvalid


def _fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray | None:
    """Plain-numpy normalized DLT (board plane -> image)."""
    from caliscope_tpu_torch.frame_selector import _frame_homography

    return _frame_homography(src, dst)


def _boxsum(stack: np.ndarray, s: int) -> np.ndarray:
    """u16 s x s box sum via cascaded hand-unrolled 2x2 strided adds.

    A reshape(B, h, s, w, s).sum(axis=(2, 4)) forces a full-size u16 copy
    with stride-hostile reduction axes; four strided slice-adds per halving
    touch the source once and shrink 4x each stage. s in {2, 4}:
    255 * 16 fits u16."""
    assert s in (2, 4) and stack.dtype == np.uint8
    B, H, W = stack.shape
    hs, ws = H // s, W // s
    v = stack[:, : hs * s, : ws * s]
    acc = (
        v[:, 0::2, 0::2].astype(np.uint16)
        + v[:, 1::2, 0::2]
        + v[:, 0::2, 1::2]
        + v[:, 1::2, 1::2]
    )
    if s == 4:
        acc = acc[:, 0::2, 0::2] + acc[:, 1::2, 0::2] + acc[:, 0::2, 1::2] + acc[:, 1::2, 1::2]
    return acc


def _downsample(stack: np.ndarray, s: int) -> np.ndarray:
    """s x s mean downsample, host-side (keeps the source dtype's range)."""
    if stack.dtype == np.uint8:
        acc = _boxsum(stack, s)
        return ((acc + s * s // 2) // (s * s)).astype(np.uint8)
    B, H, W = stack.shape
    hs, ws = H // s, W // s
    v = stack[:, : hs * s, : ws * s].reshape(B, hs, s, ws, s)
    return v.mean(axis=(2, 4)).astype(stack.dtype)


def _downsample_pack4(stack: np.ndarray, s: int) -> np.ndarray:
    """Fused s x s-mean downsample + 4-bit pack for uint8 stacks: quantizes
    straight off the u16 s x s box sum (q = (sum + s^2*8) >> log2(s^2*16)),
    skipping the intermediate low-res u8 plane's write+read."""
    acc = _boxsum(stack, s)
    ws2 = acc.shape[2] // 2 * 2  # low-res width must be even to pack
    acc = acc[:, :, :ws2]
    shift = (s * s * 16).bit_length() - 1  # s power of two: exact log2
    q = np.minimum((acc + s * s * 8) >> shift, 15).astype(np.uint8)
    return (q[:, :, 0::2] << 4) | q[:, :, 1::2]


def _pack4(stack: np.ndarray) -> np.ndarray:
    """Pack a (B, H, W) uint8 stack into (B, H, W // 2) bytes of two 4-bit
    pixels (round-to-nearest-16; device unpack maps q -> q * 17). W odd
    drops the last column — callers only ever pack the even-width half-res
    plane."""
    assert stack.dtype == np.uint8
    w2 = stack.shape[2] // 2
    q = np.minimum((stack[:, :, : w2 * 2].astype(np.uint16) + 8) >> 4, 15).astype(np.uint8)
    return (q[:, :, 0::2] << 4) | q[:, :, 1::2]



class CharucoTracker(Tracker):
    def __init__(
        self,
        charuco: Charuco,
        snap_radius_frac: float = 0.35,
        detect_scale: int | str = "auto",
        upload_bits: int | str = "auto",
        device=None,
    ):
        """detect_scale: 1 runs the device pipeline at full resolution;
        2 or 4 runs it on s x s-mean downsampled frames and polishes the
        winning corners at full resolution on the host (the frames are
        already in host memory), with a quality-gated full-resolution
        retry of weak frames. "auto" is 1.

        upload_bits: 8 ships frames as uint8; 4 packs two 4-bit pixels per
        byte for the first pass (16 gray levels are enough for a coarse
        pass; the full-resolution retry is always 8-bit). "auto" is 8.

        device: the torch device the pipeline runs on; the CUDA device by
        default, and then it raises when there is none."""
        if detect_scale != "auto" and int(detect_scale) not in (1, 2, 4):
            raise ValueError(f"detect_scale must be 1, 2, 4 or 'auto', got {detect_scale!r}")
        if upload_bits != "auto" and int(upload_bits) not in (8, 4):
            raise ValueError(f"upload_bits must be 8, 4 or 'auto', got {upload_bits!r}")
        self.charuco = charuco
        self.snap_radius_frac = snap_radius_frac
        self.detect_scale = detect_scale
        self.upload_bits = upload_bits
        self.device = resolve_device(device)
        self.dispatches = 0  # device-program dispatches since construction
        self._dispatch_lock = threading.Lock()  # one thread a camera may share the tracker
        self._mirror_hint: dict[int, bool] = {}  # cam_id -> saw mirrored last
        self._marker_board_corners = self._compute_marker_board_corners()
        self._inner_corners_2d = None  # cached board geometry

    def _scale(self) -> int:
        return 1 if self.detect_scale == "auto" else int(self.detect_scale)

    def _pack4_first_pass(self) -> bool:
        return self.upload_bits != "auto" and int(self.upload_bits) == 4

    @property
    def name(self) -> str:
        return "CHARUCO"

    @property
    def pixel_format(self) -> PixelFormat:
        return PixelFormat.GRAY

    # ---- board geometry -----------------------------------------------------
    def _compute_marker_board_corners(self) -> dict[int, np.ndarray]:
        """marker_id -> (4, 2) board-frame corner coords [TL, TR, BR, BL]
        (y down, matching the rendered board and image coords)."""
        s = self.charuco.square_size_m
        a = self.charuco.aruco_scale * s
        m = (s - a) / 2
        out = {}
        for mid, (c, r) in enumerate(self.charuco.marker_square_positions()):
            x0, y0 = c * s + m, r * s + m
            out[mid] = np.array([[x0, y0], [x0 + a, y0], [x0 + a, y0 + a], [x0, y0 + a]])
        return out

    def _board_inner_corners_2d(self) -> np.ndarray:
        if self._inner_corners_2d is None:
            self._inner_corners_2d = self.charuco.chessboard_corners()[:, :2]
        return self._inner_corners_2d

    # ---- detection ----------------------------------------------------------
    def _run_stack_chunks(self, stack: np.ndarray, scale: int, pack4: bool = False):
        """Run the device program on a (B, H, W) host stack in fixed-size
        chunks (which bounds device memory whatever the caller's batch).
        Every chunk's upload and program is enqueued on the stream before
        the first result is read; then each chunk's packed output is copied
        to the host (one copy, one synchronisation per chunk) and unpacked
        as the consumer asks for it, so the caller's host-side assembly of
        chunk k overlaps the device's work on chunks k+1... Yields
        (start, end, dets_list, cand_list)."""
        d = get_dictionary(self.charuco.dictionary)
        B = stack.shape[0]
        if B == 0:
            return
        # min_area is a POOLED-cell-area threshold; at 1/s resolution the
        # same physical marker covers 1/s^2 the pixels
        min_area = max(49 // (scale * scale), 3)
        # a coarse frame is 4-16x fewer pixels, so coarse passes take
        # double-size chunks at the same memory bound
        chunk = 1 if B == 1 else (_RUN_CHUNK if scale == 1 else 2 * _RUN_CHUNK)
        pack4 = pack4 and stack.dtype == np.uint8 and stack.shape[2] % (2 * scale) == 0
        outs = []
        for i in range(0, B, chunk):
            with span("tracker.prepare"):
                piece = stack[i : i + chunk]
                if scale > 1 and pack4:
                    piece = _downsample_pack4(piece, scale)
                elif scale > 1:
                    piece = _downsample(piece, scale)
                elif pack4:
                    piece = _pack4(piece)
                if scale > 1:
                    # the patch pyramid needs dims divisible by 8; replicate-pad
                    # to a multiple of 16 (edge values add no gradients for the
                    # threshold to bite on). Packed widths count 2 px per byte.
                    wq = 16 // (2 if pack4 else 1)
                    ph = (-piece.shape[1]) % 16
                    pw = (-piece.shape[2]) % wq
                    if ph or pw:
                        piece = np.pad(piece, ((0, 0), (0, ph), (0, pw)), mode="edge")
                piece = np.ascontiguousarray(piece)
            with span("tracker.upload", bytes=piece.nbytes):
                images = torch.from_numpy(piece).to(self.device)
            with span("tracker.launch"):
                outs.append(
                    _charuco_device_program(
                        images, d.marker_size, MARKER_KMAX, MARKER_PATCH, min_area, CCL_ITERS, X_CORNER_KMAX, pack4
                    )
                )
            with self._dispatch_lock:
                self.dispatches += 1
        for ci_, out in enumerate(outs):
            s = ci_ * chunk
            e = min(s + chunk, B)
            with span("tracker.readback"):
                packed = out.cpu().numpy()
            with span("tracker.assemble"):
                quads, cells, valid, xy, xvalid = _unpack_device_program(
                    packed, d.marker_size, MARKER_KMAX, X_CORNER_KMAX
                )
                if scale > 1:
                    # 1/s-res pixel centers sit at full-res coords s*x +
                    # (s-1)/2. Candidates stay coarse-accurate here (~s/2 px):
                    # the board assembly's homography/snap gates tolerate that,
                    # and only the few dozen winning corners per frame get the
                    # full-res host polish afterwards (_refine_hits).
                    quads = quads * float(scale) + (scale - 1) / 2.0
                    xy = xy * float(scale) + (scale - 1) / 2.0
                dets_list = assemble_marker_detections(quads, cells, valid, d)
                cand_list = [xy[b][xvalid[b]] for b in range(e - s)]
            yield s, e, dets_list, cand_list

    @staticmethod
    def _refine_hits(stack: np.ndarray, hits: list, scale: int = 2) -> None:
        """Full-res host polish of the winning corners of one coarse-scale
        pass. hits: list of [frame_idx_in_stack, kps, img_xy, ...] entries;
        img_xy is replaced in place with the refined positions
        (detect/corners.py::refine_corners_subpix_host). The integer
        re-seed search radius grows with the coarse scale: a 1/s-res
        candidate lands within ~s/2 px + subpix error of the true corner."""
        from caliscope_tpu_torch.detect.corners import refine_corners_subpix_host

        if not hits:
            return
        all_xy = np.concatenate([h[2] for h in hits])
        fids = np.concatenate([np.full(len(h[2]), h[0], np.int64) for h in hits])
        refined = refine_corners_subpix_host(
            np.asarray(stack), all_xy, fids, relocalize=True, relocal_range=max(3, scale + 1)
        )
        o = 0
        for h in hits:
            n = len(h[2])
            h[2] = refined[o : o + n]
            o += n

    def _detect_face(self, gray: np.ndarray, dets=None, cand=None):
        """Detect on one orientation. Returns (keypoint_ids, img_xy) or None.

        dets/cand: optionally precomputed device outputs (marker detections
        and X-corner candidates) — the batched path runs the device program
        over a whole frame stack and assembles per frame here.
        """
        if dets is None:
            dets = detect_markers(gray[None], self.charuco.dictionary, device=self.device)[0]
        if len(dets) < MIN_MARKERS_FOR_BOARD:
            return None
        src, dst = [], []
        for mid, corners in zip(dets.ids, dets.corners):
            board = self._marker_board_corners.get(int(mid))
            if board is None:
                continue
            src.append(board)
            dst.append(corners)
        if not src:
            return None
        marker_px = np.median([np.linalg.norm(c[0] - c[1]) for c in dets.corners])
        gate = max(3.0, 0.08 * marker_px)

        # Marker-consensus homography: the scene may contain standalone
        # markers that share ids with board markers (or mirror-aliased
        # decodes); greedily trim markers inconsistent with the board plane
        # until the survivors agree on ONE homography.
        src_m = list(src)
        dst_m = list(dst)
        H = None
        while src_m:
            s = np.concatenate(src_m)
            t = np.concatenate(dst_m)
            H = _fit_homography(s, t)
            if H is None:
                return None
            ones = np.ones((len(s), 1))
            reproj = (H @ np.hstack([s, ones]).T).T
            reproj = reproj[:, :2] / reproj[:, 2:3]
            per_marker = np.linalg.norm(reproj - t, axis=1).reshape(-1, 4).mean(axis=1)
            worst = int(np.argmax(per_marker))
            if per_marker[worst] <= gate:
                break
            if len(src_m) == 1:
                return None  # nothing consistent remains
            src_m.pop(worst)
            dst_m.pop(worst)
        src = np.concatenate(src_m)
        dst = np.concatenate(dst_m)
        if H is None:
            return None

        # Orientation gate: a physical front-face view preserves the board's
        # winding; a mirror-aliased decode (a mirror-symmetric marker read
        # with flipped corner winding) yields an orientation-REVERSING
        # homography. det of the projective Jacobian at the board center:
        cx, cy = self._board_inner_corners_2d().mean(axis=0)
        h = H
        w_c = h[2, 0] * cx + h[2, 1] * cy + h[2, 2]
        J = np.array(
            [
                [h[0, 0] * w_c - (h[0, 0] * cx + h[0, 1] * cy + h[0, 2]) * h[2, 0],
                 h[0, 1] * w_c - (h[0, 0] * cx + h[0, 1] * cy + h[0, 2]) * h[2, 1]],
                [h[1, 0] * w_c - (h[1, 0] * cx + h[1, 1] * cy + h[1, 2]) * h[2, 0],
                 h[1, 1] * w_c - (h[1, 0] * cx + h[1, 1] * cy + h[1, 2]) * h[2, 1]],
            ]
        )
        if np.linalg.det(J) < 0:
            return None

        inner = self._board_inner_corners_2d()

        if cand is None:
            # detected X-corners (device program)
            xy, _score, valid = detect_x_corners_device(
                gray[None].astype(np.float32), k_max=X_CORNER_KMAX, device=self.device
            )
            cand = xy[0][valid[0]].cpu().numpy()
        if len(cand) == 0:
            return None

        def project(Hm):
            ones = np.ones((len(inner), 1))
            p = (Hm @ np.hstack([inner, ones]).T).T
            return p[:, :2] / p[:, 2:3]

        def local_radii(expected):
            """Per-corner snap radius from the LOCAL projected grid spacing.

            Under strong perspective the square size varies across the board;
            a single global radius over-reaches at the compressed end and
            snaps corners to the wrong grid neighbor (an off-by-one that
            corner geometry alone cannot detect)."""
            cols = self.charuco.inner_columns
            n = len(expected)
            grid = expected.reshape(-1, cols, 2)
            spacing = np.full((grid.shape[0], cols), np.inf)
            if cols > 1:
                dh = np.linalg.norm(grid[:, 1:] - grid[:, :-1], axis=2)
                spacing[:, 1:] = np.minimum(spacing[:, 1:], dh)
                spacing[:, :-1] = np.minimum(spacing[:, :-1], dh)
            if grid.shape[0] > 1:
                dv = np.linalg.norm(grid[1:] - grid[:-1], axis=2)
                spacing[1:] = np.minimum(spacing[1:], dv)
                spacing[:-1] = np.minimum(spacing[:-1], dv)
            return self.snap_radius_frac * spacing.reshape(n)

        def snap(expected, radii):
            d2 = np.sum((expected[:, None, :] - cand[None, :, :]) ** 2, axis=2)
            nearest = np.argmin(d2, axis=1)
            dist = np.sqrt(d2[np.arange(len(expected)), nearest])
            keep = dist < radii
            chosen: dict[int, int] = {}
            for k in np.where(keep)[0]:
                c = int(nearest[k])
                if c not in chosen or dist[k] < dist[chosen[c]]:
                    chosen[c] = k
            kps = sorted(chosen.values())
            return np.asarray(kps, np.int64), nearest

        # Iterative homography refinement: the marker-seeded H extrapolates
        # poorly to the board's far end; each round folds the confidently
        # snapped corners back into the fit and re-projects.
        kps = np.zeros(0, np.int64)
        nearest = None
        prev_key = None
        for _ in range(3):
            expected = project(H)
            radii = local_radii(expected)
            kps, nearest = snap(expected, radii)
            if len(kps) < 4:
                break
            # converged: the snap set (corner -> candidate pairing) is what
            # the refit consumes; an unchanged set reproduces the same H
            key = (kps.tobytes(), nearest[kps].tobytes())
            if key == prev_key:
                break
            prev_key = key
            H2 = _fit_homography(
                np.concatenate([src, inner[kps]]),
                np.concatenate([dst, cand[nearest[kps]]]),
            )
            if H2 is None:
                break
            H = H2
        if len(kps) == 0:
            return None
        # final consistency gates: snapped corners AND the absolute marker
        # anchors must both agree with the refined H (a wrongly-anchored fit
        # can lock onto the corner grid while drifting off the markers)
        mproj = (H @ np.hstack([src, np.ones((len(src), 1))]).T).T
        mresid = np.linalg.norm(mproj[:, :2] / mproj[:, 2:3] - dst, axis=1)
        if np.median(mresid) > max(3.0, 0.08 * marker_px):
            return None
        expected = project(H)
        radii = local_radii(expected)
        resid = np.linalg.norm(expected[kps] - cand[nearest[kps]], axis=1)
        ok = resid < np.minimum(radii[kps], 0.25 * radii[kps] / self.snap_radius_frac)
        kps = kps[ok]
        kps = self._collinearity_gate(kps, cand, nearest)
        # a single anchoring marker fits any 4-point homography exactly, so
        # demand corroborating chessboard corners around it (a lone wall
        # marker that aliases a board id finds none)
        min_corners = 4 if len(src_m) == 1 else 1
        if len(kps) < min_corners:
            return None
        # A corner the homography places outside the frame, or in the border
        # where the ring response is zero (PAD px), has no candidate of its
        # own; the snap above pairs it with whatever candidate lies within
        # its radius (an X-response where the board meets the frame's edge),
        # up to ~30 px off. The JAX package reports such corners; the port
        # drops them here, after every gate, so the corners it keeps are the
        # JAX package's.
        h_img, w_img = gray.shape[:2]
        e = expected[kps]
        kps = kps[(e[:, 0] >= PAD) & (e[:, 0] <= w_img - 1 - PAD) & (e[:, 1] >= PAD) & (e[:, 1] <= h_img - 1 - PAD)]
        if len(kps) == 0:
            return None
        return kps, cand[nearest[kps]], len(src_m)

    def _collinearity_gate(self, kps: np.ndarray, cand: np.ndarray, nearest: np.ndarray) -> np.ndarray:
        """Drop snapped corners that break grid-line collinearity.

        A homography maps board grid lines to image LINES exactly, so a
        corner's distance to the line through its two opposite snapped
        neighbors is insensitive to perspective (unlike the H-residual gate,
        whose radius scales with square size and admits multi-pixel snaps
        onto spurious X-responses). Residual curvature is only lens
        distortion over a two-square chord (sub-pixel for real lenses).
        Iteratively removes the worst offender so one bad corner cannot
        condemn its good neighbors.
        """
        cols = self.charuco.inner_columns
        gate = 2.0  # px

        def line_dist(p, a, b):
            d = b - a
            n = np.linalg.norm(d)
            if n < 1e-9:
                return np.inf
            return abs(d[0] * (p[1] - a[1]) - d[1] * (p[0] - a[0])) / n

        kset = {int(k): cand[nearest[int(k)]] for k in kps}
        while len(kset) >= 3:
            worst_k, worst_dev = -1, gate
            for k, p in kset.items():
                c, r = k % cols, k // cols
                devs = []
                if 0 < c and c < cols - 1 and k - 1 in kset and k + 1 in kset:
                    devs.append(line_dist(p, kset[k - 1], kset[k + 1]))
                if k - cols in kset and k + cols in kset:
                    devs.append(line_dist(p, kset[k - cols], kset[k + cols]))
                if devs and min(devs) > worst_dev:
                    worst_k, worst_dev = k, min(devs)
            if worst_k < 0:
                break
            del kset[worst_k]
        return np.asarray(sorted(kset), np.int64)

    def _detect(self, frame: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> PointPacket:
        return self.get_points_batch(np.asarray(frame)[None], cam_id, rotation_count)[0]

    def _packet_from(self, best, width: int) -> PointPacket:
        """Finalize a winning face into a PointPacket (un-mirror x, split
        two-sided identity)."""
        _score, mirrored, kps, img_xy = best
        if mirrored:
            img_xy = img_xy.copy()
            img_xy[:, 0] = width - 1 - img_xy[:, 0]
        # Identity split only for a board with real substrate thickness: the
        # back face is object 1 with the SAME keypoint ids at z=+thickness.
        # At zero thickness a mirrored view IS the front face seen from
        # behind, so both share identity and BA fuses them into the same
        # world points (reference charuco_tracker.py:72-85).
        is_back = mirrored and self.charuco.thickness_m > 0
        object_id = 1 if is_back else 0
        obj_loc = self.charuco.object_corners(object_id)[kps]
        return PointPacket(
            object_id=np.full(len(kps), object_id),
            keypoint_id=kps,
            img_loc=img_xy,
            obj_loc=obj_loc,
        )

    def _is_strong(self, score) -> bool:
        """Strong acceptance: enough markers AND most corners recovered —
        the same criterion that skips the mirror retry."""
        n_markers, n_kps = score
        return n_markers >= 3 and n_kps >= 0.6 * self.charuco.n_corners

    def _orientation_passes(
        self, grays: np.ndarray, frame_ids: list, best: dict, orders, scale: int, pack4: bool
    ) -> None:
        """Run the two-orientation detection over grays[frame_ids] at the
        given device-pipeline scale, merging (score, mirrored, kps, img_xy)
        results into `best` keyed by frame id."""
        pending = list(frame_ids)
        for mirrored in orders:
            if not pending:
                break
            if not mirrored and len(pending) == grays.shape[0]:
                stack = grays  # full unmirrored pass: no copy
            else:
                stack = grays[pending]
                if mirrored:
                    stack = stack[:, :, ::-1]
                stack = np.ascontiguousarray(stack)
            still = []
            with span("tracker.pass", frames=len(pending), mirrored=mirrored, scale=scale):
                for s, e, dets_list, cand_list in self._run_stack_chunks(stack, scale, pack4):
                    with span("tracker.assemble"):
                        hits = []  # [j, kps, img_xy, b, n_markers] for this chunk
                        for j in range(s, e):
                            b = pending[j]
                            result = self._detect_face(stack[j], dets=dets_list[j - s], cand=cand_list[j - s])
                            accepted = False
                            if result is not None:
                                kps, img_xy, n_markers = result
                                hits.append([j, kps, img_xy, b, n_markers])
                                accepted = self._is_strong((n_markers, len(kps)))
                            if not accepted:
                                still.append(b)
                        if scale > 1:
                            self._refine_hits(stack, hits, scale)
                        for j, kps, img_xy, b, n_markers in hits:
                            score = (n_markers, len(kps))
                            if b not in best or score > best[b][0]:
                                best[b] = (score, mirrored, kps, img_xy)
            pending = still

    def get_points_batch(self, frames: np.ndarray, cam_id: int = 0, rotation_count: int = 0) -> list[PointPacket]:
        """Device-batched detection over a (B, H, W[, 3]) frame stack.

        The device program runs over the stack in chunks; host-side assembly
        (homography consensus, corner snap, gates) runs per frame on the
        chunk outputs. Frames that fail the first orientation are retried as
        a second, smaller stack in the flipped orientation, and the
        better-scoring face wins. `get_points` is this on a stack of one.
        """
        frames = np.asarray(frames)
        with span("tracker.batch", frames=frames.shape[0]):
            if frames.ndim == 4:
                frames = frames.mean(axis=3)
            # Inversion is the only host-side intensity op; it is exact in uint8
            # (255 - v), so uint8 frames stay uint8 (a quarter of float32's
            # upload bytes, and eligible for the 4-bit packed upload).
            if self.charuco.inverted:
                grays = 255 - frames if frames.dtype == np.uint8 else 255.0 - frames.astype(np.float32)
            else:
                grays = frames
            B = grays.shape[0]
            orders = [False, True] if not self._mirror_hint.get(cam_id, False) else [True, False]
            best: dict[int, tuple] = {}
            scale = self._scale()
            self._orientation_passes(grays, list(range(B)), best, orders, scale, self._pack4_first_pass())
            if scale > 1:
                # Quality-gated full-res retry: a weak coarse-scale result (few
                # markers / few corners) on a hard view can pass the geometric
                # gates with misidentified corners. Strong detections keep the
                # cheap path; weak or missing ones re-run at full resolution,
                # 8-bit, and the better score wins.
                weak = [b for b in range(B) if b not in best or not self._is_strong(best[b][0])]
                if weak:
                    self._orientation_passes(grays, weak, best, orders, 1, False)
            packets = []
            for b in range(B):
                if b in best:
                    packets.append(self._packet_from(best[b], grays.shape[2]))
                else:
                    packets.append(PointPacket.empty())
            if best:
                n_mirrored = sum(1 for v in best.values() if v[1])
                self._mirror_hint[cam_id] = n_mirrored * 2 > len(best)
            return packets

    # ---- metadata -----------------------------------------------------------
    def get_point_name(self, keypoint_id: int) -> str:
        return f"corner_{int(keypoint_id)}"

    def get_connected_points(self) -> set[tuple[int, int]]:
        return set(self.charuco.connectivity())
