"""Batched image kernels: threshold, connected components, quad extraction.

Port of caliscope_tpu/detect/kernels.py to plain PyTorch tensor code, the
marker-candidate stage that stands in for OpenCV's contour-based one:

1. adaptive_threshold — local-mean binarization from one shared integral
   image (two cumsum passes serve every window radius via slices).
2. connected_components — label propagation with segmented min-scans along
   rows and columns, a fixed number of rounds. This is the plain version of
   the CUDA labeling kernel (detect/ccl.py launches that on CUDA tensors).
3. component_candidates_sorted — sort the pooled cells by label; every
   per-component statistic is then a segmented scan over the sorted row
   (area = run length, bbox = run extremes); the K largest runs in the
   area band give a static K candidate slots per frame.
4. extract_patches — each candidate takes one contiguous PxP window from a
   packed pyramid atlas, so downstream work is dense and statically shaped
   whatever the blob size (the windows come from detect/cuda_kernels.py::
   extract_windows, a CUDA kernel on CUDA tensors).
5. quad_corners_from_mask — farthest-point quadrilateral heuristic on the
   patch mask; refine_quad_edges — flat-band gradient-energy line fits over
   fixed pixels + intersections for subpixel corners.

Everything batches over (B, H, W) frame stacks in float32 on either device;
the reference's per-candidate `vmap` bodies are written out over a
flattened (B*K) axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from caliscope_tpu_torch.detect.cuda_kernels import extract_windows

INTEGRAL_PAD = 32  # >= every adaptive_threshold radius in use


def integral_image(images, pad: int = INTEGRAL_PAD):
    """Edge-replicated, zero-fronted 2D prefix sums over `pad`-padded frames:
    S[b, i, j] = sum of the padded image's first i rows / j cols. float32:
    exact while every partial sum stays below 2**24 (integer-valued frames
    up to 256x256 padded), order-dependent in the last bits beyond that."""
    xp = F.pad(images.to(torch.float32)[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    s = torch.cumsum(torch.cumsum(xp, dim=1), dim=2)
    return F.pad(s, (1, 0, 1, 0))


def adaptive_threshold(images, radius: int = 10, c: float = 7.0, integral=None):
    """Dark-foreground binarization: pixel < local_mean - c.

    Pass a precomputed `integral` (integral_image(images)) when thresholding
    the same frames at several radii: the two cumsum passes are shared, and
    the per-radius window sums are four slices of the padded integral."""
    B, H, W = images.shape
    if integral is None:
        integral = integral_image(images)
    p = INTEGRAL_PAD
    assert radius <= p, "radius exceeds the shared integral padding"
    k = 2 * radius + 1
    # window [i - r, i + r] in image coords = [p + i - r, p + i + r] padded;
    # with the zero-fronted integral, sum = S[a+k, b+k] - S[a+k, b] - S[a, b+k] + S[a, b]
    y0 = p - radius
    x0 = p - radius

    def corner(dy, dx):
        return integral[:, y0 + dy : y0 + dy + H, x0 + dx : x0 + dx + W]

    total = corner(k, k) - corner(k, 0) - corner(0, k) + corner(0, 0)
    mean = total / (k * k)
    return images < (mean - c)


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------


def _segmented_min_scan(values, connected, reverse: bool = False):
    """Per-row segmented running min: `connected[i]` True means element i
    joins element i-1's segment. Batched over leading axes; scan over last.

    Two scalar scans (cumsum of segment starts + cummin of offset values).
    The offset trick: v' = v - seg_id * M with M > max(v); elements of
    earlier segments carry a strictly larger v', so a plain running min
    never leaks across a boundary. Every element that does not join the one
    before it starts a segment (a background pixel too), so seg_id reaches
    n and |v'| reaches n * M, beyond int32 on large frames (1080p): the
    offsets are taken in int64, which holds them for any int32 label plane,
    and the result is int32 again.
    """
    n = values.shape[-1]
    rows = values.shape[-2]
    M = n * rows + 1  # > any linear pixel index
    if reverse:
        # connected[i] gates the pair (i, i+1); in flipped coordinates that
        # pair becomes (j-1, j) at j = n-1-i, a plain flip of the flag array
        values = torch.flip(values, dims=(-1,))
        connected = torch.flip(connected, dims=(-1,)).clone()
        connected[..., 0] = False
    seg_id = torch.cumsum(~connected, dim=-1, dtype=torch.int64)
    shifted = values.to(torch.int64) - seg_id * M
    run = torch.cummin(shifted, dim=-1).values
    out = (run + seg_id * M).to(torch.int32)
    if reverse:
        out = torch.flip(out, dims=(-1,))
    return out


def connected_components(mask, n_iters: int = 12):
    """4-connected labeling of a (B, H, W) boolean mask.

    Labels are int32 linear pixel indices (min over the component after
    convergence); background = H*W (one past the last valid label). The
    result is the state after exactly `n_iters` rounds, converged or not.
    """
    B, H, W = mask.shape
    dev = mask.device
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    bg = torch.tensor(H * W, dtype=torch.int32, device=dev)
    labels = torch.where(mask, idx, bg)
    pair_h = mask[:, :, 1:] & mask[:, :, :-1]
    mt = mask.transpose(1, 2)
    pair_v = mt[:, :, 1:] & mt[:, :, :-1]
    no_h = torch.zeros((B, H, 1), dtype=torch.bool, device=dev)
    no_v = torch.zeros((B, W, 1), dtype=torch.bool, device=dev)
    conn_h, conn_hr = torch.cat([no_h, pair_h], dim=2), torch.cat([pair_h, no_h], dim=2)
    conn_v, conn_vr = torch.cat([no_v, pair_v], dim=2), torch.cat([pair_v, no_v], dim=2)
    for _ in range(n_iters):
        # horizontal segmented scans
        labels = _segmented_min_scan(labels, conn_h)
        labels = _segmented_min_scan(labels, conn_hr, reverse=True)
        # vertical segmented scans (on the transposed plane)
        lt = labels.transpose(1, 2).contiguous()
        lt = _segmented_min_scan(lt, conn_v)
        lt = _segmented_min_scan(lt, conn_vr, reverse=True)
        labels = torch.where(mask, lt.transpose(1, 2), bg)
    return labels.contiguous()


def pool_mask(mask, pool: int):
    """Foreground-preserving max-pool of a (B, H, W) boolean mask."""
    B, H, W = mask.shape
    Hp, Wp = H // pool, W // pool
    return mask[:, : Hp * pool, : Wp * pool].reshape(B, Hp, pool, Wp, pool).any(dim=4).any(dim=2)


def component_candidates_sorted(mask, labels, k_max: int, min_area: float, max_area_frac: float = 0.25, pool: int = 4):
    """Top-K components by area within [min_area, max_area] per frame.

    Sort the pooled cells by raw label value (background H*W sorts last);
    every per-component statistic becomes a segmented scan over the sorted
    row: area is the run length, bbox the run min/max, the representative
    label the run value itself. Runs replace segments, so there is no
    id-space cap and no overflow bucket.

    mask/labels are the full-resolution binary mask and its 4-connected
    labeling (labels = linear pixel indices, background = H*W). Returns
    (sel_labels (B, K) full-res label values, areas (B, K) in pixels at
    pool-cell quantization, bbox (B, K, 4) [x0, y0, x1, y1] cell-aligned
    and one-cell dilated, valid (B, K)).

    Areas are multiples of pool*pool, so equal scores are common: the K
    best are taken with a stable descending sort, which puts the lower
    position first among equals as `lax.top_k` does (`torch.topk` promises
    no order among equals).
    """
    B, H, W = mask.shape
    HW = H * W
    Hp, Wp = H // pool, W // pool
    # the segmented-extreme offset trick below confines cummax to runs via
    # v +- spos * M; it needs the largest offset to fit int32
    if Hp * Wp * (max(Wp, Hp) + 1) >= 2**31:
        raise ValueError(
            f"component_candidates_sorted: frame {H}x{W} at pool={pool} "
            f"overflows the int32 segmented-extreme offsets; increase pool"
        )
    lab_p = labels[:, : Hp * pool, : Wp * pool].reshape(B, Hp, pool, Wp, pool).amin(dim=(2, 4))
    fg_p = pool_mask(mask, pool)
    HWp = Hp * Wp
    c = float(pool)
    max_area = max_area_frac * HW
    lab = torch.where(fg_p, lab_p, torch.tensor(HW, dtype=torch.int32, device=mask.device)).reshape(B, HWp)
    slab, order = torch.sort(lab, dim=1, stable=True)
    order = order.to(torch.int32)
    sxs = order % Wp
    sys_ = order // Wp

    pos = torch.arange(HWp, dtype=torch.int32, device=mask.device)[None, :].expand(B, HWp)
    change = slab[:, 1:] != slab[:, :-1]
    edge = torch.ones((B, 1), dtype=torch.bool, device=mask.device)
    new_run = torch.cat([edge, change], dim=1)
    run_end = torch.cat([change, edge], dim=1)
    # run start position, propagated to every element of the run
    spos = torch.cummax(torch.where(new_run, pos, -1), dim=1).values
    # segmented extremes via the offset trick: runs are position-ordered, so
    # v +- spos * M confines every cumulative extreme to its own run
    Mx = Wp + 1
    My = Hp + 1
    x_max = torch.cummax(sxs + spos * Mx, dim=1).values - spos * Mx
    x_min = -(torch.cummax(-sxs + spos * Mx, dim=1).values - spos * Mx)
    y_max = torch.cummax(sys_ + spos * My, dim=1).values - spos * My
    y_min = -(torch.cummax(-sys_ + spos * My, dim=1).values - spos * My)

    area = (pos - spos + 1).to(torch.float32) * (c * c)
    xmaxf = x_max.to(torch.float32) * c
    xminf = x_min.to(torch.float32) * c
    ymaxf = y_max.to(torch.float32) * c
    yminf = y_min.to(torch.float32) * c
    bw = xmaxf - xminf + c
    bh = ymaxf - yminf + c
    fill = area / torch.clamp(bw * bh, min=1.0)
    eligible = (
        run_end
        & (slab < HW)
        & (area >= min_area)
        & (area <= max_area)
        & (fill > 0.15)
        & (bw >= 4)
        & (bh >= 4)
    )
    score = torch.where(eligible, area, -1.0)
    top_area, top_pos = torch.sort(score, dim=1, descending=True, stable=True)
    top_area, top_pos = top_area[:, :k_max], top_pos[:, :k_max]
    valid = top_area > 0

    def take(a):
        return torch.gather(a, 1, top_pos)

    sel = torch.where(valid, take(slab), HW)
    bbox = torch.stack(
        [
            torch.clamp(take(xminf) - (c - 1), min=0.0),
            torch.clamp(take(yminf) - (c - 1), min=0.0),
            torch.clamp(take(xmaxf) + 2 * (c - 1), max=W - 1.0),
            torch.clamp(take(ymaxf) + 2 * (c - 1), max=H - 1.0),
        ],
        dim=-1,
    )
    return sel, top_area, bbox, valid


def extract_patches(images, binary, labels, sel_labels, bbox, patch: int, margin_frac: float = 0.15, n_levels: int = 4):
    """Cut a fixed PxP window around each candidate from an image pyramid.

    images: (B, H, W) float on a 0..255 intensity scale (the atlas packs
    gray to 8 bits); binary: (B, H, W) bool foreground; labels: (B, H, W)
    full-resolution component labels; sel_labels are label values. Returns
    (gray (B, K, P, P), mask (B, K, P, P) bool, origin (B, K, 2),
    scale (B, K, 2)) with image_xy = origin + patch_xy * scale. The mask is
    pixel-exact at level 0 (small markers): foreground gated by the
    candidate's component label.

    Each candidate picks the coarsest pyramid level whose stride lets its
    (margin-padded) bbox fit in a PxP window and takes one window read from
    a packed atlas: all pyramid levels stacked vertically in a single int32
    plane carrying (label << 9 | gray8 << 1 | fg) per pixel. Gray survives
    packing exactly at level 0 (uint8 source); pooled levels round the 2x2
    mean to the nearest of 256 steps. The pyramid levels are 2x mean-pools;
    labels use nearest and binary max pooling so component identity
    survives. scale is the level stride (same for x and y).
    """
    B, H, W = images.shape
    P = patch
    dev = images.device
    imgs = images.to(torch.float32)
    HW = H * W
    # background label HW must fit the packed field: 22 bits covers 4.19 MP
    assert HW < 2**22, "extract_patches atlas packing supports frames up to 4.19 MP"

    def pool2(a):
        Hl, Wl = a.shape[1] // 2, a.shape[2] // 2
        return a[:, : Hl * 2, : Wl * 2].reshape(B, Hl, 2, Wl, 2)

    img_pyr, bin_pyr = [imgs], [binary]
    for _ in range(n_levels - 1):
        img_pyr.append(pool2(img_pyr[-1]).sum(dim=(2, 4)) * 0.25)
        bin_pyr.append(pool2(bin_pyr[-1]).any(dim=4).any(dim=2))
    # labels: nearest subsample per level (same stride as the image pyramid)
    lab_pyr = [labels[:, :: 2**i, :: 2**i] for i in range(n_levels)]

    # Pack each level and stack the bands into one (B, sum_H, atlas_W) atlas.
    # Padding (right of narrow levels, bottom of short ones) carries the
    # background value: label = HW, gray = 0, fg = 0.
    background = HW << 9
    atlas_w = max(W, P)
    offs, hs, ws = [], [], []
    off = 0
    for i in range(n_levels):
        bh, bw = max(img_pyr[i].shape[1], P), max(img_pyr[i].shape[2], P)
        offs.append(off)
        hs.append(bh)
        ws.append(bw)
        off += bh
    atlas = torch.full((B, off, atlas_w), background, dtype=torch.int32, device=dev)
    for i in range(n_levels):
        g8 = torch.clamp(torch.round(img_pyr[i]), 0.0, 255.0).to(torch.int32)
        band = (lab_pyr[i].to(torch.int32) << 9) | (g8 << 1) | bin_pyr[i].to(torch.int32)
        atlas[:, offs[i] : offs[i] + band.shape[1], : band.shape[2]] = band
    offs_a = torch.tensor(offs, dtype=torch.int32, device=dev)
    hs_a = torch.tensor(hs, dtype=torch.int32, device=dev)
    ws_a = torch.tensor(ws, dtype=torch.int32, device=dev)

    # per-candidate scalar math: pyramid level + atlas window corner
    x0, y0, x1, y1 = bbox.unbind(dim=-1)  # (B, K) each
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    need = torch.maximum(w, h) * (1.0 + 2.0 * margin_frac) + 2
    # smallest level whose PxP window covers `need` pixels
    steps = P * (2.0 ** torch.arange(n_levels - 1, dtype=torch.float32, device=dev))
    lvl = (need[..., None] > steps).sum(dim=-1).clamp(max=n_levels - 1)
    cx = (x0 + x1) * 0.5
    cy = (y0 + y1) * 0.5
    sf = torch.exp2(lvl.to(torch.float32))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    yi = torch.minimum(torch.maximum(torch.round(cy / sf).to(torch.int32) - P // 2, zero), hs_a[lvl] - P)
    xi = torch.minimum(torch.maximum(torch.round(cx / sf).to(torch.int32) - P // 2, zero), ws_a[lvl] - P)
    # level-l pixel i is the mean of image pixels [s*i, s*i+s-1], whose
    # center sits at s*i + (s-1)/2 in image coordinates
    origin = torch.stack([xi, yi], dim=-1).to(torch.float32) * sf[..., None] + (sf[..., None] - 1.0) * 0.5
    scale = sf[..., None].expand(*sf.shape, 2).contiguous()
    yi_a = (offs_a[lvl] + yi).contiguous()

    wins = extract_windows(atlas, yi_a, xi.contiguous(), P)

    g = ((wins >> 1) & 0xFF).to(torch.float32)
    m = (wins & 1).to(torch.bool) & ((wins >> 9) == sel_labels[:, :, None, None])
    return g, m, origin, scale


def _argmax2d(val):
    """(N, P, P) -> (N, 2) float (x, y) of each plane's first maximum in
    row-major order."""
    P = val.shape[-1]
    flat = torch.argmax(val.reshape(val.shape[0], -1), dim=1)
    return torch.stack([(flat % P).to(torch.float32), (flat // P).to(torch.float32)], dim=1)


def quad_corners_from_mask(mask):
    """Farthest-point quadrilateral from a (..., P, P) boolean mask.

    A = farthest from centroid; B = farthest from A; C = max |cross| from AB;
    D = max cross on the opposite side. Returns (..., 4, 2) patch coords
    ordered counter-clockwise starting from an arbitrary corner. Relies on
    `torch.argmax` returning the first maximum.
    """
    *lead, P, _ = mask.shape
    dev = mask.device
    m = mask.reshape(-1, P, P)
    xs = torch.arange(P, dtype=torch.float32, device=dev)
    gx = xs[None, None, :].expand(1, P, P)
    gy = xs[None, :, None].expand(1, P, P)
    w = m.to(torch.float32)
    n = torch.clamp(w.sum(dim=(1, 2)), min=1.0)
    cen = torch.stack([(w * gx).sum(dim=(1, 2)), (w * gy).sum(dim=(1, 2))], dim=1) / n[:, None]

    def far_from(q):
        d = ((gx - q[:, 0, None, None]) ** 2 + (gy - q[:, 1, None, None]) ** 2) * w - (1 - w) * 1e9
        return _argmax2d(d)

    A = far_from(cen)
    Bc = far_from(A)
    ab = Bc - A
    cross = torch.where(
        m,
        (gx - A[:, 0, None, None]) * ab[:, 1, None, None] - (gy - A[:, 1, None, None]) * ab[:, 0, None, None],
        0.0,
    )
    C = _argmax2d(cross)
    D = _argmax2d(-cross)
    quad = torch.stack([A, C, Bc, D], dim=1)  # (N, 4, 2): A-C-B-D walks around the hull
    # order counter-clockwise by angle around the centroid
    qcen = quad.mean(dim=1, keepdim=True)
    ang = torch.atan2(quad[..., 1] - qcen[..., 1], quad[..., 0] - qcen[..., 0])
    order = torch.argsort(ang, dim=1, stable=True)
    out = torch.gather(quad, 1, order[..., None].expand(-1, -1, 2))
    return out.reshape(*lead, 4, 2)


def refine_quad_edges(gray, quads, search: float = 2.5, shrink: float = 0.08):
    """Subpixel quad corners via gradient edge fitting.

    For each edge: weight every patch pixel inside a flat band around the
    current edge line (within `search`, along the slightly shrunk segment)
    by its squared gradient component along the edge normal, fit a line to
    that weighted mass (total least squares), intersect adjacent lines.
    gray: (..., P, P); quads: (..., 4, 2). Returns refined (..., 4, 2).

    The band must be flat: any distance taper recenters mass on the
    (mask-derived, +-1 px) initial line instead of the true edge. The four
    edges are fitted one after another over all candidates at once, which
    keeps the temporaries at (N, P, P).
    """
    *lead, P, _ = gray.shape
    dev = gray.device
    img = gray.reshape(-1, P, P)
    quad = quads.reshape(-1, 4, 2)
    ar = torch.arange(P, dtype=torch.float32, device=dev)
    pxw = ar[None, None, :].expand(1, P, P)
    pyw = ar[None, :, None].expand(1, P, P)
    # image gradients (central differences)
    gx_img = torch.zeros_like(img)
    gx_img[:, :, 1:-1] = (img[:, :, 2:] - img[:, :, :-2]) * 0.5
    gy_img = torch.zeros_like(img)
    gy_img[:, 1:-1, :] = (img[:, 2:, :] - img[:, :-2, :]) * 0.5

    cens, dirs = [], []
    for i in range(4):
        a = quad[:, i]
        d = quad[:, (i + 1) % 4] - a
        norm = torch.clamp(torch.linalg.vector_norm(d, dim=1), min=1e-6)
        nx = (-d[:, 1] / norm)[:, None, None]
        ny = (d[:, 0] / norm)[:, None, None]
        # signed distance to the edge line and projection along it
        dxp = pxw - a[:, 0, None, None]
        dyp = pyw - a[:, 1, None, None]
        dist = dxp * nx + dyp * ny
        t = (dxp * d[:, 0, None, None] + dyp * d[:, 1, None, None]) / (norm * norm)[:, None, None]
        band = (torch.abs(dist) <= search) & (t >= shrink) & (t <= 1.0 - shrink)
        gn = gx_img * nx + gy_img * ny
        w = band * gn * gn
        # raw moments in one pass; the centered covariance follows
        wx = w * pxw
        wy = w * pyw
        s0 = torch.clamp(w.sum(dim=(1, 2)), min=1e-6)
        sx = wx.sum(dim=(1, 2))
        sy = wy.sum(dim=(1, 2))
        sxx = (wx * pxw).sum(dim=(1, 2))
        sxy = (wx * pyw).sum(dim=(1, 2))
        syy = (wy * pyw).sum(dim=(1, 2))
        cens.append(torch.stack([sx, sy], dim=1) / s0[:, None])
        cxx = sxx - sx * sx / s0
        cxy = sxy - sx * sy / s0
        cyy = syy - sy * sy / s0
        # dominant eigenvector of the 2x2 covariance, closed form
        theta = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
        dirs.append(torch.stack([torch.cos(theta), torch.sin(theta)], dim=1))

    corners = []
    for i in range(4):
        c1, d1, c2, d2 = cens[(i + 3) % 4], dirs[(i + 3) % 4], cens[i], dirs[i]
        # c1 + t1 d1 = c2 + t2 d2, a 2x2 system [d1, -d2] t = c2 - c1
        rhs = c2 - c1
        det = d2[:, 0] * d1[:, 1] - d1[:, 0] * d2[:, 1]
        safe = torch.abs(det) > 1e-9
        t1 = (d2[:, 0] * rhs[:, 1] - d2[:, 1] * rhs[:, 0]) / torch.where(safe, det, 1.0)
        corners.append(torch.where(safe[:, None], c1 + t1[:, None] * d1, (c1 + c2) * 0.5))
    return torch.stack(corners, dim=1).reshape(*lead, 4, 2)


def homography_from_unit_square(quad):
    """Closed-form homography mapping the unit square (0,0)-(1,0)-(1,1)-(0,1)
    to quad corners (..., 4, 2) in order [TL, TR, BR, BL]."""
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    g = (sx * dy2 - sy * dx2) / den
    h = (dx1 * sy - dy1 * sx) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    c = x0
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    f = y0
    return torch.stack(
        [
            torch.stack([a, b, c], dim=-1),
            torch.stack([d, e, f], dim=-1),
            torch.stack([g, h, torch.ones_like(a)], dim=-1),
        ],
        dim=-2,
    )


def sample_marker_bits(gray, quad, n_bits: int):
    """Cell means over the (n_bits + 2)^2 grid (border included) of a quad.

    gray: (..., P, P) patch; quad: (..., 4, 2) patch coords ordered
    [TL, TR, BR, BL]. Returns cell means (..., n+2, n+2) in source gray units.

    Area integration instead of point sampling: map every patch pixel to
    unit-square coordinates with the closed-form inverse homography, weight
    it into its cell with separable triangular row/column kernels centered
    on cell centers (soft binning keeps sub-pixel cells sampled), and reduce
    with two (n_tot, P^2) x (P^2, n_tot) matrix products per candidate (sums
    and counts), batched over the candidates in full float32."""
    *lead, P, _ = gray.shape
    dev = gray.device
    n_tot = n_bits + 2
    Hm = homography_from_unit_square(quad).reshape(-1, 3, 3)  # unit -> patch
    img = gray.reshape(-1, P * P)
    N = img.shape[0]
    ar = torch.arange(P, dtype=torch.float32, device=dev)
    px = ar[None, :].expand(P, P).reshape(1, P * P)
    py = ar[:, None].expand(P, P).reshape(1, P * P)
    # patch -> unit via the adjugate (scale-free on homogeneous coords)
    a, b, c = Hm[:, 0, 0, None], Hm[:, 0, 1, None], Hm[:, 0, 2, None]
    d, e, f = Hm[:, 1, 0, None], Hm[:, 1, 1, None], Hm[:, 1, 2, None]
    g, h, i = Hm[:, 2, 0, None], Hm[:, 2, 1, None], Hm[:, 2, 2, None]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    den = A20 * px + A21 * py + A22
    den = torch.where(torch.abs(den) < 1e-9, 1e-9, den)
    u = (A00 * px + A01 * py + A02) / den
    v = (A10 * px + A11 * py + A12) / den
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    uu = u * n_tot - 0.5  # cell-center coordinates
    vv = v * n_tot - 0.5
    idx = torch.arange(n_tot, dtype=torch.float32, device=dev)[None, :, None]
    Rf = torch.clamp(1.0 - torch.abs(vv[:, None, :] - idx), min=0.0)  # (N, n_tot, P^2)
    Cf = torch.clamp(1.0 - torch.abs(uu[:, None, :] - idx), min=0.0) * inside[:, None, :]
    gf = img[:, None, :] * Cf
    sums = torch.bmm(Rf, gf.transpose(1, 2))
    cnts = torch.bmm(Rf, Cf.transpose(1, 2))
    out = sums / torch.clamp(cnts, min=1e-6)
    return out.reshape(*lead, n_tot, n_tot)
