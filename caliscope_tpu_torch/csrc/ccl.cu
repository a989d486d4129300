// 4-connected component labeling of a (B, H, W) boolean mask after exactly
// n_iters propagation rounds.
//
// Replaces caliscope_tpu/detect/pallas_ccl.py::connected_components_pallas
// (the Pallas TPU kernel _ccl_kernel with _hs_segmented_min). Same contract:
// labels are int32 linear pixel indices row * W + col of the frame,
// background is H * W, and the result is the state after exactly n_iters
// rounds of four directional segmented running-min scans (left to right,
// right to left, top to bottom, bottom to top), converged or not. It equals
// detect/kernels.py::connected_components bit for bit at the same n_iters.
//
// What the four scans of a round compute. A forward segmented running min
// along a line leaves, in each maximal foreground run, the prefix minima;
// these do not increase along the run, so the backward scan that follows
// leaves the run's minimum in every pixel of the run. A round is therefore
// "every horizontal run takes its minimum", then "every vertical run takes
// its minimum". Background pixels hold H * W throughout, and foreground
// labels are always below it, so `label != H * W` is the mask, no second
// plane is carried, and min(label, H * W) changes nothing.
//
// What bounds it on an H100 SXM (B = 8, 720 x 1280, n_iters = 4): the
// function must read the mask (1 B/pixel) and write the labels (4 B/pixel),
// 36.9 MB, 11 us at 3.35 TB/s; its few integer operations per pixel and
// round are far below that. So it is bound by bytes, and the design's aim
// is to touch device memory once.
//
// Two paths; which one a frame takes is decided by its shape alone, by the
// wrapper (detect/ccl.py::resident_plan), never by a failed launch.
//
// 1. Resident (ccl_resident): the frame stays on chip for all rounds, in the
//    shared memory of one thread-block cluster. The TPU kernel held a whole
//    frame in VMEM; a 720p int32 label plane is 3.7 MB and a block has 227
//    KB, but a cluster of 16 blocks has 3.72 MB and its blocks read each
//    other's shared memory. Block i of a frame's cluster keeps rows
//    i * rpb .. i * rpb + rpb - 1 (trailing blocks fewer, or none), row-major,
//    then a flag byte per column and one per 256-pixel chunk of a row. One
//    launch: labels are built from the mask in shared memory, n_iters rounds
//    run without touching device memory, labels are written once.
//      Both passes of a round are the same reduce / carry / apply over
//    pieces of a line (a row's 256-pixel chunks; a column's per-block bands):
//    (a) every piece takes the run minima inside itself, and notes whether
//    it is foreground throughout; (b) for the run that crosses a piece's
//    near edge, the minimum over the neighbouring pieces is gathered by
//    walking outwards while the pieces are linked (edge pixels both
//    foreground) and foreground throughout; likewise for its far edge; a
//    minimum that is no lower than what the run holds is dropped; (c) the
//    pixels of the two edge-touching runs take what is left. Minima of
//    integers associate, so the labels equal the plain scans' bit for bit.
//      Row pass: (a) a warp per chunk, eight pixels a lane (two 16-byte
//    loads, ordered so that a shared-memory phase hits eight bank groups),
//    runs inside the lane in registers, then a segmented min over the lanes
//    by shuffles that stops as soon as no run crosses a whole lane; a chunk
//    is written back only where a label fell, and a chunk without foreground
//    is flagged and never read again; (b) a thread per chunk; (c) a warp
//    per chunk. The 225 chunks of a block's 45 rows spread over its 32
//    warps, and no scan is longer than one chunk. Column pass: (a) a thread
//    per pair of columns walks its band down and up, 16 rows at a time
//    through registers (neighbouring threads on neighbouring words: no bank
//    conflicts); (b) a thread per column reads its neighbours' edge rows
//    and flags through distributed shared memory and keeps the two minima
//    in registers across a cluster barrier; (c) it writes them. A cluster
//    barrier separates (a) from (b) and (b) from (c), since (c) writes the
//    edge rows that (b) reads.
//      Limits: W <= 2,048 (two columns a thread in (b) and (c)) and rows,
//    flags included, within 16 x 227 KB.
//      Where it stands (H100 SXM, (8, 720, 1280), 4 rounds): the card holds 7
//    clusters of 16 blocks at once (cudaOccupancyMaxActiveClusters), so 8
//    frames take two waves, the second for one frame. A wave is ~11 us to
//    build and write the labels and ~25 us a round, about half in each pass;
//    pass (a) is bound by instruction throughput on the one SM that owns 45 rows
//    (~300 instructions a chunk), not by shared-memory bytes.
//
// 2. Two launches a round (ccl_rows, ccl_cols), for frames that fit no
//    cluster (1080p is 8.3 MB): labels live in device memory, and the launch
//    boundary is the grid-wide barrier between the row and the column pass.
//      ccl_rows: one warp per row. The row is staged in shared memory; the
//    warp walks it in 32-pixel chunks with a Hillis-Steele segmented min
//    over warp shuffles, carrying the open run across chunks, forward and
//    then backward. The first round builds the initial labels from the mask.
//      ccl_cols: one block per strip of 32 columns, all rows, staged with a
//    row stride of 33 words, one warp per column, written back with
//    coalesced rows. A strip taller than shared memory holds (1,760 rows)
//    is staged in equal segments, the open run carried from one to the next.
//    It moves the label plane twice per pass.
//      Limits: four rows of W * 4 bytes must fit a block's 227 KB (W <=
//    14,528). H is free.
//
// Both: H * W < 2^31.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_WARPS = 4;      // rows per block in ccl_rows
constexpr int STRIP = 32;         // columns per block in ccl_cols
constexpr int STRIP_STRIDE = 33;  // words per staged strip row
constexpr int SMEM_BYTES = 232448;  // shared memory a block may take (227 KB)
constexpr int MAX_SEG = SMEM_BYTES / (STRIP_STRIDE * 4) / 32 * 32;  // rows of a strip staged at once

// The two scans of a line pass over line[0], line[stride], ...,
// line[(n-1)*stride] (shared memory), one warp each. Forward leaves the
// prefix minima within each maximal run of entries != bg, backward the suffix
// minima; backward after forward leaves the run's minimum in every entry.
// `carry` is the entry just before (forward) or after (backward) the line,
// bg where there is none; the line's last (first) entry is returned, so that
// a line cut into segments is scanned segment by segment; every segment
// that another follows must then be a multiple of 32 entries long (the
// carry enters and leaves through the outer lanes of a full chunk).
__device__ int line_scan_forward(int* line, int stride, int n, int bg, int lane, int carry) {
  const int n_chunks = (n + 31) / 32;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i = ch * 32 + lane;
    int v = (i < n) ? line[i * stride] : bg;
    int prev = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) prev = carry;
    int open = (v != bg) && (prev != bg);  // linked to the predecessor
    for (int d = 1; d < 32; d <<= 1) {
      const int vr = __shfl_up_sync(FULL, v, d);
      const int fr = __shfl_up_sync(FULL, open, d);
      if (lane >= d) {
        if (open) v = min(v, vr);
        open &= fr;
      }
    }
    // `open` now says that every link from this lane back through lane 0's
    // link to the previous chunk holds
    if (open) v = min(v, carry);
    if (i < n) line[i * stride] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  __syncwarp();
  return carry;
}

__device__ int line_scan_backward(int* line, int stride, int n, int bg, int lane, int carry) {
  for (int ch = (n + 31) / 32 - 1; ch >= 0; --ch) {
    const int i = ch * 32 + lane;
    int v = (i < n) ? line[i * stride] : bg;
    int next = __shfl_down_sync(FULL, v, 1);
    if (lane == 31) next = carry;
    int open = (v != bg) && (next != bg);
    for (int d = 1; d < 32; d <<= 1) {
      const int vr = __shfl_down_sync(FULL, v, d);
      const int fr = __shfl_down_sync(FULL, open, d);
      if (lane + d < 32) {
        if (open) v = min(v, vr);
        open &= fr;
      }
    }
    if (open) v = min(v, carry);
    if (i < n) line[i * stride] = v;
    carry = __shfl_sync(FULL, v, 0);
  }
  __syncwarp();
  return carry;
}

// One warp per row. init != 0: labels are built from the mask (index where
// foreground, H * W elsewhere); scan == 0: no scan (n_iters = 0).
__global__ void ccl_rows(const unsigned char* __restrict__ mask, int* __restrict__ labels,
                         int H, int W, int init, int scan) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROW_WARPS + warp;
  if (row >= H) return;  // whole warps leave; no block-wide barrier follows
  const int bg = H * W;
  int* line = smem + warp * W;
  const size_t base = (static_cast<size_t>(blockIdx.y) * H + row) * W;
  for (int c = lane; c < W; c += 32) {
    line[c] = init ? (mask[base + c] ? row * W + c : bg) : labels[base + c];
  }
  __syncwarp();
  if (scan) {
    line_scan_forward(line, 1, W, bg, lane, bg);
    line_scan_backward(line, 1, W, bg, lane, bg);
  }
  for (int c = lane; c < W; c += 32) labels[base + c] = line[c];
}

// One block of 32 warps per strip of 32 columns, one warp per column. The
// strip is staged `seg` rows at a time: down the segments with the forward
// scan, then up them with the backward scan, each warp carrying its column's
// open run from one segment into the next. Every segment but the last is
// written back after the forward scan and staged again for the backward one
// (the block's own writes, visible to it after the barrier); a frame of at
// most `seg` rows is staged once.
__global__ void __launch_bounds__(1024) ccl_cols(int* __restrict__ labels, int H, int W, int seg) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bg = H * W;
  const int c0 = blockIdx.x * STRIP;
  const int col = c0 + lane;
  int* plane = labels + static_cast<size_t>(blockIdx.y) * H * W;
  const int n_seg = (H + seg - 1) / seg;
  int carry = bg;
  for (int pass = 0; pass < 2; ++pass) {  // 0: forward, down; 1: backward, up
    for (int k = 0; k < n_seg; ++k) {
      const int sg = pass ? n_seg - 1 - k : k;
      const int r0 = sg * seg;
      const int rows = min(seg, H - r0);
      // the last segment is still staged when the backward pass begins
      if (!(pass && k == 0)) {
        __syncthreads();
        for (int r = warp; r < rows; r += 32) {
          smem[r * STRIP_STRIDE + lane] = (col < W) ? plane[static_cast<size_t>(r0 + r) * W + col] : bg;
        }
        __syncthreads();
      } else {
        carry = bg;
      }
      if (c0 + warp < W) {
        carry = pass ? line_scan_backward(smem + warp, STRIP_STRIDE, rows, bg, lane, carry)
                     : line_scan_forward(smem + warp, STRIP_STRIDE, rows, bg, lane, carry);
      }
      if (!pass && k == n_seg - 1) continue;  // scanned backward next, then written
      __syncthreads();
      if (col < W) {
        for (int r = warp; r < rows; r += 32) {
          plane[static_cast<size_t>(r0 + r) * W + col] = smem[r * STRIP_STRIDE + lane];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The resident path
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int RES_THREADS = 1024;
constexpr int RES_WARPS = RES_THREADS / 32;
constexpr int RES_PX = 8;                  // pixels a lane keeps in the row pass
constexpr int RES_CHUNK = 32 * RES_PX;     // pixels a warp scans at once
constexpr int RES_MAX_W = 2048;            // RES_COLS columns a thread in the column pass
constexpr int RES_COLS = RES_MAX_W / RES_THREADS;
constexpr int COL_ROWS = 16;               // rows a thread of the column pass keeps in registers
// A piece's flag byte (a row's chunk, a band's column): FULL, it is foreground
// throughout; EMPTY (chunks only), it is background throughout. An empty chunk
// never changes, so from the second round on pass (a) does not even read it.
constexpr unsigned char FLAG_FULL = 1, FLAG_EMPTY = 2;

// RES_PX = 8 consecutive pixels of a row in shared memory, from column c;
// pixels past the row's end read as background and are not written. `vec`: W
// is a multiple of 4, so a group of four that starts inside lies inside,
// 16-byte aligned. A lane's two groups of four are read in two 16-byte
// loads; lanes 0-3 of every eight take their first group first and lanes
// 4-7 their second, so that the eight lanes of a shared-memory phase hit
// eight different groups of banks.
__device__ __forceinline__ void load_px(const int* row, int c, int W, int bg, bool vec, int lane, int v[RES_PX]) {
  static_assert(RES_PX == 8, "two groups of four a lane");
  if (vec) {
    const int h = (lane >> 2) & 1;
    const int ca = c + 4 * h, cb = c + 4 * (h ^ 1);
    int4 x = make_int4(bg, bg, bg, bg), y = x;
    if (ca < W) x = *reinterpret_cast<const int4*>(row + ca);
    if (cb < W) y = *reinterpret_cast<const int4*>(row + cb);
    const int4 lo = h ? y : x, hi = h ? x : y;
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int q = 0; q < RES_PX; ++q) v[q] = (c + q < W) ? row[c + q] : bg;
  }
}

__device__ __forceinline__ void store_px(int* row, int c, int W, bool vec, int lane, const int v[RES_PX]) {
  if (vec) {
    const int h = (lane >> 2) & 1;
    const int4 lo = make_int4(v[0], v[1], v[2], v[3]), hi = make_int4(v[4], v[5], v[6], v[7]);
    const int ca = c + 4 * h, cb = c + 4 * (h ^ 1);
    if (ca < W) *reinterpret_cast<int4*>(row + ca) = h ? hi : lo;
    if (cb < W) *reinterpret_cast<int4*>(row + cb) = h ? lo : hi;
  } else {
#pragma unroll
    for (int q = 0; q < RES_PX; ++q)
      if (c + q < W) row[c + q] = v[q];
  }
}

// A foreground pixel takes the minimum with its neighbour `from`, a
// background pixel stays: background is the largest value there is, so a
// background neighbour changes nothing and only the pixel itself is tested.
__device__ __forceinline__ int take(int v, int from, int bg) { return v != bg ? min(v, from) : bg; }

// Row pass (a), one warp: every run inside the chunk row[c0 .. c0+255] takes
// its minimum; *flag then says whether the whole chunk is foreground, or
// background.
__device__ __forceinline__ void chunk_scan(int* row, int c0, int W, int bg, bool vec, int lane, unsigned char* flag) {
  if (*flag & FLAG_EMPTY) return;  // the same for the whole warp
  int v[RES_PX];
  const int c = c0 + RES_PX * lane;
  load_px(row, c, W, bg, vec, lane, v);
  int old[RES_PX];
  bool any = false;
#pragma unroll
  for (int q = 0; q < RES_PX; ++q) {
    old[q] = v[q];
    any = any || v[q] != bg;
  }
  if (!__any_sync(FULL, any)) {
    if (lane == 0) *flag = FLAG_EMPTY;
    return;
  }
  bool full = v[0] != bg;
#pragma unroll
  for (int q = 1; q < RES_PX; ++q) {
    v[q] = take(v[q], v[q - 1], bg);
    full = full && v[q] != bg;
  }
#pragma unroll
  for (int q = RES_PX - 2; q >= 0; --q) v[q] = take(v[q], v[q + 1], bg);
  // Two segmented scans over the lanes, one shuffle a step each: a lane's
  // word is a label (below 2^31) with, in bit 31, "still open", that is,
  // everything gathered so far is foreground throughout and linked on.
  //   t: minimum of the run that touches this lane's right end, reaching
  //      left through lanes that are foreground throughout;
  //   u: minimum of the run that touches its left end, reaching right.
  // Lane 0 (31) is never open, so every lane closes once its span reaches
  // it, and the loop ends as soon as no lane is open: after one step where
  // no run crosses a whole lane.
  constexpr unsigned OPEN = 0x80000000u;
  const int head = v[0], tail = v[RES_PX - 1];
  const int prev_tail = __shfl_up_sync(FULL, tail, 1);
  const int next_head = __shfl_down_sync(FULL, head, 1);
  unsigned t = static_cast<unsigned>(tail) | ((full && lane > 0 && prev_tail != bg) ? OPEN : 0u);
  unsigned u = static_cast<unsigned>(head) | ((full && lane < 31 && next_head != bg) ? OPEN : 0u);
  for (int d = 1; d < 32; d <<= 1) {
    if (!__any_sync(FULL, (t | u) & OPEN)) break;
    const unsigned tr = __shfl_up_sync(FULL, t, d);
    const unsigned ur = __shfl_down_sync(FULL, u, d);
    if (lane >= d && (t & OPEN)) t = min(t & ~OPEN, tr & ~OPEN) | (tr & OPEN);
    if (lane + d < 32 && (u & OPEN)) u = min(u & ~OPEN, ur & ~OPEN) | (ur & OPEN);
  }
  // what reaches this lane's ends from its neighbours (bg: nothing, or no link)
  int from_left = static_cast<int>(__shfl_up_sync(FULL, t, 1) & ~OPEN);
  if (lane == 0) from_left = bg;
  int from_right = static_cast<int>(__shfl_down_sync(FULL, u, 1) & ~OPEN);
  if (lane == 31) from_right = bg;
  if (full) from_left = from_right = min(from_left, from_right);
  // the runs that touch the lane's ends take it; it spreads inwards pixel by
  // pixel and stops at the first background pixel
  if (__any_sync(FULL, from_left != bg || from_right != bg)) {
    v[0] = take(v[0], from_left, bg);
#pragma unroll
    for (int q = 1; q < RES_PX; ++q) v[q] = take(v[q], v[q - 1], bg);
    v[RES_PX - 1] = take(v[RES_PX - 1], from_right, bg);
#pragma unroll
    for (int q = RES_PX - 2; q >= 0; --q) v[q] = take(v[q], v[q + 1], bg);
  }
  int fell = 0;  // nonzero if any of the lane's labels fell
#pragma unroll
  for (int q = 0; q < RES_PX; ++q) fell |= v[q] ^ old[q];
  if (fell) store_px(row, c, W, vec, lane, v);
  const int all = __all_sync(FULL, full);
  if (lane == 0) *flag = all ? FLAG_FULL : 0;
}

// Row pass (c), one warp: the run that touches the chunk's left end takes
// m_left, the one that touches its right end m_right (bg: nothing to take).
// Every run inside the chunk already holds one value, so the minimum may
// spread from pixel to pixel and lane to lane like a scan of its own.
__device__ __forceinline__ void chunk_apply(int* row, int c0, int W, int bg, bool vec, int lane, int m_left, int m_right) {
  if (m_left == bg && m_right == bg) return;  // the same for the whole warp
  int v[RES_PX], old[RES_PX];
  const int c = c0 + RES_PX * lane;
  load_px(row, c, W, bg, vec, lane, v);
  bool full = true;
#pragma unroll
  for (int q = 0; q < RES_PX; ++q) {
    old[q] = v[q];
    full = full && v[q] != bg;
  }
  const unsigned fb = __ballot_sync(FULL, full);
  const int first_open = (fb == FULL) ? 32 : __ffs(~fb) - 1;   // first lane with a background pixel
  const int last_open = (fb == FULL) ? -1 : 31 - __clz(~fb);  // last such lane
  if (lane <= first_open) {
    v[0] = take(v[0], m_left, bg);
#pragma unroll
    for (int q = 1; q < RES_PX; ++q) v[q] = take(v[q], v[q - 1], bg);
  }
  if (lane >= last_open) {
    v[RES_PX - 1] = take(v[RES_PX - 1], m_right, bg);
#pragma unroll
    for (int q = RES_PX - 2; q >= 0; --q) v[q] = take(v[q], v[q + 1], bg);
  }
  int fell = 0;
#pragma unroll
  for (int q = 0; q < RES_PX; ++q) fell |= v[q] ^ old[q];
  if (fell) store_px(row, c, W, vec, lane, v);
}

// Column pass (a): every run inside the band's columns takes its minimum. A
// thread walks NC neighbouring columns (one int or one int2 a row) down and
// then up, COL_ROWS rows at a time through registers, so that the loads of
// a batch are in flight together and only the chain of minima is serial.
// all[k] says whether column k is foreground throughout.
template <int NC, bool WHOLE>
__device__ __forceinline__ void column_batch(int* p, int W, int rows, int bg, bool up, int run[NC], bool all[NC]) {
  int v[COL_ROWS][NC];
#pragma unroll
  for (int q = 0; q < COL_ROWS; ++q) {
    if (WHOLE || q < rows) {
      if (NC == 2) {
        const int2 x = *reinterpret_cast<const int2*>(p + q * W);
        v[q][0] = x.x;
        v[q][NC - 1] = x.y;
      } else {
        v[q][0] = p[q * W];
      }
    } else {
#pragma unroll
      for (int k = 0; k < NC; ++k) v[q][k] = bg;  // past the band: cuts the run, where nothing follows
    }
  }
  if (!up) {
#pragma unroll
    for (int q = 0; q < COL_ROWS; ++q) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        run[k] = v[q][k] = take(v[q][k], run[k], bg);
        if (WHOLE || q < rows) all[k] = all[k] && v[q][k] != bg;
      }
    }
  } else {
#pragma unroll
    for (int q = COL_ROWS - 1; q >= 0; --q) {
#pragma unroll
      for (int k = 0; k < NC; ++k) run[k] = v[q][k] = take(v[q][k], run[k], bg);
    }
  }
#pragma unroll
  for (int q = 0; q < COL_ROWS; ++q) {
    if (WHOLE || q < rows) {
      if (NC == 2) *reinterpret_cast<int2*>(p + q * W) = make_int2(v[q][0], v[q][NC - 1]);
      else p[q * W] = v[q][0];
    }
  }
}

// Column pass (a) of a block: thread t takes columns NC * t .. NC * t + NC - 1
// (and NC * RES_THREADS further on) and sets their flags.
template <int NC>
__device__ __forceinline__ void column_pass(int* L, int W, int n, int bg, unsigned char* col_flags) {
  const int n_batches = (n + COL_ROWS - 1) / COL_ROWS;
  for (int c = NC * threadIdx.x; c < W; c += NC * RES_THREADS) {
    int run[NC];
    bool all[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) all[k] = true;
    for (int pass = 0; pass < 2; ++pass) {  // 0: down, 1: up
#pragma unroll
      for (int k = 0; k < NC; ++k) run[k] = bg;
      for (int bi = 0; bi < n_batches; ++bi) {
        const int i0 = (pass ? n_batches - 1 - bi : bi) * COL_ROWS;
        const int rows = n - i0;
        int* p = L + i0 * W + c;
        if (rows >= COL_ROWS) column_batch<NC, true>(p, W, rows, bg, pass != 0, run, all);
        else column_batch<NC, false>(p, W, rows, bg, pass != 0, run, all);
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) col_flags[c + k] = all[k] ? FLAG_FULL : 0;
  }
}

// One cluster per frame, cluster rank r keeps rows r*rpb .. of the frame.
// Shared memory: rpb * W labels, then W column flags (padded to 4 bytes),
// then rpb * ceil(W / 256) chunk flags.
__global__ void __launch_bounds__(RES_THREADS, 1)
ccl_resident(const unsigned char* __restrict__ mask, int* __restrict__ labels, int H, int W,
             int n_iters, int rpb, int vec) {
  extern __shared__ __align__(16) int plane[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int frame = blockIdx.x / nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bg = H * W;
  const int r0 = rank * rpb;
  const int n = max(0, min(rpb, H - r0));  // rows this block keeps
  const int nch = (W + RES_CHUNK - 1) / RES_CHUNK;
  int* L = plane;
  unsigned char* col_flags = reinterpret_cast<unsigned char*>(plane + rpb * W);
  unsigned char* chunk_flags = col_flags + (W + 3) / 4 * 4;
  const size_t base = (static_cast<size_t>(frame) * H + r0) * W;  // the block's rows are contiguous

  // initial labels from the mask
  if (vec) {
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + base);
    for (int e = tid; e < n * W / 4; e += RES_THREADS) {
      const uchar4 m = m4[e];
      const int idx = r0 * W + 4 * e;
      reinterpret_cast<int4*>(L)[e] =
          make_int4(m.x ? idx : bg, m.y ? idx + 1 : bg, m.z ? idx + 2 : bg, m.w ? idx + 3 : bg);
    }
  } else {
    for (int e = tid; e < n * W; e += RES_THREADS) L[e] = mask[base + e] ? r0 * W + e : bg;
  }
  for (int e = tid; e < n * nch; e += RES_THREADS) chunk_flags[e] = 0;
  __syncthreads();

  const int batch_rows = max(1, RES_THREADS / nch);  // a thread keeps one chunk's minima in pass (b)
  for (int it = 0; it < n_iters; ++it) {
    // ---- row pass
    for (int i0 = 0; i0 < n; i0 += batch_rows) {
      const int n_items = min(batch_rows, n - i0) * nch;
      for (int item = warp, i = i0 + warp / nch, ch = warp % nch; item < n_items; item += RES_WARPS) {
        chunk_scan(L + i * W, ch * RES_CHUNK, W, bg, vec, lane, chunk_flags + i * nch + ch);
        for (ch += RES_WARPS; ch >= nch; ch -= nch) ++i;
      }
      __syncthreads();
      // (b) this thread's chunk is item lane * RES_WARPS + warp: warp `warp` applies it in turn `lane`
      int m_left = bg, m_right = bg;
      const int mine = lane * RES_WARPS + warp;
      if (mine < n_items && nch > 1) {
        const int i = i0 + mine / nch, ch = mine % nch;
        const int* row = L + i * W;
        const unsigned char* rf = chunk_flags + i * nch;
        const int c0 = ch * RES_CHUNK, c1 = min(W, c0 + RES_CHUNK) - 1;
        const bool lc = ch > 0 && row[c0] != bg && row[c0 - 1] != bg;
        const bool rc = ch + 1 < nch && row[c1] != bg && row[c1 + 1] != bg;
        int lo = bg, hi = bg;
        if (lc) {
          for (int j = ch - 1;; --j) {
            lo = min(lo, row[j * RES_CHUNK + RES_CHUNK - 1]);
            if (!((rf[j] & FLAG_FULL) && j > 0 && row[j * RES_CHUNK - 1] != bg)) break;
          }
        }
        if (rc) {
          for (int j = ch + 1;; ++j) {
            hi = min(hi, row[j * RES_CHUNK]);
            if (!((rf[j] & FLAG_FULL) && j + 1 < nch && row[(j + 1) * RES_CHUNK] != bg)) break;
          }
        }
        const bool full = rf[ch] & FLAG_FULL;
        if (lc) m_left = min(lo, (full && rc) ? hi : bg);
        if (rc) m_right = min(hi, (full && lc) ? lo : bg);
        // the runs already hold one value each: nothing to do unless it falls
        if (m_left >= row[c0]) m_left = bg;
        if (m_right >= row[c1]) m_right = bg;
      }
      __syncthreads();
      for (int item = warp, turn = 0, i = i0 + warp / nch, ch = warp % nch; item < n_items; item += RES_WARPS, ++turn) {
        const int ml = __shfl_sync(FULL, m_left, turn), mr = __shfl_sync(FULL, m_right, turn);
        chunk_apply(L + i * W, ch * RES_CHUNK, W, bg, vec, lane, ml, mr);
        for (ch += RES_WARPS; ch >= nch; ch -= nch) ++i;
      }
    }
    __syncthreads();

    // ---- column pass (a): runs inside the band, and the columns' flags
    if (n > 0 && W % 2 == 0) column_pass<2>(L, W, n, bg, col_flags);
    else if (n > 0) column_pass<1>(L, W, n, bg, col_flags);
    cluster.sync();
    // (b): minima of the runs that cross the band's top and bottom edge,
    // gathered from the other blocks' edge rows and flags
    int m_top[RES_COLS], m_bot[RES_COLS];
#pragma unroll
    for (int k = 0; k < RES_COLS; ++k) {
      m_top[k] = m_bot[k] = bg;
      const int c = tid + k * RES_THREADS;
      if (c < W && n > 0) {
        const int last = (rpb - 1) * W + c;  // the bottom row of a block above (those are never short)
        const bool tc = rank > 0 && L[c] != bg && cluster.map_shared_rank(plane, rank - 1)[last] != bg;
        const bool bc = (rank + 1) * rpb < H && L[(n - 1) * W + c] != bg &&
                        cluster.map_shared_rank(plane, rank + 1)[c] != bg;
        int lo = bg, hi = bg;
        if (tc) {
          for (int j = rank - 1;; --j) {
            const int* other = cluster.map_shared_rank(plane, j);
            lo = min(lo, other[last]);
            const unsigned char* of = reinterpret_cast<const unsigned char*>(other + rpb * W);
            if (!((of[c] & FLAG_FULL) && j > 0 && cluster.map_shared_rank(plane, j - 1)[last] != bg)) break;
          }
        }
        if (bc) {
          for (int j = rank + 1;; ++j) {
            const int* other = cluster.map_shared_rank(plane, j);
            hi = min(hi, other[c]);
            const unsigned char* of = reinterpret_cast<const unsigned char*>(other + rpb * W);
            if (!((of[c] & FLAG_FULL) && (j + 1) * rpb < H && cluster.map_shared_rank(plane, j + 1)[c] != bg)) break;
          }
        }
        const bool full = col_flags[c] & FLAG_FULL;
        if (tc) m_top[k] = min(lo, (full && bc) ? hi : bg);
        if (bc) m_bot[k] = min(hi, (full && tc) ? lo : bg);
        // the runs already hold one value each: nothing to do unless it falls
        if (m_top[k] >= L[c]) m_top[k] = bg;
        if (m_bot[k] >= L[(n - 1) * W + c]) m_bot[k] = bg;
      }
    }
    cluster.sync();
    // (c)
#pragma unroll
    for (int k = 0; k < RES_COLS; ++k) {
      const int c = tid + k * RES_THREADS;
      if (m_top[k] != bg) {
        for (int i = 0; i < n && L[i * W + c] != bg; ++i) L[i * W + c] = min(L[i * W + c], m_top[k]);
      }
      if (m_bot[k] != bg) {
        for (int i = n - 1; i >= 0 && L[i * W + c] != bg; --i) L[i * W + c] = min(L[i * W + c], m_bot[k]);
      }
    }
    __syncthreads();
  }

  // the labels, once
  if (vec) {
    int4* out = reinterpret_cast<int4*>(labels + base);
    for (int e = tid; e < n * W / 4; e += RES_THREADS) out[e] = reinterpret_cast<const int4*>(L)[e];
  } else {
    for (int e = tid; e < n * W; e += RES_THREADS) labels[base + e] = L[e];
  }
}

long long resident_bytes(int rpb, int W) {
  const long long nch = (W + RES_CHUNK - 1) / RES_CHUNK;
  return 4LL * rpb * W + (W + 3) / 4 * 4 + (rpb * nch + 3) / 4 * 4;
}

cudaError_t resident_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int blocks, int rpb, int W) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ccl_resident, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    // 16 blocks a cluster is beyond the portable 8
    err = cudaFuncSetAttribute(ccl_resident, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * blocks);
  cfg->blockDim = dim3(RES_THREADS);
  cfg->dynamicSmemBytes = static_cast<size_t>(resident_bytes(rpb, W));
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool resident_fits(int H, int W, int blocks, int rpb) {
  const bool size_ok = blocks == 1 || blocks == 2 || blocks == 4 || blocks == 8 || blocks == 16;
  return size_ok && rpb >= 1 && static_cast<long long>(blocks) * rpb >= H && W <= RES_MAX_W &&
         resident_bytes(rpb, W) <= SMEM_BYTES;
}

}  // namespace

extern "C" {

const char* ccl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory a block of the resident path takes for rpb rows of W pixels.
long long ccl_resident_bytes(int rpb, int W) { return resident_bytes(rpb, W); }

// How many clusters of `blocks` blocks with rpb rows of W pixels each the
// device can hold at once (cudaOccupancyMaxActiveClusters); minus the CUDA
// error code if the query fails.
int ccl_resident_max_active_clusters(int blocks, int rpb, int W) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(&cfg, &attr, 1, blocks, rpb, W);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ccl_resident, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The resident path: one launch, one cluster of `blocks` blocks per frame,
// rpb rows a block (blocks * rpb >= H; the plan is the wrapper's). Returns
// the launch's error code (0 on success). Does not synchronise.
int ccl_resident_launch(const unsigned char* mask, int* labels, int B, int H, int W, int n_iters,
                        int blocks, int rpb, void* stream) {
  if (B < 1 || H < 1 || W < 1 || n_iters < 0 || static_cast<long long>(H) * W >= (1LL << 31) ||
      !resident_fits(H, W, blocks, rpb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(&cfg, &attr, B, blocks, rpb, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const int vec = (W % 4 == 0) && (reinterpret_cast<size_t>(mask) % 4 == 0) &&
                  (reinterpret_cast<size_t>(labels) % 16 == 0);
  err = cudaLaunchKernelEx(&cfg, ccl_resident, mask, labels, H, W, n_iters, rpb, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Largest W the row pass's shared-memory plan takes (227 KB a block).
int ccl_max_width() { return SMEM_BYTES / (ROW_WARPS * 4); }

// Rows of a column strip the two-launch column pass stages at once.
int ccl_max_segment_rows() { return MAX_SEG; }

// mask (B,H,W) bytes 0/1 -> labels (B,H,W) int32 after n_iters rounds, on
// `stream`: 2 * n_iters launches (one for n_iters = 0). Returns
// cudaGetLastError() (0 on success). Does not synchronise.
int ccl_launch(const unsigned char* mask, int* labels, int B, int H, int W, int n_iters,
               void* stream) {
  if (B < 1 || H < 1 || W < 1 || n_iters < 0 || W > ccl_max_width() ||
      static_cast<long long>(H) * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_smem = ROW_WARPS * W * 4;
  // the column pass stages its strip in the fewest segments of equal height,
  // a multiple of 32 rows where there are several
  const int n_seg = (H + MAX_SEG - 1) / MAX_SEG;
  const int seg = n_seg == 1 ? H : ((H + n_seg - 1) / n_seg + 31) / 32 * 32;
  const int col_smem = seg * STRIP_STRIDE * 4;
  cudaError_t err = cudaFuncSetAttribute(ccl_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ccl_cols, cudaFuncAttributeMaxDynamicSharedMemorySize, col_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 row_grid((H + ROW_WARPS - 1) / ROW_WARPS, B);
  const dim3 col_grid((W + STRIP - 1) / STRIP, B);
  if (n_iters == 0) {
    ccl_rows<<<row_grid, ROW_WARPS * 32, row_smem, s>>>(mask, labels, H, W, 1, 0);
    return static_cast<int>(cudaGetLastError());
  }
  for (int it = 0; it < n_iters; ++it) {
    ccl_rows<<<row_grid, ROW_WARPS * 32, row_smem, s>>>(mask, labels, H, W, it == 0, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ccl_cols<<<col_grid, 1024, col_smem, s>>>(labels, H, W, seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
