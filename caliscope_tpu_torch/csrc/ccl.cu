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
// labels are always below it, so `label != H * W` is the mask and no second
// plane is carried.
//
// Design. The TPU kernel held one whole frame in its 16+ MB of VMEM; a 720p
// int32 label plane is 3.7 MB and a thread block has 227 KB, so a round is
// two launches over labels in device memory (the launch boundary is the
// grid-wide barrier between the row and the column pass):
//   ccl_rows: one warp per row. The row is staged in shared memory; the
//     warp walks it in 32-pixel chunks with a Hillis-Steele segmented min
//     over warp shuffles, carrying the open run across chunks, forward and
//     then backward. The first round builds the initial labels from the mask
//     instead of reading labels.
//   ccl_cols: one block per strip of 32 columns, all rows. The strip is
//     staged in shared memory with a row stride of 33 words (so a warp
//     walking down a column hits 32 different banks), one warp per column
//     runs the same chunked scan down and up, and the strip is written back
//     with coalesced rows. A strip taller than shared memory holds (1,760
//     rows) is staged in equal segments, the open run carried from one to
//     the next; all but the last segment then make the trip twice.
// Both read and write each label once per pass (frames up to 1,760 rows).
// Widths and heights are arbitrary (ragged chunks are padded with
// background).
//
// What bounds it on an H100 SXM (B = 8, 720 x 1280, n_iters = 4): the
// function must read the mask (1 B/pixel) and write the labels (4 B/pixel),
// 36.9 MB, 11 us at 3.35 TB/s; its few integer operations per pixel and
// round are far below that. So it is bound by bytes. This version moves the
// 29.5 MB label plane twice per pass (eight passes), which stays in the
// 50 MB L2 but is several times the bound; fusing rounds per tile is later
// work.
//
// Limits: four rows of W * 4 bytes must fit a block's 227 KB of shared
// memory (W <= 14,528), and H * W < 2^31. H is otherwise free.

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

}  // namespace

extern "C" {

const char* ccl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest W the row pass's shared-memory plan takes (227 KB a block).
int ccl_max_width() { return SMEM_BYTES / (ROW_WARPS * 4); }

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
