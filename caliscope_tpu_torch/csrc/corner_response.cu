// ChESS-style X-corner ring response on (B, H, W) float32 frames.
//
// Replaces caliscope_tpu/detect/pallas_kernels.py::chess_corner_response_pallas
// (the Pallas TPU kernel _response_tile_kernel). Same function:
//
//   s_i   = bilinear sample at ring offset i of n = 16 (radius 4), blended
//           over rows first and then over columns:
//             r0 = wy0 * I[y+iy,   x+ix]   + wy1 * I[y+iy+1, x+ix]
//             r1 = wy0 * I[y+iy,   x+ix+1] + wy1 * I[y+iy+1, x+ix+1]
//             s  = wx0 * r0 + wx1 * r1
//   sr    = sum_{i<8} |s_i - s_{i+8}|          (agreement across the diameter)
//   dr    = sum_{i<8} |s_i - s_{(i+4)%16}|     (disagreement at a quarter turn)
//   mr    = |(sum_i s_i) / 16 - I[y,x]| * 8 * 0.5
//   resp  = max(dr - sr - mr, 0), and 0 within `pad` = 6 px of the border.
//
// The result is the plain PyTorch version's (detect/cuda_kernels.py::
// corner_response_plain) to the last bit, for finite inputs: every product
// and sum is a single IEEE float32 operation (__fmul_rn / __fadd_rn are never
// contracted into FMAs), and every sum runs in the plain version's order. The
// taps are compile-time constants here, the wrapper's ring_taps() to the bit
// (checked once when the library is loaded: corner_response_check_taps).
//
// Design. A 2-D stencil in 128 x 32 output tiles. The block stages its tile
// with a 4-pixel halo (the farthest any tap reaches) in shared memory by
// cp.async, 16 bytes a copy where rows are 16-byte aligned, zero-filled
// outside the frame (those values reach only outputs in the zeroed border).
// Each thread then computes a run of RUN = 4 outputs along x, for four rows
// of the tile. For a run it reads each input row it needs once, as three
// 16-byte loads of shared memory (columns x0-4 .. x0+7), into registers, and
// walks the 16 taps with compile-time offsets and weights:
//   - a tap's vertical blend at column c, wy0 * I[y+iy, c] + wy1 * I[y+iy+1,
//     c], is r1 of the output at c - ix - 1 and r0 of the one at c - ix: the
//     same operation on the same operands, so it is computed once per column
//     (RUN + 1 blends for RUN outputs, not 2 RUN);
//   - a term whose weight is exactly 0.0f is dropped and a product with a
//     weight of exactly 1.0f is not formed (taps 0, 4, 8 and 12 lie on the
//     axes). For finite values that changes no bit of the result: it can
//     only turn the sign of a zero, which every later sum (from +0) and
//     absolute value erases. The near-zero weights (~1e-16) are kept.
// The rows are visited in the order 0..4 (taps 0-8 use only these) and then
// -4..-1 (taps 9-15), so the first nine samples are folded into the sums as
// soon as they are known and fewer of them stay in registers.
//
// What bounds it on an H100 SXM (B = 8, 720 x 1280): it must read and write
// 4 B per pixel, 59 MB, 17.6 us at 3.35 TB/s. Per pixel it does 133 float32
// operations once each vertical blend is shared (12 taps off the grid in both
// axes: 3 for the blend + 3 for the horizontal one; the four on the axes: 2
// each; then 16 + 16 for sr and dr, 16 sums, the mean, 3 for mr and 3 for
// the result) plus a quarter of the 12 x 3 blends for the run's extra
// column. No FMA may be formed, so each is one instruction a lane, at
// 33.5 T/s (132 SMs x 128 lanes x 1.98 GHz): 29 us. It is bound by
// operations, and by instruction issue: the shared-memory loads and the
// staging share the issue slots.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int N_TAPS = 16;
constexpr int RUN = 4;                  // outputs a thread computes along x
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_W = 32 * RUN;        // a warp covers one row of the tile
constexpr int TILE_H = 32;              // warp w computes rows w, w + 8, ...
constexpr int REACH = 4;                // rows and columns a tap reaches, either side
constexpr int SEG = RUN + 2 * REACH;    // columns x0 - 4 .. x0 + RUN + 3 of a run
constexpr int SH = TILE_H + 2 * REACH;  // staged rows
constexpr int SW = TILE_W + 2 * REACH;  // staged columns: x_t - 4 .. x_t + TILE_W + 3
constexpr int PHASE_A = 9;              // taps 0..8 use rows 0..4; taps 9..15 rows -4..-1

struct Tap {
  int iy, ix;
  float wy0, wy1, wx0, wx1;
};

// detect/cuda_kernels.py::ring_taps(), bit for bit: (iy, ix) and weights
// (1 - fy, fy, 1 - fx, fx) of the ring offsets (4 cos a, 4 sin a), a = 2 pi i / 16.
__host__ __device__ constexpr Tap tap(int k) {
  switch (k) {
    case 0: return {0, 4, 0x1p+0f, 0x0p+0f, 0x1p+0f, 0x0p+0f};
    case 1: return {1, 3, 0x1.e08756p-2f, 0x1.0fbc54p-1f, 0x1.37ca18p-2f, 0x1.641af4p-1f};
    case 2: return {2, 2, 0x1.5f619ap-3f, 0x1.a8279ap-1f, 0x1.5f619ap-3f, 0x1.a8279ap-1f};
    case 3: return {3, 1, 0x1.37ca18p-2f, 0x1.641af4p-1f, 0x1.e08756p-2f, 0x1.0fbc54p-1f};
    case 4: return {4, 0, 0x1p+0f, 0x0p+0f, 0x1p+0f, 0x1.1a6264p-52f};
    case 5: return {3, -2, 0x1.37ca18p-2f, 0x1.641af4p-1f, 0x1.0fbc54p-1f, 0x1.e08756p-2f};
    case 6: return {2, -3, 0x1.5f619ap-3f, 0x1.a8279ap-1f, 0x1.a8279ap-1f, 0x1.5f619ap-3f};
    case 7: return {1, -4, 0x1.e08756p-2f, 0x1.0fbc54p-1f, 0x1.641af4p-1f, 0x1.37ca18p-2f};
    case 8: return {0, -4, 0x1p+0f, 0x1.1a6264p-51f, 0x1p+0f, 0x0p+0f};
    case 9: return {-2, -4, 0x1.0fbc54p-1f, 0x1.e08756p-2f, 0x1.641af4p-1f, 0x1.37ca18p-2f};
    case 10: return {-3, -3, 0x1.a8279ap-1f, 0x1.5f619ap-3f, 0x1.a8279ap-1f, 0x1.5f619ap-3f};
    case 11: return {-4, -2, 0x1.641af4p-1f, 0x1.37ca18p-2f, 0x1.0fbc54p-1f, 0x1.e08756p-2f};
    case 12: return {-4, -1, 0x1p+0f, 0x0p+0f, 0x1.cp-51f, 0x1p+0f};
    case 13: return {-4, 1, 0x1.641af4p-1f, 0x1.37ca18p-2f, 0x1.e08756p-2f, 0x1.0fbc54p-1f};
    case 14: return {-3, 2, 0x1.a8279ap-1f, 0x1.5f619ap-3f, 0x1.5f619ap-3f, 0x1.a8279ap-1f};
    default: return {-2, 3, 0x1.0fbc54p-1f, 0x1.e08756p-2f, 0x1.37ca18p-2f, 0x1.641af4p-1f};
  }
}

// the rows (relative to the output row) and the columns (relative to the
// run's first output) a tap reads; a term with weight 0 reads nothing
__host__ __device__ constexpr int row_lo(const Tap& t) { return t.wy0 != 0.0f ? t.iy : t.iy + 1; }
__host__ __device__ constexpr int row_hi(const Tap& t) { return t.wy1 != 0.0f ? t.iy + 1 : t.iy; }
// blended columns j of the tap, column x0 + ix + j, j in [col_lo, col_hi]
__host__ __device__ constexpr int col_lo(const Tap& t) { return t.wx0 != 0.0f ? 0 : 1; }
__host__ __device__ constexpr int col_hi(const Tap& t) { return t.wx1 != 0.0f ? RUN : RUN - 1; }

// the row visited at step q: 0, 1, 2, 3, 4, then -4, -3, -2, -1
__host__ __device__ constexpr int row_at(int q) { return q < REACH + 1 ? q : q - 2 * REACH - 1; }

constexpr bool taps_fit() {
  for (int k = 0; k < N_TAPS; ++k) {
    const Tap t = tap(k);
    if ((t.wy0 == 0.0f && t.wy1 == 0.0f) || (t.wx0 == 0.0f && t.wx1 == 0.0f)) return false;
    if (row_lo(t) < -REACH || row_hi(t) > REACH) return false;
    if (t.ix + col_lo(t) + REACH < 0 || t.ix + col_hi(t) + REACH >= SEG) return false;
    // phase A visits rows 0..4, phase B rows -4..-1
    if (k < PHASE_A ? row_lo(t) < 0 : row_hi(t) > -1) return false;
  }
  return true;
}
static_assert(taps_fit(), "a tap reaches beyond the staged halo, the run's columns or its phase's rows");

// w * a as the plain version forms it; a weight of exactly 1 forms no product
__device__ __forceinline__ float weighted(float w, float a) { return w == 1.0f ? a : __fmul_rn(w, a); }

// The responses of RUN outputs from the staged tile: `c` points at the
// output row's column x0 - 4 (so c[4 + j] is I[y, x0 + j]).
__device__ __forceinline__ void response_run(const float* c, float res[RUN]) {
  float s[N_TAPS][RUN];       // samples, live until their sums are formed
  float v[N_TAPS][RUN + 1];   // a tap's vertical blends, column x0 + ix + j
  float center[RUN];
  float sum[RUN], sr[RUN], dr[RUN];
#pragma unroll
  for (int q = 0; q < 2 * REACH + 1; ++q) {
    const int dy = row_at(q);
    float r[SEG];
    const float4* p = reinterpret_cast<const float4*>(c + dy * SW);
#pragma unroll
    for (int i = 0; i < SEG / 4; ++i) {
      const float4 f = p[i];
      r[4 * i] = f.x;
      r[4 * i + 1] = f.y;
      r[4 * i + 2] = f.z;
      r[4 * i + 3] = f.w;
    }
    if (dy == 0) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) center[j] = r[REACH + j];
    }
#pragma unroll
    for (int k = 0; k < N_TAPS; ++k) {
      const Tap t = tap(k);
      const bool first = dy == row_lo(t), last = dy == row_hi(t);
      if (!first && !last) continue;
      const float w = dy == t.iy ? t.wy0 : t.wy1;
#pragma unroll
      for (int j = 0; j <= RUN; ++j) {
        if (j < col_lo(t) || j > col_hi(t)) continue;
        const float term = weighted(w, r[t.ix + j + REACH]);
        // rows ascend within a phase, so the iy row's term comes first, as
        // in the plain version's wy0 * a + wy1 * b
        v[k][j] = first ? term : __fadd_rn(v[k][j], term);
      }
      if (!last) continue;
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if (t.wx0 == 0.0f) {
          s[k][j] = weighted(t.wx1, v[k][j + 1]);
        } else if (t.wx1 == 0.0f) {
          s[k][j] = weighted(t.wx0, v[k][j]);
        } else {
          s[k][j] = __fadd_rn(weighted(t.wx0, v[k][j]), weighted(t.wx1, v[k][j + 1]));
        }
      }
    }
    if (q == REACH) {  // end of phase A: samples 0..8 are known
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        sum[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < PHASE_A; ++k) sum[j] = __fadd_rn(sum[j], s[k][j]);
        dr[j] = 0.0f;
#pragma unroll
        for (int i = 0; i + N_TAPS / 4 < PHASE_A; ++i) dr[j] = __fadd_rn(dr[j], fabsf(__fsub_rn(s[i][j], s[i + N_TAPS / 4][j])));
        sr[j] = __fadd_rn(0.0f, fabsf(__fsub_rn(s[0][j], s[N_TAPS / 2][j])));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
#pragma unroll
    for (int k = PHASE_A; k < N_TAPS; ++k) sum[j] = __fadd_rn(sum[j], s[k][j]);
#pragma unroll
    for (int i = PHASE_A - N_TAPS / 4; i < N_TAPS / 2; ++i) dr[j] = __fadd_rn(dr[j], fabsf(__fsub_rn(s[i][j], s[i + N_TAPS / 4][j])));
#pragma unroll
    for (int i = 1; i < N_TAPS / 2; ++i) sr[j] = __fadd_rn(sr[j], fabsf(__fsub_rn(s[i][j], s[i + N_TAPS / 2][j])));
    // sum / 16 and sum * 0.0625 are the same correctly rounded quotient
    const float mean = __fmul_rn(sum[j], 1.0f / N_TAPS);
    const float mr = __fmul_rn(__fmul_rn(fabsf(__fsub_rn(mean, center[j])), static_cast<float>(N_TAPS / 2)), 0.5f);
    res[j] = fmaxf(__fsub_rn(__fsub_rn(dr[j], sr[j]), mr), 0.0f);
  }
}

// vec: W % 4 == 0 and both planes 16-byte aligned (16-byte copies and stores)
__global__ void __launch_bounds__(THREADS, 2)
corner_response_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, int pad, bool vec) {
  __shared__ __align__(16) float tile[SH * SW];
  const int x_t = blockIdx.x * TILE_W, y_t = blockIdx.y * TILE_H;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const float* src = img + plane;
  // stage rows y_t - 4 .. y_t + TILE_H + 3 and columns x_t - 4 .. x_t + TILE_W + 3
  if (vec) {
    constexpr int SW4 = SW / 4;
    for (int q = threadIdx.x; q < SH * SW4; q += THREADS) {
      const int r = q / SW4, c4 = q - r * SW4;
      const int gy = y_t - REACH + r, gx = x_t - REACH + 4 * c4;  // gx % 4 == 0, so 4 columns are all in or all out
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      __pipeline_memcpy_async(tile + r * SW + 4 * c4, in ? src + static_cast<size_t>(gy) * W + gx : src, 16, in ? 0 : 16);
    }
  } else {
    for (int q = threadIdx.x; q < SH * SW; q += THREADS) {
      const int r = q / SW, cc = q - r * SW;
      const int gy = y_t - REACH + r, gx = x_t - REACH + cc;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      __pipeline_memcpy_async(tile + q, in ? src + static_cast<size_t>(gy) * W + gx : src, 4, in ? 0 : 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = x_t + RUN * lane;
  if (x0 >= W) return;
  // does the run hold an output off the zeroed border?
  const bool cols_in = x0 + RUN - 1 >= pad && x0 < W - pad;
  float* dst = out + plane;
  for (int oy = warp; oy < TILE_H; oy += WARPS) {
    const int y = y_t + oy;
    if (y >= H) break;
    float res[RUN] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (cols_in && y >= pad && y < H - pad) {
      response_run(tile + (oy + REACH) * SW + RUN * lane, res);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if (x0 + j < pad || x0 + j >= W - pad) res[j] = 0.0f;
      }
    }
    float* o = dst + static_cast<size_t>(y) * W + x0;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        if (x0 + j < W) o[j] = res[j];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* corner_response_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int corner_response_n_taps() { return N_TAPS; }

// 0 if the caller's taps (N_TAPS rows of (iy, ix) ints and N_TAPS rows of
// (wy0, wy1, wx0, wx1) floats, host memory) are the compiled ones bit for
// bit, else the index of the first tap that differs, plus one.
int corner_response_check_taps(const int* tap_offsets, const float* tap_weights) {
  for (int k = 0; k < N_TAPS; ++k) {
    const Tap t = tap(k);
    const float w[4] = {t.wy0, t.wy1, t.wx0, t.wx1};
    if (tap_offsets[2 * k] != t.iy || tap_offsets[2 * k + 1] != t.ix || std::memcmp(w, tap_weights + 4 * k, sizeof w) != 0) {
      return k + 1;
    }
  }
  return 0;
}

// img, out: (B,H,W) float32 on the device. `pad` is the width of the zeroed
// border; the plain version's taps must lie within it (pad > REACH).
// Returns cudaGetLastError() (0 on success). Does not synchronise.
int corner_response_launch(const float* img, float* out, int B, int H, int W, int pad, void* stream) {
  if (B < 1 || H < 1 || W < 1 || pad <= REACH || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = W % 4 == 0 && reinterpret_cast<size_t>(img) % 16 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  corner_response_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(img, out, H, W, pad, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
