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
// The taps (iy, ix, wy0, wy1, wx0, wx1) come from the wrapper as a table
// passed by value (kernel parameters live in constant memory). Every product and sum is a single IEEE float32 operation
// in a fixed order (__fmul_rn / __fadd_rn are never contracted into FMAs),
// which is the order of the plain PyTorch version, so the two agree to the
// last bit wherever the card's elementwise kernels round the same way.
//
// Design. A 2-D stencil: a block stages a TILE_W x TILE_H tile with a halo
// as wide as the zeroed border in shared memory (reads outside the frame are clamped to the
// edge; they reach only masked outputs), then each thread computes
// TILE_W * TILE_H / 256 outputs, lanes along x, so shared-memory reads are
// conflict-free and stores coalesced. The TPU kernel's row slabs, lane rolls
// and (8,128) alignment do not carry over.
//
// What bounds it on an H100 SXM (B = 8, 720 x 1280): it must read and write
// 4 B per pixel, 59 MB, 17.6 us at 3.35 TB/s. Per pixel the function needs
// a 9-operation bilinear blend only for a tap off the pixel grid, 12 of the
// 16 at radius 4 (the four on the axes are whole pixels), 32 operations for
// the differences and their sums, 17 for the mean and 5 more: 162
// operations, 1.19 GFLOP, 17.8 us at 67 TFLOP/s. Bytes and operations tie.
// (The kernel itself blends all 16 taps, so that its arithmetic is the plain
// version's to the last bit.)

#include <cuda_runtime.h>

namespace {

constexpr int N_TAPS = 16;
constexpr int TILE_W = 64;
constexpr int TILE_H = 32;
constexpr int THREADS = 256;
constexpr int MAX_PAD = 8;

struct Tap {
  int iy, ix;
  float wy0, wy1, wx0, wx1;
};

struct Taps {
  Tap t[N_TAPS];
};

__global__ void __launch_bounds__(THREADS)
corner_response_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                       int pad, const __grid_constant__ Taps taps) {
  extern __shared__ float tile[];
  const int halo = pad;  // the taps reach no further than the zeroed border
  const int sw = TILE_W + 2 * halo;
  const int sh = TILE_H + 2 * halo;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  for (int idx = threadIdx.x; idx < sw * sh; idx += THREADS) {
    const int ty = idx / sw, tx = idx - ty * sw;
    const int gy = min(max(y0 + ty - halo, 0), H - 1);
    const int gx = min(max(x0 + tx - halo, 0), W - 1);
    tile[idx] = img[base + static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE_W * TILE_H; idx += THREADS) {
    const int oy = idx / TILE_W, ox = idx - oy * TILE_W;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= H || x >= W) continue;
    float resp = 0.0f;
    if (y >= pad && y < H - pad && x >= pad && x < W - pad) {
      const float* c = tile + (oy + halo) * sw + (ox + halo);
      float s[N_TAPS];
#pragma unroll
      for (int i = 0; i < N_TAPS; ++i) {
        const Tap t = taps.t[i];
        const float* p = c + t.iy * sw + t.ix;
        const float r0 = __fadd_rn(__fmul_rn(t.wy0, p[0]), __fmul_rn(t.wy1, p[sw]));
        const float r1 = __fadd_rn(__fmul_rn(t.wy0, p[1]), __fmul_rn(t.wy1, p[sw + 1]));
        s[i] = __fadd_rn(__fmul_rn(t.wx0, r0), __fmul_rn(t.wx1, r1));
      }
      float sr = 0.0f, dr = 0.0f, sum = 0.0f;
#pragma unroll
      for (int i = 0; i < N_TAPS / 2; ++i) {
        sr = __fadd_rn(sr, fabsf(__fsub_rn(s[i], s[i + N_TAPS / 2])));
        dr = __fadd_rn(dr, fabsf(__fsub_rn(s[i], s[(i + N_TAPS / 4) % N_TAPS])));
      }
#pragma unroll
      for (int i = 0; i < N_TAPS; ++i) sum = __fadd_rn(sum, s[i]);
      const float mean = __fdiv_rn(sum, static_cast<float>(N_TAPS));
      const float mr = __fmul_rn(__fmul_rn(fabsf(__fsub_rn(mean, c[0])), static_cast<float>(N_TAPS / 2)), 0.5f);
      resp = fmaxf(__fsub_rn(__fsub_rn(dr, sr), mr), 0.0f);
    }
    out[base + static_cast<size_t>(y) * W + x] = resp;
  }
}

}  // namespace

extern "C" {

const char* corner_response_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int corner_response_n_taps() { return N_TAPS; }

// taps: N_TAPS rows of (iy, ix) ints and N_TAPS rows of (wy0, wy1, wx0, wx1)
// floats, host memory. img, out: (B,H,W) float32 on the device. `pad` <= 8 is
// the width of the zeroed border, and every tap must lie within it (|iy|,
// |iy+1|, |ix|, |ix+1| <= pad).
// Returns cudaGetLastError() (0 on success). Does not synchronise.
int corner_response_launch(const float* img, float* out, int B, int H, int W, const int* tap_offsets,
                           const float* tap_weights, int pad, void* stream) {
  if (B < 1 || H < 1 || W < 1 || pad < 1 || pad > MAX_PAD || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int i = 0; i < N_TAPS; ++i) {
    Tap& t = taps.t[i];
    t.iy = tap_offsets[2 * i];
    t.ix = tap_offsets[2 * i + 1];
    if (t.iy < -pad || t.iy + 1 > pad || t.ix < -pad || t.ix + 1 > pad) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.wy0 = tap_weights[4 * i];
    t.wy1 = tap_weights[4 * i + 1];
    t.wx0 = tap_weights[4 * i + 2];
    t.wx1 = tap_weights[4 * i + 3];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  const int smem = (TILE_W + 2 * pad) * (TILE_H + 2 * pad) * static_cast<int>(sizeof(float));
  corner_response_kernel<<<grid, THREADS, smem, s>>>(img, out, H, W, pad, taps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
