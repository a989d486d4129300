// One (win, win) window per seed out of (B, Hp, Wp) frames of 32-bit words.
//
// Replaces caliscope_tpu/detect/pallas_kernels.py::extract_windows_pallas
// (the Pallas TPU kernel _extract_windows_kernel; extract_corner_windows_pallas
// is its float32 alias). out[b, k, r, c] = frames[b, y + r, x + c] with
// (y, x) = seed k of frame b, clamped to [0, Hp - win] x [0, Wp - win] as
// `lax.dynamic_slice` clamps its start (the callers clip already). The copy
// is of 32-bit words, so float32 frames and the packed int32 atlas go through
// the same kernel bit for bit.
//
// Design. One block per (seed, frame): its threads walk the window row-major,
// so each warp reads runs of consecutive words of a frame row and writes
// consecutive words of the output. The TPU kernel's aligned slab DMAs and
// residual rolls answered Mosaic's alignment rules and do not carry over.
//
// What bounds it on an H100 SXM: bytes. It reads and writes 4 * win * win
// bytes per seed: 18.9 MB each way for the marker atlas (B = 8, K = 64,
// win = 96), 11.3 us at 3.35 TB/s; 6.4 MB each way for the corner windows
// (K = 256, win = 28), 3.8 us. No arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
extract_windows_kernel(const unsigned* __restrict__ frames, const int* __restrict__ yi,
                       const int* __restrict__ xi, unsigned* __restrict__ out, int Hp, int Wp, int K,
                       int win) {
  const int k = blockIdx.x, b = blockIdx.y;
  const int seed = b * K + k;
  const int y = min(max(yi[seed], 0), Hp - win);
  const int x = min(max(xi[seed], 0), Wp - win);
  const unsigned* src = frames + (static_cast<size_t>(b) * Hp + y) * Wp + x;
  unsigned* dst = out + static_cast<size_t>(seed) * win * win;
  for (int idx = threadIdx.x; idx < win * win; idx += THREADS) {
    const int r = idx / win, c = idx - r * win;
    dst[idx] = src[static_cast<size_t>(r) * Wp + c];
  }
}

}  // namespace

extern "C" {

const char* extract_windows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// frames (B,Hp,Wp) and out (B,K,win,win) 32-bit words, yi/xi (B,K) int32,
// all on the device. Returns cudaGetLastError() (0 on success). Does not
// synchronise.
int extract_windows_launch(const void* frames, const int* yi, const int* xi, void* out, int B, int Hp,
                           int Wp, int K, int win, void* stream) {
  if (B < 1 || K < 1 || win < 1 || win > Hp || win > Wp || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(K, B);
  extract_windows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(frames), yi, xi, static_cast<unsigned*>(out), Hp, Wp, K, win);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
