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
// What bounds it on an H100 SXM: bytes, 4 * win * win * B * K read and as
// many written. No arithmetic. The marker atlas (B = 8, K = 64, win = 96):
// 18.9 MB each way, 11.3 us at 3.35 TB/s; the corner windows (B = 8, K =
// 256, win = 28): 6.4 MB each way, 3.8 us; the chessboard's (B = 1, K = 512,
// win = 28): 1.6 MB each way, 0.96 us, where a launch's own latency is most
// of the time.
//
// Two paths; the wrapper (detect/cuda_kernels.py::tma_stages) picks one by
// shape and alignment and passes `stages`:
//
// - TMA (stages >= 1): the Tensor Memory Accelerator moves the bytes both
//   ways. The host encodes a 3-D tensor map over (Wp, Hp, B) words.
//   Persistent blocks walk the seeds (block g takes g, g + G, ...), as many
//   an SM as fit at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//   One thread keeps `stages` tile loads in flight (cp.async.bulk.tensor,
//   completed on an mbarrier a stage). A box must start on a 16-byte
//   boundary in its rows (on the H100 a load whose innermost coordinate is
//   not a multiple of 16 bytes stops the kernel with an illegal
//   instruction), so the box is PAD words wider than the window and starts
//   at x rounded down to a multiple of 4 words; a row of it reaches at most
//   one 32-byte sector past the window's own on each side. Once a tile
//   lands, the block's four warps pack its window into a contiguous buffer
//   (consecutive threads on consecutive words, so neither side has bank
//   conflicts; each thread's (row, column) walk is fixed a kernel, no
//   division a word), and one thread sends it out as one bulk store of its
//   win * win * 4 bytes (cp.async.bulk ... bulk_group), packing the next
//   window only once that store has read the buffer
//   (cp.async.bulk.wait_group.read). The stage refills at once. The seeds
//   are clamped in the kernel, so a box's window always lies inside the
//   frame and TMA's zero fill acts only on the unused columns. The first
//   warp's lanes fetch the seeds 32 at a time, a chunk ahead of their use.
//   TMA needs 16-byte row strides (Wp % 4 == 0), box rows of a multiple of
//   16 bytes (win % 4 == 0), box sides of at most 256 (and here within the
//   frame: win + PAD <= Wp), a 16-byte aligned base, and here a stage
//   beside the packed window in RING_BYTES (win <= 116).
// - Rows (stages == 0), for the rest: one warp copies one window row at a
//   time with coalesced 4-byte loads and stores, walking its rows with no
//   division; a block takes max(1, ROWS_PER_BLOCK / win) windows, so small
//   windows share a block.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstdio>

namespace {

// TMA path
constexpr int MAX_STAGES = 2;              // tile stages a block, at most: one lands while one is packed
constexpr int RING_BYTES = 112 * 1024;     // a block's stages and packed window, at most: two blocks fit an SM
constexpr int STAGE_ALIGN = 128;           // TMA writes shared memory at 128-byte aligned addresses
constexpr int MAX_BOX = 256;               // TMA's largest box side
constexpr int PAD = 4;                     // words a box row has beyond its window
constexpr int TMA_THREADS = 128;           // a block's threads: they pack its windows, one of them issues the copies
constexpr int MIN_BLOCKS_PER_SM = 8;       // registers enough for this many blocks an SM
// rows path
constexpr int ROW_THREADS = 256;           // 8 warps, each on one window row at a time
constexpr int ROWS_PER_BLOCK = 64;         // a block takes max(1, ROWS_PER_BLOCK / win) windows

constexpr int ENCODE_ERROR = 100000;       // + the CUresult of a refused tensor-map encode

__host__ __device__ constexpr int aligned(int bytes) { return (bytes + STAGE_ALIGN - 1) / STAGE_ALIGN * STAGE_ALIGN; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(TMA_THREADS, MIN_BLOCKS_PER_SM)
windows_tma_kernel(const __grid_constant__ CUtensorMap frames, const int* __restrict__ yi, const int* __restrict__ xi,
                   unsigned* __restrict__ out, int Hp, int Wp, int K, int n_seeds, int win, int stages) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[MAX_STAGES];
  __shared__ int shift[MAX_STAGES];  // x minus the box's start, of the tile in each stage
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = gridDim.x;
  const int n = (n_seeds - 1 - static_cast<int>(blockIdx.x)) / G + 1;  // this block's seeds: blockIdx.x + i * G
  const int box_w = win + PAD, words = win * win;
  const unsigned tile_bytes = static_cast<unsigned>(box_w * win * 4);
  const unsigned stage_bytes = aligned(box_w * win * 4);
  unsigned char* base = smem + (STAGE_ALIGN - smem_u32(smem) % STAGE_ALIGN) % STAGE_ALIGN;
  unsigned* packed = reinterpret_cast<unsigned*>(base + stages * stage_bytes);
  const unsigned bar0 = smem_u32(full);
  const unsigned long long map = reinterpret_cast<unsigned long long>(&frames);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar0 + 8 * s), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the first warp: (x, y, b) of items 32c + lane (chunk c = j / 32 of the
  // next load j) and 32(c + 1) + lane, clamped into the frame
  int cx = 0, cy = 0, cb = 0, nx = 0, ny = 0, nb = 0;
  auto fetch = [&](int chunk, int& x, int& y, int& b) {
    const int i = chunk * 32 + lane;
    if (i < n) {
      const int s = static_cast<int>(blockIdx.x) + i * G;
      b = s / K;
      y = min(max(__ldg(yi + s), 0), Hp - win);
      x = min(max(__ldg(xi + s), 0), Wp - win);
    }
  };
  int j = 0;  // the next item to load; the first warp keeps it
  auto load = [&]() {
    if (j > 0 && (j & 31) == 0) {
      cx = nx, cy = ny, cb = nb;
      fetch((j >> 5) + 1, nx, ny, nb);
    }
    const int x = __shfl_sync(0xffffffffu, cx, j & 31);
    const int y = __shfl_sync(0xffffffffu, cy, j & 31);
    const int b = __shfl_sync(0xffffffffu, cb, j & 31);
    if (lane == 0) {
      const int s = j % stages;
      const unsigned bar = bar0 + 8 * s;
      shift[s] = x & 3;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(tile_bytes) : "memory");
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(base + s * stage_bytes)),
          "l"(map), "r"(x & ~3), "r"(y), "r"(b), "r"(bar)
          : "memory");
    }
    ++j;
  };
  if (tid < 32) {
    fetch(0, cx, cy, cb);
    fetch(1, nx, ny, nb);
    while (j < min(n, stages)) load();
  }

  // this thread's words of a window: o = tid + TMA_THREADS * t, at row r,
  // column c, stepped by (dr, dc)
  const int dr = TMA_THREADS / win, dc = TMA_THREADS % win;
  const int r0 = tid / win, c0 = tid % win;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    wait_parity(bar0 + 8 * s, static_cast<unsigned>(i / stages) & 1u);
    // the store of item i - 1 has read the packed window
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    const unsigned* tile = reinterpret_cast<const unsigned*>(base + s * stage_bytes) + shift[s];
#pragma unroll 4
    for (int o = tid, r = r0, c = c0; o < words; o += TMA_THREADS) {
      packed[o] = tile[r * box_w + c];
      r += dr, c += dc;
      if (c >= win) c -= win, ++r;
    }
    // the packed words, written by the threads, before the bulk store reads
    // them; the tile's words, read, before the next load overwrites them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      unsigned* dst = out + (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * G) * words;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_u32(packed)),
                   "r"(words * 4)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (tid < 32 && j < n) load();  // item i + stages, into the stage just read
  }
  // the shared memory may go once the last store has read it; the writes
  // land before the grid completes
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__global__ void __launch_bounds__(ROW_THREADS)
windows_rows_kernel(const unsigned* __restrict__ frames, const int* __restrict__ yi, const int* __restrict__ xi,
                    unsigned* __restrict__ out, int Hp, int Wp, int K, int n_seeds, int win, int per_block) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = static_cast<int>(blockIdx.x) * per_block;
  const int windows = min(per_block, n_seeds - first);
  int w = 0, r = warp;  // the warp's window and row: row index w * win + r
  while (r >= win) r -= win, ++w;
  const unsigned* src = nullptr;
  unsigned* dst = nullptr;
  int cur = -1;
  while (w < windows) {
    if (w != cur) {
      const int s = first + w;
      const int b = s / K;
      const int y = min(max(__ldg(yi + s), 0), Hp - win);
      const int x = min(max(__ldg(xi + s), 0), Wp - win);
      src = frames + (static_cast<size_t>(b) * Hp + y) * Wp + x;
      dst = out + static_cast<size_t>(s) * win * win;
      cur = w;
    }
    const unsigned* from = src + static_cast<size_t>(r) * Wp;
    unsigned* to = dst + static_cast<size_t>(r) * win;
    for (int c = lane; c < win; c += 32) to[c] = __ldg(from + c);
    r += ROW_THREADS / 32;
    while (r >= win) r -= win, ++w;
  }
}

}  // namespace

extern "C" {

// The wrapper packs these once a call (detect/cuda_kernels.py: _ARGS).
struct ExtractWindowsArgs {
  const void* frames;  // (B, Hp, Wp) 32-bit words
  const int* yi;       // (B, K)
  const int* xi;       // (B, K)
  void* out;           // (B, K, win, win) 32-bit words
  void* stream;        // a stream of `device`
  int B, Hp, Wp, K, win;
  int stages;  // the TMA path's tile stages, or 0: the rows path
  int device;  // the CUDA device the tensors lie on
};
static_assert(sizeof(ExtractWindowsArgs) == 72, "the wrapper packs 5 pointers, 7 ints and 4 bytes of padding");

const char* extract_windows_error_string(int code) {
  if (code >= ENCODE_ERROR) {
    thread_local char text[160];
    const char* what = nullptr;
    if (cuGetErrorString(static_cast<CUresult>(code - ENCODE_ERROR), &what) != CUDA_SUCCESS) what = nullptr;
    snprintf(text, sizeof text, "cuTensorMapEncodeTiled refused the frames' tensor map: %s",
             what ? what : "unknown CUresult");
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static int launch(const ExtractWindowsArgs* a, int device);

// Launches the path `a->stages` names on `a->device` and `a->stream`,
// making the device current for the launch only if it is not. Returns 0, a
// cudaError_t, or ENCODE_ERROR + a CUresult. Does not synchronise.
int extract_windows_launch(const ExtractWindowsArgs* a) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current == a->device) return launch(a, current);
  err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int result = launch(a, a->device);
  err = cudaSetDevice(current);
  return result != 0 ? result : static_cast<int>(err);
}

static int launch(const ExtractWindowsArgs* a, int device) {
  const int B = a->B, Hp = a->Hp, Wp = a->Wp, K = a->K, win = a->win, stages = a->stages;
  if (B < 1 || K < 1 || win < 1 || win > Hp || win > Wp || static_cast<long long>(B) * K > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = B * K;
  const auto stream = static_cast<cudaStream_t>(a->stream);
  if (stages == 0) {
    const int per_block = max(1, ROWS_PER_BLOCK / win);
    windows_rows_kernel<<<(n - 1) / per_block + 1, ROW_THREADS, 0, stream>>>(
        static_cast<const unsigned*>(a->frames), a->yi, a->xi, static_cast<unsigned*>(a->out), Hp, Wp, K, n, win,
        per_block);
    return static_cast<int>(cudaGetLastError());
  }
  const int ring = stages * aligned((win + PAD) * win * 4) + aligned(win * win * 4);
  if (stages < 1 || stages > MAX_STAGES || win % 4 || Wp % 4 || win + PAD > MAX_BOX || win + PAD > Wp ||
      ring > RING_BYTES || reinterpret_cast<uintptr_t>(a->frames) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Wp), static_cast<cuuint64_t>(Hp), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Wp) * 4, static_cast<cuuint64_t>(Hp) * Wp * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(win + PAD), static_cast<cuuint32_t>(win), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult enc = cuTensorMapEncodeTiled(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(a->frames), dims,
                                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(enc);
  // the grid: as many blocks an SM as fit at once with this shared memory,
  // on every SM. Worked out again when the device or the shared memory
  // changes (the last answer kept a thread); the limit on the kernel's
  // dynamic shared memory only ever rises to RING_BYTES' worth, so threads
  // gathering different windows never lower it under each other
  const int smem = ring + STAGE_ALIGN;  // the stages, the packed window and their alignment slack
  thread_local int grid_device = -1, grid_smem = -1, grid_blocks = 0;
  if (grid_device != device || grid_smem != smem) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && smem > 48 * 1024) {
      err = cudaFuncSetAttribute(windows_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES + STAGE_ALIGN);
    }
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, windows_tma_kernel, TMA_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_device = device, grid_smem = smem, grid_blocks = per_sm * sms;
  }
  windows_tma_kernel<<<min(n, grid_blocks), TMA_THREADS, smem, stream>>>(
      map, a->yi, a->xi, static_cast<unsigned*>(a->out), Hp, Wp, K, n, win, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
