// Fused Schur-complement assembly for the dense point-minor BA layout.
//
// Replaces caliscope_tpu/solvers/pallas_schur.py::_schur_s_rhs_impl (the
// Pallas TPU kernel _s_rhs_kernel). Same contract, same three outputs, none
// negated:
//
//   per point p:  Hpp_inv[:,:,p] = damped inverse of d_p = sum_{c,r} w Jp Jp^T
//                 (zero-trace blocks pinned to I, diagonal floored at 1e-12,
//                  H = d + lam*max(diag, 1e-12) + 1e-12, closed-form
//                  symmetric inverse)
//   G_k[a,p]   = sum_r Jc[c,r,i,p] w[c,r,p] Jp[c,r,k,p]      a = 9c + i
//   Y_k[a,p]   = sum_j G_j[a,p] Hpp_inv[j,k,p]
//   S          = sum_k sum_p Y_k[:,p] G_k[:,p]^T             (9C x 9C)
//   rhs        = sum_k sum_p Y_k[:,p] bp[k,p]                 (9C)
//
// Inputs (float32, contiguous): Jc (C,2,9,P), Jp (C,2,3,P), w (C,2,P),
// bp (3,P), lam (1) on the device. Outputs: S (9C,9C), rhs (9C),
// Hpp_inv (3,3,P). C <= 16; P is any positive count (a ragged last tile is
// filled with zeros, which add nothing).
//
// What bounds it on an H100 SXM (C = 8, P = 40,960, the canonical dense
// problem): it must read Jc, Jp, w and bp once and write S, rhs and Hpp_inv
// once, about 36 MB, ~10.8 us at 3.35 TB/s; and it must do ~0.77 GFLOP,
// almost all in the three (72,P)x(P,72) products, of which only the upper
// triangle of the symmetric S is needed: ~11.5 us at the 67 TFLOP/s of
// non-tensor FP32. So it is bound by operations in IEEE f32, with the byte
// bound close behind. An SM issues 128 FP32 FMAs a clock but reads only 32
// words of shared memory, so the product has to reuse each word it reads
// several times, out of registers.
//
// Design. The TPU kernel walks point tiles in order into one VMEM
// accumulator. Here blocks run in parallel and share nothing, so each block
// keeps a partial S and a second pass adds the partials.
//   pass 1 (s_rhs_partial): one persistent block of 256 threads an SM, which
//   takes tiles of TP points round-robin (TP = 40 at C = 8; the largest
//   multiple of 4 and of the slices, up to 64, whose buffers fit 227 KB).
//   - S lives in registers. It is cut into 8 x 8 tiles and only the tiles on
//     and above the diagonal are kept (45 at C = 8, 171 at C = 16; 9C is
//     padded to a multiple of 8 with zero rows). A thread owns one tile's 64
//     accumulators; per point and k it reads 8 values of Y_k and 8 of G_k
//     (four 16-byte loads) for 64 FMAs: 4 FMAs a word, not 0.5. The threads
//     that own the same tile split the tile's points into slices (5 slices
//     at C = 8: 225 of 256 threads), and the slices are added in a fixed
//     order through shared memory when the block has walked its tiles.
//   - G_k and Y_k are staged per point as [k][point][row], a row laid out so
//     that the two 16-byte halves of tile j lie at words 4j and 4*NT + 4j:
//     the eight threads that share a shared-memory phase read neighbouring
//     tiles, hence distinct banks, or the same address. A point row's stride
//     is an odd multiple of 4 words. The staging gives a lane one point and
//     one camera (the inverse, the weights and Jp read once for nine rows of
//     Jc); a warp of 8 points x 4 cameras stores to 32 distinct banks.
//   - Three tiles are in flight. While the block multiplies tile i out of
//     one staged buffer, it stages tile i+1 into the other (even warps stage
//     first and multiply second, odd warps the other way round), and the
//     raw Jc, Jp, w and bp of tile i+2 arrive by cp.async in the raw buffer
//     that tile i left. After the barrier the point blocks of tile i+2 are
//     summed (THREADS / TP threads a point, cameras dealt out among them,
//     the partial sums added in order) and inverted by one thread a point.
//   - rhs: thread e < 3 * 8 NT owns entry (row, k) and walks the staged tile's
//     points in four FMA chains; the three k are added at the end.
//   pass 2 (s_rhs_reduce): 32 entries a block; eight groups of threads each
//   add every eighth partial (coalesced), and the eight sums are added in
//   order. It writes each entry and its mirror image, so S is exactly
//   symmetric. No atomics anywhere: every run gives the same bits.
// All arithmetic is IEEE float32 FMAs: no TF32, no tensor-core mma.
//
// Where it stands (H100 SXM, C = 8, P = 40,960): the block is bound by
// shared-memory traffic, not by the FMA pipe: the product's four 16-byte
// loads per 64 FMAs take the load pipe as long as the FMAs take theirs, and
// the staging's loads and stores come on top. Timed with parts taken out,
// the product is ~20 us, the staging ~11, the copies ~8, the point inverses
// and rhs ~4 each, and ~19 us are the two launches, the first tile's
// exposed copy and staging, the slices' sum and pass 2. Next: 8 x 16 tiles
// for half the loads per FMA, or the products on the tensor cores in
// 3xTF32, should the rule "f32 means IEEE f32" ever be lifted for them.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // threads per block of pass 1
constexpr int MAX_C = 16;           // bound set by the shared-memory plan
constexpr int SMEM_BYTES = 232448;  // shared memory a block may take (227 KB)
constexpr int MAX_SLICES = 8;
constexpr int MAX_TP = 64;
constexpr int REDUCE_GROUPS = 8;    // groups of 32 threads in a block of pass 2

// How a camera count is laid out; the same on the host and the device.
struct Plan {
  int ncp;       // 9C
  int nt;        // 8-row tiles a side
  int tiles;     // tiles on and above the diagonal
  int slices;    // threads that share a tile of S
  int pps;       // points per slice
  int tp;        // points per tile: slices * pps, a multiple of 4
  int row;       // words per staged point row
  int raw_rows;  // rows of tp floats of raw input per tile
  int partial;   // floats a block writes for pass 2
};

// floats of dynamic shared memory for tiles of tp points: two raw tiles, two
// staged tiles (Y and G), the inverses, two tiles' bp, the point blocks'
// partial sums
__host__ __device__ inline long long shared_floats(int raw_rows, int row, int tp) {
  return 2LL * raw_rows * tp + 12LL * tp * row + 9LL * tp + 6LL * tp + 6LL * THREADS;
}

__host__ __device__ inline Plan make_plan(int C) {
  Plan pl;
  pl.ncp = 9 * C;
  pl.nt = (pl.ncp + 7) / 8;
  pl.tiles = pl.nt * (pl.nt + 1) / 2;
  const int s = THREADS / pl.tiles;
  pl.slices = s < 1 ? 1 : (s > MAX_SLICES ? MAX_SLICES : s);
  pl.row = 8 * pl.nt + 4;
  pl.raw_rows = 26 * C + 3;
  pl.partial = 64 * pl.tiles + 8 * pl.nt;
  // the largest tile that fits: at most MAX_TP points, a multiple of 4 (the
  // 16-byte copies) and of the slices
  pl.pps = 1;
  for (int pps = MAX_TP; pps >= 1; --pps) {
    const int tp = pl.slices * pps;
    if (tp <= MAX_TP && tp % 4 == 0 &&
        shared_floats(pl.raw_rows, pl.row, tp) * (long long)sizeof(float) <= SMEM_BYTES) {
      pl.pps = pps;
      break;
    }
  }
  pl.tp = pl.slices * pl.pps;
  return pl;
}

// Everything a block's phases share.
struct Tile {
  const float* jc; const float* jp; const float* w; const float* bp;
  float* hinv_out;
  float* raw0;       // two raw tiles, [raw_rows][TP] each
  float* staged0;    // two staged tiles, Y [3][TP][ROW] then G [3][TP][ROW] each
  float* bps0;       // two tiles' bp, [3][TP] each
  float* hv;         // [9][TP]
  float* dpart;      // [parts][6][TP]
  float lam;
  int C, P, TP, ROW, NT, ncp, raw_rows, vec;
  __device__ float* raw(int b) const { return raw0 + b * raw_rows * TP; }
  __device__ float* staged(int b) const { return staged0 + b * 6 * TP * ROW; }
  __device__ float* bps(int b) const { return bps0 + b * 3 * TP; }
};

// Start the copy of tile `tile`'s raw rows (Jc, Jp, w, bp, in that order)
// into `raw`; points past P are written as zeros. vec: P is a multiple of 4
// and the inputs are 16-byte aligned, so the copies are 16 bytes each.
__device__ __forceinline__ void fetch_tile(const Tile& t, float* raw, int tile) {
  const int p0 = tile * t.TP;
  const int per_row = t.vec ? t.TP / 4 : t.TP;
  const int step = t.vec ? 4 : 1;
  int q = threadIdx.x / per_row, x = threadIdx.x % per_row;
  const int dq = THREADS / per_row, dx = THREADS % per_row;
  while (q < t.raw_rows) {
    const float* src;
    if (q < 18 * t.C) src = t.jc + (size_t)q * t.P;
    else if (q < 24 * t.C) src = t.jp + (size_t)(q - 18 * t.C) * t.P;
    else if (q < 26 * t.C) src = t.w + (size_t)(q - 24 * t.C) * t.P;
    else src = t.bp + (size_t)(q - 26 * t.C) * t.P;
    float* dst = raw + q * t.TP + x * step;
    const int p = p0 + x * step;
    if (p < t.P) {
      if (t.vec) __pipeline_memcpy_async(dst, src + p, 16);
      else __pipeline_memcpy_async(dst, src + p, 4);
    } else if (t.vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *dst = 0.f;
    }
    q += dq;
    x += dx;
    if (x >= per_row) {
      x -= per_row;
      ++q;
    }
  }
  __pipeline_commit();
}

// The damped inverse point blocks of the tile in `raw` into t.hv (and out to
// Hpp_inv for the points that exist). THREADS / TP threads share a point:
// each sums the cameras dealt to it, and one thread adds those sums in
// order. Two barriers inside; the caller's barrier must precede it.
__device__ __forceinline__ void point_inverses(const Tile& t, const float* raw, int tile) {
  const int TP = t.TP, tid = threadIdx.x;
  const float* raw_jp = raw + 18 * t.C * TP;
  const float* raw_w = raw + 24 * t.C * TP;
  const int parts = min(THREADS / TP, t.C);
  const int pt = tid % TP, part_id = tid / TP;
  if (part_id < parts) {
    float d00 = 0.f, d01 = 0.f, d02 = 0.f, d11 = 0.f, d12 = 0.f, d22 = 0.f;
    for (int c = part_id; c < t.C; c += parts) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cr = c * 2 + r;
        const float wv = raw_w[cr * TP + pt];
        const float j0 = raw_jp[(cr * 3 + 0) * TP + pt];
        const float j1 = raw_jp[(cr * 3 + 1) * TP + pt];
        const float j2 = raw_jp[(cr * 3 + 2) * TP + pt];
        const float u0 = j0 * wv, u1 = j1 * wv, u2 = j2 * wv;
        d00 += u0 * j0; d01 += u0 * j1; d02 += u0 * j2;
        d11 += u1 * j1; d12 += u1 * j2; d22 += u2 * j2;
      }
    }
    float* dp = t.dpart + part_id * 6 * TP + pt;
    dp[0] = d00; dp[TP] = d01; dp[2 * TP] = d02; dp[3 * TP] = d11; dp[4 * TP] = d12; dp[5 * TP] = d22;
  }
  __syncthreads();
  if (tid < TP) {
    float d[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < parts; ++q) {
#pragma unroll
      for (int m = 0; m < 6; ++m) d[m] += t.dpart[(q * 6 + m) * TP + tid];
    }
    float d00 = d[0], d11 = d[3], d22 = d[5];
    const float d01 = d[1], d02 = d[2], d12 = d[4];
    const float pin = (d00 + d11 + d22 == 0.f) ? 1.f : 0.f;
    d00 += pin; d11 += pin; d22 += pin;
    const float h00 = d00 + t.lam * fmaxf(d00, 1e-12f) + 1e-12f;
    const float h11 = d11 + t.lam * fmaxf(d11, 1e-12f) + 1e-12f;
    const float h22 = d22 + t.lam * fmaxf(d22, 1e-12f) + 1e-12f;
    const float c00 = h11 * h22 - d12 * d12;
    const float c01 = d02 * d12 - d01 * h22;
    const float c02 = d01 * d12 - d02 * h11;
    const float c11 = h00 * h22 - d02 * d02;
    const float c12 = d01 * d02 - h00 * d12;
    const float c22 = h00 * h11 - d01 * d01;
    const float inv_det = 1.f / (h00 * c00 + d01 * c01 + d02 * c02);
    float h[9];
    h[0] = c00 * inv_det; h[1] = c01 * inv_det; h[2] = c02 * inv_det;
    h[3] = h[1];          h[4] = c11 * inv_det; h[5] = c12 * inv_det;
    h[6] = h[2];          h[7] = h[5];          h[8] = c22 * inv_det;
#pragma unroll
    for (int q = 0; q < 9; ++q) t.hv[q * TP + tid] = h[q];
    const int p = tile * TP + tid;
    if (p < t.P) {
#pragma unroll
      for (int q = 0; q < 9; ++q) t.hinv_out[(size_t)q * t.P + p] = h[q];
    }
  }
  __syncthreads();
}

// Where row a of G_k or Y_k lies in a staged point row: the two 16-byte
// halves of 8-row tile j at words 4j and 4*NT + 4j.
__device__ __forceinline__ int staged_pos(int a, int NT) {
  const int g = a >> 2;
  return (g & 1) * 4 * NT + (g >> 1) * 4 + (a & 3);
}

// G_k and Y_k of the tile in `raw` (with its inverses in t.hv) into `staged`,
// and its bp into `bps`. A lane takes one point and one camera: it reads the
// point's inverse, the camera's weights and Jp once, and walks the camera's
// nine rows of Jc. A warp is 8 points x 4 cameras: its 32 stores of a row
// hit 32 distinct banks (a point row's stride is an odd multiple of 4 words,
// and 9c + i of four neighbouring cameras differ in their low two bits).
// The padding rows past 9C are zeroed once, before the first tile.
__device__ __forceinline__ void stage_tile(const Tile& t, const float* raw, float* staged, float* bps) {
  const int TP = t.TP, ROW = t.ROW, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* raw_jp = raw + 18 * t.C * TP;
  const float* raw_w = raw + 24 * t.C * TP;
  const float* raw_bp = raw + 26 * t.C * TP;
  float* ys = staged;
  float* gs = staged + 3 * TP * ROW;
  const int n_cg = (t.C + 3) / 4;
  const int n_items = n_cg * ((TP + 7) / 8);
  for (int item = warp; item < n_items; item += THREADS / 32) {
    const int pt = (item / n_cg) * 8 + (lane & 7);
    const int c = (item % n_cg) * 4 + (lane >> 3);
    if (pt >= TP || c >= t.C) continue;
    float h[9], wv[2], jpv[2][3];
#pragma unroll
    for (int q = 0; q < 9; ++q) h[q] = t.hv[q * TP + pt];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wv[r] = raw_w[(2 * c + r) * TP + pt];
#pragma unroll
      for (int k = 0; k < 3; ++k) jpv[r][k] = raw_jp[((2 * c + r) * 3 + k) * TP + pt];
    }
    const float* jc0 = raw + (2 * c * 9) * TP + pt;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float u = jc0[(r * 9 + i) * TP] * wv[r];
#pragma unroll
        for (int k = 0; k < 3; ++k) g[k] += u * jpv[r][k];
      }
      const int at = pt * ROW + staged_pos(9 * c + i, t.NT);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ys[k * TP * ROW + at] = g[0] * h[0 * 3 + k] + g[1] * h[1 * 3 + k] + g[2] * h[2 * 3 + k];
        gs[k * TP * ROW + at] = g[k];
      }
    }
  }
  for (int e = tid; e < 3 * TP; e += THREADS) bps[e] = raw_bp[e];
}

__global__ void __launch_bounds__(THREADS, 1)
s_rhs_partial(const float* __restrict__ jc, const float* __restrict__ jp,
              const float* __restrict__ w, const float* __restrict__ bp,
              const float* __restrict__ lam_ptr, float* __restrict__ hinv_out,
              float* __restrict__ part, int C, int P, int vec16) {
  extern __shared__ __align__(16) float sm[];
  const Plan pl = make_plan(C);
  const int TP = pl.tp, ROW = pl.row, NT = pl.nt;
  Tile t;
  t.jc = jc; t.jp = jp; t.w = w; t.bp = bp; t.hinv_out = hinv_out;
  t.raw0 = sm;
  t.staged0 = t.raw0 + 2 * pl.raw_rows * TP;
  t.hv = t.staged0 + 12 * TP * ROW;
  t.bps0 = t.hv + 9 * TP;
  t.dpart = t.bps0 + 6 * TP;
  t.lam = *lam_ptr;
  t.C = C; t.P = P; t.TP = TP; t.ROW = ROW; t.NT = NT; t.ncp = pl.ncp; t.raw_rows = pl.raw_rows; t.vec = vec16;
  const int tid = threadIdx.x, warp = tid >> 5;

  // this thread's tile of S and its slice of every point tile
  const int my_tile = tid % pl.tiles, my_slice = tid / pl.tiles;
  const bool active = my_slice < pl.slices;
  int ta = 0, tb = my_tile;
  while (tb >= NT - ta) {  // rows of the upper triangle hold NT, NT-1, ... tiles
    tb -= NT - ta;
    ++ta;
  }
  tb += ta;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // rhs: entry (row a, k) number tid, and tid + THREADS where 3 * 8 NT > THREADS
  const int n_rhs = 3 * 8 * NT;
  float racc[2] = {0.f, 0.f};
  int rhs_y[2], rhs_b[2];  // offsets of the entry's Y_k row word and bp_k row
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = tid + m * THREADS, a = e % (8 * NT), k = e / (8 * NT);
    rhs_y[m] = k * TP * ROW + staged_pos(a, NT);
    rhs_b[m] = k * TP;
  }

  const int n_tiles = (P + TP - 1) / TP;
  const int stride = gridDim.x;
  // prologue: the first tile staged, the second one's raw rows and inverses ready
  fetch_tile(t, t.raw(0), blockIdx.x);
  {
    const int pad = 8 * NT - pl.ncp;  // rows of zeros that fill the last 8-row tile
    for (int e = tid; e < 12 * TP * pad; e += THREADS) {
      t.staged0[(e / pad) * ROW + staged_pos(pl.ncp + e % pad, NT)] = 0.f;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  point_inverses(t, t.raw(0), blockIdx.x);
  const bool second = blockIdx.x + stride < n_tiles;
  if (second) fetch_tile(t, t.raw(1), blockIdx.x + stride);
  stage_tile(t, t.raw(0), t.staged(0), t.bps(0));
  __pipeline_wait_prior(0);
  __syncthreads();
  if (second) point_inverses(t, t.raw(1), blockIdx.x + stride);

  int cur = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += stride, cur ^= 1) {
    // here: staged[cur] holds this tile; raw[cur ^ 1] the next one, and hv its inverses
    const int next = tile + stride, after = next + stride;
    if (after < n_tiles) fetch_tile(t, t.raw(cur), after);  // lands under the product
    // even warps stage the next tile and then multiply, odd warps the other
    // way round: the staging waits on shared memory, the product on the FMA
    // pipe, and so each fills the other's gaps
    const bool stage_first = (warp & 1) == 0;
    if (next < n_tiles && stage_first) stage_tile(t, t.raw(cur ^ 1), t.staged(cur ^ 1), t.bps(cur ^ 1));
    const float* ys = t.staged(cur);
    const float* gs = ys + 3 * TP * ROW;
    if (active) {
      const int pt0 = my_slice * pl.pps;
      for (int pt = pt0; pt < pt0 + pl.pps; ++pt) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* yrow = ys + (k * TP + pt) * ROW;
          const float* grow = gs + (k * TP + pt) * ROW;
          const float4 y0 = *reinterpret_cast<const float4*>(yrow + 4 * ta);
          const float4 y1 = *reinterpret_cast<const float4*>(yrow + 4 * NT + 4 * ta);
          const float4 g0 = *reinterpret_cast<const float4*>(grow + 4 * tb);
          const float4 g1 = *reinterpret_cast<const float4*>(grow + 4 * NT + 4 * tb);
          const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
          const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(y[i], g[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (tid + m * THREADS < n_rhs) {
        const float* yk = ys + rhs_y[m];
        const float* bk = t.bps(cur) + rhs_b[m];
        // four chains of FMAs, added in a fixed order (TP is a multiple of 4)
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        for (int pt = 0; pt < TP; pt += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) r[j] = fmaf(yk[(pt + j) * ROW], bk[pt + j], r[j]);
        }
        racc[m] += (r[0] + r[1]) + (r[2] + r[3]);
      }
    }
    if (next < n_tiles && !stage_first) stage_tile(t, t.raw(cur ^ 1), t.staged(cur ^ 1), t.bps(cur ^ 1));
    __pipeline_wait_prior(0);
    __syncthreads();  // staged[cur], raw[cur ^ 1] and hv are done with; raw[cur] has landed
    if (after < n_tiles) point_inverses(t, t.raw(cur), after);
  }

  // the slices of every tile, added in slice order; then out to the workspace
  float* red = t.staged(0);             // [64][tiles]
  float* rred = red + 64 * pl.tiles;    // [8 * NT]
  for (int s = 0; s < pl.slices; ++s) {
    if (active && my_slice == s) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* dst = red + (i * 8 + j) * pl.tiles + my_tile;
          *dst = (s == 0) ? acc[i][j] : *dst + acc[i][j];
        }
      }
    }
    __syncthreads();
  }
  // rhs: the three k of a row, added in order (the entries of k lie 8 NT apart)
  float* rk = t.staged(1);  // [3][8 * NT]
#pragma unroll
  for (int m = 0; m < 2; ++m)
    if (tid + m * THREADS < n_rhs) rk[tid + m * THREADS] = racc[m];
  __syncthreads();
  for (int a = tid; a < 8 * NT; a += THREADS) rred[a] = rk[a] + rk[8 * NT + a] + rk[16 * NT + a];
  __syncthreads();
  float* dst = part + (size_t)blockIdx.x * pl.partial;
  for (int e = tid; e < pl.partial; e += THREADS) dst[e] = red[e];
}

// Adds the blocks' partials in a fixed order and writes S (both triangles)
// and rhs. A partial is [64][tiles] tile entries, then 8 * NT entries of rhs.
__global__ void __launch_bounds__(32 * REDUCE_GROUPS)
s_rhs_reduce(const float* __restrict__ part, float* __restrict__ s_out, float* __restrict__ rhs_out,
             int n_blocks, int C) {
  __shared__ float sums[REDUCE_GROUPS][32];
  const Plan pl = make_plan(C);
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (e < pl.partial) {
    for (int b = group; b < n_blocks; b += REDUCE_GROUPS) acc += part[(size_t)b * pl.partial + e];
  }
  sums[group][lane] = acc;
  __syncthreads();
  if (group != 0 || e >= pl.partial) return;
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < REDUCE_GROUPS; ++q) total += sums[q][lane];
  if (e >= 64 * pl.tiles) {
    const int a = e - 64 * pl.tiles;
    if (a < pl.ncp) rhs_out[a] = total;
    return;
  }
  const int ij = e / pl.tiles;
  int ta = 0, tb = e % pl.tiles;
  while (tb >= pl.nt - ta) {
    tb -= pl.nt - ta;
    ++ta;
  }
  tb += ta;
  const int i = ij / 8, j = ij % 8;
  const int a = 8 * ta + i, b = 8 * tb + j;
  // a diagonal tile holds both (i, j) and (j, i), summed in different
  // orders: keep the upper one, so that the mirror image is exact
  if (a > b || b >= pl.ncp) return;
  s_out[a * pl.ncp + b] = total;
  s_out[b * pl.ncp + a] = total;
}

}  // namespace

extern "C" {

int schur_s_rhs_max_cameras() { return MAX_C; }

// Dynamic shared memory of pass 1, in bytes.
long long schur_s_rhs_shared_bytes(int C) {
  const Plan pl = make_plan(C);
  return shared_floats(pl.raw_rows, pl.row, pl.tp) * (long long)sizeof(float);
}

// Blocks of pass 1 for P points on a device of n_sm SMs: one persistent
// block an SM, and never more than there are tiles.
int schur_s_rhs_blocks(int C, int P, int n_sm) {
  const int tp = make_plan(C).tp;
  const int n_tiles = (P + tp - 1) / tp;
  return n_tiles < n_sm ? n_tiles : n_sm;
}

// Floats of workspace each block of pass 1 writes.
int schur_s_rhs_partial_floats(int C) { return make_plan(C).partial; }

const char* schur_s_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both passes on `stream`; part (n_blocks, schur_s_rhs_partial_floats(C))
// is scratch the caller allocates. Returns cudaGetLastError() (0 on
// success). Does not synchronise.
int schur_s_rhs_launch(const float* jc, const float* jp, const float* w, const float* bp,
                       const float* lam, float* s_out, float* rhs_out, float* hinv_out,
                       float* part, int C, int P, int n_blocks, void* stream) {
  if (C < 1 || C > MAX_C || P < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(C);
  if (n_blocks > (P + pl.tp - 1) / pl.tp) return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in shared-memory size is set once per device, at the most any C takes
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(s_rhs_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int smem = static_cast<int>(schur_s_rhs_shared_bytes(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t addresses = reinterpret_cast<size_t>(jc) | reinterpret_cast<size_t>(jp) |
                           reinterpret_cast<size_t>(w) | reinterpret_cast<size_t>(bp);
  const int vec16 = (P % 4 == 0) && (addresses % 16 == 0);
  s_rhs_partial<<<n_blocks, THREADS, smem, s>>>(jc, jp, w, bp, lam, hinv_out, part, C, P, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  s_rhs_reduce<<<(pl.partial + 31) / 32, 32 * REDUCE_GROUPS, 0, s>>>(part, s_out, rhs_out, n_blocks, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
