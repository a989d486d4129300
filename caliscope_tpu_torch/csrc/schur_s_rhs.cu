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
// masked).
//
// Design. The TPU kernel walks point tiles in order into one VMEM
// accumulator. Here blocks run in parallel and share nothing, so:
//   pass 1 (s_rhs_partial): each block takes tiles of TP points round-robin.
//     Per tile it computes the inverse point blocks (written out), stages
//     G_k and Y_k for the tile in shared memory, and adds the tile's
//     Y_k G_k^T and Y_k bp_k into a per-block S and rhs kept in shared
//     memory (S is 83 KB at C = 16, hence dynamic shared memory). At the end
//     it writes its partial S and rhs to a workspace.
//   pass 2 (s_rhs_reduce): one thread per output entry sums the partials in
//     block order. No atomics anywhere, so every run gives the same bits.
// All arithmetic is IEEE float32 FMAs: no TF32, no tensor-core mma.
//
// What bounds it on an H100 SXM (C = 8, P = 40,960, the canonical dense
// problem): it must read Jc, Jp, w and bp once and write S, rhs and Hpp_inv
// once, about 36 MB, which is ~10.8 us at 3.35 TB/s; it must do ~0.77
// GFLOP, almost all in the three (72,P)x(P,72) products, of which only the
// upper triangle of the symmetric S is needed: ~11.5 us at the 67 TFLOP/s
// of non-tensor FP32. So it is bound by operations in IEEE f32, with the
// byte bound close behind. This first version is far from that bound: it
// computes the whole of S, and its inner product reads both operands from
// shared memory for every FMA. Making it fast is later work: compute only
// S's upper triangle, register-tile the product, split f32 into 3xTF32 or
// use wgmma for the products, and feed tiles with TMA.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 32;        // points per tile
constexpr int THREADS = 256;  // threads per block of pass 1
constexpr int MAX_C = 16;     // bound set by the shared-memory plan

__global__ void __launch_bounds__(THREADS)
s_rhs_partial(const float* __restrict__ jc, const float* __restrict__ jp,
              const float* __restrict__ w, const float* __restrict__ bp,
              const float* __restrict__ lam_ptr, float* __restrict__ hinv_out,
              float* __restrict__ s_part, float* __restrict__ rhs_part, int C, int P) {
  extern __shared__ float sm[];
  const int ncp = 9 * C;
  float* s_acc = sm;                  // [ncp][ncp]
  float* g = s_acc + ncp * ncp;       // [3][TP][ncp]
  float* y = g + 3 * TP * ncp;        // [3][TP][ncp]
  float* hv = y + 3 * TP * ncp;       // [9][TP]
  float* bps = hv + 9 * TP;           // [3][TP]
  float* rhs_acc = bps + 3 * TP;      // [ncp]
  const float lam = *lam_ptr;
  const int tid = threadIdx.x;

  for (int e = tid; e < ncp * ncp; e += blockDim.x) s_acc[e] = 0.f;
  for (int e = tid; e < ncp; e += blockDim.x) rhs_acc[e] = 0.f;

  const int n_tiles = (P + TP - 1) / TP;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    __syncthreads();  // the previous tile's readers are done with g, y, hv, bps

    // 1. damped inverse point blocks, one thread per point
    if (tid < TP) {
      const int p = p0 + tid;
      float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float b[3] = {0.f, 0.f, 0.f};
      if (p < P) {
        float d00 = 0.f, d01 = 0.f, d02 = 0.f, d11 = 0.f, d12 = 0.f, d22 = 0.f;
        for (int c = 0; c < C; ++c) {
          float t00 = 0.f, t01 = 0.f, t02 = 0.f, t11 = 0.f, t12 = 0.f, t22 = 0.f;
          for (int r = 0; r < 2; ++r) {
            const int cr = c * 2 + r;
            const float wv = w[(size_t)cr * P + p];
            const float j0 = jp[((size_t)cr * 3 + 0) * P + p];
            const float j1 = jp[((size_t)cr * 3 + 1) * P + p];
            const float j2 = jp[((size_t)cr * 3 + 2) * P + p];
            const float u0 = j0 * wv, u1 = j1 * wv, u2 = j2 * wv;
            t00 += u0 * j0; t01 += u0 * j1; t02 += u0 * j2;
            t11 += u1 * j1; t12 += u1 * j2; t22 += u2 * j2;
          }
          d00 += t00; d01 += t01; d02 += t02; d11 += t11; d12 += t12; d22 += t22;
        }
        const float pin = (d00 + d11 + d22 == 0.f) ? 1.f : 0.f;
        d00 += pin; d11 += pin; d22 += pin;
        const float h00 = d00 + lam * fmaxf(d00, 1e-12f) + 1e-12f;
        const float h11 = d11 + lam * fmaxf(d11, 1e-12f) + 1e-12f;
        const float h22 = d22 + lam * fmaxf(d22, 1e-12f) + 1e-12f;
        const float c00 = h11 * h22 - d12 * d12;
        const float c01 = d02 * d12 - d01 * h22;
        const float c02 = d01 * d12 - d02 * h11;
        const float c11 = h00 * h22 - d02 * d02;
        const float c12 = d01 * d02 - h00 * d12;
        const float c22 = h00 * h11 - d01 * d01;
        const float inv_det = 1.f / (h00 * c00 + d01 * c01 + d02 * c02);
        h[0] = c00 * inv_det; h[1] = c01 * inv_det; h[2] = c02 * inv_det;
        h[3] = h[1];          h[4] = c11 * inv_det; h[5] = c12 * inv_det;
        h[6] = h[2];          h[7] = h[5];          h[8] = c22 * inv_det;
        for (int q = 0; q < 9; ++q) hinv_out[(size_t)q * P + p] = h[q];
        for (int k = 0; k < 3; ++k) b[k] = bp[(size_t)k * P + p];
      }
      for (int q = 0; q < 9; ++q) hv[q * TP + tid] = h[q];
      for (int k = 0; k < 3; ++k) bps[k * TP + tid] = b[k];
    }

    // 2. coupling G_k[a, p] for the tile (zero past the last point)
    for (int e = tid; e < ncp * TP; e += blockDim.x) {
      const int a = e / TP, pl = e % TP, p = p0 + pl;
      const int c = a / 9, i = a % 9;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      if (p < P) {
        for (int r = 0; r < 2; ++r) {
          const int cr = c * 2 + r;
          const float u = jc[((size_t)cr * 9 + i) * P + p] * w[(size_t)cr * P + p];
          g0 += u * jp[((size_t)cr * 3 + 0) * P + p];
          g1 += u * jp[((size_t)cr * 3 + 1) * P + p];
          g2 += u * jp[((size_t)cr * 3 + 2) * P + p];
        }
      }
      g[(0 * TP + pl) * ncp + a] = g0;
      g[(1 * TP + pl) * ncp + a] = g1;
      g[(2 * TP + pl) * ncp + a] = g2;
    }
    __syncthreads();

    // 3. Y_k = sum_j G_j Hpp_inv[j, k]
    for (int e = tid; e < ncp * TP; e += blockDim.x) {
      const int pl = e / ncp, a = e % ncp;
      const float G0 = g[(0 * TP + pl) * ncp + a];
      const float G1 = g[(1 * TP + pl) * ncp + a];
      const float G2 = g[(2 * TP + pl) * ncp + a];
      for (int k = 0; k < 3; ++k) {
        y[(k * TP + pl) * ncp + a] =
            G0 * hv[(0 * 3 + k) * TP + pl] + G1 * hv[(1 * 3 + k) * TP + pl] + G2 * hv[(2 * 3 + k) * TP + pl];
      }
    }
    __syncthreads();

    // 4. S += sum_k Y_k G_k^T and rhs += sum_k Y_k bp_k over the tile
    for (int e = tid; e < ncp * ncp; e += blockDim.x) {
      const int a = e / ncp, b = e % ncp;
      float acc = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float* yk = y + k * TP * ncp;
        const float* gk = g + k * TP * ncp;
#pragma unroll 8
        for (int pl = 0; pl < TP; ++pl) acc += yk[pl * ncp + a] * gk[pl * ncp + b];
      }
      s_acc[e] += acc;
    }
    for (int a = tid; a < ncp; a += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < 3; ++k)
        for (int pl = 0; pl < TP; ++pl) acc += y[(k * TP + pl) * ncp + a] * bps[k * TP + pl];
      rhs_acc[a] += acc;
    }
  }
  __syncthreads();
  float* s_dst = s_part + (size_t)blockIdx.x * ncp * ncp;
  for (int e = tid; e < ncp * ncp; e += blockDim.x) s_dst[e] = s_acc[e];
  for (int e = tid; e < ncp; e += blockDim.x) rhs_part[(size_t)blockIdx.x * ncp + e] = rhs_acc[e];
}

__global__ void s_rhs_reduce(const float* __restrict__ s_part, const float* __restrict__ rhs_part,
                             float* __restrict__ s_out, float* __restrict__ rhs_out, int n_blocks,
                             int ncp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_s = ncp * ncp;
  if (e < n_s) {
    float acc = 0.f;
    for (int b = 0; b < n_blocks; ++b) acc += s_part[(size_t)b * n_s + e];
    s_out[e] = acc;
  } else if (e < n_s + ncp) {
    const int a = e - n_s;
    float acc = 0.f;
    for (int b = 0; b < n_blocks; ++b) acc += rhs_part[(size_t)b * ncp + a];
    rhs_out[a] = acc;
  }
}

}  // namespace

extern "C" {

int schur_s_rhs_max_cameras() { return MAX_C; }

int schur_s_rhs_tile_points() { return TP; }

// Dynamic shared memory of pass 1, in bytes.
long long schur_s_rhs_shared_bytes(int C) {
  const long long ncp = 9LL * C;
  return (ncp * ncp + 6LL * TP * ncp + 12LL * TP + ncp) * (long long)sizeof(float);
}

const char* schur_s_rhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both passes on `stream`; s_part (n_blocks, 9C, 9C) and rhs_part
// (n_blocks, 9C) are scratch the caller allocates. Returns cudaGetLastError()
// (0 on success). Does not synchronise.
int schur_s_rhs_launch(const float* jc, const float* jp, const float* w, const float* bp,
                       const float* lam, float* s_out, float* rhs_out, float* hinv_out,
                       float* s_part, float* rhs_part, int C, int P, int n_blocks, void* stream) {
  if (C < 1 || C > MAX_C || P < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ncp = 9 * C;
  const int smem = static_cast<int>(schur_s_rhs_shared_bytes(C));
  cudaError_t err =
      cudaFuncSetAttribute(s_rhs_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  s_rhs_partial<<<n_blocks, THREADS, smem, s>>>(jc, jp, w, bp, lam, hinv_out, s_part, rhs_part, C, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = ncp * ncp + ncp;
  s_rhs_reduce<<<(n_out + 255) / 256, 256, 0, s>>>(s_part, rhs_part, s_out, rhs_out, n_blocks, ncp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
