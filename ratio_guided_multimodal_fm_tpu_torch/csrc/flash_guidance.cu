// mc_feng guidance (Feng et al. Alg. 2) for Hopper, IEEE float32 throughout.
//
// Replaces: ratio_guided_multimodal_fm_tpu/ops/guidance_pallas.py:flash_guidance
// (body `_kernel`), which walks the MC axis N as a sequential grid with a
// [TB, Dx+Dy] float32 accumulator in VMEM. At the main-path width
// (Dx+Dy = 1024+3072 floats a row) that accumulator does not fit a CTA, and
// CTAs cannot carry a sum from one grid step to the next, so the function is
// computed here in three kernels instead of one online softmax:
//
//   1. scores_partial: a tiled GEMM of A = [x_t | y_t] (B rows) against
//      V = [X1 | Y1] (N rows) over the concatenated feature axis, split over
//      K so that the B=512, N=256 product fills the card. Each split writes
//      its partial cross products and the partial squared row norms of V
//      (computed from the tiles already in shared memory).
//   2. row_softmax: one CTA per trajectory b sums the K-splits, forms
//        s[n] = log r[n] - (t^2 |v_n|^2 - 2t cross[n]) / (2 sigma^2),
//      sigma = 1 - t + 1e-3, then m = max s, l = sum e^{s-m},
//      q = sum e^{2(s-m)}, ESS = l^2/(q+1e-30) and W = e^{s-m}/(l+1e-30).
//      The row constant |a|^2 of |a - t v_n|^2 cancels in the softmax and is
//      left out: at D = 4096 it is ~4096, and its float32 rounding alone
//      would move s by ~1e-4. Materialising W [B, N] costs 512 KB.
//   3. weighted_sum: a tiled GEMM G = (W V - [x_t | y_t]) / sigma, written
//      back split into g_x and g_y.
//
// Masked edges stand in for the TPU kernel's -1e30 log-ratio and zero
// feature padding: rows n >= N and features d >= Dx+Dy are never read.
// t is a kernel argument, so nothing is rebuilt per ODE step.
//
// Bound on the card: 2*B*N*D FMAs, 2.15 GFLOP at B=512, N=256, D=4096,
// which at the H100 SXM's 67 TFLOP/s non-tensor float32 rate is ~32 us;
// the ~21 MB of inputs and outputs take ~6 us at 3.35 TB/s. So the bound
// is operations. The design keeps both GEMMs in plain FMA (no TF32: the
// JAX reference pins float32 dots to HIGHEST) with a 4x4 register tile per
// thread, float4 shared-memory reads, and enough CTAs (K-split for the
// first GEMM) to cover all SMs. wgmma/TMA are left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEpsT = 1e-3f;   // sigma floor, ref flow_utils.py:279
constexpr int kBM = 64;          // tile rows (trajectories b)
constexpr int kBN = 64;          // tile cols (MC rows n, or features d)
constexpr int kBK = 16;          // reduction depth per shared-memory stage
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowThreads = 256;

// Element (row, k) of the virtual concat [P | Q] with row widths Dp, Dq.
__device__ __forceinline__ float concat_at(const float* __restrict__ P,
                                           const float* __restrict__ Q,
                                           int row, int k, int Dp, int Dq) {
  return k < Dp ? P[(size_t)row * Dp + k] : Q[(size_t)row * Dq + (k - Dp)];
}

// Kernel 1. grid (ceil(N/kBN), ceil(B/kBM), slices), block kThreads.
// cross_ws[z][b][n] = sum_{k in slice z} A[b,k] V[n,k];
// vnorm_ws[z][n] = sum_{k in slice z} V[n,k]^2 (written by blockIdx.y == 0).
__global__ void __launch_bounds__(kThreads)
scores_partial_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                      const float* __restrict__ X1, const float* __restrict__ Y1,
                      int B, int N, int Dx, int Dy, int k_per_slice,
                      float* __restrict__ cross_ws,
                      float* __restrict__ vnorm_ws) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Vs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int z = blockIdx.z;
  const int D = Dx + Dy;
  const int k_begin = z * k_per_slice;
  const int k_end = min(D, k_begin + k_per_slice);

  // Loader mapping: each thread stages 4 consecutive k of one tile row.
  const int ld_row = tid / 4;          // 0..63
  const int ld_k = (tid % 4) * 4;      // 0, 4, 8, 12
  const int a_row = m0 + ld_row;
  const int v_row = n0 + ld_row;

  const bool norm_v = blockIdx.y == 0 && tid < kBN;
  float nrm = 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ld_k + j;
      const bool kin = k < k_end;
      As[ld_k + j][ld_row] =
          (kin && a_row < B) ? concat_at(xt, yt, a_row, k, Dx, Dy) : 0.f;
      Vs[ld_k + j][ld_row] =
          (kin && v_row < N) ? concat_at(X1, Y1, v_row, k, Dx, Dy) : 0.f;
    }
    __syncthreads();

    if (norm_v) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) nrm = fmaf(Vs[kk][tid], Vs[kk][tid], nrm);
    }

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&Vs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (norm_v && n0 + tid < N) vnorm_ws[(size_t)z * N + n0 + tid] = nrm;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + ty * 4 + i;
    if (b >= B) continue;
    float* out = cross_ws + ((size_t)z * B + b) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[n] = acc[i][j];
    }
  }
}

// Block-wide reduction of one float over kRowThreads threads.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kRowThreads / 32 ? scratch[lane] : (kMax ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = kMax ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return v;
}

// Kernel 2. grid B, block kRowThreads. Writes W[b][n], ess[b], l[b].
// Each thread touches only its own n's of W, so W doubles as the buffer
// for s and then e^{s-m} without extra synchronisation.
__global__ void __launch_bounds__(kRowThreads)
row_softmax_kernel(const float* __restrict__ cross_ws,
                   const float* __restrict__ vnorm_ws,
                   const float* __restrict__ log_r, int B, int N, int slices,
                   float t, float* __restrict__ W, float* __restrict__ ess,
                   float* __restrict__ l_out) {
  __shared__ float scratch[kRowThreads / 32];
  const int b = blockIdx.x;
  const float sigma = 1.0f - t + kEpsT;
  const float inv_2s2 = 0.5f / (sigma * sigma);
  const float two_t = 2.0f * t;
  const float t2 = t * t;

  float* w = W + (size_t)b * N;
  float m = -INFINITY;
  for (int n = threadIdx.x; n < N; n += kRowThreads) {
    float cross = 0.f;
    float vn = 0.f;
    for (int z = 0; z < slices; ++z) {
      cross += cross_ws[((size_t)z * B + b) * N + n];
      vn += vnorm_ws[(size_t)z * N + n];
    }
    // Rounded step by step, without FMA contraction, in the order of the
    // plain PyTorch version: s = log r - (t^2 |v|^2 - 2t cross) / (2 sigma^2).
    const float sq = __fsub_rn(__fmul_rn(t2, vn), __fmul_rn(two_t, cross));
    const float s = __fsub_rn(log_r[n], __fmul_rn(sq, inv_2s2));
    w[n] = s;
    m = fmaxf(m, s);
  }
  m = block_reduce<true>(m, scratch);

  float l = 0.f;
  float q = 0.f;
  for (int n = threadIdx.x; n < N; n += kRowThreads) {
    const float e = expf(w[n] - m);
    w[n] = e;
    l += e;
    q = fmaf(e, e, q);
  }
  l = block_reduce<false>(l, scratch);
  q = block_reduce<false>(q, scratch);

  const float inv_l = 1.0f / (l + 1e-30f);
  for (int n = threadIdx.x; n < N; n += kRowThreads) w[n] *= inv_l;
  if (threadIdx.x == 0) {
    ess[b] = (l * l) / (q + 1e-30f);
    l_out[b] = l;
  }
}

// Kernel 3. grid (ceil(D/kBN), ceil(B/kBM)), block kThreads.
// G[b][d] = (sum_n W[b][n] V[n][d] - A[b][d]) / sigma, split into gx | gy.
__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(const float* __restrict__ W, const float* __restrict__ X1,
                    const float* __restrict__ Y1, const float* __restrict__ xt,
                    const float* __restrict__ yt, int B, int N, int Dx, int Dy,
                    float t, float* __restrict__ gx, float* __restrict__ gy) {
  __shared__ __align__(16) float Ws[kBK][kBM];
  __shared__ __align__(16) float Vs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int D = Dx + Dy;

  // W tile [kBM rows b][kBK cols n]: each thread stages 4 consecutive n.
  const int w_row = tid / 4;
  const int w_k = (tid % 4) * 4;
  // V tile [kBK rows n][kBN cols d]: each thread stages 4 consecutive d.
  const int v_k = tid / 16;
  const int v_col = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int b = m0 + w_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = k0 + w_k + j;
      Ws[w_k + j][w_row] = (b < B && n < N) ? W[(size_t)b * N + n] : 0.f;
    }
    const int n = k0 + v_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + v_col + j;
      Vs[v_k][v_col + j] =
          (n < N && d < D) ? concat_at(X1, Y1, n, d, Dx, Dy) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Ws[kk][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&Vs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float inv_sigma = 1.0f / (1.0f - t + kEpsT);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < Dx) {
        const size_t o = (size_t)b * Dx + d;
        gx[o] = (acc[i][j] - xt[o]) * inv_sigma;
      } else if (d < D) {
        const size_t o = (size_t)b * Dy + (d - Dx);
        gy[o] = (acc[i][j] - yt[o]) * inv_sigma;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch the three kernels on `stream`. Workspaces are allocated by the
// caller: cross_ws [slices, B, N], vnorm_ws [slices, N], W [B, N].
// Returns cudaGetLastError() (0 = launched).
int rgmf_flash_guidance(const float* xt, const float* yt, const float* X1,
                        const float* Y1, const float* log_r, int B, int N,
                        int Dx, int Dy, float t, int slices, int k_per_slice,
                        float* cross_ws, float* vnorm_ws,
                        float* W, float* gx, float* gy, float* ess, float* l,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = Dx + Dy;

  const dim3 g1((N + kBN - 1) / kBN, (B + kBM - 1) / kBM, slices);
  scores_partial_kernel<<<g1, kThreads, 0, s>>>(xt, yt, X1, Y1, B, N, Dx, Dy,
                                               k_per_slice, cross_ws, vnorm_ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  row_softmax_kernel<<<B, kRowThreads, 0, s>>>(cross_ws, vnorm_ws, log_r, B, N,
                                               slices, t, W, ess, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 g3((D + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  weighted_sum_kernel<<<g3, kThreads, 0, s>>>(W, X1, Y1, xt, yt, B, N, Dx, Dy,
                                              t, gx, gy);
  return (int)cudaGetLastError();
}

const char* rgmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
