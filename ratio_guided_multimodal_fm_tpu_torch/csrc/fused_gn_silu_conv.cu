// Fused GroupNorm + SiLU + 3x3 SAME convolution for Hopper (sm_90a):
//
//   out[b,h,w,o] = conv_b[o] + sum_{dh,dw,c} act[b,h+dh-1,w+dw-1,c] * W[dh,dw,c,o]
//   act = round_to_T(silu((x - mean[b,g]) * rstd[b,g] * scale[c] + bias[c]))
//
// NHWC activations of type T (bf16 or float32), HWIO float32 weights (rounded
// to T on load, as the JAX kernel casts them), float32 GroupNorm parameters
// and bias. An out-of-image tap contributes 0: SAME padding pads the
// activation, not x.
//
// Replaces: ratio_guided_multimodal_fm_tpu/ops/resblock_pallas.py:
// fused_gn_silu_conv (body `_kernel`). That kernel loads TB whole samples into
// VMEM, computes their group statistics in place and feeds the normalised
// tile straight into 9 shifted MXU matmuls. A CTA of an implicit GEMM sees
// only part of an image, so the statistics cannot be computed where they are
// used. Two kernels instead:
//
//   1. gn_stats: one CTA per (sample, group) sums x and x^2 in float32 and
//      writes (mean, rstd) with the fast variance E[x^2] - E[x]^2.
//   2. conv: an implicit GEMM with M = B*H*W output pixels, N = O and
//      K = 9*C (tap-major, then channel). The loader of the A tile reads x
//      at the tap's shifted pixel, applies the normalise, affine, SiLU and
//      rounding to T on the way into shared memory, and indexes the
//      statistics by each element's own channel (a group may span two
//      K tiles). bf16 runs on the tensor cores through WMMA (16x16x16,
//      float32 accumulate); float32 runs in plain IEEE FMA with a 4x4
//      register tile per thread (never TF32). The bias is added in the
//      epilogue before the store in T.
//
// Bound on the card at the bench's 512x32x32x64->64 bf16 shape: 38.7 GFLOP
// (0.039 ms at 989 TFLOP/s) against one read of x and one write of out,
// 128 MiB (0.040 ms at 3.35 TB/s): the two are even. This first version
// recomputes the activation once per tap (9 times per element) and stages
// tiles synchronously; it is right and simple, not at the bound.
// wgmma, TMA and a pipelined halo tile are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStatThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// silu(((v - mean) * rstd) * scale + bias) in float32, in the JAX order.
__device__ __forceinline__ float gn_silu(float v, const float* __restrict__ st,
                                         float scale, float bias) {
  float y = (v - st[0]) * st[1];
  y = y * scale + bias;
  return y / (1.0f + expf(-y));
}

// Kernel 1. grid B*G, block kStatThreads. stats[bg] = (mean, rstd).
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const T* __restrict__ x, int HW, int C, int G, float eps,
                float* __restrict__ stats) {
  __shared__ float red[2][kStatThreads / 32];
  const int bg = blockIdx.x;
  const int b = bg / G;
  const int cg = C / G;
  const T* xb = x + (size_t)b * HW * C + (size_t)(bg % G) * cg;
  const int n = HW * cg;
  float s = 0.f;
  float q = 0.f;
  for (int e = threadIdx.x; e < n; e += kStatThreads) {
    const int p = e / cg;
    const float v = to_float(xb[(size_t)p * C + (e - p * cg)]);
    s += v;
    q = fmaf(v, v, q);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kStatThreads / 32 ? red[0][lane] : 0.f;
    q = lane < kStatThreads / 32 ? red[1][lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      const float mean = s / (float)n;
      const float var = q / (float)n - mean * mean;
      stats[2 * bg] = mean;
      stats[2 * bg + 1] = rsqrtf(var + eps);
    }
  }
}

// The output pixel m = (b, h, w) that one loader thread stages, decoded once.
struct Pixel {
  int b, h, w;
  bool ok;
};

__device__ __forceinline__ Pixel decode(int m, int M, int H, int W) {
  Pixel p{0, 0, 0, m < M};
  if (p.ok) {
    p.b = m / (H * W);
    const int r = m - p.b * H * W;
    p.h = r / W;
    p.w = r - p.h * W;
  }
  return p;
}

// Address of x at pixel p shifted by tap (dh, dw) = (tap/3 - 1, tap%3 - 1),
// or nullptr where the tap falls outside the image (zero activation).
template <typename T>
__device__ __forceinline__ const T* tap_row(const T* __restrict__ x,
                                            const Pixel& p, int tap, int H,
                                            int W, int C) {
  const int hh = p.h + tap / 3 - 1;
  const int ww = p.w + tap % 3 - 1;
  if (!p.ok || hh < 0 || hh >= H || ww < 0 || ww >= W) return nullptr;
  return x + (((size_t)p.b * H + hh) * W + ww) * C;
}

// Activation of channel c of a tap row (0 outside the image or past C).
template <typename T>
__device__ __forceinline__ float act_at(const T* row, int c, int C, int cg,
                                        const float* __restrict__ st_b,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias) {
  if (row == nullptr || c >= C) return 0.f;
  return gn_silu(to_float(row[c]), st_b + 2 * (c / cg), scale[c], bias[c]);
}

// ---- float32: plain FMA implicit GEMM -------------------------------------
constexpr int kBM = 64;        // output pixels per CTA
constexpr int kBN = 64;        // output channels per CTA
constexpr int kBK = 16;        // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// grid (ceil(M/kBM), ceil(O/kBN)), block kThreads.
__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ w, const float* __restrict__ cb,
                int B, int H, int W, int C, int O, int G,
                float* __restrict__ out) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int M = B * H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cg = C / G;

  // A loader: pixel a_r of the tile, 4 consecutive channels from a_c.
  const int a_r = tid / 4;
  const int a_c = (tid % 4) * 4;
  const Pixel px = decode(m0 + a_r, M, H, W);
  const float* st_b = stats + (size_t)2 * px.b * G;
  // B loader: weight row b_r of the stage, 4 consecutive outputs from b_c.
  const int b_r = tid / 16;
  const int b_c = (tid % 16) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const float* row = tap_row(x, px, tap, H, W, C);
    const float* wt = w + (size_t)tap * C * O;
    for (int c0 = 0; c0 < C; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        As[a_c + j][a_r] = act_at(row, c0 + a_c + j, C, cg, st_b, scale, bias);
      const int k = c0 + b_r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_c + j;
        Bs[b_r][b_c + j] = (k < C && n < O) ? wt[(size_t)k * O + n] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < O) out[(size_t)m * O + n] = acc[i][j] + cb[n];
    }
  }
}

// ---- bf16: WMMA implicit GEMM ----------------------------------------------
constexpr int kWBM = 64;         // output pixels per CTA
constexpr int kWBN = 64;         // output channels per CTA
constexpr int kWBK = 32;         // input channels per shared-memory stage
constexpr int kWThreads = 128;   // 4 warps, each a 32 x 32 block of the tile
constexpr int kLdA = kWBK + 8;   // padded rows (80 B, a multiple of 16 B)
constexpr int kLdB = kWBN + 8;   // 144 B
constexpr int kLdC = kWBN + 4;   // 272 B

// grid (ceil(M/kWBM), ceil(O/kWBN)), block kWThreads.
__global__ void __launch_bounds__(kWThreads)
conv_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ w, const float* __restrict__ cb,
                 int B, int H, int W, int C, int O, int G,
                 bf16* __restrict__ out) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[kWBM * kLdA];   // [pixel][channel]
  __shared__ __align__(32) bf16 Bs[kWBK * kLdB];   // [channel][output]
  __shared__ __align__(32) float Cs[kWBM * kLdC];  // epilogue staging

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int M = B * H * W;
  const int m0 = blockIdx.x * kWBM;
  const int n0 = blockIdx.y * kWBN;
  const int cg = C / G;

  // A loader: pixel a_r of the tile, 16 consecutive channels from a_c.
  const int a_r = tid / 2;
  const int a_c = (tid % 2) * 16;
  const Pixel px = decode(m0 + a_r, M, H, W);
  const float* st_b = stats + (size_t)2 * px.b * G;
  // B loader: weight row b_r of the stage, 16 consecutive outputs from b_c.
  const int b_r = tid / 4;
  const int b_c = (tid % 4) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const bf16* row = tap_row(x, px, tap, H, W, C);
    const float* wt = w + (size_t)tap * C * O;
    for (int c0 = 0; c0 < C; c0 += kWBK) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        As[a_r * kLdA + a_c + j] = __float2bfloat16(
            act_at(row, c0 + a_c + j, C, cg, st_b, scale, bias));
      const int k = c0 + b_r;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + b_c + j;
        Bs[b_r * kLdB + b_c + j] = __float2bfloat16(
            (k < C && n < O) ? wt[(size_t)k * O + n] : 0.f);
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kWBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + wn + j * 16, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * kLdC + wn + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < kWBM * kWBN; e += kWThreads) {
    const int r = e / kWBN;
    const int c = e % kWBN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < O)
      out[(size_t)m * O + n] = __float2bfloat16(Cs[r * kLdC + c] + cb[n]);
  }
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`. `stats` is caller-allocated scratch of
// 2*B*groups floats; x, out are NHWC [B,H,W,C] / [B,H,W,O] of bf16 when
// is_bf16, else float32. Returns cudaGetLastError() (0 = launched).
int rgmf_fused_gn_silu_conv(const void* x, const float* gn_scale,
                            const float* gn_bias, const float* conv_w,
                            const float* conv_b, int B, int H, int W, int C,
                            int O, int groups, float eps, int is_bf16,
                            float* stats, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;

  if (is_bf16) {
    gn_stats_kernel<bf16><<<B * groups, kStatThreads, 0, s>>>(
        static_cast<const bf16*>(x), H * W, C, groups, eps, stats);
  } else {
    gn_stats_kernel<float><<<B * groups, kStatThreads, 0, s>>>(
        static_cast<const float*>(x), H * W, C, groups, eps, stats);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (is_bf16) {
    const dim3 grid((M + kWBM - 1) / kWBM, (O + kWBN - 1) / kWBN);
    conv_bf16_kernel<<<grid, kWThreads, 0, s>>>(
        static_cast<const bf16*>(x), stats, gn_scale, gn_bias, conv_w, conv_b,
        B, H, W, C, O, groups, static_cast<bf16*>(out));
  } else {
    const dim3 grid((M + kBM - 1) / kBM, (O + kBN - 1) / kBN);
    conv_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), stats, gn_scale, gn_bias, conv_w, conv_b,
        B, H, W, C, O, groups, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

const char* rgmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
