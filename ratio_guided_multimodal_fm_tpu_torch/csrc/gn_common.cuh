// GroupNorm statistics and activation shared by group_norm_silu.cu (kernel B)
// and fused_gn_silu_conv.cu (kernel C), plus the Hopper copy primitives both
// use (1-D bulk copies completing on an mbarrier).
//
// Statistics: the per-group sums of x and x^2 are taken in float64. For bf16
// inputs every term is exact there, so the sums do not depend on the order in
// which threads, warps and CTAs add them. mean and E[x^2] are rounded once to
// float32, var = E[x^2] - mean^2 in float32 (the fast variance), and
// rstd = float32(1 / sqrt(float64(var + eps))). The plain PyTorch versions do
// the same operations, so kernel and plain version agree on (mean, rstd) bit
// for bit. With float32 sums in two orders the two may differ by an ulp,
// which moves the bf16 rounding of some affine outputs; where SiLU then
// shrinks the value into a lower binade, the move exceeds one bf16 step of
// the output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rgmf {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements, loaded and stored as one access of N*sizeof(T) bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Adds elements [0, n) of src (n a multiple of N) to s and s2, in float64.
template <typename T, int N>
__device__ __forceinline__ void accumulate(const T* src, int n, double& s,
                                          double& s2) {
  for (int j = 0; j < n; j += N) {
    const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(src + j);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const double d = (double)to_f32(v.v[k]);
      s += d;
      s2 = fma(d, d, s2);
    }
  }
}

// Channels-last partial sums of group g over pixels p = p0, p0 + pstep, ...
// < npix of src [npix][C]: each pixel's cg channels of the group, loaded N at a
// time (N divides cg).
template <typename T, int N>
__device__ __forceinline__ void cl_partial(const T* src, int npix, int C,
                                          int cg, int g, int p0, int pstep,
                                          double& s, double& s2) {
#pragma unroll 4
  for (int p = p0; p < npix; p += pstep)
    accumulate<T, N>(src + (size_t)p * C + g * cg, cg, s, s2);
}

// The same, with N the widest of 16/sizeof(T), ..., 1 elements that divides cg
// and keeps src's accesses aligned (`align` = the byte alignment of src + C).
template <typename T>
__device__ __forceinline__ void cl_partial_any(const T* src, int npix, int C,
                                              int cg, int g, int p0,
                                              int pstep, int align, double& s,
                                              double& s2) {
  constexpr int kMax = 16 / sizeof(T);
  const int w = (cg * (int)sizeof(T)) | align;   // lowest set bit bounds N
  const int n = (w & -w) / (int)sizeof(T);
  if (n >= kMax)
    cl_partial<T, kMax>(src, npix, C, cg, g, p0, pstep, s, s2);
  else if (n >= 4)
    cl_partial<T, 4>(src, npix, C, cg, g, p0, pstep, s, s2);
  else if (n >= 2)
    cl_partial<T, 2>(src, npix, C, cg, g, p0, pstep, s, s2);
  else
    cl_partial<T, 1>(src, npix, C, cg, g, p0, pstep, s, s2);
}

struct GroupStat {
  float mean, rstd;
};

// (mean, rstd) of a group of n elements from its float64 sums (see the top).
__device__ __forceinline__ GroupStat gn_finalize(double s, double s2, double n,
                                                 float eps) {
  const float mean = (float)(s / n);
  const float msq = (float)(s2 / n);
  const float var = __fsub_rn(msq, __fmul_rn(mean, mean));
  return {mean, (float)(1.0 / sqrt((double)__fadd_rn(var, eps)))};
}

// ((v - mean) * rstd) * w + b, each operation rounded to float32 (no FMA
// contraction), as the plain versions compute it.
__device__ __forceinline__ float gn_affine(float v, GroupStat st, float w,
                                           float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, st.mean), st.rstd), w), b);
}

// silu(y) = y * sigmoid(y) in float32 with the approximate exponential and
// reciprocal (ex2.approx, rcp.approx: a few float32 ulps from the plain
// version's; the reciprocal of an infinite denominator is 0, so silu of a
// large negative y is -0).
__device__ __forceinline__ float silu_f32(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + __expf(-y)));
  return y * r;
}

// ---- Hopper copy primitives -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory before
// later async-proxy (bulk copy) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to this CTA's shared memory, completing on `bar`. Issued in pieces of
// at most 32 KiB.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (uint32_t off = 0; off < bytes; off += 32768u) {
    const uint32_t n = bytes - off < 32768u ? bytes - off : 32768u;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(d + off)),
        "l"(s + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

}  // namespace rgmf
