// Backward of GroupNorm + SiLU (group_norm_silu.cu) for Hopper (sm_90a):
//
//   x̂ = (x - mean_g) * rstd_g,  ã = round_T(x̂ * w[c] + b[c]),  y = silu(ã)
//   da  = dy * s * (1 + ã * (1 - s)),  s = sigmoid(ã)       (float32)
//   dβ_c = Σ_{b,hw} da,  dγ_c = Σ_{b,hw} da * x̂
//   c1 = mean_g(da * w),  c2 = mean_g(da * w * x̂)           per (b, g)
//   dx = round_T(rstd_g * (da * w - c1 - x̂ * c2))
//
// for NCHW x and dy of type T (bf16 or float32) laid out contiguously or in
// channels_last memory (dy in x's layout, dx too), with the statistics the
// forward saved (mean, rstd: float32 [B, G]). SiLU' is taken at the ROUNDED
// affine output ã: the rounding passes the cotangent through unchanged, as the
// convert of the JAX U-Net's XLA path (models/layers.py FusedGroupNorm) does
// under jax.grad. x̂, ã, da and dx round to float32 at the points of the plain
// version, ops/groupnorm.py:group_norm_silu_backward_reference (the sigmoid's
// reciprocal is the IEEE one, __frcp_rn); the sums are taken in a fixed order
// of their own, float32 over a thread's few dozen elements and float64
// beyond, so dγ, dβ, c1 and c2 differ from the plain version's float32 sums
// only by those sums' rounding.
//
// Replaces: no TPU kernel. The JAX package differentiates its XLA GroupNorm
// (models/layers.py FusedGroupNorm) with jax.grad; the port's forward is a
// hand-written kernel, so its gradient is one too.
//
// Bound on the card: bytes. x and dy are read from device memory once and dx
// written once: 3 B C H W sizeof(T) (the SVHN U-Net's largest training site,
// 128x192x32x32 float32: 302 MB, 0.090 ms at 3.35 TB/s); some fifty operations
// per element, which the design keeps off the critical path.
//
// Design (plan: ops/groupnorm.py:gn_backward_plan). A CTA takes a contiguous
// slice of one sample's memory (or several small samples): whole pixel rows in
// channels_last, whole channels in NCHW; a cluster of 2-8 CTAs, or 16 where
// the card holds such clusters (non-portable), splits a larger sample, so that
// at the SVHN U-Net's largest sites an SM holds two CTAs and one CTA's
// exchange and stores overlap another's loads.
//   * A staged slice arrives by bulk copy (cp.async.bulk) on an mbarrier.
//     Cutting it into chunks of 8 or 16 KiB, each on its own barrier so that
//     pass 1 starts on the first, measured 1-8% slower at the large sites
//     than one copy (PERF.md, PR 11): the SM's other CTAs already overlap
//     one CTA's wait.
//   * Pass 1 computes da once. It forms per-channel sums S1 = Σ da and
//     S2 = Σ da·x̂ (channels_last: a thread keeps fixed channels and adds its
//     few dozen elements of each in float32; NCHW: a warp takes whole
//     channels and a lane adds its elements in float32; beyond the thread
//     every sum is float64), and in float32 writes x̂ and da back over the
//     staged x and dy. The threads that share a channel are added by warp shuffles where
//     they sit in one warp and then in a fixed sequence of rounds through the
//     channel sums in shared memory: no per-thread float64 array.
//   * The group sums c1·n = Σ_c w_c S1_c and c2·n = Σ_c w_c S2_c are exchanged
//     between the cluster's CTAs through distributed shared memory in rank
//     order. Pass 2 is then one short chain per element from the staged x̂
//     and da (bf16 recomputes them from the staged x and dy) and writes dx
//     with 16-byte stores.
//   * Slices too large to stage are read twice from device memory: the plan
//     gives them up to 512 threads and at most two CTAs an SM, and pass 2
//     walks the slice backwards, so that its first reads find what pass 1
//     read last still in the L2.
//   * Where dγ and dβ are asked for, each cluster's rank r adds the cluster's
//     channel sums of its share of the channels in rank order and writes them
//     to a workspace row; a second small launch adds the rows in a fixed
//     order. No float atomics: two runs give the same bits.

#include <cooperative_groups.h>

#include "c_api.cuh"
#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using rgmf::bf16;
using rgmf::GroupStat;
using rgmf::Vec;

constexpr int kMaxBars = 4;        // mbarriers: one a staged sample
constexpr int kMaxCluster = 16;    // non-portable beyond 8

// Shared-memory layout (bytes), the same formula as
// ops/groupnorm.py:_bwd_header_bytes:
//   [0, 8 kMaxBars)         mbarriers, one per staged sample
//   then 16 spc G           this CTA's group sums (w·S1, w·S2) per sample, f64
//   then 16 spc C           per-channel sums (S1, S2) per sample, f64
//   then 8 spc G            (c1, c2) per sample and group, f32
//   rounded up to 128; then spc * slice_cap elements of x, then of dy (staged)
__host__ __device__ inline int bwd_header_bytes(int C, int G, int spc) {
  return rgmf::round_up(
      8 * kMaxBars + 16 * spc * G + 16 * spc * C + 8 * spc * G, 128);
}

struct Args {
  const void* x;
  const void* dy;
  const float* w;
  const float* b;
  const float* mean;   // [B][G]
  const float* rstd;
  void* dx;
  double* ws;          // [grid / K][C][2] (S1, S2) per cluster, or null
  int B, C, HW, G, K, spc, staged;
};

// Elements [lo, hi) of a sample's memory owned by cluster rank r (as
// group_norm_silu.cu): pixels in channels_last, channels in NCHW.
template <bool CL>
__device__ __forceinline__ void slice_of(const Args& a, int r, int& lo,
                                         int& hi) {
  if (CL) {
    lo = (int)((long long)r * a.HW / a.K) * a.C;
    hi = (int)((long long)(r + 1) * a.HW / a.K) * a.C;
  } else {
    lo = (int)((long long)r * a.C / a.K) * a.HW;
    hi = (int)((long long)(r + 1) * a.C / a.K) * a.HW;
  }
}

// da for one element, and x̂ in `xh`, in the plain version's order.
template <typename T>
__device__ __forceinline__ float d_act(float x, float dy, GroupStat st,
                                       float w, float b, float& xh) {
  xh = __fmul_rn(__fsub_rn(x, st.mean), st.rstd);
  const float a = rgmf::to_f32(rgmf::from_f32<T>(__fadd_rn(__fmul_rn(xh, w), b)));
  const float s = __frcp_rn(__fadd_rn(1.0f, expf(-a)));
  return __fmul_rn(__fmul_rn(dy, s),
                   __fadd_rn(1.0f, __fmul_rn(a, __fsub_rn(1.0f, s))));
}

__device__ __forceinline__ float d_input(float da, float xh, float w,
                                         float rstd, float c1, float c2) {
  return __fmul_rn(rstd, __fsub_rn(__fsub_rn(__fmul_rn(da, w), c1),
                                   __fmul_rn(xh, c2)));
}

template <typename T, int N, bool CL>
__global__ void __launch_bounds__(512) gn_silu_bwd_kernel(Args a) {
  // float32 staged slices hold x̂ and da after pass 1
  constexpr bool kKeep = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int C = a.C, HW = a.HW, G = a.G, cg_ = C / G;
  const int K = a.K;
  const int r = blockIdx.x % K;
  const int b0 = (blockIdx.x / K) * a.spc;
  const int nb = min(a.spc, a.B - b0);
  const size_t sample = (size_t)C * HW;
  const bool keep = kKeep && a.staged;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int off = 8 * kMaxBars;
  double* gsum = reinterpret_cast<double*>(smem + off);    // [spc*G][2]
  off += 16 * a.spc * G;
  double* chan = reinterpret_cast<double*>(smem + off);    // [spc][C][2]
  off += 16 * a.spc * C;
  float* cst = reinterpret_cast<float*>(smem + off);       // [spc*G][2]
  int lo, hi;
  slice_of<CL>(a, r, lo, hi);
  const int len = hi - lo;
  const int cap = CL ? (HW + K - 1) / K * C : (C + K - 1) / K * HW;
  T* data = reinterpret_cast<T*>(smem + bwd_header_bytes(C, G, a.spc));
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  // 0. the slices of x and dy into shared memory (bulk copies by thread 0,
  //    one mbarrier a sample); the channel sums outside an NCHW slice stay 0
  if (a.staged && tid == 0) {
    const uint32_t bytes = (uint32_t)(len * sizeof(T));
    for (int s = 0; s < nb; ++s) {
      rgmf::mbar_init(bar + s, 1);
      rgmf::mbar_expect_tx(bar + s, 2 * bytes);
      rgmf::bulk_g2s(data + (size_t)s * cap, x + (b0 + s) * sample + lo,
                     bytes, bar + s);
      rgmf::bulk_g2s(data + (size_t)(a.spc + s) * cap,
                     dy + (b0 + s) * sample + lo, bytes, bar + s);
    }
  }
  for (int i = tid; i < a.spc * C * 2; i += nthreads) chan[i] = 0.0;
  __syncthreads();             // the barriers are initialised before any wait
  auto xs = [&](int s) -> T* {
    return a.staged ? data + (size_t)s * cap
                    : const_cast<T*>(x) + (b0 + s) * sample + lo;
  };
  auto dys = [&](int s) -> T* {
    return a.staged ? data + (size_t)(a.spc + s) * cap
                    : const_cast<T*>(dy) + (b0 + s) * sample + lo;
  };
  auto stat_of = [&](int s, int g) -> GroupStat {
    const size_t i = (size_t)(b0 + s) * G + g;
    return {a.mean[i], a.rstd[i]};
  };

  // 1. per-channel sums S1 = Σ da, S2 = Σ da·x̂ of the slice: float32 within
  //    a thread (a lane, NCHW), float64 beyond; in float32 x̂ and da replace
  //    the staged x and dy
  for (int s = 0; s < nb; ++s) {
    T* xin = xs(s);
    T* din = dys(s);
    if (CL) {
      // nthreads * N is a multiple of C, so a thread's channels stay fixed
      const int c_t = (tid * N) % C;
      float wv[N], bv[N], p1[N], p2[N];
      GroupStat st[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        wv[k] = a.w[c_t + k];
        bv[k] = a.b[c_t + k];
        st[k] = stat_of(s, (c_t + k) / cg_);
        p1[k] = p2[k] = 0.f;
      }
      if (a.staged) rgmf::mbar_wait(bar + s, 0);
      for (int i = tid * N; i < len; i += nthreads * N) {
        const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xin + i);
        const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(din + i);
        Vec<T, N> xo, dao;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float xh;
          const float da = d_act<T>(rgmf::to_f32(v.v[k]),
                                    rgmf::to_f32(d.v[k]), st[k], wv[k],
                                    bv[k], xh);
          p1[k] += da;
          p2[k] = fmaf(da, xh, p2[k]);
          xo.v[k] = rgmf::from_f32<T>(xh);
          dao.v[k] = rgmf::from_f32<T>(da);
        }
        if (keep) {
          *reinterpret_cast<Vec<T, N>*>(xin + i) = xo;
          *reinterpret_cast<Vec<T, N>*>(din + i) = dao;
        }
      }
      double s1[N], s2[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s1[k] = (double)p1[k];
        s2[k] = (double)p2[k];
      }
      // Threads t and t + V (V = C / N) share channels. Where V divides 32
      // the lanes of a warp that share them are added by shuffles first;
      // then the holders add into chan in rounds, one round a warp (or a
      // group of V threads), in a fixed order.
      const int V = C / N;
      const bool fold = V < 32 && 32 % V == 0;
      if (fold) {
        for (int o = V; o < 32; o <<= 1) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
            s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
          }
        }
      }
      const bool holder = !fold || lane < V;
      const int round = fold ? warp : tid / V;
      const int rounds = fold ? nwarps : nthreads / V;
      double* cs = chan + (size_t)s * C * 2;
      for (int q = 0; q < rounds; ++q) {
        if (holder && round == q) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            double* p = cs + (c_t + k) * 2;
            p[0] = q == 0 ? s1[k] : p[0] + s1[k];
            p[1] = q == 0 ? s2[k] : p[1] + s2[k];
          }
        }
        __syncthreads();
      }
    } else {
      // a warp takes whole channels of the slice (N divides HW)
      if (a.staged) rgmf::mbar_wait(bar + s, 0);
      for (int c = lo / HW + warp; c < hi / HW; c += nwarps) {
        const GroupStat st = stat_of(s, c / cg_);
        const float wc = a.w[c], bc = a.b[c];
        T* xr = xin + (size_t)(c * HW - lo);
        T* dr = din + (size_t)(c * HW - lo);
        float p1 = 0.f, p2 = 0.f;
        for (int i = lane * N; i < HW; i += 32 * N) {
          const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xr + i);
          const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(dr + i);
          Vec<T, N> xo, dao;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            float xh;
            const float da = d_act<T>(rgmf::to_f32(v.v[k]),
                                      rgmf::to_f32(d.v[k]), st, wc, bc, xh);
            p1 += da;
            p2 = fmaf(da, xh, p2);
            xo.v[k] = rgmf::from_f32<T>(xh);
            dao.v[k] = rgmf::from_f32<T>(da);
          }
          if (keep) {
            *reinterpret_cast<Vec<T, N>*>(xr + i) = xo;
            *reinterpret_cast<Vec<T, N>*>(dr + i) = dao;
          }
        }
        const double t1 = rgmf::warp_sum((double)p1);
        const double t2 = rgmf::warp_sum((double)p2);
        if (lane == 0) {
          chan[(s * C + c) * 2] = t1;
          chan[(s * C + c) * 2 + 1] = t2;
        }
      }
    }
  }
  __syncthreads();

  // 2. this CTA's group sums, the cluster's in rank order, then (c1, c2)
  for (int q = tid; q < nb * G; q += nthreads) {
    const int s = q / G, g = q % G;
    double t1 = 0.0, t2 = 0.0;
    for (int c = g * cg_; c < (g + 1) * cg_; ++c) {
      const double wc = (double)a.w[c];
      t1 = fma(wc, chan[(s * C + c) * 2], t1);
      t2 = fma(wc, chan[(s * C + c) * 2 + 1], t2);
    }
    gsum[2 * q] = t1;
    gsum[2 * q + 1] = t2;
  }
  const double n = (double)cg_ * HW;
  if (K > 1) {                 // then spc == 1, and nthreads >= G
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    double t1 = 0.0, t2 = 0.0;
    if (tid < G) {
      for (int q = 0; q < K; ++q) {
        const double* p = cluster.map_shared_rank(gsum, q);
        t1 += p[2 * tid];
        t2 += p[2 * tid + 1];
      }
    }
    if (a.ws != nullptr) {     // dβ, dγ partials of the cluster, rank order
      double* row = a.ws + (size_t)(blockIdx.x / K) * C * 2;
      for (int c = r * C / K + tid; c < (r + 1) * C / K; c += nthreads) {
        double u1 = 0.0, u2 = 0.0;
        for (int q = 0; q < K; ++q) {
          const double* p = cluster.map_shared_rank(chan, q);
          u1 += p[2 * c];
          u2 += p[2 * c + 1];
        }
        row[2 * c] = u1;
        row[2 * c + 1] = u2;
      }
    }
    cluster.sync();            // no CTA leaves while a peer reads its sums
    if (tid < G) {
      cst[2 * tid] = (float)(t1 / n);
      cst[2 * tid + 1] = (float)(t2 / n);
    }
  } else {
    if (a.ws != nullptr) {     // dβ, dγ partials of this CTA's samples
      for (int c = tid; c < C; c += nthreads) {
        double t1 = 0.0, t2 = 0.0;
        for (int s = 0; s < nb; ++s) {
          t1 += chan[(s * C + c) * 2];
          t2 += chan[(s * C + c) * 2 + 1];
        }
        a.ws[((size_t)blockIdx.x * C + c) * 2] = t1;
        a.ws[((size_t)blockIdx.x * C + c) * 2 + 1] = t2;
      }
    }
    __syncthreads();
    for (int q = tid; q < nb * G; q += nthreads) {
      cst[2 * q] = (float)(gsum[2 * q] / n);
      cst[2 * q + 1] = (float)(gsum[2 * q + 1] / n);
    }
  }
  __syncthreads();

  // 3. dx = rstd (da w - c1 - x̂ c2): from the kept x̂ and da (float32,
  //    staged), else recomputing da; unstaged slices backwards (see the top)
  for (int s = 0; s < nb; ++s) {
    T* out = dx + (b0 + s) * sample + lo;
    const T* xin = xs(s);
    const T* din = dys(s);
    if (CL) {
      const int c_t = (tid * N) % C;
      float wv[N], bv[N], c1[N], c2[N];
      GroupStat st[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int g = (c_t + k) / cg_;
        wv[k] = a.w[c_t + k];
        bv[k] = a.b[c_t + k];
        st[k] = stat_of(s, g);
        c1[k] = cst[2 * (s * G + g)];
        c2[k] = cst[2 * (s * G + g) + 1];
      }
      const int step = nthreads * N;
      const int count = tid * N < len ? (len - tid * N + step - 1) / step : 0;
      for (int it = 0; it < count; ++it) {
        const int i = tid * N + (a.staged ? it : count - 1 - it) * step;
        const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xin + i);
        const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(din + i);
        Vec<T, N> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float xh, da;
          if (keep) {
            xh = rgmf::to_f32(v.v[k]);
            da = rgmf::to_f32(d.v[k]);
          } else {
            da = d_act<T>(rgmf::to_f32(v.v[k]), rgmf::to_f32(d.v[k]), st[k],
                          wv[k], bv[k], xh);
          }
          o.v[k] = rgmf::from_f32<T>(
              d_input(da, xh, wv[k], st[k].rstd, c1[k], c2[k]));
        }
        *reinterpret_cast<Vec<T, N>*>(out + i) = o;
      }
    } else {
      const int c_lo = lo / HW, c_hi = hi / HW;
      for (int q = warp; q < c_hi - c_lo; q += nwarps) {
        const int c = a.staged ? c_lo + q : c_hi - 1 - q;
        const int g = c / cg_;
        const GroupStat st = stat_of(s, g);
        const float wc = a.w[c], bc = a.b[c];
        const float c1 = cst[2 * (s * G + g)], c2 = cst[2 * (s * G + g) + 1];
        const size_t base = (size_t)(c * HW - lo);
        for (int i = lane * N; i < HW; i += 32 * N) {
          const Vec<T, N> v =
              *reinterpret_cast<const Vec<T, N>*>(xin + base + i);
          const Vec<T, N> d =
              *reinterpret_cast<const Vec<T, N>*>(din + base + i);
          Vec<T, N> o;
#pragma unroll
          for (int k = 0; k < N; ++k) {
            float xh, da;
            if (keep) {
              xh = rgmf::to_f32(v.v[k]);
              da = rgmf::to_f32(d.v[k]);
            } else {
              da = d_act<T>(rgmf::to_f32(v.v[k]), rgmf::to_f32(d.v[k]), st,
                            wc, bc, xh);
            }
            o.v[k] = rgmf::from_f32<T>(d_input(da, xh, wc, st.rstd, c1, c2));
          }
          *reinterpret_cast<Vec<T, N>*>(out + base + i) = o;
        }
      }
    }
  }
}

// dβ, dγ from the workspace's rows: 32 channels a block, 8 row lanes each
// adding every 8th row in order, then the 8 lanes in order.
constexpr int RED_CH = 32, RED_ROWS = 8;

__global__ void __launch_bounds__(RED_CH * RED_ROWS)
    gn_wb_reduce_kernel(const double* ws, int rows, int C, float* dgamma,
                        float* dbeta) {
  __shared__ double part[RED_ROWS][RED_CH][2];
  const int cl = threadIdx.x % RED_CH, rl = threadIdx.x / RED_CH;
  const int c = blockIdx.x * RED_CH + cl;
  double t1 = 0.0, t2 = 0.0;
  if (c < C) {
    for (int q = rl; q < rows; q += RED_ROWS) {
      t1 += ws[((size_t)q * C + c) * 2];
      t2 += ws[((size_t)q * C + c) * 2 + 1];
    }
  }
  part[rl][cl][0] = t1;
  part[rl][cl][1] = t2;
  __syncthreads();
  if (rl == 0 && c < C) {
    for (int q = 1; q < RED_ROWS; ++q) {
      t1 += part[q][cl][0];
      t2 += part[q][cl][1];
    }
    dbeta[c] = (float)t1;
    dgamma[c] = (float)t2;
  }
}

// Raises the instantiation's dynamic shared-memory limit, and allows
// clusters past 8, once each; fills the launch configuration.
template <typename T, int N, bool CL>
int configure(const Args& a, int grid, int threads, int smem, cudaStream_t s,
              cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  auto kernel = gn_silu_bwd_kernel<T, N, CL>;
  static int smem_set = 0;         // per instantiation
  static bool wide_set = false;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (a.K > 8 && !wide_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_set = true;
  }
  cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.K > 1 ? 1 : 0;
  return 0;
}

// Launches the kernel, or with `occupancy` only asks how many of its
// clusters the card holds at once.
template <typename T, int N, bool CL>
int launch(const Args& a, int grid, int threads, int smem, cudaStream_t s,
           int* occupancy) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc = configure<T, N, CL>(a, grid, threads, smem, s, cfg, attr);
  if (rc != 0) return rc;
  if (occupancy)
    return (int)cudaOccupancyMaxActiveClusters(
        occupancy, gn_silu_bwd_kernel<T, N, CL>, &cfg);
  return (int)cudaLaunchKernelEx(&cfg, gn_silu_bwd_kernel<T, N, CL>, a);
}

template <typename T, bool CL>
int dispatch_vec(const Args& a, int vec, int grid, int threads, int smem,
                 cudaStream_t s, int* occupancy) {
  switch (vec) {
    case 1: return launch<T, 1, CL>(a, grid, threads, smem, s, occupancy);
    case 2: return launch<T, 2, CL>(a, grid, threads, smem, s, occupancy);
    case 4: return launch<T, 4, CL>(a, grid, threads, smem, s, occupancy);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, CL>(a, grid, threads, smem, s, occupancy);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Args& a, int is_bf16, int cl, int vec, int grid,
             int threads, int smem, cudaStream_t s, int* occupancy) {
  if (is_bf16)
    return cl ? dispatch_vec<bf16, true>(a, vec, grid, threads, smem, s,
                                         occupancy)
              : dispatch_vec<bf16, false>(a, vec, grid, threads, smem, s,
                                          occupancy);
  return cl ? dispatch_vec<float, true>(a, vec, grid, threads, smem, s,
                                        occupancy)
            : dispatch_vec<float, false>(a, vec, grid, threads, smem, s,
                                         occupancy);
}

}  // namespace

extern "C" {

// Launch on `stream` with the plan of ops/groupnorm.py:gn_backward_plan.
// x, dy, dx: [B, C, H*W] samples of bf16 (is_bf16) or float32, contiguous in
// NCHW or channels_last memory, all three in one layout; w, b: float32 [C];
// mean, rstd: float32 [B, G], as group_norm_silu.cu saved them. With ws (a
// float64 [grid / cluster, C, 2] workspace) each cluster's channel sums go
// there and a second launch writes dgamma and dbeta (float32 [C]); with ws
// null neither is formed. Returns a CUDA error code (0 = launched);
// cudaErrorInvalidValue for a plan the kernel cannot run.
int rgmf_group_norm_silu_backward(
    const void* x, const void* dy, const float* w, const float* b,
    const float* mean, const float* rstd, void* dx, double* ws, float* dgamma,
    float* dbeta, int B, int C, int HW, int G, int is_bf16, int channels_last,
    int vec, int cluster, int spc, int threads, int staged, int smem_bytes,
    int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int itemsize = is_bf16 ? 2 : 4;
  const int cap = channels_last ? (HW + cluster - 1) / cluster * C
                                : (C + cluster - 1) / cluster * HW;
  const int need = bwd_header_bytes(C, G, spc) +
                   (staged ? 2 * spc * cap * itemsize : 0);
  if (threads % 32 || threads > 512 || threads < G || smem_bytes < need ||
      cluster < 1 || cluster > kMaxCluster || (cluster > 1 && spc != 1) ||
      C % G || (channels_last && (threads * vec) % C) || grid % cluster ||
      spc > kMaxBars ||
      (ws != nullptr && (dgamma == nullptr || dbeta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dy, w, b, mean, rstd, dx, ws, B, C, HW, G, cluster, spc,
               staged};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = (cudaError_t)dispatch(a, is_bf16, channels_last, vec, grid, threads,
                              smem_bytes, s, nullptr);
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  gn_wb_reduce_kernel<<<(C + RED_CH - 1) / RED_CH, RED_CH * RED_ROWS, 0, s>>>(
      ws, grid / cluster, C, dgamma, dbeta);
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs of the backward kernel (the instantiation and
// launch shape given) that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int rgmf_group_norm_silu_backward_max_clusters(int is_bf16, int channels_last,
                                               int vec, int cluster,
                                               int threads, int smem_bytes,
                                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  Args a = {};
  a.K = cluster;
  int n = 0;
  const int rc = dispatch(a, is_bf16, channels_last, vec, 1024 * cluster,
                          threads, smem_bytes, 0, &n);
  return rc == 0 ? n : -rc;
}

}  // extern "C"
