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
// under jax.grad. Every operation rounds to float32 in the order of the plain
// version, ops/groupnorm.py:group_norm_silu_backward_reference; the sums are
// taken in float64.
//
// Replaces: no TPU kernel. The JAX package differentiates its XLA GroupNorm
// (models/layers.py FusedGroupNorm) with jax.grad; the port's forward is a
// hand-written kernel, so its gradient is one too.
//
// Bound on the card: bytes. x and dy are read from device memory once and dx
// written once: 3 B C H W sizeof(T) (the experiment-1 ratio net's first site,
// 512x32x28x28 float32: 154 MB, 0.046 ms at 3.35 TB/s); a few dozen
// operations per element.
//
// Design (kernel B's decomposition, ops/groupnorm.py:gn_backward_plan). A CTA
// takes a contiguous slice of one sample's memory (or several small samples):
// whole pixel rows in channels_last, whole channels in NCHW; a cluster of 2-8
// CTAs splits a larger sample. Thread 0 bulk-copies the slice of x and of dy
// into shared memory where both fit (else both are read twice from device
// memory). Pass 1 forms per-channel sums S1 = Σ da and S2 = Σ da·x̂ of the
// slice in float64: in channels_last each thread keeps fixed channels and the
// threads that share a channel are added in thread order; in NCHW a warp takes
// whole channels. The group sums c1·n = Σ_c w_c S1_c and c2·n = Σ_c w_c S2_c
// follow, exchanged between the cluster's CTAs through distributed shared
// memory in rank order. Pass 2 recomputes da from the staged slices and writes
// dx with vector stores. Where dγ and dβ are asked for, each CTA writes its S1
// and S2 to a workspace and a second small launch adds the CTAs' rows in a
// fixed order: no float atomics, so two runs give the same bits. A simple
// kernel first: its time is in PERF.md.

#include <cooperative_groups.h>

#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using rgmf::bf16;
using rgmf::GroupStat;
using rgmf::Vec;

// Shared-memory layout (bytes), the same formula as
// ops/groupnorm.py:_bwd_header_bytes:
//   [0, 16)                 mbarrier
//   then 16 spc G           this CTA's group sums (w·S1, w·S2) per sample, f64
//   then 16 spc C           per-channel sums (S1, S2) per sample, f64
//   then 8 spc G            (c1, c2) per sample and group, f32
//   then 16 N threads       per-thread channel sums (channels_last only), f64
//   rounded up to 128; then spc * slice_cap elements of x, then of dy (staged)
__host__ __device__ inline int bwd_header_bytes(int C, int G, int spc,
                                                int threads, int vec, int cl) {
  return rgmf::round_up(
      16 + 16 * spc * G + 16 * spc * C + 8 * spc * G + (cl ? 16 * vec * threads : 0),
      128);
}

struct Args {
  const void* x;
  const void* dy;
  const float* w;
  const float* b;
  const float* mean;   // [B][G]
  const float* rstd;
  void* dx;
  double* ws;          // [grid][C][2] (S1, S2) per CTA, or null
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
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
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
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int C = a.C, HW = a.HW, G = a.G, cg_ = C / G;
  const int r = blockIdx.x % a.K;
  const int b0 = (blockIdx.x / a.K) * a.spc;
  const int nb = min(a.spc, a.B - b0);
  const size_t sample = (size_t)C * HW;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int off = 16;
  double* gsum = reinterpret_cast<double*>(smem + off);    // [spc*G][2]
  off += 16 * a.spc * G;
  double* chan = reinterpret_cast<double*>(smem + off);    // [spc][C][2]
  off += 16 * a.spc * C;
  float* cst = reinterpret_cast<float*>(smem + off);       // [spc*G][2]
  off += 8 * a.spc * G;
  double* red = reinterpret_cast<double*>(smem + off);     // [threads][N][2]
  int lo, hi;
  slice_of<CL>(a, r, lo, hi);
  const int len = hi - lo;
  const int cap = CL ? (HW + a.K - 1) / a.K * C : (C + a.K - 1) / a.K * HW;
  T* data = reinterpret_cast<T*>(
      smem + bwd_header_bytes(C, G, a.spc, nthreads, N, CL));
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);

  // 0. the slices of x and dy into shared memory (bulk copies by thread 0)
  if (a.staged) {
    if (tid == 0) {
      rgmf::mbar_init(bar, 1);
      rgmf::mbar_expect_tx(bar, (uint32_t)(2 * nb * len * sizeof(T)));
      for (int s = 0; s < nb; ++s) {
        rgmf::bulk_g2s(data + (size_t)s * cap, x + (b0 + s) * sample + lo,
                       (uint32_t)(len * sizeof(T)), bar);
        rgmf::bulk_g2s(data + (size_t)(a.spc + s) * cap,
                       dy + (b0 + s) * sample + lo,
                       (uint32_t)(len * sizeof(T)), bar);
      }
    }
  }
  for (int i = tid; i < a.spc * C * 2; i += nthreads) chan[i] = 0.0;
  __syncthreads();             // the barrier is initialised before any wait
  if (a.staged) rgmf::mbar_wait(bar, 0);
  auto xs = [&](int s) -> const T* {
    return a.staged ? data + (size_t)s * cap : x + (b0 + s) * sample + lo;
  };
  auto dys = [&](int s) -> const T* {
    return a.staged ? data + (size_t)(a.spc + s) * cap
                    : dy + (b0 + s) * sample + lo;
  };
  auto stat_of = [&](int s, int g) -> GroupStat {
    const size_t i = (size_t)(b0 + s) * G + g;
    return {a.mean[i], a.rstd[i]};
  };

  // 1. per-channel sums S1 = Σ da, S2 = Σ da·x̂ of the slice, float64
  for (int s = 0; s < nb; ++s) {
    if (CL) {
      // nthreads * N is a multiple of C, so a thread's channels stay fixed
      const int c_t = (tid * N) % C;
      float wv[N], bv[N];
      GroupStat st[N];
      double s1[N], s2[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        wv[k] = a.w[c_t + k];
        bv[k] = a.b[c_t + k];
        st[k] = stat_of(s, (c_t + k) / cg_);
        s1[k] = s2[k] = 0.0;
      }
      const T* xin = xs(s);
      const T* din = dys(s);
      for (int i = tid * N; i < len; i += nthreads * N) {
        const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xin + i);
        const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(din + i);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float xh;
          const float da = d_act<T>(rgmf::to_f32(v.v[k]), rgmf::to_f32(d.v[k]),
                                    st[k], wv[k], bv[k], xh);
          s1[k] += (double)da;
          s2[k] = fma((double)da, (double)xh, s2[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        red[(tid * N + k) * 2] = s1[k];
        red[(tid * N + k) * 2 + 1] = s2[k];
      }
      __syncthreads();
      // channel c sits in slot c % N of threads c / N + q * C / N
      const int R = nthreads * N / C;
      for (int c = tid; c < C; c += nthreads) {
        double t1 = 0.0, t2 = 0.0;
        for (int q = 0; q < R; ++q) {
          const int t = c / N + q * (C / N);
          t1 += red[(t * N + c % N) * 2];
          t2 += red[(t * N + c % N) * 2 + 1];
        }
        chan[(s * C + c) * 2] = t1;
        chan[(s * C + c) * 2 + 1] = t2;
      }
      __syncthreads();         // red is reused by the next sample
    } else {
      // a warp takes whole channels of the slice (N divides HW)
      for (int c = lo / HW + warp; c < hi / HW; c += nwarps) {
        const GroupStat st = stat_of(s, c / cg_);
        const float wc = a.w[c], bc = a.b[c];
        const T* xr = xs(s) + (size_t)(c * HW - lo);
        const T* dr = dys(s) + (size_t)(c * HW - lo);
        double t1 = 0.0, t2 = 0.0;
        for (int i = lane * N; i < HW; i += 32 * N) {
          const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xr + i);
          const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(dr + i);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            float xh;
            const float da = d_act<T>(rgmf::to_f32(v.v[k]),
                                      rgmf::to_f32(d.v[k]), st, wc, bc, xh);
            t1 += (double)da;
            t2 = fma((double)da, (double)xh, t2);
          }
        }
        t1 = rgmf::warp_sum(t1);
        t2 = rgmf::warp_sum(t2);
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
  if (a.ws != nullptr) {       // dβ, dγ partials of this CTA
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
  const double n = (double)cg_ * HW;
  if (a.K > 1) {               // then spc == 1, and nthreads >= G
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    double t1 = 0.0, t2 = 0.0;
    if (tid < G) {
      for (int q = 0; q < a.K; ++q) {
        const double* p = cluster.map_shared_rank(gsum, q);
        t1 += p[2 * tid];
        t2 += p[2 * tid + 1];
      }
    }
    cluster.sync();            // no CTA leaves while a peer reads its sums
    if (tid < G) {
      cst[2 * tid] = (float)(t1 / n);
      cst[2 * tid + 1] = (float)(t2 / n);
    }
  } else {
    __syncthreads();
    for (int q = tid; q < nb * G; q += nthreads) {
      cst[2 * q] = (float)(gsum[2 * q] / n);
      cst[2 * q + 1] = (float)(gsum[2 * q + 1] / n);
    }
  }
  __syncthreads();

  // 3. dx = rstd (da w - c1 - x̂ c2), recomputing da from the slices
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
      for (int i = tid * N; i < len; i += nthreads * N) {
        const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(xin + i);
        const Vec<T, N> d = *reinterpret_cast<const Vec<T, N>*>(din + i);
        Vec<T, N> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float xh;
          const float da = d_act<T>(rgmf::to_f32(v.v[k]), rgmf::to_f32(d.v[k]),
                                    st[k], wv[k], bv[k], xh);
          o.v[k] = rgmf::from_f32<T>(
              d_input(da, xh, wv[k], st[k].rstd, c1[k], c2[k]));
        }
        *reinterpret_cast<Vec<T, N>*>(out + i) = o;
      }
    } else {
      for (int c = lo / HW + warp; c < hi / HW; c += nwarps) {
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
            float xh;
            const float da = d_act<T>(rgmf::to_f32(v.v[k]),
                                      rgmf::to_f32(d.v[k]), st, wc, bc, xh);
            o.v[k] = rgmf::from_f32<T>(d_input(da, xh, wc, st.rstd, c1, c2));
          }
          *reinterpret_cast<Vec<T, N>*>(out + base + i) = o;
        }
      }
    }
  }
}

// dβ, dγ from the CTAs' rows of the workspace: 32 channels a block, 8 row
// lanes each adding every 8th row in order, then the 8 lanes in order.
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

template <typename T, int N, bool CL>
int launch(const Args& a, int grid, int threads, int smem, cudaStream_t s) {
  auto kernel = gn_silu_bwd_kernel<T, N, CL>;
  static int smem_set = 0;         // per instantiation
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.K > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, bool CL>
int dispatch_vec(const Args& a, int vec, int grid, int threads, int smem,
                 cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1, CL>(a, grid, threads, smem, s);
    case 2: return launch<T, 2, CL>(a, grid, threads, smem, s);
    case 4: return launch<T, 4, CL>(a, grid, threads, smem, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, CL>(a, grid, threads, smem, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream` with the plan of ops/groupnorm.py:gn_backward_plan.
// x, dy, dx: [B, C, H*W] samples of bf16 (is_bf16) or float32, contiguous in
// NCHW or channels_last memory, all three in one layout; w, b: float32 [C];
// mean, rstd: float32 [B, G], as group_norm_silu.cu saved them. With ws (a
// float64 [grid, C, 2] workspace) the CTAs' channel sums go there and a second
// launch writes dgamma and dbeta (float32 [C]); with ws null neither is formed.
// Returns a CUDA error code (0 = launched); cudaErrorInvalidValue for a plan
// the kernel cannot run.
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
  const int need = bwd_header_bytes(C, G, spc, threads, vec, channels_last) +
                   (staged ? 2 * spc * cap * itemsize : 0);
  if (threads % 32 || threads > 512 || threads < G || smem_bytes < need ||
      cluster < 1 || cluster > 8 || (cluster > 1 && spc != 1) || C % G ||
      (channels_last && (threads * vec) % C) || grid % cluster ||
      (ws != nullptr && (dgamma == nullptr || dbeta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dy, w, b, mean, rstd, dx, ws, B, C, HW, G, cluster, spc,
               staged};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = (cudaError_t)(channels_last
              ? dispatch_vec<bf16, true>(a, vec, grid, threads, smem_bytes, s)
              : dispatch_vec<bf16, false>(a, vec, grid, threads, smem_bytes, s));
  else
    err = (cudaError_t)(channels_last
              ? dispatch_vec<float, true>(a, vec, grid, threads, smem_bytes, s)
              : dispatch_vec<float, false>(a, vec, grid, threads, smem_bytes, s));
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  gn_wb_reduce_kernel<<<(C + RED_CH - 1) / RED_CH, RED_CH * RED_ROWS, 0, s>>>(
      ws, grid, C, dgamma, dbeta);
  return (int)cudaGetLastError();
}

const char* rgmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
