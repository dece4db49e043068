// GroupNorm + SiLU for Hopper (sm_90a), one pass over device memory:
//
//   y = round_T(silu(round_T(((x - mean_g) * rstd_g) * w[c] + b[c])))
//
// for NCHW x of type T (bf16 or float32) laid out contiguously or in
// channels_last (NHWC) memory; y has x's strides. Statistics per (sample,
// group) as in gn_common.cuh (float64 sums, float32 mean and rstd, the fast
// variance). The affine output is rounded to T before SiLU, exactly as the
// plain version (ops/groupnorm.py) and the JAX U-Net's default XLA path
// (models/layers.py FusedGroupNorm) do; SiLU is computed in float32 on the
// rounded value and rounded to T again.
//
// Replaces: ratio_guided_multimodal_fm_tpu/ops/groupnorm_pallas.py:
// group_norm_silu (the Pallas kernel keeps one sample in VMEM, takes its
// statistics and normalises it there).
//
// Bound on the card: bytes. Each element of x is read from device memory once
// and each element of y written once (512x64x32x32 bf16: 2 x 64 MiB, 0.040 ms
// at 3.35 TB/s); the arithmetic is a few operations per element.
//
// Design. A CTA takes a contiguous slice of one sample's memory (or of several
// small samples) and copies it into shared memory with 1-D bulk copies that
// complete on an mbarrier: whole pixel rows of C channels in channels_last,
// whole channels of H*W pixels in NCHW. It takes the group sums from shared
// memory, normalises from shared memory and writes y with vector stores.
// Several CTAs share an SM (64 KiB slices, three an SM), so one CTA's copy is
// in flight while another sums or normalises. (Persistent CTAs that
// double-buffer their slices measured slower: with one or two CTAs an SM the
// chain of reductions and cluster barriers of each item is no longer hidden.)
// Where a sample is larger than one slice (e.g. 32x32x128 bf16 = 256 KiB, more
// than a block's 227 KB), the CTAs of a thread-block cluster (2-8) split it;
// they exchange their per-group partial sums through distributed shared
// memory between two cluster barriers, in rank order, so every CTA finalises
// the same statistics. Where a slice would not fit shared memory at all
// (`staged` = 0, very large samples) or is not 16-byte aligned, the CTA reads
// x twice from device memory instead. The plan (slice and cluster size,
// samples per CTA, threads, dynamic shared memory) is made by the wrapper,
// ops/groupnorm.py:gn_plan; the layout of shared memory below follows it.

#include <cooperative_groups.h>

#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using rgmf::bf16;

// Shared-memory layout (bytes), the same formula as ops/groupnorm.py:gn_plan:
//   [0, 16)                     mbarrier
//   [16, 16 + 16 G)             this CTA's per-group partial sums (s, s2)
//   then 8 spc G                (mean, rstd) per sample and group
//   then 16 spc G nwarps        per-warp partial sums (s, s2)
//   rounded up to 128; then spc * slice_cap elements of T (staged only)
__host__ __device__ inline int header_bytes(int G, int spc, int nwarps) {
  return rgmf::round_up(16 + 16 * G + 8 * spc * G + 16 * spc * G * nwarps,
                        128);
}

struct Args {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  float* mean_out;   // [B][G]: the statistics, for the backward; null: none
  float* rstd_out;
  int B, C, HW, G, K, spc, staged;
  float eps;
};

// Slice of the sample owned by cluster rank r: elements [lo, hi) of the
// sample's memory. Channels-last: pixels [r*HW/K, (r+1)*HW/K); NCHW: channels
// [r*C/K, (r+1)*C/K).
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

// STATS: also write each group's (mean, rstd) to a.mean_out / a.rstd_out (a
// separate instantiation, so the sampler's no-grad launches run the code
// they ran before the statistics output existed; a run-time check of the
// pointer instead made those launches ~6% slower on an H100, PERF.md).
template <typename T, int N, bool CL, bool STATS>
__global__ void __launch_bounds__(512) gn_silu_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int C = a.C, HW = a.HW, G = a.G, cg_ = C / G;
  const int r = blockIdx.x % a.K;           // rank in the cluster
  const int b0 = (blockIdx.x / a.K) * a.spc;
  const int nb = min(a.spc, a.B - b0);
  const size_t sample = (size_t)C * HW;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  double* part = reinterpret_cast<double*>(smem + 16);              // [G][2]
  rgmf::GroupStat* stat =
      reinterpret_cast<rgmf::GroupStat*>(smem + 16 + 16 * G);      // [spc*G]
  double* red = reinterpret_cast<double*>(smem + 16 + 16 * G +
                                          8 * a.spc * G);  // [spc*G][nw][2]
  int lo, hi;
  slice_of<CL>(a, r, lo, hi);
  const int len = hi - lo;
  const int cap = CL ? (HW + a.K - 1) / a.K * C : (C + a.K - 1) / a.K * HW;
  T* data = reinterpret_cast<T*>(smem + header_bytes(G, a.spc, nwarps));
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  // 0. the slices into shared memory: bulk copies issued by thread 0
  if (a.staged) {
    if (tid == 0) {
      rgmf::mbar_init(bar, 1);
      rgmf::mbar_expect_tx(bar, (uint32_t)(nb * len * sizeof(T)));
      for (int s = 0; s < nb; ++s)
        rgmf::bulk_g2s(data + (size_t)s * cap, x + (b0 + s) * sample + lo,
                       (uint32_t)(len * sizeof(T)), bar);
    }
    __syncthreads();           // the barrier is initialised before any wait
    rgmf::mbar_wait(bar, 0);
  }
  auto src = [&](int s) -> const T* {
    return a.staged ? data + (size_t)s * cap : x + (b0 + s) * sample + lo;
  };

  // 1. per-warp partial sums of every (sample, group) of the slice
  for (int s = 0; s < nb; ++s) {
    if (CL) {
      // thread: group tid % G, pixels tid / G + k * (nthreads / G)
      double ps = 0.0, ps2 = 0.0;
      const int g = tid % G;
      uintptr_t al = (uintptr_t)src(s) | (uintptr_t)(C * sizeof(T)) | 16u;
      al &= ~al + 1;                  // lowest set bit: src's alignment
      rgmf::cl_partial_any<T>(src(s), len / C, C, cg_, g, tid / G,
                              nthreads / G, (int)al, ps, ps2);
      if (32 % G == 0) {
        // lanes l and l ^ off share a group for off >= G: lane g < G ends
        // with its group's warp sums
        for (int off = 16; off >= G; off >>= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
          ps2 += __shfl_xor_sync(0xffffffffu, ps2, off);
        }
        if (lane < G) {
          red[((s * G + lane) * nwarps + warp) * 2] = ps;
          red[((s * G + lane) * nwarps + warp) * 2 + 1] = ps2;
        }
      } else {
        for (int gg = 0; gg < G; ++gg) {
          const double v = rgmf::warp_sum(gg == g ? ps : 0.0);
          const double v2 = rgmf::warp_sum(gg == g ? ps2 : 0.0);
          if (lane == 0) {
            red[((s * G + gg) * nwarps + warp) * 2] = v;
            red[((s * G + gg) * nwarps + warp) * 2 + 1] = v2;
          }
        }
      }
    } else {
      // each group's channels within the slice are one contiguous run
      for (int gg = 0; gg < G; ++gg) {
        const int c0 = max(lo / HW, gg * cg_);
        const int c1 = min(hi / HW, (gg + 1) * cg_);
        double ps = 0.0, ps2 = 0.0;
        if (c0 < c1) {
          const T* run = src(s) + (size_t)(c0 * HW - lo);
          const int n = (c1 - c0) * HW;   // a multiple of N (N divides HW)
          for (int i = tid * N; i < n; i += nthreads * N)
            rgmf::accumulate<T, N>(run + i, N, ps, ps2);
        }
        const double v = rgmf::warp_sum(ps);
        const double v2 = rgmf::warp_sum(ps2);
        if (lane == 0) {
          red[((s * G + gg) * nwarps + warp) * 2] = v;
          red[((s * G + gg) * nwarps + warp) * 2 + 1] = v2;
        }
      }
    }
  }
  __syncthreads();

  // 2. fold the warps (and the cluster's CTAs), finalise (mean, rstd)
  double fs = 0.0, fs2 = 0.0;
  if (tid < nb * G) {
    for (int w = 0; w < nwarps; ++w) {
      fs += red[(tid * nwarps + w) * 2];
      fs2 += red[(tid * nwarps + w) * 2 + 1];
    }
  }
  if (a.K > 1) {           // then spc == 1
    cg::cluster_group cluster = cg::this_cluster();
    if (tid < G) {
      part[2 * tid] = fs;
      part[2 * tid + 1] = fs2;
    }
    cluster.sync();
    if (tid < G) {
      fs = fs2 = 0.0;
      for (int q = 0; q < a.K; ++q) {
        const double* p = cluster.map_shared_rank(part, q);
        fs += p[2 * tid];
        fs2 += p[2 * tid + 1];
      }
    }
    cluster.sync();        // no CTA leaves while a peer reads its partials
  }
  if (tid < nb * G) {
    stat[tid] = rgmf::gn_finalize(fs, fs2, (double)cg_ * HW, a.eps);
    if (STATS && r == 0) {                   // tid = s * G + g
      a.mean_out[(size_t)b0 * G + tid] = stat[tid].mean;
      a.rstd_out[(size_t)b0 * G + tid] = stat[tid].rstd;
    }
  }
  __syncthreads();

  // 3. normalise, affine, round, SiLU, round; vector stores of N elements
  if (CL) {
    // nthreads * N is a multiple of C, so a thread's channels stay fixed
    const int c_t = (tid * N) % C;
    float wv[N], bv[N];
    rgmf::GroupStat st[N];
    for (int s = 0; s < nb; ++s) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        wv[k] = a.w[c_t + k];
        bv[k] = a.b[c_t + k];
        st[k] = stat[s * G + (c_t + k) / cg_];
      }
      const T* in = src(s);
      T* out = y + (b0 + s) * sample + lo;
      for (int i = tid * N; i < len; i += nthreads * N) {
        const rgmf::Vec<T, N> v =
            *reinterpret_cast<const rgmf::Vec<T, N>*>(in + i);
        rgmf::Vec<T, N> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float z = rgmf::to_f32(rgmf::from_f32<T>(
              rgmf::gn_affine(rgmf::to_f32(v.v[k]), st[k], wv[k], bv[k])));
          o.v[k] = rgmf::from_f32<T>(rgmf::silu_f32(z));
        }
        *reinterpret_cast<rgmf::Vec<T, N>*>(out + i) = o;
      }
    }
  } else {
    for (int s = 0; s < nb; ++s) {
      const T* in = src(s);
      T* out = y + (b0 + s) * sample + lo;
      for (int i = tid * N; i < len; i += nthreads * N) {
        const int c = (lo + i) / HW;   // N divides HW: one channel a vector
        const rgmf::GroupStat st = stat[s * G + c / cg_];
        const float wc = a.w[c], bc = a.b[c];
        const rgmf::Vec<T, N> v =
            *reinterpret_cast<const rgmf::Vec<T, N>*>(in + i);
        rgmf::Vec<T, N> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float z = rgmf::to_f32(rgmf::from_f32<T>(
              rgmf::gn_affine(rgmf::to_f32(v.v[k]), st, wc, bc)));
          o.v[k] = rgmf::from_f32<T>(rgmf::silu_f32(z));
        }
        *reinterpret_cast<rgmf::Vec<T, N>*>(out + i) = o;
      }
    }
  }
}

template <typename T, int N, bool CL, bool STATS>
int launch(const Args& a, int grid, int threads, int smem, cudaStream_t s) {
  auto kernel = gn_silu_kernel<T, N, CL, STATS>;
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

template <typename T, bool CL, bool STATS>
int dispatch_vec(const Args& a, int vec, int grid, int threads, int smem,
                 cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1, CL, STATS>(a, grid, threads, smem, s);
    case 2: return launch<T, 2, CL, STATS>(a, grid, threads, smem, s);
    case 4: return launch<T, 4, CL, STATS>(a, grid, threads, smem, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8, CL, STATS>(a, grid, threads, smem, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool STATS>
int dispatch_layout(const Args& a, int channels_last, int vec, int grid,
                    int threads, int smem, cudaStream_t s) {
  return channels_last
             ? dispatch_vec<T, true, STATS>(a, vec, grid, threads, smem, s)
             : dispatch_vec<T, false, STATS>(a, vec, grid, threads, smem, s);
}

}  // namespace

extern "C" {

// Launch on `stream` with the plan of ops/groupnorm.py:gn_plan. x, y: [B, C,
// H*W] samples of bf16 (is_bf16) or float32, contiguous in NCHW or
// channels_last memory (y in x's layout); w, b: float32 [C]. mean_out and
// rstd_out, float32 [B, G], receive each group's statistics for the backward
// (group_norm_silu_backward.cu); both null, nothing is written. Returns a CUDA
// error code (0 = launched); cudaErrorInvalidValue for a plan the kernel
// cannot run (shared memory below what the layout needs, a thread count that
// is not a multiple of 32 or of the groups, an unsupported vector width).
int rgmf_group_norm_silu(const void* x, const float* w, const float* b,
                         void* y, float* mean_out, float* rstd_out, int B,
                         int C, int HW, int G, float eps, int is_bf16,
                         int channels_last, int vec, int cluster, int spc, int threads, int staged, int smem_bytes,
                         int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int itemsize = is_bf16 ? 2 : 4;
  const int nwarps = threads / 32;
  const int cap = channels_last ? (HW + cluster - 1) / cluster * C
                                : (C + cluster - 1) / cluster * HW;
  const int need = header_bytes(G, spc, nwarps) +
                   (staged ? spc * cap * itemsize : 0);
  if (threads % 32 || threads > 512 || threads % G || smem_bytes < need ||
      cluster < 1 || cluster > 8 || (cluster > 1 && spc != 1) || C % G ||
      (channels_last && (threads * vec) % C) || grid % cluster)
    return (int)cudaErrorInvalidValue;
  if ((mean_out == nullptr) != (rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, b, y, mean_out, rstd_out, B, C, HW, G, cluster, spc,
               staged, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = mean_out != nullptr;
  if (is_bf16)
    return stats ? dispatch_layout<bf16, true>(a, channels_last, vec, grid,
                                               threads, smem_bytes, s)
                 : dispatch_layout<bf16, false>(a, channels_last, vec, grid,
                                                threads, smem_bytes, s);
  return stats ? dispatch_layout<float, true>(a, channels_last, vec, grid,
                                              threads, smem_bytes, s)
               : dispatch_layout<float, false>(a, channels_last, vec, grid,
                                               threads, smem_bytes, s);
}

const char* rgmf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
