// Fused BatchNorm + SiLU in train mode for Hopper (sm_90a), flax's semantics
// (nn.BatchNorm(momentum=0.9), eps 1e-5), float32:
//
//   var_c = max(msq_c − mean_c², 0),  rstd_c = rsqrt(var_c + eps),
//   mul_c = rstd_c · γ_c,  z = (x − mean_c) · mul_c + β_c,
//   y = silu(z) = z / (1 + exp(−z)),
//   running_mean = 0.9 · running_mean + 0.1 · mean (the same for var, the
//   biased variance), num_batches_tracked += 1
//
// from the batch statistics mean_c = E[x] and msq_c = E[x²] over the n =
// N·H·W rows, and its backward, with x̂ = (x − mean_c) · rstd_c and
// s = sigmoid(z):
//
//   g = dy · s · (1 + z · (1 − s)),  dβ_c = Σg,  dγ_c = Σg·x̂
//   dx = mul_c · ((g − dβ_c / n) − x̂ · dγ_c / n)
//
// where a channel whose variance was clamped drops the variance term
// (dγ_c / n → 0): autograd of the E[x²] − E[x]² form with clamp_min passes
// no gradient through a clamped variance. x, y, dy and dx are NCHW tensors
// in channels_last memory, seen as n rows of C channels (C a multiple of 4,
// at most 1024). Every float32 operation rounds at the points of the plain
// versions, ops/batchnorm.py:batch_norm_silu_reference and
// batch_norm_silu_backward_reference. mean and msq come from the wrapper,
// PyTorch's float32 means, as models/ratio.py:BatchNorm2d forms them: the
// statistics, the running statistics and y then equal the plain path's. (A
// float64 version of the statistics, exact where PyTorch's float32 means
// round, moved the ratio benchmark cell's parameters further from its float32
// reference, which takes PyTorch's means, than its limits allow: PERF.md,
// the BatchNorm+SiLU findings.)
//
// Replaces: no TPU kernel. The JAX package composes flax's BatchNorm and
// SiLU in XLA; the port's train step ran them as some forty-five PyTorch
// launches a site (forward and backward) and eleven passes over the
// activation forward, twenty backward.
//
// Bound on the card: bytes. Some thirty operations an element. Forward:
// read x, write y; backward: read x and dy, write dx. The backward reads x
// and dy twice, once to reduce and once to apply; the experiment-2 ratio
// net's largest site, 131,072 rows of 64 channels (33.6 MB a pass), fits the
// 50 MB L2, so the second read may come from there.
//
// Design: one launch forward, two backward.
//   * Forward apply (bn_silu_apply_kernel): every CTA forms the channels'
//     (mean, mul, β) in shared memory from mean and msq; CTA 0 also writes
//     rstd for the backward and the running statistics. Then elementwise
//     over 16-byte vectors.
//   * Backward reduce (bn_grad_reduce_kernel): a grid of row blocks x slices
//     of 32 channels. A thread keeps 4 fixed channels (one 16-byte load a
//     row) and adds its rows' g and g·x̂ in float64; the 16 warps' sums meet
//     through warp shuffles and shared memory in a fixed order and go to a
//     float64 workspace row. The last CTA of a slice (an integer ticket; no
//     float atomics) adds the slice's rows in a fixed order and writes dγ,
//     dβ and the apply's coefficients. The tickets are the call's own
//     workspace, zeroed on the stream before the launch: no host
//     synchronisation, the launch replays inside a CUDA graph, and launches
//     on two streams at once, or after one that was aborted, share nothing.
//   * Backward apply (bn_silu_grad_apply_kernel): elementwise, as forward.
// Same bits on every run: the sums' order depends on the launch shape only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"

namespace {

constexpr int kSlice = 32;                    // channels of a reduce CTA
constexpr int kLanes = kSlice / 4;            // 16-byte lanes of a slice row
constexpr int kReduceThreads = 512;
constexpr int kRowsPerPass = kReduceThreads / kLanes;   // 64
constexpr int kWarps = kReduceThreads / 32;   // 16
constexpr int kMaxSlices = 32;
constexpr int kMaxC = kMaxSlices * kSlice;    // 1024
constexpr int kApplyThreads = 256;
// running = kKeep·running + kNew·batch, the constants the plain version
// multiplies by (0.9 and 0.1 rounded to float32; 1 − 0.9f is not 0.1f)
constexpr float kKeep = 0.9f, kNew = 0.1f;

// x − mean, z = (x − mean)·mul + β, x̂ = (x − mean)·rstd (float32, rounded
// as the plain version rounds them)
struct Chan {
  float mean, rstd, mul, beta;
};

__device__ __forceinline__ float act_z(float xm, const Chan& ch) {
  return __fadd_rn(__fmul_rn(xm, ch.mul), ch.beta);
}

// g = dy·s·(1 + z·(1 − s)), s = sigmoid(z) = 1 / (1 + exp(−z))
__device__ __forceinline__ float act_grad(float dy, float z) {
  const float s = __frcp_rn(__fadd_rn(1.0f, expf(-z)));
  return __fmul_rn(__fmul_rn(dy, s),
                   __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s))));
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

struct FwdArgs {
  const float* x;
  const float* w;
  const float* b;
  const float* mean;    // [C], E[x]
  const float* msq;     // [C], E[x²]
  float* y;
  float* rstd;          // [C], negative where the variance was clamped
  float* running_mean;
  float* running_var;
  long long* num_batches;
  int rows, C;
  float eps;
};

__global__ void __launch_bounds__(kApplyThreads)
    bn_silu_apply_kernel(FwdArgs a) {
  extern __shared__ float csh[];               // mean, mul, β: [3][C]
  const int C = a.C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mean = a.mean[c];
    const float raw = __fsub_rn(a.msq[c], __fmul_rn(mean, mean));
    const float var = raw < 0.0f ? 0.0f : raw;
    const float r = rsqrtf(__fadd_rn(var, a.eps));
    csh[c] = mean;
    csh[C + c] = __fmul_rn(r, a.w[c]);
    csh[2 * C + c] = a.b[c];
    if (blockIdx.x == 0) {
      a.rstd[c] = raw < 0.0f ? -r : r;
      a.running_mean[c] = __fadd_rn(__fmul_rn(kKeep, a.running_mean[c]),
                                    __fmul_rn(kNew, mean));
      a.running_var[c] = __fadd_rn(__fmul_rn(kKeep, a.running_var[c]),
                                   __fmul_rn(kNew, var));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.num_batches += 1;
  __syncthreads();
  const int C4 = C / 4;
  const int nvec = a.rows * C4;
  const int stride = gridDim.x * blockDim.x;
  const int step = stride % C4;
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int c = (v % C4) * 4;
  const float4* x = reinterpret_cast<const float4*>(a.x);
  float4* y = reinterpret_cast<float4*>(a.y);
  for (; v < nvec; v += stride) {
    const float4 xv = x[v];
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float z = __fadd_rn(
          __fmul_rn(__fsub_rn(comp(xv, k), csh[c + k]), csh[C + c + k]),
          csh[2 * C + c + k]);
      o[k] = __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
    }
    y[v] = make_float4(o[0], o[1], o[2], o[3]);
    c += step * 4;
    if (c >= C) c -= C;
  }
}

struct BwdArgs {
  const float* x;
  const float* dy;
  const float* w;
  const float* b;
  const float* mean;
  const float* rstd;    // negative where the forward clamped the variance
  float* dx;
  float* dgamma;
  float* dbeta;
  float* coef;          // [2][C]: dβ/n, dγ/n (0 where clamped)
  double* ws;           // [slices][row blocks][64]
  unsigned int* tickets;  // [slices], 0 at launch
  int rows, C;
};

__device__ __forceinline__ Chan chan_of(const BwdArgs& a, int c) {
  const float r = fabsf(a.rstd[c]);
  return {a.mean[c], r, __fmul_rn(r, a.w[c]), a.b[c]};
}

// Per-thread float64 sums (Σg, Σg·x̂) of 4 channels from one row's 16 bytes
// of x and dy.
__device__ __forceinline__ void add_row(const float4& v, const float4& d,
                                        const Chan* ch, double* a,
                                        double* b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xm = __fsub_rn(comp(v, k), ch[k].mean);
    const float g = act_grad(comp(d, k), act_z(xm, ch[k]));
    const float xh = __fmul_rn(xm, ch[k].rstd);
    a[k] += (double)g;
    b[k] = fma((double)g, (double)xh, b[k]);
  }
}

// CTA (blockIdx.x = row block rb, blockIdx.y = slice s) adds rows
// [rb·R, min((rb+1)·R, rows)) of channels [32 s, 32 s + 32) and writes the
// 64 float64 sums to ws[(s · gridDim.x + rb) · 64 + {0: Σg, 32: Σg·x̂} +
// channel]. The slice's last CTA adds the rows of ws in order and
// finalises.
__global__ void __launch_bounds__(kReduceThreads)
    bn_grad_reduce_kernel(BwdArgs a) {
  __shared__ double red[kWarps][kLanes][8];   // a[4], b[4] per warp lane
  __shared__ double fin[kWarps][2][kSlice];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int s = blockIdx.y;
  const int rb = blockIdx.x;
  const int nrb = gridDim.x;
  const int C = a.C;
  const int c0 = s * kSlice + lane * 4;
  const int R = (a.rows + nrb - 1) / nrb;
  const int r_lo = rb * R;
  const int r_hi = min(a.rows, r_lo + R);

  double sa[4] = {0.0, 0.0, 0.0, 0.0}, sb[4] = {0.0, 0.0, 0.0, 0.0};
  if (c0 < C) {
    Chan ch[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ch[k] = chan_of(a, c0 + k);
    int r = r_lo + tid / kLanes;
    // four rows in flight a thread, then the rest one at a time
    for (; r + 3 * kRowsPerPass < r_hi; r += 4 * kRowsPerPass) {
      float4 v[4], d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t off = (size_t)(r + u * kRowsPerPass) * C + c0;
        v[u] = *reinterpret_cast<const float4*>(a.x + off);
        d[u] = *reinterpret_cast<const float4*>(a.dy + off);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) add_row(v[u], d[u], ch, sa, sb);
    }
    for (; r < r_hi; r += kRowsPerPass) {
      const size_t off = (size_t)r * C + c0;
      add_row(*reinterpret_cast<const float4*>(a.x + off),
              *reinterpret_cast<const float4*>(a.dy + off), ch, sa, sb);
    }
  }
  // lanes l, l + 8, l + 16, l + 24 of a warp share channels
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
      sa[k] += __shfl_xor_sync(0xffffffffu, sa[k], o);
      sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], o);
    }
  }
  const int warp = tid / 32;
  if (tid % 32 < kLanes) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[warp][lane][k] = sa[k];
      red[warp][lane][4 + k] = sb[k];
    }
  }
  __syncthreads();
  if (tid < 2 * kSlice) {          // (which sum, channel of the slice)
    const int which = tid / kSlice, c = tid % kSlice;
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[w][c / 4][which * 4 + c % 4];
    a.ws[((size_t)s * nrb + rb) * 2 * kSlice + tid] = t;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&a.tickets[s], 1u) == (unsigned int)nrb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  {                                // the slice's rows in a fixed order
    const int c = tid % kSlice, q = tid / kSlice;   // q < kWarps
    double ta = 0.0, tb = 0.0;
    const double* base = a.ws + (size_t)s * nrb * 2 * kSlice;
    for (int j = q; j < nrb; j += kWarps) {
      ta += __ldcg(base + (size_t)j * 2 * kSlice + c);
      tb += __ldcg(base + (size_t)j * 2 * kSlice + kSlice + c);
    }
    fin[q][0][c] = ta;
    fin[q][1][c] = tb;
  }
  __syncthreads();
  const int c = s * kSlice + tid;
  if (tid < kSlice && c < C) {
    double A = 0.0, B = 0.0;
    for (int q = 0; q < kWarps; ++q) {
      A += fin[q][0][tid];
      B += fin[q][1][tid];
    }
    const double n = (double)a.rows;
    a.dbeta[c] = (float)A;
    a.dgamma[c] = (float)B;
    a.coef[c] = (float)(A / n);
    a.coef[C + c] = a.rstd[c] < 0.0f ? 0.0f : (float)(B / n);
  }
}

__global__ void __launch_bounds__(kApplyThreads)
    bn_silu_grad_apply_kernel(BwdArgs a) {
  extern __shared__ float csh[];   // mean, rstd, mul, β, c1, c2: [6][C]
  const int C = a.C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const Chan ch = chan_of(a, c);
    csh[c] = ch.mean;
    csh[C + c] = ch.rstd;
    csh[2 * C + c] = ch.mul;
    csh[3 * C + c] = ch.beta;
    csh[4 * C + c] = a.coef[c];
    csh[5 * C + c] = a.coef[C + c];
  }
  __syncthreads();
  const int C4 = C / 4;
  const int nvec = a.rows * C4;
  const int stride = gridDim.x * blockDim.x;
  const int step = stride % C4;
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  int c = (v % C4) * 4;
  const float4* x = reinterpret_cast<const float4*>(a.x);
  const float4* dy = reinterpret_cast<const float4*>(a.dy);
  float4* dx = reinterpret_cast<float4*>(a.dx);
  for (; v < nvec; v += stride) {
    const float4 xv = x[v];
    const float4 dv = dy[v];
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ck = c + k;
      const Chan ch{csh[ck], csh[C + ck], csh[2 * C + ck], csh[3 * C + ck]};
      const float xm = __fsub_rn(comp(xv, k), ch.mean);
      const float g = act_grad(comp(dv, k), act_z(xm, ch));
      const float xh = __fmul_rn(xm, ch.rstd);
      o[k] = __fmul_rn(ch.mul, __fsub_rn(__fsub_rn(g, csh[4 * C + ck]),
                                         __fmul_rn(xh, csh[5 * C + ck])));
    }
    dx[v] = make_float4(o[0], o[1], o[2], o[3]);
    c += step * 4;
    if (c >= C) c -= C;
  }
}

// The plan's checks (ops/batchnorm.py:bn_plan): rows and C in range, grids
// at least 1, the elementwise operands 16-byte aligned.
bool valid(int rows, int C, int grid, const void* const* ptrs, int nptrs) {
  if (rows < 1 || C < 4 || C % 4 || C > kMaxC || grid < 1 ||
      (long long)rows * C >= (1LL << 31))
    return false;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// Forward on `stream`: y = silu(BatchNorm(x)) for x, y float32 [rows][C]
// (channels_last NCHW) from the batch's mean and msq = E[x²] (float32 [C]);
// w, b, running_mean, running_var float32 [C] (the running statistics
// updated in place), num_batches int64 (incremented); writes rstd (float32
// [C], negated where the variance was clamped) for the backward. Returns a
// CUDA error code (0 = launched); cudaErrorInvalidValue for arguments the
// kernel does not take.
int rgmf_batch_norm_silu(const float* x, const float* w, const float* b,
                         const float* mean, const float* msq, float* y,
                         float* rstd, float* running_mean, float* running_var,
                         long long* num_batches, int rows, int C, float eps,
                         int apply_grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[] = {x, y};
  if (!valid(rows, C, apply_grid, ptrs, 2)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, w, b, mean, msq, y, rstd, running_mean, running_var,
                  num_batches, rows, C, eps};
  bn_silu_apply_kernel<<<apply_grid, kApplyThreads, 3 * C * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Backward on `stream`: dx, dgamma, dbeta (float32 [rows][C], [C], [C]) of
// the forward at its mean and rstd, for dy float32 [rows][C] in x's layout.
// ws: float64 [ceil(C/32)][row_blocks][64]; coef: float32 [2][C];
// tickets: uint32 [ceil(C/32)], zeroed before the launch on `stream`.
int rgmf_batch_norm_silu_backward(const float* x, const float* dy,
                                  const float* w, const float* b,
                                  const float* mean, const float* rstd,
                                  float* dx, float* dgamma, float* dbeta,
                                  double* ws, float* coef,
                                  unsigned int* tickets, int rows, int C,
                                  int row_blocks, int apply_grid, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[] = {x, dy, dx};
  if (!valid(rows, C, row_blocks < apply_grid ? row_blocks : apply_grid,
             ptrs, 3))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, dy, w, b, mean, rstd, dx, dgamma, dbeta, coef, ws,
                  tickets, rows, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_blocks, (C + kSlice - 1) / kSlice);
  bn_grad_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_silu_grad_apply_kernel<<<apply_grid, kApplyThreads,
                              6 * C * sizeof(float), s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
