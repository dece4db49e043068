// mc_feng guidance (Feng et al. Alg. 2) for Hopper (sm_90a). The scores are
// float64: their products on the FP64 tensor cores (mma.m16n8k8.f64), their
// norms, sums and finishing in IEEE float64, S kept in float64; the weighted
// sum is IEEE float32 FMA. Exponentials are expf and the ESS quotient is an
// IEEE division: no approximate intrinsic (__expf, __fdividef) is used.
//
// Replaces: ratio_guided_multimodal_fm_tpu/ops/guidance_pallas.py:flash_guidance
// (body `_kernel`), which walks the MC axis N as a sequential grid with a
// [TB, Dx+Dy] float32 accumulator in VMEM and an online softmax. A CTA can
// neither hold that accumulator nor carry a sum from one grid step to the
// next, so the function is two kernels here:
//
//   1. scores_kernel:  S[b, n] = log r[n]
//                         - (t^2 |v_n|^2 - 2t <a_b, v_n>) / (2 sigma^2)
//      with a_b = [x_t | y_t][b], v_n = [X1 | Y1][n], sigma = 1 - t + 1e-3.
//      The row constant |a_b|^2 of |a_b - t v_n|^2 cancels in the softmax
//      and is left out. The scores are ~t^2 D / (2 sigma^2) in magnitude
//      (~7e5 at D = 4096, t = 0.95).
//      Why float64: near-tied weights amplify any rounding of the scores,
//      and a float32 version's (a float32 S at 7e5 carries an ulp of
//      0.06, float32 dot products move a near tie by ~1e-3) decides which
//      float32 order wins on a given draw; in float64 the kernel's scores
//      are exact to ~1e-9 and its g error is kernel 2's own float32
//      rounding (ops/guidance.py:score_error_bound is the a-priori bound
//      on S's error).
//   2. weighted_sum_kernel:  m = max_n S, l = sum e^{S-m}, q = sum e^{2(S-m)}
//      (S - m taken in float64 and rounded to float32 for expf),
//      ESS = l^2/(q+1e-30), W = e^{S-m}/(l+1e-30), G = (W V - [x_t | y_t])/sigma,
//      written split into g_x and g_y.
//
// Bound on the card: operations. 2*B*N*D multiply-adds (2.15 GFLOP at B=512,
// N=256, D=4096) at the H100 SXM's 67 TFLOP/s (its FP64 tensor-core rate and
// its non-tensor float32 rate alike, NVIDIA's data sheet) are ~32 us; the
// ~22 MB of inputs and outputs take ~7 us at 3.35 TB/s. Kernel 2's float32
// FMA GEMM cannot reach that rate on this card: with 4x8 outputs per thread
// its shared-memory reads keep the SM's one load/store unit as busy as its
// four FMA pipes.
//
// What the design does about that:
//   * Both products run from a ring of kStages shared-memory stages filled by
//     16-byte cp.async copies (zero-filled past the edges), so the next stages
//     load while the current one multiplies, with one CTA barrier per stage.
//   * Operands whose rows run along the reduction axis (x_t|y_t, X1|Y1 in
//     kernel 1, W in kernel 2) stay row-major in shared memory with a row
//     stride of 36 floats: the copies need no transposition, and a warp's
//     fragment reads (kernel 1: rows lane / 4, k = lane % 4) or float4 reads
//     along k of 8 consecutive rows (kernel 2) fall into distinct banks.
//   * Kernel 1: 8 warps a CTA, each a 32 x 32 block of the 64 x 128 tile as
//     2 x 4 fragments of the FP64 tensor cores' 16 x 8 x 8 product (sm_90),
//     the float32 operands converted to float64 (exactly) as they are read.
//     The feature axis is split over a thread-block cluster of up to 8 CTAs
//     per tile. The ranks exchange their float64 partial tiles and partial
//     |v_n|^2 through distributed shared memory and add them in rank order,
//     each rank finishing its share of the tile's rows: no [slices, B, N]
//     workspace, and the same bits every run.
//     The cluster size comes from what the card holds at once: an H100 80GB
//     HBM3 holds 15 clusters of 8 such CTAs but 17 of 6, so the 16 tiles of
//     B=512, N=256 take clusters of 6 (one wave) rather than 8 (two).
//   * The finishing ranks of kernel 1 also leave, behind S, the softmax
//     partials (max in float64, sum e and sum e^2 in float32) of every 32
//     columns of a row. Kernel 2
//     folds them into m, l and q per row in its prologue (taking them from the
//     scores again costs 131 K exponentials in each of the 32 column blocks),
//     then forms each W stage on the fly while it writes it to shared memory:
//     W never exists in device memory.
//   * Kernel 2 takes 64 x 128 tiles with 4x8 outputs per thread, two CTAs an
//     SM: 16 warps hide the barriers and shared-memory latency better than
//     8 warps with 8x8 outputs did (measured). That is 256 CTAs at D = 4096
//     and 104 at D = 1568; its first V stages load while the prologue folds
//     the softmax partials.
//   * Rows that are not 16-byte aligned take a generic loader (template
//     parameter) with scalar loads inside the same kernels.
//
// The plan (cluster size, loader, grids, shared-memory bytes) is made by
// ops/guidance.py:guidance_plan; the constants below mirror it.
// Masked edges stand in for the TPU kernel's -1e30 log-ratio and zero feature
// padding. t is a kernel argument, so nothing is rebuilt per ODE step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "c_api.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kEpsT = 1e-3f;   // sigma floor, ref flow_utils.py:279
constexpr int kThreads = 256;
constexpr int kBK = 32;          // reduction depth of a stage
constexpr int kLd = kBK + 4;     // row stride of a row-major stage (floats)
constexpr int kStages = 4;       // ring depth
constexpr int kBM1 = 64;         // kernel 1 tile: trajectories b
constexpr int kBN1 = 128;        // kernel 1 tile: MC rows n
constexpr int kStage1 = (kBM1 + kBN1) * kLd;   // floats of one kernel-1 stage
constexpr int kBM2 = 64;         // kernel 2 tile: trajectories b
constexpr int kBD2 = 128;        // kernel 2 tile: features d
constexpr int kLdP = kBN1 + 2;   // row stride of the float64 partial tile
constexpr unsigned kFull = 0xffffffffu;

static_assert(2 * (kBM1 * kLdP + kBN1) <= kStages * kStage1,
              "partial tile and |v|^2 sums alias the ring");

__host__ __device__ constexpr int smem1_floats() {
  return kStages * kStage1 + 3 * kBN1;   // ring, |v|^2 partials (double), sums
}
__host__ __device__ constexpr int smem2_floats() {
  return kStages * kBK * kBD2 + 2 * kBM2 * kLd + 3 * kBM2;
}

struct Args {
  const float* xt;
  const float* yt;
  const float* X1;
  const float* Y1;
  const float* log_r;
  double* S;
  float* gx;
  float* gy;
  float* ess;
  float* l;
  int B, N, Dx, Dy, K;
  float t;
};

// c += a b on the FP64 tensor cores (16x8x8, sm_90), with g = lane / 4 and
// q = lane % 4: a[i + 2j] = A[g + 8i][q + 4j], b[j] = B[q + 4j][g] and
// c[i + 2j] = C[g + 8j][2q + i].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !ok (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Tile [ROWS][COLS] of the virtual concat [P | Q] (row widths Dp, Dq) at
// (row0, col0) into dst with row stride LD; rows >= nrows and columns >=
// col_end are zero. AL: every row of P and Q is 16-byte aligned and col_end is
// a multiple of 4, so a 4-float chunk lies wholly in P or in Q.
template <bool AL, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ P,
                                          const float* __restrict__ Q, int Dp,
                                          int Dq, int nrows, int row0, int col0,
                                          int col_end, int tid) {
  if (AL) {
    constexpr int CPR = COLS / 4;
    static_assert((ROWS * CPR) % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / CPR, c = (e % CPR) * 4;
      const int row = row0 + r, col = col0 + c;
      const bool ok = row < nrows && col < col_end;
      const float* src = P;
      if (ok)
        src = col < Dp ? P + (size_t)row * Dp + col
                       : Q + (size_t)row * Dq + (col - Dp);
      cp_async16(dst + r * LD + c, src, ok);
    }
  } else {
    static_assert((ROWS * COLS) % kThreads == 0, "whole elements per thread");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / COLS, c = e % COLS;
      const int row = row0 + r, col = col0 + c;
      float v = 0.f;
      if (row < nrows && col < col_end)
        v = col < Dp ? P[(size_t)row * Dp + col]
                     : Q[(size_t)row * Dq + (col - Dp)];
      dst[r * LD + c] = v;
    }
  }
}

// Kernel 1. grid K * tiles (1-D), cluster K along x, block kThreads.
// Rank r of a cluster multiplies over stages [r*T/K, (r+1)*T/K) of the T =
// ceil(D/kBK) stages of the feature axis.
template <bool AL>
__global__ void __launch_bounds__(kThreads, 1) scores_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  // this rank's partial |v_n|^2, in float64: |v_n|^2 ~ D shifts the score of
  // column n for every row alike, so its rounding does not cancel in the
  // softmax; the ranks' partials are added exactly and rounded once
  double* vn_s = reinterpret_cast<double*>(smem + kStages * kStage1);
  // after the loop, in the ring: this rank's partial tile of <a_b, v_n>,
  // then |v_n|^2 over the ranks (kBN1), all float64
  double* P = reinterpret_cast<double*>(smem);
  double* vn = P + kBM1 * kLdP;

  const int tid = threadIdx.x;
  const int K = a.K;
  const int rank = blockIdx.x % K;
  const int tile = blockIdx.x / K;
  const int tiles_n = (a.N + kBN1 - 1) / kBN1;
  const int n0 = (tile % tiles_n) * kBN1;
  const int m0 = (tile / tiles_n) * kBM1;
  const int D = a.Dx + a.Dy;
  const int total = (D + kBK - 1) / kBK;
  const int s_begin = (int)((long long)rank * total / K);
  const int s_end = (int)((long long)(rank + 1) * total / K);
  const int nst = s_end - s_begin;
  const int k_end = min(D, s_end * kBK);

  auto load_stage = [&](int st) {
    float* As = ring + (st % kStages) * kStage1;
    float* Vs = As + kBM1 * kLd;
    const int k0 = (s_begin + st) * kBK;
    load_tile<AL, kBM1, kBK, kLd>(As, a.xt, a.yt, a.Dx, a.Dy, a.B, m0, k0,
                                  k_end, tid);
    load_tile<AL, kBN1, kBK, kLd>(Vs, a.X1, a.Y1, a.Dx, a.Dy, a.N, n0, k0,
                                  k_end, tid);
  };

  // compute mapping: warp w owns the 32 x 32 block at rows 32 (w / 4),
  // columns 32 (w % 4) of the tile as 2 x 4 fragments of 16 x 8; a lane
  // reads rows (or columns) lane / 4 (+ 8) of a fragment at k = lane % 4
  // (+ 4)
  const int lane = tid & 31;
  const int wm = (tid >> 7) * 32;
  const int wn = ((tid >> 5) & 3) * 32;
  const int fr = lane >> 2;
  const int fk = lane & 3;
  // |v_n|^2 mapping: row tid/2, k in [16 (tid&1), +16)
  const int vrow = tid >> 1;
  const int vk = (tid & 1) * 16;

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
  double nrm = 0.0;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) load_stage(p);
    cp_async_commit();
  }

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` has landed; stage it-1 is free again
    if (it + kStages - 1 < nst) load_stage(it + kStages - 1);
    cp_async_commit();

    const float* As = ring + (it % kStages) * kStage1;
    const float* Vs = As + kBM1 * kLd;
    {
      const float* p = Vs + vrow * kLd + vk;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(p + 4 * c);
        nrm = fma((double)v.x, (double)v.x, nrm);
        nrm = fma((double)v.y, (double)v.y, nrm);
        nrm = fma((double)v.z, (double)v.z, nrm);
        nrm = fma((double)v.w, (double)v.w, nrm);
      }
    }
    // the stage's 32 k in float64 on the tensor cores (the float32 inputs
    // are exact in float64): 4 steps of 8, each 8 fragment products
    const float* ap = As + (wm + fr) * kLd + fk;
    const float* vp = Vs + (wn + fr) * kLd + fk;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      double af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          af[i][v] = ap[(16 * i + 8 * (v & 1)) * kLd + kk + 4 * (v >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) bf[j][v] = vp[8 * j * kLd + kk + 4 * v];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], af[i], bf[j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();   // every thread is done with the ring: P may alias it

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
        *reinterpret_cast<double2*>(
            &P[(wm + 16 * i + 8 * h8 + fr) * kLdP + wn + 8 * j + 2 * fk]) =
            make_double2(acc[i][j][2 * h8], acc[i][j][2 * h8 + 1]);
  nrm += __shfl_xor_sync(kFull, nrm, 1);
  if ((tid & 1) == 0) vn_s[vrow] = nrm;

  cg::cluster_group cluster = cg::this_cluster();
  if (K > 1) cluster.sync(); else __syncthreads();

  if (tid < kBN1) {
    double v = 0.0;
    for (int q = 0; q < K; ++q) {
      const double* p = K > 1 ? cluster.map_shared_rank(vn_s, q) : vn_s;
      v += p[tid];
    }
    vn[tid] = v;
  }
  __syncthreads();

  // rank r finishes rows r, r + K, ... of the tile (each half of the CTA every
  // other one of them), adding the ranks' partial sums in rank order
  // the float32 scalars of the plain version, then float64 arithmetic
  const float sigma = 1.0f - a.t + kEpsT;
  const double inv_2s2 = 0.5f / (sigma * sigma);
  const double two_t = 2.0f * a.t;
  const double t2 = a.t * a.t;
  const int h = tid >> 7;
  const int n = tid & 127;
  const int nn = n0 + n;
  const bool in = nn < a.N;
  const int C = (a.N + 31) / 32;
  double* part_m = a.S + (size_t)a.B * a.N;
  float* part_l = reinterpret_cast<float*>(part_m + (size_t)a.B * C);
  float* part_q = part_l + (size_t)a.B * C;
  const double vnn = vn[n];
  const float lr = in ? a.log_r[nn] : 0.f;
  const double* peer[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    peer[q] = K > 1 ? cluster.map_shared_rank(P, q < K ? q : 0) : P;
  // four rows at a time: all their loads from the peers go first
  for (int mb = rank + h * K; mb < kBM1; mb += 8 * K) {
    double pv[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = min(mb + 2 * K * r, kBM1 - 1);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        pv[r][q] = q < K ? peer[q][m * kLdP + n] : 0.0;
    }
    double s[4], mx[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      double cross = 0.0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < K) cross += pv[r][q];
      // In float64, each step rounded without FMA contraction, in the order
      // of the plain version:
      // s = log r - (t^2 |v_n|^2 - 2t cross) / (2 sigma^2).
      const double sq = __dsub_rn(__dmul_rn(t2, vnn), __dmul_rn(two_t, cross));
      s[r] = in ? __dsub_rn(lr, __dmul_rn(sq, inv_2s2)) : -DBL_MAX;
      mx[r] = s[r];
    }
    // softmax partials of this warp's 32 columns of each row
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mx[r] = fmax(mx[r], __shfl_xor_sync(kFull, mx[r], off));
    float l[4], q2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = in ? expf(__double2float_rn(s[r] - mx[r])) : 0.f;
      l[r] = e;
      q2[r] = e * e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], off);
        q2[r] += __shfl_xor_sync(kFull, q2[r], off);
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = mb + 2 * K * r;
      const int b = m0 + m;
      if (m >= kBM1 || b >= a.B || !in) continue;
      a.S[(size_t)b * a.N + nn] = s[r];
      if ((tid & 31) == 0) {
        const size_t idx = (size_t)b * C + nn / 32;
        part_m[idx] = mx[r];
        part_l[idx] = l[r];
        part_q[idx] = q2[r];
      }
    }
  }
  // no CTA leaves while a peer reads its partial sums
  if (K > 1) cluster.sync();
}

// Kernel 2. grid tiles_d * tiles_b (1-D), block kThreads. One CTA per BM x BD
// tile of G; K = N in stages of kBK. Thread (ty, tx) owns rows ty + 16i
// (i < BM/16) and columns 64g + 4tx .. +3 (g < BD/64).
template <bool AL>
__global__ void __launch_bounds__(kThreads, 2) weighted_sum_kernel(Args a) {
  constexpr int BM = kBM2;
  constexpr int BD = kBD2;
  constexpr int TM = BM / 16;
  constexpr int TG = BD / 64;
  constexpr int kStage2 = kBK * BD;
  constexpr int WR = BM / 32;      // W rows a thread fills per stage
  constexpr int SR = BM / 8;       // rows a warp takes statistics of

  extern __shared__ __align__(16) float smem[];
  float* Vs = smem;
  float* Ws = smem + kStages * kStage2;     // [2][BM][kLd]
  double* row_m = reinterpret_cast<double*>(Ws + 2 * BM * kLd);
  float* row_il = reinterpret_cast<float*>(row_m + BM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int B = a.B, N = a.N, Dx = a.Dx;
  const int D = a.Dx + a.Dy;
  const int tiles_d = (D + BD - 1) / BD;
  const int d0 = (blockIdx.x % tiles_d) * BD;
  const int m0 = (blockIdx.x / tiles_d) * BM;
  const int nst = (N + kBK - 1) / kBK;
  const bool s_vec = AL && (N % 4 == 0);

  auto load_v = [&](int st) {
    load_tile<AL, kBK, BD, BD>(Vs + (st % kStages) * kStage2, a.X1, a.Y1, a.Dx,
                               a.Dy, N, st * kBK, d0, D, tid);
  };

  // the first V stages load while the prologue takes the rows' statistics
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < nst) load_v(p);
    cp_async_commit();
  }

  // softmax statistics of the tile's rows from the partials (max, sum e,
  // sum e^2 per 32 columns) that kernel 1 left behind S: warp w takes rows
  // w + 8j, all at once, lane j the j-th partial
  const int C = (N + 31) / 32;
  const double* part_m = a.S + (size_t)B * N;
  const float* part_l = reinterpret_cast<const float*>(part_m + (size_t)B * C);
  const float* part_q = part_l + (size_t)B * C;
  {
    double M[SR];
    float l[SR], q[SR];
#pragma unroll
    for (int rr = 0; rr < SR; ++rr) {
      M[rr] = -DBL_MAX;
      l[rr] = 0.f;
      q[rr] = 0.f;
    }
    for (int cb = 0; cb < C; cb += 32) {
      const bool have = cb + lane < C;
      double pm[SR];
      float pl[SR], pq[SR];
#pragma unroll
      for (int rr = 0; rr < SR; ++rr) {
        const size_t idx = (size_t)min(m0 + warp + 8 * rr, B - 1) * C +
                           min(cb + lane, C - 1);
        pm[rr] = part_m[idx];
        pl[rr] = part_l[idx];
        pq[rr] = part_q[idx];
      }
#pragma unroll
      for (int rr = 0; rr < SR; ++rr) {
        if (!have) continue;
        if (pm[rr] > M[rr]) {
          const float c = expf(__double2float_rn(M[rr] - pm[rr]));
          l[rr] *= c;
          q[rr] *= c * c;
          M[rr] = pm[rr];
        }
        const float c = expf(__double2float_rn(pm[rr] - M[rr]));
        l[rr] = fmaf(pl[rr], c, l[rr]);
        q[rr] = fmaf(pq[rr], c * c, q[rr]);
      }
    }
    double Mw[SR];
#pragma unroll
    for (int rr = 0; rr < SR; ++rr) Mw[rr] = M[rr];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < SR; ++rr)
        Mw[rr] = fmax(Mw[rr], __shfl_xor_sync(kFull, Mw[rr], off));
#pragma unroll
    for (int rr = 0; rr < SR; ++rr) {
      const float c = expf(__double2float_rn(M[rr] - Mw[rr]));
      l[rr] *= c;
      q[rr] *= c * c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < SR; ++rr) {
        l[rr] += __shfl_xor_sync(kFull, l[rr], off);
        q[rr] += __shfl_xor_sync(kFull, q[rr], off);
      }
    // every lane holds every row's totals: lane rr finishes row warp + 8 rr
    double Mv = Mw[0];
    float lv = l[0], qv = q[0];
#pragma unroll
    for (int rr = 1; rr < SR; ++rr)
      if (lane == rr) {
        Mv = Mw[rr];
        lv = l[rr];
        qv = q[rr];
      }
    if (lane < SR) {
      const int r = warp + 8 * lane;
      const int b = m0 + r;
      const bool in = b < B;
      row_m[r] = in ? Mv : 0.0;
      row_il[r] = in ? __frcp_rn(lv + 1e-30f) : 0.f;
      if (in && d0 == 0) {
        a.ess[b] = (lv * lv) / (qv + 1e-30f);
        a.l[b] = lv;
      }
    }
  }
  __syncthreads();

  // W stage: thread fills chunk wc (4 consecutive n) of rows wr + 32i;
  // sv holds S - m in float32 (-FLT_MAX past N), taken in float64
  const int wc = (tid & 7) * 4;
  const int wr = tid >> 3;
  float4 sv[WR];
  auto load_s = [&](int st) {
    const int n = st * kBK + wc;
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int b = m0 + wr + 32 * i;
      const double m = row_m[wr + 32 * i];
      float4 v = make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
      if (b < B) {
        const double* p = a.S + (size_t)b * N + n;
        if (s_vec) {
          if (n < N) {
            const double2 lo = *reinterpret_cast<const double2*>(p);
            const double2 hi = *reinterpret_cast<const double2*>(p + 2);
            v = make_float4(__double2float_rn(lo.x - m),
                            __double2float_rn(lo.y - m),
                            __double2float_rn(hi.x - m),
                            __double2float_rn(hi.y - m));
          }
        } else {
          if (n < N) v.x = __double2float_rn(p[0] - m);
          if (n + 1 < N) v.y = __double2float_rn(p[1] - m);
          if (n + 2 < N) v.z = __double2float_rn(p[2] - m);
          if (n + 3 < N) v.w = __double2float_rn(p[3] - m);
        }
      }
      sv[i] = v;
    }
  };
  auto store_w = [&](int st) {
    float* dst = Ws + (st & 1) * BM * kLd + wc;
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const float il = row_il[wr + 32 * i];
      float4 w;
      w.x = sv[i].x > -FLT_MAX ? expf(sv[i].x) * il : 0.f;
      w.y = sv[i].y > -FLT_MAX ? expf(sv[i].y) * il : 0.f;
      w.z = sv[i].z > -FLT_MAX ? expf(sv[i].z) * il : 0.f;
      w.w = sv[i].w > -FLT_MAX ? expf(sv[i].w) * il : 0.f;
      *reinterpret_cast<float4*>(dst + wr * kLd + 32 * i * kLd) = w;
    }
  };

  float acc[TM][4 * TG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * TG; ++j) acc[i][j] = 0.f;

  load_s(0);
  store_w(0);

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // V stage `it` and W stage `it` are in shared memory
    if (it + kStages - 1 < nst) load_v(it + kStages - 1);
    cp_async_commit();
    const bool more = it + 1 < nst;
    if (more) load_s(it + 1);     // in flight while this stage multiplies

    const float* Wb = Ws + (it & 1) * BM * kLd + ty * kLd;
    const float* Vb = Vs + (it % kStages) * kStage2 + tx * 4;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      float4 wf[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        wf[i] = *reinterpret_cast<const float4*>(Wb + i * 16 * kLd + 4 * c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vf[TG];
#pragma unroll
        for (int g = 0; g < TG; ++g)
          vf[g] = *reinterpret_cast<const float4*>(Vb + (4 * c + kk) * BD +
                                                   64 * g);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float w = kk == 0 ? wf[i].x
                          : kk == 1 ? wf[i].y
                          : kk == 2 ? wf[i].z
                                    : wf[i].w;
#pragma unroll
          for (int g = 0; g < TG; ++g) {
            acc[i][4 * g + 0] = fmaf(w, vf[g].x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(w, vf[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(w, vf[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(w, vf[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    // buffer (it+1)&1 was last read in stage it-1, before this stage's barrier
    if (more) store_w(it + 1);
  }
  cp_async_wait<0>();

  const float inv_sigma = 1.0f / (1.0f - a.t + kEpsT);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int g = 0; g < TG; ++g) {
      const int d = d0 + 64 * g + 4 * tx;
      if (AL) {
        if (d >= D) continue;
        const size_t o = d < Dx ? (size_t)b * Dx + d
                                : (size_t)b * a.Dy + (d - Dx);
        const float4 x =
            *reinterpret_cast<const float4*>((d < Dx ? a.xt : a.yt) + o);
        float4 out;
        out.x = (acc[i][4 * g + 0] - x.x) * inv_sigma;
        out.y = (acc[i][4 * g + 1] - x.y) * inv_sigma;
        out.z = (acc[i][4 * g + 2] - x.z) * inv_sigma;
        out.w = (acc[i][4 * g + 3] - x.w) * inv_sigma;
        *reinterpret_cast<float4*>((d < Dx ? a.gx : a.gy) + o) = out;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dj = d + j;
          if (dj < Dx) {
            const size_t o = (size_t)b * Dx + dj;
            a.gx[o] = (acc[i][4 * g + j] - a.xt[o]) * inv_sigma;
          } else if (dj < D) {
            const size_t o = (size_t)b * a.Dy + (dj - Dx);
            a.gy[o] = (acc[i][4 * g + j] - a.yt[o]) * inv_sigma;
          }
        }
      }
    }
  }
}

// Raises the kernel's dynamic shared-memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& set) {
  if (bytes > 48 * 1024 && bytes > set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set = bytes;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t scores_config(const Args& a, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  const int tiles = ((a.N + kBN1 - 1) / kBN1) * ((a.B + kBM1 - 1) / kBM1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.K * tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem1_floats() * sizeof(float);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.K > 1 ? 1 : 0;
  return cfg;
}

// Launches the score kernel, or with `occupancy` only asks how many of its
// clusters the card holds at once.
template <bool AL>
int launch_scores(const Args& a, cudaStream_t s, int* occupancy) {
  auto kernel = scores_kernel<AL>;
  static int smem_set = 0;
  cudaError_t err =
      allow_smem(kernel, smem1_floats() * (int)sizeof(float), smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scores_config(a, s, attr);
  if (occupancy)
    return (int)cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <bool AL>
int launch_sum(const Args& a, cudaStream_t s) {
  auto kernel = weighted_sum_kernel<AL>;
  static int smem_set = 0;
  const int bytes = smem2_floats() * (int)sizeof(float);
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int D = a.Dx + a.Dy;
  const int grid = ((D + kBD2 - 1) / kBD2) * ((a.B + kBM2 - 1) / kBM2);
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch both kernels on `stream` with the plan of
// ops/guidance.py:guidance_plan: `cluster` CTAs split the feature axis of each
// score tile and `aligned` picks the 16-byte loader. S is the only workspace:
// [B, N] float64 scores followed by the softmax partials, [B, ceil(N/32)]
// float64 maxima and [2, B, ceil(N/32)] float32 sums. smem1 and
// smem2 are the plan's dynamic shared-memory bytes and must equal this file's.
// Returns a CUDA error code (0 = launched); cudaErrorInvalidValue for a plan
// the kernels cannot run.
int rgmf_flash_guidance(const float* xt, const float* yt, const float* X1,
                        const float* Y1, const float* log_r, int B, int N,
                        int Dx, int Dy, float t, int cluster, int aligned,
                        int smem1, int smem2, double* S, float* gx, float* gy,
                        float* ess, float* l, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int D = Dx + Dy;
  const int total = (D + kBK - 1) / kBK;
  if (B < 1 || N < 1 || Dx < 1 || Dy < 1 || cluster < 1 || cluster > 8 ||
      cluster > total || smem1 != smem1_floats() * (int)sizeof(float) ||
      smem2 != smem2_floats() * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (aligned &&
      (Dx % 4 || Dy % 4 ||
       (((uintptr_t)xt | (uintptr_t)yt | (uintptr_t)X1 | (uintptr_t)Y1 |
         (uintptr_t)S | (uintptr_t)gx | (uintptr_t)gy) & 15)))
    return (int)cudaErrorInvalidValue;
  const Args a{xt, yt, X1, Y1, log_r, S, gx, gy, ess, l, B, N, Dx, Dy,
               cluster, t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = aligned ? launch_scores<true>(a, s, nullptr)
                   : launch_scores<false>(a, s, nullptr);
  if (rc != 0) return rc;
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return aligned ? launch_sum<true>(a, s) : launch_sum<false>(a, s);
}

// Clusters of `cluster` CTAs of the score kernel that the card can hold at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int rgmf_flash_guidance_max_clusters(int cluster, int aligned, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  Args a = {};
  a.B = kBM1;
  a.N = kBN1 * 1024;     // 1024 tiles: the grid does not limit the answer
  a.K = cluster;
  int n = 0;
  const int rc = aligned ? launch_scores<true>(a, 0, &n)
                         : launch_scores<false>(a, 0, &n);
  return rc == 0 ? n : -rc;
}

// cudaGetLastError of this library's runtime (and clears it).
int rgmf_last_error(void) { return (int)cudaGetLastError(); }

}  // extern "C"
