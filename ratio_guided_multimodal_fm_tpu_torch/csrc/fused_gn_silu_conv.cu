// Fused GroupNorm + SiLU + 3x3 SAME convolution for Hopper (sm_90a):
//
//   out[b,h,w,o] = conv_b[o] + sum_{dh,dw,c} act[b,h+dh-1,w+dw-1,c] * W[dh,dw,c,o]
//   act = round_to_T(silu((x - mean[b,g]) * rstd[b,g] * scale[c] + bias[c]))
//
// NHWC activations of type T (bf16 or float32), HWIO float32 weights (rounded
// to T, as the JAX kernel casts them), float32 GroupNorm parameters and bias.
// An out-of-image tap contributes 0: SAME padding pads the activation, not x.
// SiLU runs in float32 and the activation is rounded once, to T, before the
// product; the products accumulate in float32 and the bias is added before the
// store in T.
//
// Replaces: ratio_guided_multimodal_fm_tpu/ops/resblock_pallas.py:
// fused_gn_silu_conv (body `_kernel`), which keeps whole samples in VMEM,
// takes their statistics there and feeds the normalised tile into 9 shifted
// MXU matmuls.
//
// Bound on the card at the bench's 512x32x32x64->64 bf16 shape: 38.7 GFLOP
// (0.039 ms at 989 TFLOP/s) against one read of x and one write of out,
// 128 MiB (0.040 ms at 3.35 TB/s): the two are even, so neither the
// activation nor the copies may cost more than the products.
//
// Three launches:
//   1. gn_stats: one CTA per sample takes its per-group statistics with the
//      code kernel B uses (gn_common.cuh: float64 sums, float32 mean/rstd).
//      A CTA of the convolution sees only part of an image, so the statistics
//      cannot be taken where they are used.
//   2. prep_weights: HWIO float32 -> T, zero-padded, as the sequence of
//      weight stages in their shared-memory layout (bf16 [n][k] rows for
//      ldmatrix, float32 [k][n]).
//   3. conv: persistent CTAs walk tiles of R whole image rows (up to 128
//      output pixels; columns are tiled only where W > 128) times all O
//      outputs. For each tile the CTA holds the (R+2) x (Wt+2) x C halo of x
//      in shared memory, applies normalise, affine, SiLU and the rounding to T
//      once per element, and writes zeros outside the image. The 9 taps then
//      read shifted views of that one tile, and O > 64 reuses it for each
//      64-wide chunk of outputs. A call computes M*C*(R+2)/R activations
//      (times (Wt+2)/Wt for the columns; 1.5x M*C at 32x32 maps, R = 4)
//      where the first version of this kernel computed M*9*C*ceil(O/64), once
//      per tap and per output tile (9x and 18x M*C at the bench shapes).
//      While a tile is multiplied, the raw x rows of the CTA's next tile are
//      in flight as one bulk copy (TMA, completing on an mbarrier), and the
//      next weight stage (64 outputs x 64 input channels of one tap) as one
//      more bulk copy, double-buffered.
//
// Tensor cores: bf16 runs mma.sync.m16n8k16 (float32 accumulate) with both
// operands from ldmatrix. The A rows are pixels of the halo tile addressed one
// by one, so the shift of a tap is a constant added to each lane's row
// address, and the halo's channel pitch (a multiple of 16 plus 8 elements)
// keeps the eight rows of each 8x8 matrix on distinct banks. wgmma would read
// A from a swizzled shared-memory descriptor, where a shift by one pixel is
// not a descriptor offset, or from registers loaded the same way as here; it
// pays only once the activation, the epilogue and the per-stage barrier no
// longer take most of a tile's time, so this version keeps mma.sync (wgmma
// with warp-specialised producers is for a later change). float32 stays plain
// IEEE FMA (never TF32), an 8x4 register tile per thread over the same halo.

#include "c_api.cuh"
#include "gn_common.cuh"

namespace {

using rgmf::bf16;

constexpr int kBN = 64;    // outputs per N chunk
constexpr int kKC = 64;    // input channels per weight stage
constexpr int kMaxM = 128; // output pixels per tile
constexpr int kStages = 2; // ring of weight stages in shared memory (a
                           // deeper ring costs CTAs an SM and measured slower)
constexpr int kThreadsBF16 = 128;  // 4 warps: 2 along the pixels, 2 along
                                   // the outputs, 64 x 32 each
constexpr int kMI = 4;             // m16 tiles of a warp (bf16)
constexpr int kThreadsF32 = 256;   // 16 x 16 threads, 8 pixels x 4 outputs

// ---- 1. statistics -----------------------------------------------------------

// grid B, block a multiple of 32 and of G; dynamic shared memory
// 16 * G * nwarps bytes. stats[b*G + g] = (mean, rstd).
template <typename T>
__global__ void __launch_bounds__(1024)
gn_stats_kernel(const T* __restrict__ x, int HW, int C, int G, float eps,
                rgmf::GroupStat* __restrict__ stats) {
  extern __shared__ double red[];     // [G][nwarps][2]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int cg = C / G, g = tid % G;
  const T* xs = x + (size_t)blockIdx.x * HW * C;
  uintptr_t al = (uintptr_t)xs | (uintptr_t)(C * sizeof(T)) | 16u;
  al &= ~al + 1;
  double s = 0.0, s2 = 0.0;
  rgmf::cl_partial_any<T>(xs, HW, C, cg, g, tid / G, nthreads / G, (int)al, s,
                          s2);
  for (int gg = 0; gg < G; ++gg) {
    const double v = rgmf::warp_sum(gg == g ? s : 0.0);
    const double v2 = rgmf::warp_sum(gg == g ? s2 : 0.0);
    if (lane == 0) {
      red[(gg * nwarps + warp) * 2] = v;
      red[(gg * nwarps + warp) * 2 + 1] = v2;
    }
  }
  __syncthreads();
  if (tid < G) {
    s = s2 = 0.0;
    for (int w = 0; w < nwarps; ++w) {
      s += red[(tid * nwarps + w) * 2];
      s2 += red[(tid * nwarps + w) * 2 + 1];
    }
    stats[blockIdx.x * G + tid] = rgmf::gn_finalize(s, s2, (double)cg * HW, eps);
  }
}

// ---- 2. weights in the operand layout ---------------------------------------

// The weights as the sequence of stages the convolution consumes: stage
// s = (nc * 9 + tap) * nK + kc holds outputs [64 nc, 64 nc + 64) and input
// channels [64 kc, 64 kc + 64) of one tap, zero-padded, in the layout of its
// shared-memory slot: bf16 [64 n][64 + 8 k] (k contiguous, 8 elements of
// padding against bank conflicts), float32 [64 k][64 n]. One bulk copy moves
// a stage.
template <typename T>
__global__ void prep_weights_kernel(const float* __restrict__ w, int C, int O,
                                    int nK, int n_chunks, T* __restrict__ wp) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kStage = kBF16 ? kBN * (kKC + 8) : kKC * kBN;
  const int total = n_chunks * 9 * nK * kStage;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int s = i / kStage, e = i - s * kStage;
    const int kc = s % nK, tap = (s / nK) % 9, nc = s / (9 * nK);
    const int kk = kBF16 ? e % (kKC + 8) : e / kBN;
    const int nn = kBF16 ? e / (kKC + 8) : e % kBN;
    const int k = kc * kKC + kk, n = nc * kBN + nn;
    const float v = (kk < kKC && k < C && n < O)
                        ? w[((size_t)tap * C + k) * O + n] : 0.f;
    wp[i] = rgmf::from_f32<T>(v);
  }
}

// ---- 3. the convolution ------------------------------------------------------

struct ConvArgs {
  const void* x;
  const rgmf::GroupStat* stats;
  const float* scale;
  const float* bias;
  const void* wp;
  const float* cb;
  void* out;
  int B, H, W, C, O, G;
  int R, Wt, tiles_h, tiles_w, ntiles;
  int Kpad, CP, Np, bulk;
};

// Channel pitch of the halo tile and padded depth: bf16 pads C to a multiple
// of 16 (the MMA depth) plus 8 elements against bank conflicts.
__host__ __device__ inline int conv_kpad(int C, int itemsize) {
  return itemsize == 2 ? rgmf::round_up(C, 16) : C;
}
__host__ __device__ inline int conv_pitch(int C, int itemsize) {
  return itemsize == 2 ? rgmf::round_up(C, 16) + 8 : rgmf::round_up(C, 4);
}

// Shared-memory layout (bytes), the same formula as ops/resblock.py:conv_plan:
//   [0, 16) mbarrier; [128, ..) mean, rstd, scale, bias per channel (float32,
//   each padded to a multiple of 8);
//   halo [(R+2)][(Wt+2)][CP] of T; raw x rows [(R+2)][Wr][C] of T (Wr = W for
//   full-width tiles, else Wt+2); kStages weight stages.
struct ConvSmem {
  int halo, raw, w, stage, total;
};
__host__ __device__ inline ConvSmem conv_smem(int itemsize, int C, int W,
                                              int R, int Wt) {
  const int HP = R + 2, WP = Wt + 2, Wr = Wt == W ? W : WP;
  ConvSmem s;
  s.halo = rgmf::round_up(128 + 16 * rgmf::round_up(C, 8), 128);
  s.raw = s.halo + rgmf::round_up(HP * WP * conv_pitch(C, itemsize) * itemsize,
                                   128);
  s.w = s.raw + rgmf::round_up(HP * Wr * C * itemsize, 128);
  s.stage = itemsize == 2 ? kBN * (kKC + 8) * 2 : kKC * kBN * 4;
  s.total = s.w + kStages * s.stage;
  return s;
}

struct Tile {
  int b, h0, w0;
};
__device__ __forceinline__ Tile tile_of(const ConvArgs& a, int t) {
  const int per = a.tiles_h * a.tiles_w;
  return {t / per, (t % per) / a.tiles_w * a.R, (t % a.tiles_w) * a.Wt};
}

// Raw x rows h0-1 .. h0+R (clipped to the image) of tile t into `raw`: one
// bulk copy (full-width tiles) or one per row, completing on `bar`. Thread 0.
template <typename T>
__device__ void request_raw(const ConvArgs& a, int t, T* raw, uint64_t* bar) {
  const Tile tl = tile_of(a, t);
  const T* x = static_cast<const T*>(a.x);
  const int gh_lo = max(0, tl.h0 - 1), gh_hi = min(a.H, tl.h0 + a.R + 1);
  if (a.Wt == a.W) {
    const uint32_t bytes = (uint32_t)((gh_hi - gh_lo) * a.W * a.C * sizeof(T));
    rgmf::mbar_expect_tx(bar, bytes);
    rgmf::bulk_g2s(raw + (size_t)(gh_lo - (tl.h0 - 1)) * a.W * a.C,
                   x + ((size_t)tl.b * a.H + gh_lo) * a.W * a.C, bytes, bar);
  } else {
    const int WP = a.Wt + 2;
    const int gw_lo = max(0, tl.w0 - 1), gw_hi = min(a.W, tl.w0 + a.Wt + 1);
    const uint32_t row = (uint32_t)((gw_hi - gw_lo) * a.C * sizeof(T));
    rgmf::mbar_expect_tx(bar, row * (gh_hi - gh_lo));
    for (int gh = gh_lo; gh < gh_hi; ++gh)
      rgmf::bulk_g2s(
          raw + ((size_t)(gh - (tl.h0 - 1)) * WP + (gw_lo - (tl.w0 - 1))) * a.C,
          x + (((size_t)tl.b * a.H + gh) * a.W + gw_lo) * a.C, row, bar);
  }
}

// The same copy by all threads with plain loads (x not 16-byte aligned).
template <typename T>
__device__ void copy_raw_sync(const ConvArgs& a, int t, T* raw) {
  const Tile tl = tile_of(a, t);
  const T* x = static_cast<const T*>(a.x);
  const int HP = a.R + 2, WP = a.Wt + 2, Wr = a.Wt == a.W ? a.W : WP;
  const int n = HP * Wr * a.C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % a.C, col = (i / a.C) % Wr, hp = i / (a.C * Wr);
    const int gh = tl.h0 - 1 + hp;
    const int gw = a.Wt == a.W ? col : tl.w0 - 1 + col;
    if (gh >= 0 && gh < a.H && gw >= 0 && gw < a.W)
      raw[i] = x[(((size_t)tl.b * a.H + gh) * a.W + gw) * a.C + c];
  }
}

// raw x of tile t -> activation halo: normalise, affine, SiLU in float32, one
// rounding to T; zeros outside the image and in the padded channels.
template <typename T>
__device__ void activate(const ConvArgs& a, int t, const T* raw, T* halo,
                         const float* par) {
  constexpr int V = 16 / sizeof(T);
  const Tile tl = tile_of(a, t);
  const int C = a.C, HP = a.R + 2, WP = a.Wt + 2, npix = HP * WP;
  const int Wr = a.Wt == a.W ? a.W : WP;
  const int width = sizeof(T) == 2 ? a.Kpad : a.CP;   // channels written
  const int nv = width / V;
  const int Cq = rgmf::round_up(C, 8);
  const float* mc = par;
  const float* rc = mc + Cq;
  const float* sc = rc + Cq;
  const float* bi = sc + Cq;
  auto raw_at = [&](int hp, int wp, int gw) {
    return raw + ((size_t)hp * Wr + (a.Wt == a.W ? gw : wp)) * C;
  };
  if (blockDim.x % nv == 0 && C % V == 0) {
    // A thread's V channels stay fixed: their parameters sit in registers and
    // the thread walks the pixels with a stride, without divisions.
    const int cv = (threadIdx.x % nv) * V, step = blockDim.x / nv;
    const bool real = cv < C;
    float m[V], r[V], w[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = real ? mc[cv + k] : 0.f;
      r[k] = real ? rc[cv + k] : 0.f;
      w[k] = real ? sc[cv + k] : 0.f;
      b[k] = real ? bi[cv + k] : 0.f;
    }
    int pix = threadIdx.x / nv, hp = pix / WP, wp = pix - hp * WP;
    for (; pix < npix; pix += step) {
      const int gh = tl.h0 - 1 + hp, gw = tl.w0 - 1 + wp;
      rgmf::Vec<T, V> o;
      if (real && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W) {
        const rgmf::Vec<T, V> v =
            *reinterpret_cast<const rgmf::Vec<T, V>*>(raw_at(hp, wp, gw) + cv);
#pragma unroll
        for (int k = 0; k < V; ++k)
          o.v[k] = rgmf::from_f32<T>(rgmf::silu_f32(rgmf::gn_affine(
              rgmf::to_f32(v.v[k]), {m[k], r[k]}, w[k], b[k])));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) o.v[k] = rgmf::from_f32<T>(0.f);
      }
      *reinterpret_cast<rgmf::Vec<T, V>*>(halo + (size_t)pix * a.CP + cv) = o;
      for (wp += step; wp >= WP; wp -= WP) ++hp;
    }
    return;
  }
  for (int i = threadIdx.x; i < npix * nv; i += blockDim.x) {
    const int pix = i / nv, cv = (i - pix * nv) * V;
    const int hp = pix / WP, wp = pix - hp * WP;
    const int gh = tl.h0 - 1 + hp, gw = tl.w0 - 1 + wp;
    const bool in = gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    const T* rp = raw_at(hp, wp, gw) + cv;
    rgmf::Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = cv + k;
      o.v[k] = in && c < C ? rgmf::from_f32<T>(rgmf::silu_f32(rgmf::gn_affine(
                                 rgmf::to_f32(rp[k]), {mc[c], rc[c]}, sc[c],
                                 bi[c])))
                           : rgmf::from_f32<T>(0.f);
    }
    *reinterpret_cast<rgmf::Vec<T, V>*>(halo + (size_t)pix * a.CP + cv) = o;
  }
}

// Position in the cyclic sequence of weight stages (n chunk, tap, k chunk),
// k chunk fastest: S = (Np / 64) * 9 * nK stages make one tile.
struct StageCursor {
  int nc = 0, tap = 0, kc = 0;
  __device__ void next(int nK, int n_chunks) {
    if (++kc < nK) return;
    kc = 0;
    if (++tap < 9) return;
    tap = 0;
    if (++nc == n_chunks) nc = 0;
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-thread state of the products of one 64-output chunk.
template <typename T>
struct Mma;

// bf16: warp (wm, wn) takes pixels [64 wm, 64 wm + 64) and outputs
// [32 wn, 32 wn + 32) of the chunk: 4 x 4 tiles of m16n8.
template <>
struct Mma<bf16> {
  float acc[kMI][4][4];
  uint32_t a_row[kMI];   // shared address of this lane's A row, tap (0, 0)
  uint32_t b_row;      // shared byte offset of this lane's B row in a stage
  int wm, wn, lane, Mt;

  __device__ void init(const ConvArgs& a, const bf16* halo) {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm = warp >> 1;
    wn = warp & 1;
    Mt = a.R * a.Wt;
    const int WP = a.Wt + 2;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      int m = wm * kMI * 16 + mi * 16 + (lane & 15);
      if (m >= Mt) m = 0;                   // rows past the tile: discarded
      const int r = m / a.Wt, c = m - r * a.Wt;
      a_row[mi] = rgmf::smem_u32(halo + ((size_t)r * WP + c) * a.CP +
                                 (lane >> 4) * 8);
    }
    const int n = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
    b_row = (uint32_t)((n * (kKC + 8) + ((lane >> 3) & 1) * 8) * 2);
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }
  // products of one stage: tap offset `tap_off` (elements of the halo),
  // channels [k0, k0 + kc) against the stage in `w`.
  __device__ void run(int tap_off, int k0, int kc, const bf16* w) {
    const uint32_t wb = rgmf::smem_u32(w) + b_row;
    const uint32_t aoff = (uint32_t)((tap_off + k0) * 2);
    bool act[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) act[mi] = wm * kMI * 16 + mi * 16 < Mt;
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {   // unrolled: loads run ahead
      if (ks >= kc) break;
      uint32_t af[kMI][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        if (act[mi]) ldmatrix_x4(af[mi], a_row[mi] + aoff + ks * 2);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(bfr[p], wb + (uint32_t)((p * 16 * (kKC + 8) + ks) * 2));
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        if (act[mi])
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            mma_bf16(acc[mi][nj], af[mi], bfr[nj >> 1][(nj & 1) * 2],
                     bfr[nj >> 1][(nj & 1) * 2 + 1]);
    }
  }
  __device__ void store(const ConvArgs& a, const Tile& tl, int n0) {
    bf16* out = static_cast<bf16*>(a.out);
    float2 bias[4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + wn * 32 + nj * 8 + 2 * (lane & 3);
      bias[nj] = make_float2(n < a.O ? a.cb[n] : 0.f,
                             n + 1 < a.O ? a.cb[n + 1] : 0.f);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = wm * kMI * 16 + mi * 16 + (lane >> 2) + hh * 8;
        if (m >= Mt) continue;
        const int r = m / a.Wt, h = tl.h0 + r, w = tl.w0 + m - r * a.Wt;
        if (h >= a.H || w >= a.W) continue;
        bf16* row = out + (((size_t)tl.b * a.H + h) * a.W + w) * a.O;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = n0 + wn * 32 + nj * 8 + 2 * (lane & 3);
          const float v0 = acc[mi][nj][2 * hh] + bias[nj].x;
          const float v1 = acc[mi][nj][2 * hh + 1] + bias[nj].y;
          if (n + 1 < a.O && (a.O & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(row + n) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < a.O) row[n] = __float2bfloat16_rn(v0);
            if (n + 1 < a.O) row[n + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
};

// float32: thread (ty, tx) takes pixels 8 ty .. 8 ty + 7 and outputs
// 4 tx .. 4 tx + 3 of the chunk, IEEE FMA.
template <>
struct Mma<float> {
  float acc[8][4];
  int a_idx[8];
  int tx, ty, Mt;
  const float* halo;

  __device__ void init(const ConvArgs& a, const float* h) {
    halo = h;
    tx = threadIdx.x % 16;
    ty = threadIdx.x / 16;
    Mt = a.R * a.Wt;
    const int WP = a.Wt + 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int m = ty * 8 + i;
      if (m >= Mt) m = 0;
      const int r = m / a.Wt, c = m - r * a.Wt;
      a_idx[i] = (r * WP + c) * a.CP;
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void run(int tap_off, int k0, int kc, const float* w) {
    const float* hb = halo + tap_off + k0;
    for (int k = 0; k < kc; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(w + k * kBN + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = hb[a_idx[i] + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
  __device__ void store(const ConvArgs& a, const Tile& tl, int n0) {
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty * 8 + i;
      if (m >= Mt) continue;
      const int r = m / a.Wt, h = tl.h0 + r, w = tl.w0 + m - r * a.Wt;
      if (h >= a.H || w >= a.W) continue;
      float* row = out + (((size_t)tl.b * a.H + h) * a.W + w) * a.O;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < a.O) row[n] = acc[i][j] + a.cb[n];
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kThreadsBF16 : kThreadsF32)
conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ConvSmem L = conv_smem(sizeof(T), a.C, a.W, a.R, a.Wt);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);      // raw x rows
  uint64_t* wbar = bar + 1;                                // [kStages]
  float* par = reinterpret_cast<float*>(smem + 128);
  T* halo = reinterpret_cast<T*>(smem + L.halo);
  T* raw = reinterpret_cast<T*>(smem + L.raw);
  T* wring = reinterpret_cast<T*>(smem + L.w);
  const int stage_elems = L.stage / (int)sizeof(T);
  const int tid = threadIdx.x;
  const int C = a.C, Cq = rgmf::round_up(C, 8), cg = C / a.G;
  const int depth = sizeof(T) == 2 ? a.Kpad : C;   // channels multiplied
  const int nK = (depth + kKC - 1) / kKC;           // weight stages per tap
  const int S = (a.Np / kBN) * 9 * nK;      // weight stages per tile
  const int WP = a.Wt + 2;

  for (int c = tid; c < C; c += blockDim.x) {
    par[2 * Cq + c] = a.scale[c];
    par[3 * Cq + c] = a.bias[c];
  }
  // The weight stages form one sequence over this CTA's tiles (stage g is
  // stage g % S of a tile), kept kStages - 1 ahead of the products in a ring
  // of slots, each filled by one bulk copy that completes on its mbarrier.
  const int my_tiles = (a.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * S;
  const int n_chunks = a.Np / kBN;
  const T* wp = static_cast<const T*>(a.wp);
  auto issue = [&](int g) {      // thread 0
    if (g >= total) return;
    uint64_t* b = &wbar[g % kStages];
    rgmf::mbar_expect_tx(b, (uint32_t)L.stage);
    rgmf::bulk_g2s(wring + (g % kStages) * stage_elems,
                   wp + (size_t)(g % S) * stage_elems, (uint32_t)L.stage, b);
  };
  if (tid == 0) {
    for (int q = 0; q < kStages; ++q) rgmf::mbar_init(&wbar[q], 1);
    if (a.bulk) {
      rgmf::mbar_init(bar, 1);
      request_raw<T>(a, blockIdx.x, raw, bar);
    }
    for (int g = 0; g < kStages - 1; ++g) issue(g);
  }
  Mma<T> mma;
  mma.init(a, halo);

  int st = 0;   // weight stages consumed by this CTA
  for (int t = blockIdx.x, it = 0; t < a.ntiles; t += gridDim.x, ++it) {
    const Tile tl = tile_of(a, t);
    __syncthreads();   // the previous tile's products are done with the halo
    for (int c = tid; c < C; c += blockDim.x) {
      const rgmf::GroupStat g = a.stats[tl.b * a.G + c / cg];
      par[c] = g.mean;
      par[Cq + c] = g.rstd;
    }
    if (a.bulk)
      rgmf::mbar_wait(bar, it & 1);
    else
      copy_raw_sync<T>(a, t, raw);
    __syncthreads();
    activate<T>(a, t, raw, halo, par);
    rgmf::fence_proxy_async();   // our reads of raw before the next bulk copy
    __syncthreads();
    const bool more = t + (int)gridDim.x < a.ntiles;
    if (tid == 0 && a.bulk && more)
      request_raw<T>(a, t + gridDim.x, raw, bar);

    StageCursor cur;
    for (int s = 0; s < S; ++s, ++st, cur.next(nK, n_chunks)) {
      __syncthreads();     // slot (st - 1) % kStages is free again
      if (tid == 0) {
        rgmf::fence_proxy_async();
        issue(st + kStages - 1);
      }
      rgmf::mbar_wait(&wbar[st % kStages], (st / kStages) & 1);
      if (cur.tap == 0 && cur.kc == 0) mma.zero();
      const int k0 = cur.kc * kKC;
      mma.run(((cur.tap / 3) * WP + cur.tap % 3) * a.CP, k0,
              min(kKC, depth - k0), wring + (st % kStages) * stage_elems);
      if (cur.tap == 8 && cur.kc == nK - 1) mma.store(a, tl, cur.nc * kBN);
    }
  }
}

template <typename T>
int launch_all(const ConvArgs& a0, const float* conv_w, int smem_bytes,
               float eps, cudaStream_t s) {
  ConvArgs a = a0;
  const int itemsize = sizeof(T);
  // 1. statistics
  int base = 32;
  while (base % a.G) base += 32;
  if (base > 1024) return (int)cudaErrorInvalidValue;
  const int st_threads = base * max(1, 256 / base);
  gn_stats_kernel<T><<<a.B, st_threads, 16 * a.G * (st_threads / 32), s>>>(
      static_cast<const T*>(a.x), a.H * a.W, a.C, a.G, eps,
      const_cast<rgmf::GroupStat*>(a.stats));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. weights
  const int nK = ((itemsize == 2 ? a.Kpad : a.C) + kKC - 1) / kKC;
  const int total = (a.Np / kBN) * 9 * nK *
                    (itemsize == 2 ? kBN * (kKC + 8) : kKC * kBN);
  prep_weights_kernel<T><<<min((total + 255) / 256, 1024), 256, 0, s>>>(
      conv_w, a.C, a.O, nK, a.Np / kBN,
      static_cast<T*>(const_cast<void*>(a.wp)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. the convolution, persistent over the tiles
  auto kernel = conv_kernel<T>;
  const int threads = itemsize == 2 ? kThreadsBF16 : kThreadsF32;
  static int smem_set = 0;
  if (smem_bytes > 48 * 1024 && smem_bytes > smem_set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(a.ntiles, per_sm * sms);
  kernel<<<grid, threads, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the three kernels on `stream` with the tiling of
// ops/resblock.py:conv_plan (R rows by Wt columns a tile, `smem_bytes` of
// dynamic shared memory). x, out: NHWC [B,H,W,C] / [B,H,W,O] of bf16 when
// is_bf16, else float32. Scratch from the caller: `stats` 2*B*groups floats;
// `wp` the weight stages, round_up(O,64)/64 * 9 * ceil(K/64) stages of
// 64*72 bf16 (K = round_up(C,16)) or 64*64 float32 (K = C) elements. Returns
// a CUDA error code (0 = launched); cudaErrorInvalidValue where smem_bytes is
// below the layout's need or the tiling is out of range.
int rgmf_fused_gn_silu_conv(const void* x, const float* gn_scale,
                            const float* gn_bias, const float* conv_w,
                            const float* conv_b, int B, int H, int W, int C,
                            int O, int groups, float eps, int is_bf16, int R,
                            int Wt, int smem_bytes, void* wp, float* stats,
                            void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int itemsize = is_bf16 ? 2 : 4;
  if (R < 1 || R > H || Wt < 1 || Wt > W || R * Wt > kMaxM || C % groups ||
      conv_smem(itemsize, C, W, R, Wt).total > smem_bytes)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x;
  a.stats = reinterpret_cast<const rgmf::GroupStat*>(stats);
  a.scale = gn_scale;
  a.bias = gn_bias;
  a.wp = wp;
  a.cb = conv_b;
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.O = O; a.G = groups;
  a.R = R; a.Wt = Wt;
  a.tiles_h = (H + R - 1) / R;
  a.tiles_w = (W + Wt - 1) / Wt;
  a.ntiles = B * a.tiles_h * a.tiles_w;
  a.Kpad = conv_kpad(C, itemsize);
  a.CP = conv_pitch(C, itemsize);
  a.Np = rgmf::round_up(O, kBN);
  a.bulk = (C * itemsize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_all<bf16>(a, conv_w, smem_bytes, eps, s)
                 : launch_all<float>(a, conv_w, smem_bytes, eps, s);
}

}  // extern "C"
