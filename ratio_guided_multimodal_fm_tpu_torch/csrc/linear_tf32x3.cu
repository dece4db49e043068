// A float32 matrix product as 3xTF32 on Hopper's tensor cores (sm_90a):
//
//   out[r][c] = bias[c] + sum_k A(r, k) * B(c, k)       (float32 in and out)
//
// each float32 operand v split into a TF32 high part and a low part,
// hi = rna_tf32(v), lo = rna_tf32(v - hi), and the product taken as three
// TF32 products with float32 accumulation, lo*hi + hi*lo + hi*hi (the small
// ones first, as CUTLASS's OpMultiplyAddFastF32 orders them; lo*lo is below
// float32's rounding). That keeps float32's accuracy: no product here is
// TF32 alone.
//
// Replaces: no TPU kernel. The JAX package leaves its dense layers to XLA;
// the port's SiT token projections (models/sit.py: attn.qkv, attn.proj,
// mlp.fc1, mlp.fc2) ran on cuBLAS's and CUTLASS's SIMT float32 GEMMs, which
// sit near the 67 TFLOP/s FFMA peak. One kernel serves the three roles of a
// linear layer (ops/linear.py plans them):
//   forward  out = x W^T + b   A = x [M][K],   B = W [N][K]
//   dgrad    dx  = dy W        A = dy [M][N],  B = W^T (split pre-pass)
//   wgrad    dW  = dy^T x      A read transposed from an [M][*] tile, B the
//                              narrower of dy and x, transposed by the
//                              pre-pass; the product lands as dW or dW^T
//
// Bound on the card: operations. At SiT-XL/2's shapes (M = 8,192 tokens,
// widths 1,152-4,608) a call is 22-87 GFLOP; three TF32 products run at
// most at 495 / 3 = 165 TFLOP/s (989 / 6, the bf16 peak over six).
//
// Design:
//   * TF32 wgmma takes K-major operands only (no transpose bit for 32-bit
//     types). B is read by wgmma from shared memory, so it has to be K-major
//     there, in a high and a low plane: `split_kernel` writes the planes
//     [2][C][ldb] of B once a call (transposing where the role needs it:
//     W^T for dgrad, x^T or dy^T for wgrad). The planes are scratch of the
//     call (ops/linear.py allocates them; never saved for the backward):
//     at most 2 x 8,192 x 1,152 floats (75 MB) at SiT-XL/2's shapes.
//   * A comes from registers (wgmma's RS form). Each consumer thread loads
//     its fragment of the staged float32 tile with plain shared-memory loads
//     and splits it in registers (cvt.rna.tf32.f32, one subtraction), so A
//     needs no pre-pass and is read once. A K-major tile (forward, dgrad) is
//     one TMA box; a transposed one (wgrad: A(r, k) = src[k][r]) is four
//     boxes of 32 x 32, and the fragment's addresses swap r and k. Both
//     read conflict-free (transposed: 2-way) under the 128-byte swizzle.
//   * TMA loads a ring of four stages (A tile, B hi tile, B lo tile; 32
//     floats deep, one 128-byte swizzle row; 48 KiB) on mbarriers; one
//     producer thread keeps the ring full; two consumer warpgroups each take
//     64 rows of the 128 x 128 tile. The ragged edge is TMA's zero fill
//     (rows beyond R, k beyond K) and masked stores (columns beyond C).
//     256-row tiles (two m64 blocks a consumer) measured no faster at these
//     shapes and cannot hold the promotion's second accumulator.
//   * Accumulation: the tensor core rounds each wgmma's sum toward zero, so
//     with one accumulator the bias grows with the number of wgmmas (three a
//     k8 slice): 5-47x cuBLAS's float32 error at K = 1,152-8,192 on the card.
//     So each stage's 12 wgmmas sum into a fresh partial tile, which ordinary
//     round-to-nearest adds bring into the float32 total, as DeepGEMM
//     promotes its FP8 sums: 0.2-0.7x cuBLAS's error, for ~10% of the time.
//     Within a stage the eight small products (lo*hi, hi*lo) go first, so
//     they truncate at their own scale, 2^-11 of the large ones, and the
//     partial's own magnitude takes four truncations (hi*hi), not twelve.
//   * Fixed order everywhere, no split-K, no atomics: two calls give the
//     same bits (a CUDA graph replay equals the eager call).

#include <cuda.h>   // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "c_api.cuh"
#include "hopper.cuh"

namespace {

using rgmf::smem_u32;

constexpr int kBN = 128;          // columns of a CTA tile: one wgmma's N
constexpr int kBK = 32;           // depth of a stage: 128 bytes, one swizzle row
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBTileBytes = kBN * kBK * 4;   // one plane's tile, 16 KiB

constexpr int kBM = 64 * kConsumers;         // rows of a CTA tile
constexpr int kATileBytes = kBM * kBK * 4;
constexpr int kStageBytes = kATileBytes + 2 * kBTileBytes;   // 48 KiB
constexpr int kStages = 4;                                   // 192 KiB
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

struct GemmArgs {
  float* out;
  const float* bias;   // [C] or null
  int R, C, K;
  int ldo;
  int out_trans;       // out[c][r] instead of out[r][c]
};

// ---- primitives --------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// wgmma's shared-memory descriptor of a K-major tile of 128-byte rows under
// the 128-byte swizzle (8-row atoms 1,024 bytes apart).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (+)= A B for a 64 x 128 tile, k = 8: A from registers (this thread's
// four TF32 values), B from shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps registers that an asynchronous wgmma reads or writes in place until
// the wait that follows: the compiler sees them used here.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A lost
// arrival would hang the card: after about 2**34 cycles (~9 s) it traps, and
// the launch's stream reports the fault.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Byte offset of A(r, k) in a stage's A tile (r the tile's row, k < 32).
// K-major: one box of kBM rows of 128 bytes. Transposed: boxes of 32 k-rows
// of 32 r (128 bytes), one a 32 rows of the tile. 128-byte swizzle: the
// 16-byte chunk c of row y of a 1,024-byte-aligned box sits at c ^ (y & 7).
template <bool kTransA>
__device__ __forceinline__ uint32_t a_offset(int r, int k) {
  if (kTransA)
    return (r >> 5) * 4096 + k * 128 + ((((r & 31) >> 2) ^ (k & 7)) << 4) +
           (r & 3) * 4;
  return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4;
}

// ---- the product ---------------------------------------------------------------

// grid (ceil(C / 128), ceil(R / 128)), kThreads threads: warpgroup 0 the
// producer (one thread issues every TMA load), warpgroups 1 and 2 the
// consumers, each 64 rows of the tile by its 128 columns.
template <bool kTransA>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int KT = (g.K + kBK - 1) / kBK;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rgmf::mbar_init(&full[s], 1);
      rgmf::mbar_init(&empty[s], kConsumers * 128);
    }
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) wait_phase(&empty[s], ((kt / kStages) + 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        rgmf::mbar_expect_tx(&full[s], kStageBytes);
        const int k0 = kt * kBK;
        if (kTransA) {
#pragma unroll
          for (int j = 0; j < kBM / 32; ++j)
            tma_load_2d(st + j * 4096, &tm_a, r0 + 32 * j, k0, &full[s]);
        } else {
          tma_load_2d(st, &tm_a, k0, r0, &full[s]);
        }
        tma_load_2d(st + kATileBytes, &tm_b, k0, c0, &full[s]);
        tma_load_2d(st + kATileBytes + kBTileBytes, &tm_b, k0, g.C + c0,
                    &full[s]);
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int row = (wg - 1) * 64 + warp * 16 + (lane >> 2);   // and row + 8
  const int t4 = lane & 3;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    wait_phase(&full[s], (kt / kStages) & 1);
    const unsigned char* st = smem + s * kStageBytes;
    const uint32_t b_hi = smem_u32(st + kATileBytes);
    const uint32_t b_lo = b_hi + kBTileBytes;
    // this thread's A fragments of the stage's four k8 slices, split
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kk * 8 + t4;
      const float v[4] = {
          *reinterpret_cast<const float*>(st + a_offset<kTransA>(row, k)),
          *reinterpret_cast<const float*>(st + a_offset<kTransA>(row + 8, k)),
          *reinterpret_cast<const float*>(st + a_offset<kTransA>(row, k + 4)),
          *reinterpret_cast<const float*>(
              st + a_offset<kTransA>(row + 8, k + 4))};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[kk][i], lo[kk][i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {           // the small products
      wgmma_tf32(part, lo[kk], desc_sw128(b_hi + kk * 32), kk > 0);
      wgmma_tf32(part, hi[kk], desc_sw128(b_lo + kk * 32), 1);
    }                                          // (the first overwrites)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)             // then the large ones
      wgmma_tf32(part, hi[kk], desc_sw128(b_hi + kk * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    hold(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(hi[kk]);
      hold(lo[kk]);
    }
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  // ---- epilogue: bias, masked stores ----
  // acc[4j + 2h + e] holds (row + 8h, column 8j + 2*t4 + e) of the tile.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + 8 * j + 2 * t4;
    if (c >= g.C) continue;          // C is even: c + 1 < C as well
    const float b0 = g.bias ? g.bias[c] : 0.f;
    const float b1 = g.bias ? g.bias[c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + row + 8 * h;
      if (r >= g.R) continue;
      const float v0 = __fadd_rn(acc[4 * j + 2 * h], b0);
      const float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
      if (g.out_trans) {
        g.out[(size_t)c * g.ldo + r] = v0;
        g.out[(size_t)(c + 1) * g.ldo + r] = v1;
      } else {
        *reinterpret_cast<float2*>(g.out + (size_t)r * g.ldo + c) =
            make_float2(v0, v1);
      }
    }
  }
}

// ---- the split pre-pass ----------------------------------------------------------

// src [rows][cols] float32 -> the planes hi = dst, lo = dst + plane, each
// [rows][ldd] (trans = 0) or [cols][ldd] (trans = 1, through a 32 x 33
// shared tile). grid (ceil(rows / 32), ceil(cols / 32)), 256 threads.
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 int rows, int cols, int ldd, long long plane, int trans) {
  __shared__ float tile[32][33];
  const int rt = blockIdx.x * 32, ct = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  uint32_t hi, lo;
  if (!trans) {
    for (int i = ty; i < 32; i += 8) {
      const int r = rt + i, c = ct + tx;
      if (r < rows && c < cols) {
        split_tf32(src[(size_t)r * cols + c], hi, lo);
        dst[(size_t)r * ldd + c] = __uint_as_float(hi);
        dst[plane + (size_t)r * ldd + c] = __uint_as_float(lo);
      }
    }
    return;
  }
  for (int i = ty; i < 32; i += 8) {
    const int r = rt + i, c = ct + tx;
    tile[i][tx] = (r < rows && c < cols) ? src[(size_t)r * cols + c] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = ct + i, r = rt + tx;
    if (c < cols && r < rows) {
      split_tf32(tile[tx][i], hi, lo);
      dst[(size_t)c * ldd + r] = __uint_as_float(hi);
      dst[plane + (size_t)c * ldd + r] = __uint_as_float(lo);
    }
  }
}

// ---- host side ---------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D float32 tensor map: `inner` x `outer` elements, rows `ld` floats
// apart, boxes of 32 x box_outer, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const float* base, long long inner,
              long long outer, long long ld, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTransA>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const GemmArgs& g, cudaStream_t s) {
  auto kern = gemm_tf32x3_kernel<kTransA>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((g.C + kBN - 1) / kBN, (g.R + kBM - 1) / kBM);
  kern<<<grid, kThreads, kSmemBytes, s>>>(ma, mb, g);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// The split pre-pass on `stream`: src float32 [rows][cols] (contiguous) into
// dst float32 [2][rows][ldd] (trans = 0) or [2][cols][ldd] (trans = 1), the
// TF32 high plane first. Returns a CUDA error code (0 = launched).
int rgmf_linear_split(const float* src, float* dst, int rows, int cols,
                      int ldd, int trans, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || cols < 1 || ldd < (trans ? rows : cols))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)(trans ? cols : rows) * ldd;
  const dim3 grid((rows + 31) / 32, (cols + 31) / 32);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, rows, cols, ldd, plane, trans);
  return (int)cudaGetLastError();
}

// The product on `stream`: out (+ bias) = A B^T over K, R x C outputs.
//   a: a_trans = 0: A [R][K] (rows K floats apart); 1: A(r, k) = a[k][r]
//      ([K][R], rows R floats apart).
//   b: the split planes [2][C][ldb] (high, then low), B(c, k) = b[c][k].
//   out: [R][ldo] (out_trans = 0) or out[c][r], [C][ldo] (out_trans = 1).
//   bias: [C] or null.
// Requires R, C, K >= 1, C even, ldb >= K and a multiple of 4, K (a_trans
// 0) or R (a_trans 1) a multiple of 4, a and b 16-byte aligned, out 8-byte
// aligned. Returns a CUDA error code (0 = launched).
int rgmf_linear_gemm(const float* a, const float* b, const float* bias,
                     float* out, int R, int C, int K, int ldb, int ldo,
                     int a_trans, int out_trans, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || C < 1 || K < 1 || C % 2 || ldb < K || ldb % 4 ||
      (a_trans ? R % 4 : K % 4) ||
      ldo < (out_trans ? R : C) || (R + kBM - 1) / kBM > 65535 ||
      !aligned(a, 16) || !aligned(b, 16) ||
      !aligned(out, 8) || (!out_trans && ldo % 2))
    return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb;
  const bool ok =
      (a_trans ? make_map(&ma, a, R, K, R, 32) : make_map(&ma, a, K, R, K, kBM))
      && make_map(&mb, b, K, 2LL * C, ldb, kBN);
  if (!ok) return (int)cudaErrorInvalidValue;
  const GemmArgs g{out, bias, R, C, K, ldo, out_trans};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a_trans ? launch<true>(ma, mb, g, s)
                       : launch<false>(ma, mb, g, s));
}

}  // extern "C"
