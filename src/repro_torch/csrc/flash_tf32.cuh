// The shared f32 flash-attention tile of K3 and K4 on Hopper tensor cores,
// by split TF32 ("3xTF32").
//
// Replaces, for f32 inputs, the same TPU kernels' inner loops as the bf16
// tile of flash_tc.cuh: repro/kernels/flex_attention/flex_attention.py::
// _flex_kernel (K4, csrc/flex_prefill.cu) and repro/kernels/
// paged_attention/paged_attention.py::_prefill_kernel (K3,
// csrc/paged_prefill.cu), and it keeps their f32 contract, |a - b| <=
// 2e-5 (1 + |b|) against the plain versions.  One TF32 product keeps 11
// significant bits, too few; so every operand x is split into two TF32
// words, hi = rna(x) and lo = rna(x - hi), rounded as cvt.rna.tf32.f32
// rounds (to nearest, ties away; the 13 low bits become 0, so the tensor
// core's own treatment of those bits does not matter), and each product
// is x y ~ lo(x) hi(y) + hi(x) lo(y) + hi(x) hi(y): three TF32 products,
// small terms first, lo lo dropped; the residual of an operand is below
// 2^-22 of it.  tests/test_torch_tf32x3.py models exactly this arithmetic
// on the CPU (kernels.tf32, kernels.tf32_product).  Tensor-core sums
// truncate, so each tile's q.K and p.V go into accumulators fresh per
// tile, and p.V enters o by one f32 fma with alpha: o takes one rounding
// per tile over the up to 2048 keys of K3's un-normalised partials.
//
// The CTA is ONE consumer warpgroup (128 threads) of 64 query rows; K/V
// tiles hold kBN = 64 keys (32 at D = 192 and 256) and arrive by TMA (f32
// boxes of 32 columns, 128-byte swizzle) into the flash_tc ring (ring_wait
// / ring_refill / ring_release: a full and an empty mbarrier per stage,
// thread 0 producing) of kStages = 2 (1 at D = 256).  Q is loaded once per
// CTA by plain 16-byte loads and stored as hi and lo in the swizzled
// layout.  Per tile i:
//
//   K split        the warpgroup rounds the K tile to hi in place and
//                  writes its lo into the K lo tile (layout-oblivious:
//                  float4 by float4), then fence.proxy.async and a CTA
//                  barrier.  Tile i + 1's split runs while tile i's p.V
//                  products are in flight (K lo is free then);
//   S = Q K^T      wgmma m64n64k8 .f32.tf32.tf32, Q and K from shared
//                  memory, K-major, 128-byte swizzle (32 f32 per 128-byte
//                  row: a k8 step is 32 bytes, as a bf16 k16 step);
//   softmax        online, in f32 on the accumulator fragment, with the
//                  bf16 tile's shared helpers (score_tile, softmax_max);
//   V transpose    wgmma takes .tf32 operands from shared memory only
//                  K-major (the transpose bits exist for f16/bf16 only),
//                  and V arrives MN-major (head dim innermost; TMA cannot
//                  produce V^T from (pages, P, Hkv, D), where keys are not
//                  innermost).  So the warpgroup reads the V tile into
//                  registers and writes V^T: hi in place of V, lo into
//                  the stage's K tile (free once q.K is done): no shared
//                  memory beyond the ring;
//   O += P V       wgmma m64n{D}k8 .tf32 with P hi/lo from registers as
//                  the A operand and V^T hi/lo as B (at D = 192 in two
//                  halves of m64n96, one after the other, so that the
//                  fresh accumulator takes 48 registers, not 96; at D =
//                  256 in four quarters of m64n64, 32 registers).
//
// P from registers: the f32 accumulator gives a thread keys 2t and 2t + 1
// of each group of 8 (t = lane % 4); the tf32 A fragment wants columns t
// and t + 4.  The kernel feeds key 2t as column t and key 2t + 1 as column
// t + 4, and writes V^T's k-index t + 4e from key 2t + e: the same fixed
// permutation of the 8 keys on both sides, so P.V is unchanged.
// chip_smoke checks it with distinct V rows and scores that are not
// symmetric in the keys.
//
// Rounding: hi and lo are formed with an integer add and mask (exactly
// cvt.rna's result; the conversion instruction runs at a fraction of the
// integer rate, and every K, V and P element is split once per CTA).
//
// What bounds it: 3 TF32 products for each f32 one, at 495 TFLOP/s dense,
// ~165 TFLOP/s of f32 work against 67 on the CUDA cores.  With one
// warpgroup per SM (the shared memory below), the K split, V transpose
// and softmax run between the products, not beside them, apart from the
// next tile's K split; the first tile of each CTA waits for its loads.
//
// Shared memory at D = 128: Q hi 32 KB + Q lo 32 KB + K lo 32 KB + 2
// stages x (K 32 KB + V 32 KB) = 224 KB of the 227 KB (D = 64: 112 KB), so
// one CTA (4 warps) per SM at D = 128.  At D = 192 64-key tiles would take
// 7 x 48 KB = 336 KB, so a K/V tile holds 32 keys: Q hi 48 KB + Q lo 48 KB
// + K lo 24 KB + 2 x (24 KB + 24 KB) = 216 KB (q.K m64n32).  At D = 256 Q
// hi + lo alone take 128 KB, and two stages of 32 keys would make 288 KB,
// so the ring has ONE stage: Q 128 KB + K lo 32 KB + (32 KB + 32 KB) = 224
// KB; the next tile's loads then start only once this tile is done (no
// overlap of loads with products: correct, not fast).  Every tile and
// panel sits at a multiple of 1024 bytes, the period of the 128-byte
// swizzle.
#pragma once

#include "flash_tc.cuh"

namespace flash_tf32 {

namespace ft = flash_tc;

constexpr int kThreads = 128;  // one consumer warpgroup
constexpr int kRows = 64;      // query rows per CTA
constexpr int kPanelBytes = 64 * 128;  // 64 rows x 32 f32: a Q panel

// Byte offsets in the (1024-aligned) dynamic shared memory of a CTA, with
// the members the flash_tc ring helpers read.  With I8 (int8 pools) the
// ring holds the int8 K and V as TMA lands them (kBN rows of D bytes,
// unswizzled), three stages of them, and the products read one f32
// working tile of each (kWK: K as TMA's f32 boxes would give it; kWV: V^T):
// widen_k and widen_vt write them.  An int8 value is exact in TF32 (11-bit
// significand), so K and V need no lo part and no K lo tile: q.K and p.V
// are two TF32 products each (q and P as hi + lo against the exact K and
// V), not three.  At D = 128: Q hi + lo 64 KB + 3 x (8 + 8) KB + 64 KB =
// 176 KB; at D = 192: 96 + 36 + 48 = 180 KB; at D = 256, with two int8
// stages: 128 + 32 + 64 = 224 KB.
template <int D, bool I8 = false>
struct Layout {
  static_assert(ft::head_dim_ok(D), "head dim 64, 128, 192 or 256");
  static constexpr bool kInt8 = I8;
  static constexpr int kD = D;
  static constexpr int kThreads = flash_tf32::kThreads;
  static constexpr int kBN = D <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int kStages = D <= 192 ? (I8 ? 3 : 2) : (I8 ? 2 : 1);
  static constexpr int kPanelCols = 32;  // f32 columns per 128-byte row
  static constexpr int kStagePanel = kBN * 128;
  static constexpr int kPanels = D / 32;
  static constexpr int kQTile = kPanels * kPanelBytes;  // 64 rows of D f32
  static constexpr int kWTile = kPanels * kStagePanel;  // kBN rows of D f32
  static constexpr int kTile = I8 ? kBN * D : kWTile;   // a ring stage
  // p.V in kPvParts products of D / kPvParts columns each
  static constexpr int kPvParts = D <= 128 ? 1 : D <= 192 ? 2 : 4;
  static constexpr int kQ = 0;  // Q hi
  static constexpr int kQlo = kQTile;
  static constexpr int kKlo = 2 * kQTile;  // not I8
  static constexpr int kK = I8 ? 2 * kQTile : kKlo + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kWK = kV + kStages * kTile;  // I8: the working tiles
  static constexpr int kWV = kWK + kWTile;
  static constexpr int kBar = I8 ? kWV + kWTile : kWK;  // full, then empty
  static constexpr size_t kBytes = 1024 + kBar + 16 * kStages;
};

// x as a TF32 word, rounded as cvt.rna.tf32.f32 rounds it (to nearest,
// ties away from zero; low 13 bits 0): half a TF32 ulp added to the
// magnitude bits, then the 13 low bits cleared.  Two full-rate integer
// operations instead of a conversion, for every K, V and P element.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x ~ hi + lo, two TF32 words.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// Store 16-byte chunk `ch` (4 f32) of query row `row` (from `src`, or
// zeros when null) as hi and lo into the swizzled Q tiles: chunk c of a
// row lands at chunk c ^ (row % 8) of its 128-byte panel row, as TMA's
// 128-byte swizzle places it.
template <int D>
__device__ __forceinline__ void store_q_chunk(uint8_t* gen, int row, int ch,
                                              const float* src) {
  using L = Layout<D>;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src != nullptr)
    v = __ldg(reinterpret_cast<const float4*>(src + ch * 4));
  float4 lo;
  const float4 hi = split4(v, lo);
  const int off =
      (ch / 8) * kPanelBytes + row * 128 + (((ch % 8) ^ (row & 7)) << 4);
  *reinterpret_cast<float4*>(gen + L::kQ + off) = hi;
  *reinterpret_cast<float4*>(gen + L::kQlo + off) = lo;
}

// K of stage st: hi in place, lo into the K lo tile, then visible to wgmma.
template <int D>
__device__ __forceinline__ void split_k(uint8_t* gen, int st) {
  using L = Layout<D>;
  float4* k = reinterpret_cast<float4*>(gen + L::kK + st * L::kTile);
  float4* lo = reinterpret_cast<float4*>(gen + L::kKlo);
  for (int c = threadIdx.x; c < L::kTile / 16; c += kThreads) {
    float4 l;
    k[c] = split4(k[c], l);
    lo[c] = l;
  }
  ft::fence_proxy_async();
  __syncthreads();
}

// d[64 x 64] (+)= a[64 x 8] * b[8 x 64], TF32 in, f32 out: a and b K-major
// in shared memory (128-byte swizzle); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= a[64 x 8] * b[8 x 32], TF32 in, f32 out: a and b K-major
// in shared memory (128-byte swizzle); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += a[64 x 8] * b[8 x 128], TF32 in, f32 out: a as TF32 words
// in registers (the m16n8k8 A fragment per warp), b K-major in shared
// memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 8] * b[8 x 64], as wgmma_tf32_rs_n128.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 96] += a[64 x 8] * b[8 x 96], as wgmma_tf32_rs_n128.
__device__ __forceinline__ void wgmma_tf32_rs_n96(float (&d)[48],
                                                  const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x N] += a[64 x 8] * b[8 x N]: p.V (or one part of it) over N columns.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t db) {
  wgmma_tf32_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<96>(float (&o)[48], const uint32_t* a,
                                             uint64_t db) {
  wgmma_tf32_rs_n96(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t* a, uint64_t db) {
  wgmma_tf32_rs_n128(o, a, db);
}

// S = Q K^T over a tile of N keys: m64n{N}k8.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_tf32_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<32>(float (&s)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_tf32_n32(s, da, db, scale_d);
}

// S = Q K^T for the stage's split K tile: small terms first.  On the int8
// layout K is the exact working tile: lo(q) K + hi(q) K.
template <int D, class L = Layout<D>>
__device__ __forceinline__ void qk(uint32_t base, int st,
                                   float (&s)[L::kBN / 2]) {
  constexpr int kPasses = L::kInt8 ? 2 : 3;
  const uint32_t q_hi = base + L::kQ, q_lo = base + L::kQlo;
  const uint32_t k_hi =
      L::kInt8 ? base + L::kWK : base + L::kK + st * L::kTile;
  const uint32_t k_lo = base + L::kKlo;
  ft::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const uint32_t qa = pass == 0 ? q_lo : q_hi;
    const uint32_t kb = !L::kInt8 && pass == 1 ? k_lo : k_hi;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // k8 step in its panel
      const uint32_t kp = (kk / 4) * L::kStagePanel + col;
      wgmma_qk<L::kBN>(s, ft::make_desc(qa + (kk / 4) * kPanelBytes + col,
                                        16),
                       ft::make_desc(kb + kp, 16), pass > 0 || kk > 0);
    }
  }
  ft::wgmma_commit();
  ft::wgmma_wait0();
  ft::fence_regs(s);
}

// V of stage st as V^T (K-major: D rows of the tile's kBN keys, kBN / 32
// 32-key panels of D x 128 bytes, 128-byte swizzle): hi in place of the
// stage's V tile, lo into its K tile (free once every warp is past q.K),
// keys permuted within each group of 8 (key 2t + e at k-index t + 4e, the
// A fragment's columns for P).  Warp w transposes column chunks w, w + 4,
// ...; lane l keys l and 32 + l, so a warp's reads and writes meet no
// bank twice.  The whole tile is read before any write (in place).
template <int D>
__device__ __forceinline__ void transpose_v(uint8_t* gen, int st) {
  using L = Layout<D>;
  constexpr int kChunks = D / 16;  // 4-column chunks per warp and key half
  uint8_t* v = gen + L::kV + st * L::kTile;
  uint8_t* lo = gen + L::kK + st * L::kTile;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  constexpr int kHalves = L::kBN / 32;  // 32-key panels of V^T
  float4 x[kHalves][kChunks];
#pragma unroll
  for (int kh = 0; kh < kHalves; ++kh)
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int key = 32 * kh + l, ch = w + 4 * i;  // chunk of 4 columns
      x[kh][i] = *reinterpret_cast<const float4*>(
          v + (ch / 8) * L::kStagePanel + key * 128 +
          (((ch % 8) ^ (key & 7)) << 4));
    }
  __syncthreads();  // every V read is done, and every warp's q.K
#pragma unroll
  for (int kh = 0; kh < kHalves; ++kh) {
    const int k8 = l & 7;
    const int c = (l & ~7) + (k8 >> 1) + 4 * (k8 & 1);  // k-index in panel
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float e[4] = {x[kh][i].x, x[kh][i].y, x[kh][i].z, x[kh][i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = 4 * (w + 4 * i) + q;
        const int off = kh * (D * 128) + d * 128 +
                        (((c >> 2) ^ (d & 7)) << 4) + (c & 3) * 4;
        uint32_t hi, lw;
        split(e[q], hi, lw);
        *reinterpret_cast<uint32_t*>(v + off) = hi;
        *reinterpret_cast<uint32_t*>(lo + off) = lw;
      }
    }
  }
  ft::fence_proxy_async();
  __syncthreads();
}

// V^T's byte offset of key `key`, column d (transpose_v's layout: 32-key
// panels of D rows of 128 bytes, 128-byte swizzle, keys permuted within
// each group of 8).
template <int D>
__device__ __forceinline__ int vt_offset(int key, int d) {
  const int l = key % 32, k8 = l & 7;
  const int c = (l & ~7) + (k8 >> 1) + 4 * (k8 & 1);  // k-index in panel
  return (key / 32) * (D * 128) + d * 128 + (((c >> 2) ^ (d & 7)) << 4) +
         (c & 3) * 4;
}

// Ring stage st's int8 K as f32 into the working K tile, where TMA's f32
// boxes would have put it (16 bytes of a row become four 16-byte chunks of
// its 32-column panel), then visible to wgmma.  Rows no box filled hold
// int8 bytes, finite in f32.
template <int D, class L>
__device__ __forceinline__ void widen_k(uint8_t* gen, int st) {
  constexpr int kCh = D / 16;  // 16-byte int8 chunks of a row
  const uint8_t* src = gen + L::kK + st * L::kTile;
  uint8_t* dst = gen + L::kWK;
  static_assert(L::kBN * kCh % kThreads == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < L::kBN * kCh / kThreads; ++it) {
    const int x = threadIdx.x + it * kThreads;
    const int r = x / kCh, c = x % kCh;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * D + c * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    uint8_t* row = dst + (c / 2) * L::kStagePanel + r * 128;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float f[4];
      ft::i8x4_to_f32(words[e], f);
      *reinterpret_cast<float4*>(row + (((4 * (c % 2) + e) ^ (r & 7)) << 4)) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  ft::fence_proxy_async();
  __syncthreads();
}

// Ring stage st's int8 V as f32 V^T into the working V tile, in
// transpose_v's layout (no lo: the values are exact).  The 32 lanes of a
// warp take 32 keys of one chunk pass, lane l reading its row's chunk (c +
// l) % kCh: a read meets each bank of a 16-byte group at most four times
// (the least for 512 bytes at D = 64 and 128), and each of its 16 writes,
// at one column d for 32 keys, meets every bank once.  First a CTA barrier:
// every warp's p.V of the last tile (which read the tile) is done.
template <int D, class L>
__device__ __forceinline__ void widen_vt(uint8_t* gen, int st) {
  constexpr int kCh = D / 16;
  const uint8_t* src = gen + L::kV + st * L::kTile;
  uint8_t* vt = gen + L::kWV;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < L::kBN * kCh / kThreads; ++it) {
    const int x = threadIdx.x + it * kThreads;
    const int key = x % L::kBN, c = (x / L::kBN + key) % kCh;
    const uint4 w = *reinterpret_cast<const uint4*>(src + key * D + c * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float f[4];
      ft::i8x4_to_f32(words[e], f);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float*>(vt + vt_offset<D>(key, 16 * c + 4 * e + q)) =
            f[q];
    }
  }
  ft::fence_proxy_async();
  __syncthreads();
}

// P in s (the probabilities, f32) split into TF32 A fragments (ph, pl;
// they must live until the products complete): columns t, t + 4 of key
// group j are keys 8 j + 2 t and 8 j + 2 t + 1.
template <int N>
__device__ __forceinline__ void split_p(const float (&s)[N], uint32_t (&ph)[N],
                                        uint32_t (&pl)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    split(s[4 * j + 0], ph[4 * j + 0], pl[4 * j + 0]);
    split(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
    split(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
    split(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
  }
}

// Issue pv (the accumulator fragment of o's columns [c0, c0 + N)) = P V
// over the stage's transposed V (hi in the V tile, lo in the K tile; on the
// int8 layout the exact V^T of the working tile), P as split by split_p.
// Small terms first; the caller waits.
template <int D, int N, class L = Layout<D>>
__device__ __forceinline__ void pv_issue(uint32_t base, int st, int c0,
                                         const uint32_t (&ph)[L::kBN / 2],
                                         const uint32_t (&pl)[L::kBN / 2],
                                         float (&pv)[N / 2]) {
  constexpr int kPasses = L::kInt8 ? 2 : 3;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) pv[x] = 0.f;
  const uint32_t vt_hi =
      (L::kInt8 ? base + L::kWV : base + L::kV + st * L::kTile) + c0 * 128;
  const uint32_t vt_lo = base + L::kK + st * L::kTile + c0 * 128;
  ft::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const uint32_t* a = pass == 0 ? pl : ph;
    const uint32_t b = !L::kInt8 && pass == 1 ? vt_lo : vt_hi;
#pragma unroll
    for (int kk = 0; kk < L::kBN / 8; ++kk) {
      const uint32_t off = (kk / 4) * (D * 128) + (kk % 4) * 32;
      wgmma_pv<N>(pv, a + 4 * kk, ft::make_desc(b + off, 16));
    }
  }
  ft::wgmma_commit();
}

// The flash loop over `n` K/V tiles, after ft::init_ring, ft::prefetch and
// ft::q_ready on the Layout L.  Tile provides what flash_tc's mainloop
// documents, except kPTerms (P is always hi + lo here).  Per tile: q.K,
// softmax, V transpose, p.V issued; the next tile's K split while p.V
// runs; then o, the stage's release and its refill kStages tiles ahead.
// On the int8 layout the K split is widen_k (into the working K tile, free
// once every warp's q.K is done: widen_vt's barrier) and the V transpose
// widen_vt.  With one stage the next tile lands in the stage this tile
// holds, so its K split waits for the refill after the release.
template <int D, class Tile, class L = Layout<D>>
__device__ __forceinline__ void mainloop(const Tile& t, uint8_t* gen,
                                         uint32_t base, int n,
                                         const int (&key)[2], ft::Acc<D>& a) {
  constexpr int BN = L::kBN, NP = D / L::kPvParts;
  const auto prepare_k = [&](int st) {
    if constexpr (L::kInt8)
      widen_k<D, L>(gen, st);
    else
      split_k<D>(gen, st);
  };
  ft::acc_init(a);
  if (n > 0) prepare_k(ft::ring_acquire<L>(t, base, 0, n));
  for (int i = 0; i < n; ++i) {
    const int st = i % L::kStages;
    float s[BN / 2];
    qk<D, L>(base, st, s);
    ft::score_tile<BN>(t, i, key, s);
    float alpha[2], m_log2[2];
    ft::softmax_max<BN>(s, t.exp_scale, a, alpha, m_log2);
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) {
      const int h = (x >> 1) & 1;
      s[x] = ft::exp2_approx(fmaf(s[x], t.exp_scale, -m_log2[h]));
      a.l[h] += s[x];
    }

    if constexpr (L::kInt8)
      widen_vt<D, L>(gen, st);
    else
      transpose_v<D>(gen, st);
    uint32_t ph[BN / 2], pl[BN / 2];
    split_p(s, ph, pl);
#pragma unroll
    for (int part = 0; part < L::kPvParts; ++part) {
      float pv[NP / 2];
      pv_issue<D, NP, L>(base, st, part * NP, ph, pl, pv);
      // tile i + 1's K split overlaps tile i's p.V products: K lo (the
      // working K tile on the int8 layout) is free
      if (L::kStages > 1 && part == 0 && i + 1 < n)
        prepare_k(ft::ring_wait<L>(base, i + 1));
      ft::wgmma_wait0();
      ft::fence_regs(pv);
#pragma unroll
      for (int x = 0; x < NP / 2; ++x)
        a.o[part * NP / 2 + x] =
            fmaf(a.o[part * NP / 2 + x], alpha[(x >> 1) & 1], pv[x]);
    }
    ft::ring_release<L>(base, st);
    ft::ring_refill<L>(t, base, i + L::kStages, n);
    if (L::kStages == 1 && i + 1 < n) prepare_k(ft::ring_wait<L>(base, i + 1));
  }
  ft::acc_finish(a, t.m_scale);
}

// The tile's f32 boxes: 32 columns, the 128-byte swizzle.
inline int encode_f32_sw128(CUtensorMap* map, const void* ptr, uint64_t cols,
                            uint64_t rows, uint64_t row_bytes,
                            uint32_t box_rows) {
  return ft::encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cols, rows,
                       row_bytes, 32, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace flash_tf32
