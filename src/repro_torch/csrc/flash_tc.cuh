// The shared bf16 flash-attention tile of K3 and K4 on Hopper tensor cores.
//
// Replaces the TPU kernels' inner loops: repro/kernels/flex_attention/
// flex_attention.py::_flex_kernel (K4, csrc/flex_prefill.cu) and
// repro/kernels/paged_attention/paged_attention.py::_prefill_kernel (K3,
// csrc/paged_prefill.cu) for bf16 inputs.  A CTA of two consumer warpgroups
// (256 threads) holds up to 128 query rows, 64 per warpgroup, and walks a
// list of K/V tiles of kBN keys (128, or 64 at D = 192 and 256) that its
// kernel defines:
//
//   S = Q K^T      wgmma m64n{kBN}k16, bf16 in, f32 out, Q and K from shared
//                  memory (K-major, 128-byte swizzle);
//   softmax        online, in f32 on the accumulator fragment: each thread
//                  holds two rows, reduced over the quad of lanes sharing
//                  them; the running sum is rescaled by alpha;
//   O += P V       P rounded to bf16 and fed from registers as the A
//                  operand (the accumulator fragment is already A's
//                  layout), V from shared memory as the transposed
//                  (MN-major) B operand, wgmma m64n{D}k16 (two m64n128k16
//                  halves at D = 256).  K4 normalises
//                  its output, so one bf16 term of P is enough; K3 emits
//                  un-normalised partials summed over up to thousands of
//                  keys, where one term's 2^-9 rounding exceeds the bf16
//                  tolerance, so it feeds P as hi + lo (two products).
//
// K/V tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle, boxes of
// 64 columns) into a ring of kStages = 3 stages (2 at D = 256) with a "full"
// and an "empty" mbarrier each: thread 0 keeps the next kStages - 1 tiles in
// flight while tile i computes, refilling a stage once all eight warps
// have released it.  The warpgroups never wait for each other at a CTA
// barrier, so one's softmax can overlap the other's products.  Q is loaded once, while the first
// tiles are in flight, by plain 16-byte loads stored in the same swizzled
// layout (the kernels' rows are gathered: GQA rows of K3, ragged tiles of
// K4).  The softmax scale is folded into the exponent.  Masks apply in
// registers, and only on tiles whose live columns do not span kBN for one
// of the thread's rows, or that the kernel marks elementwise: the masks of
// K3 and the engine's masks of K4 are per-row column ranges [lo, hi); K4's
// other masks add element predicates (score_tile).
//
// What bounds it: at the main paths' shapes (prompts of 1536, chunks of
// 512 over ~1300 cached keys) q.K and p.V are bound by operations (about
// 4 D flops per key and row against 4 D bytes per key), so the products
// run on the tensor cores, which are the only way to the card's bf16 rate;
// the loads in flight keep them fed.  Inside a warpgroup the softmax is
// not overlapped with the products yet (no FA3-style ping-pong schedule).
//
// Shared memory at D = 128: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) =
// 224 KB of the 227 KB (D = 64: 112 KB), above the 48 KB default, hence
// cudaFuncAttributeMaxDynamicSharedMemorySize.  At D = 192 the same ring of
// 128-key stages would take 336 KB, so a stage holds 64 keys: Q 48 KB + 3 x
// (24 KB + 24 KB) = 192 KB; q.K is then m64n64 and p.V m64n192, and o
// holds 96 registers per thread.  At D = 256 three 64-key stages beside Q
// (64 KB) would take 256 KB, so the ring has two: Q 64 KB + 2 x (32 KB + 32
// KB) = 192 KB; p.V is two m64n128 products and o holds 128 registers per
// thread.  Every tile is placed at a multiple of 1024 bytes, the period of
// the 128-byte swizzle.
#pragma once

#include <cuda.h>  // CUtensorMap and the tensor-map encoder's types

#include "common.cuh"

namespace flash_tc {

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kRows = 128;     // query rows per CTA, 64 per warpgroup
constexpr int kPanelBytes = kRows * 128;  // 128 rows x 64 bf16: a Q panel
constexpr float kLog2e = 1.4426950408889634f;

// The head dims both tiles take (paged_attention.py: HEAD_DIMS).
constexpr bool head_dim_ok(int D) {
  return D == 64 || D == 128 || D == 192 || D == 256;
}

// Byte offsets in the (1024-aligned) dynamic shared memory of a CTA.  The
// ring helpers below take any layout with the same members (flash_tf32.cuh
// defines the f32 one): kThreads consumer threads, kBN keys per tile,
// kStages stages of kTile bytes at kK (K) and kV (V), each holding
// kPanels panels of kPanelCols columns, kStagePanel bytes apart, and the
// barriers at kBar.  Q (kQTile bytes at kQ) has panels of kPanelBytes.
//
// With I8 (int8 pools) the ring's stages hold the int8 K and V as TMA
// lands them, unswizzled (kTile = kBN rows of D bytes), and one bf16
// working stage (kWK, kWV: the layout TMA's bf16 boxes would give) takes
// the tile the products read: widen_stage writes it from the ring.  An
// int8 value is exact in bf16 (8-bit significand), so the working stage
// holds the integers themselves; the kernel folds kv_scale into the score
// scale and into acc at the store.  At D = 128: Q 32 KB + 3 x (16 + 16)
// KB + 64 KB = 192 KB; at D = 192 (64-key stages): 48 + 72 + 48 = 168 KB;
// at D = 256: 64 + 96 + 64 = 224 KB, so the int8 ring keeps three stages
// where the bf16 ring has two.  The ring of three bf16 stages does not fit
// beside the int8 ring, so the working stage is single.
template <int D, bool I8 = false>
struct Layout {
  static_assert(head_dim_ok(D), "head dim 64, 128, 192 or 256");
  static constexpr bool kInt8 = I8;
  static constexpr int kD = D;
  static constexpr int kThreads = flash_tc::kThreads;
  static constexpr int kBN = D <= 128 ? 128 : 64;  // keys per K/V stage
  static constexpr int kStages = D <= 192 || I8 ? 3 : 2;
  static constexpr int kPanelCols = 64;  // bf16 columns per 128-byte row
  static constexpr int kStagePanel = kBN * 128;
  static constexpr int kPanels = D / 64;
  static constexpr int kQTile = kPanels * kPanelBytes;  // Q
  static constexpr int kWTile = kPanels * kStagePanel;  // a bf16 K/V stage
  static constexpr int kTile = I8 ? kBN * D : kWTile;   // a ring stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kWK = kV + kStages * kTile;  // I8: the working stage
  static constexpr int kWV = kWK + kWTile;
  static constexpr int kBar = I8 ? kWV + kWTile : kWK;  // full, then empty
  // dynamic shared memory to request: 1024 bytes of alignment slack
  static constexpr size_t kBytes = 1024 + kBar + 16 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA -------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with parity `parity` has completed.  A
// load that never lands (a bad tensor map) traps after ~2^26 polls, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// One 2-D box of a tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Generic-proxy shared-memory writes become visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// -- int8 pools ----------------------------------------------------------------
// The 4 int8 of a word as exact f32: byte b becomes the f32 2^23 + (b ^
// 0x80) by a byte permute, less 2^23 + 128 (no int-to-float conversion,
// which runs at a quarter of the rate).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
}

// The 4 int8 of a word as two bf16 pairs (low bytes first): the f32 of a
// value of 8 bits has 16 zero low bits, so its high half is the exact bf16.
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  float f[4];
  i8x4_to_f32(w, f);
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// Ring stage st's int8 K and V (kBN rows of D bytes) as bf16 into the
// working stage, where TMA's bf16 boxes would have put them: 16 bytes of a
// row become two 16-byte chunks c ^ (row % 8) of its 64-column panel.  A
// warp's reads are one contiguous run; its writes meet each bank four
// times for 512 bytes, the least a 16-byte store can.  Rows no box filled
// hold int8 bytes, finite as bf16 (P is 0 there).  The caller fences and
// synchronises.
template <class L>
__device__ __forceinline__ void widen_stage(uint32_t base, int st) {
  constexpr int kCh = L::kD / 16;  // 16-byte int8 chunks of a row
  constexpr int kItems = L::kBN * kCh;
  static_assert(2 * kItems % L::kThreads == 0, "whole passes");
#pragma unroll 2
  for (int it = 0; it < 2 * kItems / L::kThreads; ++it) {
    const int x = threadIdx.x + it * L::kThreads;
    const int kv = x >= kItems;
    const int y = x - kv * kItems, r = y / kCh, c = y % kCh;
    const uint4 w = lds128(base + (kv ? L::kV : L::kK) + st * L::kTile +
                           r * L::kD + c * 16);
    const uint2 a = i8x4_to_bf16(w.x), b = i8x4_to_bf16(w.y);
    const uint2 e = i8x4_to_bf16(w.z), f = i8x4_to_bf16(w.w);
    const uint32_t row = base + (kv ? L::kWV : L::kWK) +
                         (c / 4) * L::kStagePanel + r * 128;
    const int cw = 2 * (c % 4);
    sts128(row + ((cw ^ (r & 7)) << 4), make_uint4(a.x, a.y, b.x, b.y));
    sts128(row + (((cw + 1) ^ (r & 7)) << 4), make_uint4(e.x, e.y, f.x, f.y));
  }
}

// -- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands (Q,
// K): 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
// MN-major V: 8-key groups 1024 bytes apart (SBO), 64-column panels `lbo`
// bytes apart (LBO).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  const uint64_t enc_addr = (addr & 0x3FFFF) >> 4;
  const uint64_t enc_lbo = (lbo & 0x3FFFF) >> 4;
  const uint64_t enc_sbo = 1024 >> 4;
  return enc_addr | (enc_lbo << 16) | (enc_sbo << 32) | (1ull << 62);
}

// 2^x by the special-function unit; flushes denormals, so 2^(-huge) = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading accumulators before wgmma_wait0.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= a[64 x 16] * b[16 x 128]: a and b K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= a[64 x 16] * b[16 x 64]: a and b K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] += a[64 x 16] * b[16 x 128]: a as bf16 pairs in registers, b
// MN-major in shared memory (128-byte swizzle, transposed operand).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
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

// d[64 x 64] += a[64 x 16] * b[16 x 64]: a as bf16 pairs in registers, b
// MN-major in shared memory (128-byte swizzle, transposed operand).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 192] += a[64 x 16] * b[16 x 192]: a as bf16 pairs in registers, b
// MN-major in shared memory (128-byte swizzle, transposed operand).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, "
      "p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<192>(float (&o)[96],
                                              const uint32_t* a, uint64_t db) {
  wgmma_rs_n192(o, a, db);
}
// D = 256: columns 0..127 and 128..255 as two m64n128 products, the second
// on V's panels 2 and 3 (two LBOs on from the first: the descriptor's
// address field counts 16-byte units, and its LBO sits at bit 16).
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t* a, uint64_t db) {
  const uint64_t two_panels = 2 * ((db >> 16) & 0x3FFF);
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o), a, db);
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 64), a, db + two_panels);
}

// S = Q K^T over a tile of N keys: m64n{N}k16.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(s, da, db, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- the CTA ---------------------------------------------------------------
// Aligns the dynamic shared memory to 1024 bytes; returns its shared address
// and sets `gen` to the same place as a generic pointer.
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw, uint8_t** gen) {
  const uint32_t a = smem_u32(raw);
  const uint32_t base = (a + 1023u) & ~1023u;
  *gen = raw + (base - a);
  return base;
}

// Store query row `row` (D bf16 at `src`, or zeros when null) into the
// swizzled Q tile: 16-byte chunk c of a row lands at chunk c ^ (row % 8)
// of its 128-byte panel row, as TMA's 128-byte swizzle places it.
template <int D>
__device__ __forceinline__ void store_q_chunk(uint8_t* q_s, int row, int ch,
                                              const __nv_bfloat16* src) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src != nullptr) v = __ldg(reinterpret_cast<const uint4*>(src + ch * 8));
  const int panel = ch / 8, cw = ch % 8;
  *reinterpret_cast<uint4*>(q_s + panel * kPanelBytes + row * 128 +
                            ((cw ^ (row & 7)) << 4)) = v;
}

// The ring's barriers: full[s] completes when stage s's boxes have landed,
// empty[s] when every consumer warp is done reading the tile in stage s.
template <class L>
__device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) {
  return base + L::kBar + 8 * s;
}
template <class L>
__device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
  return base + L::kBar + 8 * (L::kStages + s);
}

// Zero the V ring (tile rows that no box fills must not hold NaN bit
// patterns: P is 0 there, but 0 * NaN is NaN), set up the barriers, and
// make both visible to the async proxy.  The CTA's first step.
template <class L>
__device__ __forceinline__ void init_ring(uint8_t* gen, uint32_t base) {
  for (int off = threadIdx.x * 16; off < L::kStages * L::kTile;
       off += L::kThreads * 16)
    *reinterpret_cast<uint4*>(gen + L::kV + off) = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full_bar<L>(base, s), 1);  // the producer's expect_tx
      mbar_init(empty_bar<L>(base, s), L::kThreads / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
}

// Tile j's boxes into its stage of the ring (thread 0 only).
template <class L, class Tile>
__device__ __forceinline__ void issue_tile(const Tile& t, uint32_t base,
                                           int j) {
  const int s = j % L::kStages;
  t.issue(j, base + L::kK + s * L::kTile, base + L::kV + s * L::kTile,
          full_bar<L>(base, s));
}

// Thread 0 starts the loads of the first kStages - 1 tiles, before the CTA
// stores its Q tile, so that they are in flight meanwhile.
template <class L, class Tile>
__device__ __forceinline__ void prefetch(const Tile& t, uint32_t base, int n) {
  if (threadIdx.x == 0)
    for (int j = 0; j < L::kStages - 1 && j < n; ++j)
      issue_tile<L>(t, base, j);
}

// Thread 0 loads tile j (< n) into its stage once every warp has released
// the tile that stage held (j - kStages).
template <class L, class Tile>
__device__ __forceinline__ void ring_refill(const Tile& t, uint32_t base,
                                            int j, int n) {
  if (threadIdx.x == 0 && j < n) {
    if (j >= L::kStages)
      mbar_wait(empty_bar<L>(base, j % L::kStages),
                ((j / L::kStages) - 1) & 1);
    issue_tile<L>(t, base, j);
  }
}

// Every thread waits for tile i's boxes; returns its stage.
template <class L>
__device__ __forceinline__ int ring_wait(uint32_t base, int i) {
  const int st = i % L::kStages;
  mbar_wait(full_bar<L>(base, st), (i / L::kStages) & 1);
  return st;
}

// Step i of the loop over n tiles: thread 0 refills the stage that tile
// i - 1 held with tile i + kStages - 1 (keeping kStages - 1 tiles in
// flight), then every thread waits for tile i.  Returns tile i's stage.
template <class L, class Tile>
__device__ __forceinline__ int ring_acquire(const Tile& t, uint32_t base,
                                            int i, int n) {
  ring_refill<L>(t, base, i + L::kStages - 1, n);
  return ring_wait<L>(base, i);
}

// The warp is done reading stage st.
template <class L>
__device__ __forceinline__ void ring_release(uint32_t base, int st) {
  if (threadIdx.x % 32 == 0) mbar_arrive(empty_bar<L>(base, st));
}

// The Q tile's plain stores become visible to wgmma.
__device__ __forceinline__ void q_ready() {
  fence_proxy_async();
  __syncthreads();
}

// Per-thread results of the main loop: the thread's two rows are
// row(0) = 64 * warpgroup + 16 * warp + lane / 4 and row(1) = row(0) + 8;
// o[4 j + 2 h + e] is row h, column 8 j + 2 (lane % 4) + e.
template <int D>
struct Acc {
  float o[D / 2];
  float m[2];  // row max (natural-log units), REPRO_NEG_INF when empty
  float l[2];  // sum of exp(s - m) over the row, reduced over the quad
};

__device__ __forceinline__ int thread_row(int h) {
  const int t = threadIdx.x;
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * h;
}

__device__ __forceinline__ int thread_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + e;
}

template <int D>
__device__ __forceinline__ void acc_init(Acc<D>& a) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) a.o[i] = 0.f;
  a.m[0] = a.m[1] = REPRO_NEG_INF;
  a.l[0] = a.l[1] = 0.f;
}

// The scores of tile i after q.K, in the accumulator fragment of a tile of
// N keys (s[4 j + 2 h + e]: row h, column thread_col(j, e)): the score
// transform (K3's softcap; K4's softcap and ALiBi steps), then the masks:
// per-row column limits [lo, hi), and, on the tiles the kernel marks
// elementwise, its element predicate for the columns inside them.  Rows
// whose limits span the tile and tiles without the predicate take no
// per-element work.
template <int N, class Tile>
__device__ __forceinline__ void score_tile(const Tile& t, int i,
                                           const int (&key)[2],
                                           float (&s)[N / 2]) {
  const int k0 = t.origin(i);
#pragma unroll
  for (int st = 0; st < Tile::kSteps; ++st) {
    if (st >= t.steps()) break;
    t.template apply_step<N>(st, k0, key, s);
  }
  int lo[2], hi[2];
  t.bounds(i, key[0], lo[0], hi[0]);
  t.bounds(i, key[1], lo[1], hi[1]);
  const bool elem = t.elementwise(i);
  if (elem || lo[0] > 0 || lo[1] > 0 || hi[0] < N || hi[1] < N) {
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = thread_col(jj, e & 1);
        if (c < lo[h] || c >= hi[h] || (elem && !t.live(key[h], k0 + c)))
          s[4 * jj + e] = REPRO_NEG_INF;
      }
  }
}

// The online softmax's running max over the tile's scores (reduced over
// the quad of lanes sharing a row): updates m, rescales l by alpha, and
// gives alpha (for o) and the max in log2 units of exp (0 for a row with
// nothing live yet: masked scores, NEG_INF, must give 0).
template <int N, int D>
__device__ __forceinline__ void softmax_max(const float (&s)[N / 2],
                                            float exp_scale, Acc<D>& a,
                                            float (&alpha)[2],
                                            float (&m_log2)[2]) {
  float mx[2] = {a.m[0], a.m[1]};
#pragma unroll
  for (int x = 0; x < N / 2; ++x)
    mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2_approx((a.m[h] - mx[h]) * exp_scale);
    a.m[h] = mx[h];
    a.l[h] *= alpha[h];
    m_log2[h] = (mx[h] == REPRO_NEG_INF ? 0.f : mx[h]) * exp_scale;
  }
}

// After the last tile: l summed over the quad, m in natural units.
template <int D>
__device__ __forceinline__ void acc_finish(Acc<D>& a, float m_scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a.l[h] += __shfl_xor_sync(0xffffffffu, a.l[h], 1);
    a.l[h] += __shfl_xor_sync(0xffffffffu, a.l[h], 2);
    if (a.m[h] != REPRO_NEG_INF) a.m[h] *= m_scale;
  }
}

// The flash loop over `n` K/V tiles, after init_ring, prefetch and
// q_ready.  Tile provides
//   void issue(int i, uint32_t k_dst, uint32_t v_dst, uint32_t bar) const
//       thread 0 only: expect_tx on `bar` and the TMA boxes of tile i
//       (i increasing from 0);
//   void bounds(int i, int key, int& lo, int& hi) const
//       live columns of tile i for a row whose row_key is `key`: [lo, hi);
//   bool elementwise(int i) const, bool live(int key, int k) const
//       when elementwise(i), a column c inside the bounds is live only if
//       live(key, origin(i) + c) (K4's element predicates);
//   int origin(int i) const
//       the key index of tile i's column 0 (for score and live);
//   static constexpr int kSteps, int steps() const,
//   void apply_step<N>(int st, int k0, const int (&key)[2],
//                      float (&s)[N / 2]) const
//       the score transform as steps() <= kSteps passes over the tile's
//       fragment (0: scores are q.k itself), step st given the tile's
//       origin k0 and the rows' keys (thread_col gives a column);
//   float exp_scale, m_scale
//       score units -> log2 units of exp, and -> the natural units of m;
//   static constexpr int kPTerms
//       1: P enters p.V as one bf16 value; 2: as hi + lo, two bf16 values
//       (about 16 bits), at one more p.V product per tile, for partials
//       that stay un-normalised over thousands of keys;
// and `key[h]` is the tile-independent row_key of the thread's rows.  The
// warpgroups run unsynchronised, so one's softmax can overlap the other's
// products.  On the int8 layout (L::kInt8) every tile is first widened into
// the working stage by the whole CTA, between two CTA barriers (the stage
// is single, so the warpgroups run in step), and its ring stage is
// released at once.
template <int D, class Tile, class L = Layout<D>>
__device__ __forceinline__ void mainloop(const Tile& t, uint32_t base, int n,
                                         const int (&key)[2], Acc<D>& a) {
  constexpr int BN = L::kBN;
  const int wg = threadIdx.x / 128;
  acc_init(a);
  const uint32_t q_s = base + L::kQ + wg * 64 * 128;

  for (int i = 0; i < n; ++i) {
    const int st = ring_acquire<L>(t, base, i, n);
    uint32_t k_s = base + L::kK + st * L::kTile;
    uint32_t v_s = base + L::kV + st * L::kTile;
    if constexpr (L::kInt8) {
      if (i > 0) __syncthreads();  // every warp's products of tile i - 1
      widen_stage<L>(base, st);
      fence_proxy_async();
      __syncthreads();
      ring_release<L>(base, st);
      k_s = base + L::kWK;
      v_s = base + L::kWV;
    }

    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // k16 step in its panel
      wgmma_qk<BN>(s, make_desc(q_s + (kk / 4) * kPanelBytes + col, 16),
                   make_desc(k_s + (kk / 4) * L::kStagePanel + col, 16),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    score_tile<BN>(t, i, key, s);
    float alpha[2], m_log2[2];
    softmax_max<BN>(s, t.exp_scale, a, alpha, m_log2);
    uint32_t p_hi[BN / 4], p_lo[Tile::kPTerms == 2 ? BN / 4 : 1];
#pragma unroll
    for (int x = 0; x < BN / 2; x += 2) {
      const int h = (x >> 1) & 1;
      const float p0 = exp2_approx(fmaf(s[x], t.exp_scale, -m_log2[h]));
      const float p1 = exp2_approx(fmaf(s[x + 1], t.exp_scale, -m_log2[h]));
      a.l[h] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      p_hi[x / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      if constexpr (Tile::kPTerms == 2) {
        const float2 back = __bfloat1622float2(hi);
        p_lo[x / 2] = pack_bf16(p0 - back.x, p1 - back.y);
      }
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) a.o[x] *= alpha[(x >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = make_desc(v_s + kk * 16 * 128, L::kStagePanel);
      wgmma_pv<D>(a.o, p_hi + 4 * kk, dv);
      if constexpr (Tile::kPTerms == 2) wgmma_pv<D>(a.o, p_lo + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(a.o);
    if constexpr (!L::kInt8) ring_release<L>(base, st);
  }
  acc_finish(a, t.m_scale);
}

// -- host: tensor maps -------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: reached through the
// runtime's entry-point query, so the library needs no -lcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrNoEncoder = 900;  // error codes of the C entry points
constexpr int kErrEncode = 901;

// A matrix of `rows` rows of `cols` elements of `type`, `row_bytes` apart,
// read in boxes of (box_rows, box_cols) with `swizzle` (the tensor-core tile:
// bf16, 64 columns, the 128-byte swizzle; K1 and the tiles' int8 rings:
// whole unswizzled head rows).  Out-of-range rows of a box read as zeros.  Returns 0
// or an error code.
inline int encode_2d(CUtensorMap* map, const void* ptr,
                     CUtensorMapDataType type, uint64_t cols, uint64_t rows,
                     uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The tile's bf16 boxes: 64 columns, the 128-byte swizzle.
inline int encode_bf16_sw128(CUtensorMap* map, const void* ptr, uint64_t cols,
                             uint64_t rows, uint64_t row_bytes,
                             uint32_t box_rows) {
  return encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, rows,
                   row_bytes, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The int8 rings' boxes: whole head rows of D bytes, unswizzled (the bytes
// as they are; widen_stage reads them).
inline int encode_i8_rows(CUtensorMap* map, const void* ptr, uint64_t cols,
                          uint64_t rows, uint32_t D, uint32_t box_rows) {
  return encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, cols, rows, cols,
                   D, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace flash_tc
