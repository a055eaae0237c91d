// K1: split-K paged decode attention for Hopper (sm_90a), and the decode op
// (K1, then K2) from one host call.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _decode_kernel (launcher paged_attention_partials).  One CTA per (split,
// kv_head, batch) slot walks the KV tokens of its split through the block
// table, clamped exactly as _blocked_tables clamps it (dense rows: the rank
// never passes the last live page; every id is clamped into the pool), and
// emits the un-normalised online-softmax partials (m, l, acc) in f32.  An
// empty split emits (NEG_INF, 0, 0).  Masks as the TPU kernel: liveness
// pos < len, or the ring-slot window mask; softcap; int8 pools times
// kv_scale.
//
// What bounds it: decode reads every live K and V row once and does two
// flops per element read for each of the G query heads that share the kv
// head (G = 1 for llama2-7b, 6 for nemotron-4-15b), a GEMV bound by device
// memory: live K+V bytes / 3.35 TB/s.  Holding that rate takes ~25-32 KB in
// flight per SM (3.35 TB/s / 132 SMs x ~1 us of latency), so the design is
// a load pipeline:
//
// - A ring of kStages = 4 stages of 16 KB in shared memory, each holding
//   the K and V rows of one tile of kT tokens of this head (the largest
//   power of two of whole rows that fits, at most 32: 32 for bf16 at D =
//   128, 16 for f32; at D = 192 and 256, 16 for bf16 and 8 for f32).  One
//   producer thread (lane 0 of the last warp) fills it by TMA: one
//   unswizzled box of whole head rows (D columns) per page touched by the
//   tile, from the
//   pools viewed as a 2-D tensor of (num_pages * P) rows of Hkv * D
//   elements; pages of up to kT tokens go several to a tile, each at a
//   128-byte aligned stage offset (TMA's destination alignment: a page
//   whose bytes are not a multiple of 128, such as an odd int8 page at D =
//   64, leaves a gap after it), longer pages are cut into kT-row tiles.
//   The page ids are read from the table as each tile is issued, with the
//   clamp above.  K and V of a tile complete on the stage's "full"
//   mbarrier; the producer refills a stage once its "empty" mbarrier has
//   one arrival from each consumer warp.  At most 4 tiles (64 KB) per CTA
//   are in flight: above the ~32 KB the rate needs, and at least the 3
//   stages the consumers are not reading (48 KB per CTA).
// - No CTA barrier per tile.  Each group of 4 consumer warps owns a fixed
//   share of every tile, rows [8w, 8w + 8) of a 32-token tile (kT / 4 in
//   general), reads them in passes of 32 / LPR rows, a row over LPR lanes
//   (D / VEC lanes of one 8- or 16-byte vector each where that divides a
//   warp; else 32 lanes of D / 32 columns in vectors of VEC elements, 6 = 3
//   x 2 at D = 192, 8 = 2 x 4 for f32 at D = 256; neighbouring lanes read
//   neighbouring bytes, so no bank is met twice), and keeps its own online
//   softmax: the max over the
//   warp's scores of the tile updates its (m, l), and the tile's p.V is
//   summed on its own before it enters the accumulator held in registers.
//   A warp releases the stage with one arrival on its empty barrier and
//   goes on to the next tile; warps never wait for each other.
// - GQA: a warp keeps GW query heads (GW in {1, 2, 4, 8}: its registers
//   hold GW x D / LPR columns of q, of the accumulator and of the tile's
//   p.V).  A group of up to 16 heads is cut into `slices` of GW heads, and
//   each slice is a group of 4 consumer warps reading the same stages: one
//   pass over the kv head's K/V from device memory for G <= 16, whatever
//   G (heads past G in the last slice are dead rows: q = 0, never stored).
//   G = 1, 2, 4 run one slice of GW = G (4 for G = 3); G = 5..8 two slices
//   of 4; G = 9..16 two slices of 8.  A group of more than 16 heads (an
//   MQA model with many heads) is cut into `chunks` of at most 16 over the
//   grid (grid.y = Hkv * chunks): each chunk's CTAs read the head's K/V
//   again, chunks times its bytes from device memory at most (the chunks
//   of a head are neighbours in the grid, so part of it may come from L2).
//   decode_group_plan (paged_attention.py) mirrors plan() below.
// - One merge at the end: each warp's (m, l, acc) goes to shared memory,
//   and after the only CTA barrier past the prologue the CTA merges each
//   head's four warps with K2's formula (m* = max m_w, l = sum l_w
//   e^(m_w - m*), likewise acc).
//
// The arithmetic stays on the CUDA cores: at G <= 16 decode does at most
// 16 flops per bf16 byte, below what the tensor cores would need.
//
// paged_decode_attention launches K1 and then K2 (combine.cu), at every
// split count, on the same stream, and returns the first error.
#include <atomic>
#include <mutex>

#include "common.cuh"
#include "flash_tc.cuh"

namespace ft = flash_tc;

// K2's C entry (combine.cu), launched by the decode op after K1.
extern "C" int combine_partials(
    int out_code, const void* m, const void* l, const void* acc, void* out,
    int B, int Hkv, int NQ, int S, int R, int D, int G, int q_block, int C,
    long long m_b, long long m_h, long long m_nq, long long m_s,
    long long m_r, long long a_b, long long a_h, long long a_nq,
    long long a_s, long long a_r, long long o_b, long long o_tok,
    long long o_head, void* stream);

namespace {

constexpr int kWarps = 4;  // consumer warps of a slice
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;  // K + V of one tile
constexpr int kMaxTile = 32;        // tokens per tile, at most
constexpr int kMaxCtaGroup = 16;    // query heads of one CTA, at most

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// Threads of a CTA of `slices` slices: their consumer warps and the
// producer warp.  GW < 4 runs one slice, GW >= 4 up to two.
constexpr int threads_of(int slices) { return 32 * (kWarps * slices + 1); }
template <int GW>
constexpr int max_threads() {
  return threads_of(GW >= 4 ? 2 : 1);
}

// How a group of G query heads is cut: (heads per warp, slices per CTA,
// chunks over the grid, heads per chunk).  decode_group_plan mirrors it.
struct Plan {
  int gw, slices, chunks, gc;
};
inline Plan plan(int G) {
  Plan pl;
  pl.chunks = (G + kMaxCtaGroup - 1) / kMaxCtaGroup;
  pl.gc = (G + pl.chunks - 1) / pl.chunks;
  if (pl.gc <= 4) {
    pl.gw = pl.gc <= 1 ? 1 : pl.gc <= 2 ? 2 : 4;
    pl.slices = 1;
  } else {
    pl.gw = pl.gc <= 8 ? 4 : 8;
    pl.slices = 2;
  }
  return pl;
}

// Tile geometry for pools of TKV at head dim D.
template <typename TKV, int D>
struct Geo {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kFit = kStageBytes / (2 * kRowBytes);
  static constexpr int kT = pow2_floor(kFit < kMaxTile ? kFit : kMaxTile);
  static constexpr int kHalf = kT * kRowBytes;  // K (or V) bytes of a stage
  // elements per 16-byte vector, at most 8 (int8 keeps registers low)
  static constexpr int VEC16 = 16 / sizeof(TKV) < 8 ? 16 / sizeof(TKV) : 8;
  static constexpr bool kWide = D / VEC16 > 32 || 32 % (D / VEC16) != 0;
  static constexpr int LPR = kWide ? 32 : D / VEC16;  // lanes per row
  static constexpr int C = D / LPR;                   // columns per lane
  static constexpr int VEC =  // elements per vector, at most 16 bytes
      kWide ? ((C & -C) < VEC16 ? (C & -C) : VEC16) : VEC16;
  static constexpr int NV = C / VEC;                  // vectors per lane
  static constexpr int RPI = 32 / LPR;     // rows per pass of a warp
  static constexpr int TPW = kT / kWarps;  // rows of a tile per warp
  static constexpr int NP = TPW / RPI;     // passes per tile
  static_assert(LPR * C == D && NV * VEC == C, "a row fits a warp");
  static_assert(TPW % RPI == 0 && NP >= 1, "whole passes per tile");
};

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* lens;
  float* m;
  float* l;
  float* acc;
  int B, Hkv, G, D, num_pages, page_size, max_pages, ppb, S, bps;
  int slices, chunks, gc;  // the group's plan (heads per warp: GW)
  int pstride;  // bytes between whole pages in a stage (128-byte aligned)
  float scale;
  int window;
  float softcap;
  float kv_scale;
  int q_code;  // 0 f32, 1 bf16
};

// The tokens [lo, hi) of one slot and its tiles.  Pages of at most kT
// tokens go tp whole pages to a tile (as many as fit at `pstride` bytes
// apart); a longer page is cut into tiles of kT rows (cpp per page; its
// last may be shorter).  Tile rows are the tile's tokens in order.
struct Span {
  int lo, hi, P, kT, tp, cpp, tile_tok;
  bool multi;  // several whole pages per tile

  __device__ Span(int lo_, int hi_, int P_, int kT_, int half, int pstride)
      : lo(lo_), hi(hi_), P(P_), kT(kT_) {
    multi = P <= kT;
    tp = multi ? min(kT / P, half / pstride) : 1;
    cpp = multi ? 1 : (P + kT - 1) / kT;
    tile_tok = multi ? tp * P : kT;
  }
  __device__ int start(int i) const {
    return multi ? lo + i * tile_tok : lo + (i / cpp) * P + (i % cpp) * kT;
  }
  __device__ int end(int i) const {
    const int s = start(i);
    return min(hi, multi ? s + tile_tok : min(s + kT, (s / P + 1) * P));
  }
  __device__ int count() const {
    const int len = hi - lo;
    if (len <= 0) return 0;
    return multi ? (len + tile_tok - 1) / tile_tok
                 : (len / P) * cpp + (len % P + kT - 1) / kT;
  }
};

// N elements of T from shared memory (2, 4, 8 or 16 bytes), widened to f32.
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4 || kBytes == 2,
                "2- to 16-byte loads");
  if constexpr (kBytes == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
    const uint16_t raw = *reinterpret_cast<const uint16_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  }
}

// Shared memory of a CTA whose merge holds `heads` query heads (slices x
// GW): the stages, the merge, the barriers, 128 bytes of alignment slack.
template <typename TKV, int D>
constexpr size_t smem_bytes(int heads) {
  return 128 + kStages * 2 * Geo<TKV, D>::kHalf +
         static_cast<size_t>(kWarps) * heads * (D + 2) * sizeof(float) +
         16 * kStages;
}

template <typename TKV, int D, int GW>
__global__ void __launch_bounds__(max_threads<GW>())
    paged_decode_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const DecodeParams p) {
  using Gm = Geo<TKV, D>;
  constexpr int VEC = Gm::VEC, LPR = Gm::LPR, NV = Gm::NV, C = Gm::C;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = ft::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 127u) & ~127u) - raw;
  uint8_t* smem = smem_raw + pad;  // stages, then the merge, then barriers
  const uint32_t base = raw + pad;
  const int heads = p.slices * GW;  // the merge's heads (slice-major)
  float* m_s = reinterpret_cast<float*>(smem + kStages * 2 * Gm::kHalf);
  float* l_s = m_s + kWarps * heads;   // [kWarps][heads]
  float* acc_s = l_s + kWarps * heads;  // [kWarps][heads][D]
  const uint32_t bars = base + kStages * 2 * Gm::kHalf +
                        kWarps * heads * (D + 2) * sizeof(float);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int s = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.chunks;
  const int g0 = (blockIdx.y % p.chunks) * p.gc;  // the chunk's first head
  const int n_heads = min(p.gc, p.G - g0);         // its live heads
  const int consumers = kWarps * p.slices;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int P = p.page_size;
  const int L = p.lens[b];

  // token range of this split, cut to what can be live
  const int split_tokens = p.bps * p.ppb * P;
  const int lo = s * split_tokens;
  int hi = lo + split_tokens;
  int ring = 0;
  const int cur_page = max(L - 1, 0) / P;
  if (p.window > 0) {
    ring = (p.window + P - 1) / P + 1;
    hi = min(hi, ring * P);  // slots past the ring never hold this layer
  } else {
    hi = min(hi, L);
  }
  const Span sp(lo, hi, P, Gm::kT, Gm::kHalf, p.pstride);
  const int n = sp.count();

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      ft::mbar_init(full(st), 1);           // the producer's expect_tx
      ft::mbar_init(empty(st), consumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == consumers) {
    // -- the producer: tile i into stage i % kStages, once it is free ------
    if (lane == 0) {
      const int* trow = p.tables + static_cast<size_t>(b) * p.max_pages;
      const int n_live = max((L + P - 1) / P, 1);
      const uint32_t box = (sp.multi ? P : Gm::kT) * Gm::kRowBytes;
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        if (i >= kStages) ft::mbar_wait(empty(st), ((i / kStages) - 1) & 1);
        const int t0 = sp.start(i);
        const int np = sp.multi ? (sp.end(i) - t0 + P - 1) / P : 1;
        const int off = t0 % P;  // 0 for whole pages
        ft::mbar_expect_tx(full(st), 2u * np * box);
        const uint32_t kd = base + st * 2 * Gm::kHalf;
        for (int j = 0; j < np; ++j) {
          const int rank = t0 / P + j;
          int r = p.window > 0 ? rank : min(rank, n_live - 1);
          r = min(r, p.max_pages - 1);
          const int pg = min(max(__ldg(trow + r), 0), p.num_pages - 1);
          const int row = pg * P + off;
          ft::tma_load_2d(kd + j * p.pstride, &tk, full(st), h * D, row);
          ft::tma_load_2d(kd + Gm::kHalf + j * p.pstride, &tv, full(st),
                          h * D, row);
        }
      }
    }
    __syncwarp();
  } else {
    // -- a consumer warp: its rows of every tile for its slice's GW heads,
    //    its own online softmax --------------------------------------------
    const int slice = warp / kWarps, wq = warp % kWarps;
    const int grp = lane / LPR;  // row of the pass
    const int lc = lane % LPR;   // vector v of the lane: columns
                                 // (v * LPR + lc) * VEC + [0, VEC)
    const float kvs = p.kv_scale > 0.f ? p.kv_scale : 1.f;
    // stage byte offsets of the thread's rows of every tile, fixed across
    // tiles (rows of a page are contiguous; whole pages sit pstride bytes
    // apart), computed once: a division per row and tile would cost the
    // loop more than its loads
    const bool gapped = sp.multi && p.pstride != P * Gm::kRowBytes;
    int roff[Gm::NP];
#pragma unroll
    for (int pp = 0; pp < Gm::NP; ++pp) {
      const int r = wq * Gm::TPW + pp * Gm::RPI + grp;
      roff[pp] = gapped ? (r / P) * p.pstride + (r % P) * Gm::kRowBytes
                        : r * Gm::kRowBytes;
    }
    float qr[GW][C];
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      const int hd = slice * GW + g;  // the chunk's head
      const bool live = hd < n_heads;
      const size_t row =
          ((static_cast<size_t>(b) * p.Hkv + h) * p.G + g0 + hd) * D;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const size_t off = row + (v * LPR + lc) * VEC + e;
          float x = 0.f;
          if (live)
            x = p.q_code == 0
                    ? static_cast<const float*>(p.q)[off]
                    : to_f32(static_cast<const __nv_bfloat16*>(p.q)[off]);
          qr[g][v * VEC + e] = x * p.scale;
        }
    }
    float m[GW], l[GW], acc[GW][C];
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      m[g] = REPRO_NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
    }

    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      ft::mbar_wait(full(st), (i / kStages) & 1);
      const int t0 = sp.start(i), cnt = sp.end(i) - t0;
      const uint8_t* ks = smem + st * 2 * Gm::kHalf;
      const uint8_t* vs = ks + Gm::kHalf;

      float sc[Gm::NP][GW], mx[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g) mx[g] = REPRO_NEG_INF;
#pragma unroll
      for (int pp = 0; pp < Gm::NP; ++pp) {
        const int row = wq * Gm::TPW + pp * Gm::RPI + grp;
        float part[GW];
#pragma unroll
        for (int g = 0; g < GW; ++g) part[g] = 0.f;
        if (row < cnt) {
          const TKV* kr = reinterpret_cast<const TKV*>(ks + roff[pp]);
          float kv[C];
#pragma unroll
          for (int v = 0; v < NV; ++v)
            lds_vec<TKV, VEC>(kr + (v * LPR + lc) * VEC, kv + v * VEC);
#pragma unroll
          for (int g = 0; g < GW; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c) part[g] += qr[g][c] * kv[c];
        }
#pragma unroll
        for (int g = 0; g < GW; ++g)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
        bool live = row < cnt;
        if (live && p.window > 0) {
          const int t = t0 + row, rank = t / P;
          const int wrap = ((cur_page - rank) % ring + ring) % ring;
          int pos = (cur_page - wrap) * P + t % P;
          if (pos >= L) pos -= ring * P;
          live = pos >= 0 && pos < L && pos >= L - p.window;
        }
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float x = part[g] * kvs;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          sc[pp][g] = live ? x : REPRO_NEG_INF;
          mx[g] = fmaxf(mx[g], sc[pp][g]);
        }
      }
      float alpha[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g) {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
        const float m_new = fmaxf(m[g], mx[g]);
        alpha[g] = expf(m[g] - m_new);
        m[g] = m_new;
      }

      // the tile's p.V and sum of p, on their own, then into (l, acc)
      float pv[GW][C], ps[GW];
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        ps[g] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) pv[g][c] = 0.f;
      }
#pragma unroll
      for (int pp = 0; pp < Gm::NP; ++pp) {
        const int row = wq * Gm::TPW + pp * Gm::RPI + grp;
        if (row >= cnt) continue;
        const TKV* vr = reinterpret_cast<const TKV*>(vs + roff[pp]);
        float vv[C];
#pragma unroll
        for (int v = 0; v < NV; ++v)
          lds_vec<TKV, VEC>(vr + (v * LPR + lc) * VEC, vv + v * VEC);
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          const float x = sc[pp][g];
          const float pe = x > 0.5f * REPRO_NEG_INF ? expf(x - m[g]) : 0.f;
          ps[g] += pe;
#pragma unroll
          for (int c = 0; c < C; ++c) pv[g][c] += pe * vv[c];
        }
      }
      __syncwarp();
      if (lane == 0) ft::mbar_arrive(empty(st));  // the warp is done reading
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        l[g] = fmaf(l[g], alpha[g], ps[g]);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[g][c] = fmaf(acc[g][c], alpha[g], pv[g][c] * kvs);
      }
    }

    // the warp's rows of a pass hold partial sums: add them up
#pragma unroll
    for (int g = 0; g < GW; ++g)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], o);
      }
    if (lane < LPR) {
#pragma unroll
      for (int g = 0; g < GW; ++g)
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc_s[(wq * heads + slice * GW + g) * D + (v * LPR + lc) * VEC +
                  e] = acc[g][v * VEC + e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        m_s[wq * heads + slice * GW + g] = m[g];
        l_s[wq * heads + slice * GW + g] = l[g];
      }
    }
  }
  __syncthreads();

  // -- merge each head's warps' partials with K2's formula ----------------
  const size_t slot = (static_cast<size_t>(b) * p.Hkv + h) * p.S + s;
  for (int i = threadIdx.x; i < n_heads * D; i += blockDim.x) {
    const int hd = i / D, d = i % D;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * heads + hd]);
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * heads + hd] - mx);
      o += acc_s[(w * heads + hd) * D + d] * c;
      ls += l_s[w * heads + hd] * c;
    }
    const size_t g = slot * p.G + g0 + hd;
    p.acc[g * D + d] = o;
    if (d == 0) {
      p.m[g] = mx;
      p.l[g] = ls;
    }
  }
}

template <typename T>
constexpr CUtensorMapDataType tma_type();
template <>
constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <>
constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
constexpr CUtensorMapDataType tma_type<int8_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;  // the bytes as they are
}

// A pool's tensor map: (num_pages * P) rows of Hkv * D elements, boxes of
// box_rows whole head rows, unswizzled.  A decode step asks for the same
// two maps per layer at every step and a map is a function of its key
// alone, so the maps are kept (the host's share of the op is most of its
// cost at the main shapes).
int pool_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
             int elem_bytes, uint64_t cols, uint64_t rows, uint32_t D,
             uint32_t box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    CUtensorMapDataType type;
    uint64_t cols, rows;
    uint32_t D, box_rows;
  };
  constexpr int kKept = 256;
  static Entry kept[kKept];
  static int n_kept = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_kept; ++i) {
    const Entry& e = kept[i];
    if (e.ptr == ptr && e.type == type && e.cols == cols && e.rows == rows &&
        e.D == D && e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  }
  const int bad = ft::encode_2d(map, ptr, type, cols, rows, cols * elem_bytes,
                                D, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (bad) return bad;
  kept[next] = Entry{*map, ptr, type, cols, rows, D, box_rows};
  next = (next + 1) % kKept;
  n_kept = n_kept < kKept ? n_kept + 1 : kKept;
  return 0;
}

template <typename TKV, int D, int GW>
int launch(DecodeParams p, cudaStream_t st) {
  using Gm = Geo<TKV, D>;
  const int P = p.page_size;
  // whole pages land at 128-byte aligned stage offsets (TMA's destination
  // alignment)
  p.pstride = (P * Gm::kRowBytes + 127) / 128 * 128;
  const uint64_t rows = static_cast<uint64_t>(p.num_pages) * P;
  const uint64_t cols = static_cast<uint64_t>(p.Hkv) * D;
  const uint32_t box_rows = P <= Gm::kT ? P : Gm::kT;
  CUtensorMap tk, tv;
  int bad = pool_map(&tk, p.k, tma_type<TKV>(), sizeof(TKV), cols, rows, D,
                     box_rows);
  if (!bad)
    bad = pool_map(&tv, p.v, tma_type<TKV>(), sizeof(TKV), cols, rows, D,
                   box_rows);
  if (bad) return bad;
  // the shared-memory limit, raised once per device to the instance's most
  constexpr int kMaxHeads = GW * (GW >= 4 ? 2 : 1);
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = 1ull << (dev & 63);
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(
        paged_decode_kernel<TKV, D, GW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<TKV, D>(kMaxHeads)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const dim3 grid(p.S, p.Hkv * p.chunks, p.B);
  paged_decode_kernel<TKV, D, GW>
      <<<grid, threads_of(p.slices), smem_bytes<TKV, D>(p.slices * GW), st>>>(
          tk, tv, p);
  return 0;
}

template <typename TKV, int D>
int dispatch_group(const DecodeParams& p, int gw, cudaStream_t st) {
  switch (gw) {
    case 1: return launch<TKV, D, 1>(p, st);
    case 2: return launch<TKV, D, 2>(p, st);
    case 4: return launch<TKV, D, 4>(p, st);
    case 8: return launch<TKV, D, 8>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int dispatch_kv(int kv_code, const DecodeParams& p, int gw, cudaStream_t st) {
  switch (kv_code) {
    case 0: return dispatch_group<float, D>(p, gw, st);
    case 1: return dispatch_group<__nv_bfloat16, D>(p, gw, st);
    case 2: return dispatch_group<int8_t, D>(p, gw, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1 on `stream`: 0, or the first error.
int run_decode(int q_code, int kv_code, const void* q, const void* k_pages,
               const void* v_pages, const void* tables, const void* lens,
               void* m, void* l, void* acc, int B, int Hkv, int G, int D,
               int num_pages, int page_size, int max_pages, int ppb,
               int num_splits, int bps, float scale, int window,
               float softcap, float kv_scale, cudaStream_t st) {
  if (page_size < 1 || num_splits < 1 || bps < 1 || ppb < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(G);
  DecodeParams p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  p.B = B;
  p.Hkv = Hkv;
  p.G = G;
  p.D = D;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.ppb = ppb;
  p.S = num_splits;
  p.bps = bps;
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.kv_scale = kv_scale;
  p.q_code = q_code;
  p.slices = pl.slices;
  p.chunks = pl.chunks;
  p.gc = pl.gc;
  p.pstride = 0;  // set per instance by launch()
  int bad;
  switch (D) {
    case 64: bad = dispatch_kv<64>(kv_code, p, pl.gw, st); break;
    case 128: bad = dispatch_kv<128>(kv_code, p, pl.gw, st); break;
    case 192: bad = dispatch_kv<192>(kv_code, p, pl.gw, st); break;
    case 256: bad = dispatch_kv<256>(kv_code, p, pl.gw, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_partials(
    int q_code, int kv_code, const void* q, const void* k_pages,
    const void* v_pages, const void* tables, const void* lens, void* m,
    void* l, void* acc, int B, int Hkv, int G, int D, int num_pages,
    int page_size, int max_pages, int ppb, int num_splits, int bps,
    float scale, int window, float softcap, float kv_scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  return run_decode(q_code, kv_code, q, k_pages, v_pages, tables, lens, m, l,
                    acc, B, Hkv, G, D, num_pages, page_size, max_pages, ppb,
                    num_splits, bps, scale, window, softcap, kv_scale,
                    static_cast<cudaStream_t>(stream));
}

// The decode op: K1's partials into (m, l, acc), then K2 merges them into
// `out` (B, Hkv, G, D) in the q dtype, on the same stream, at every split
// count (at one split K2 is the plain normalise, bit for bit).
extern "C" int paged_decode_attention(
    int q_code, int kv_code, const void* q, const void* k_pages,
    const void* v_pages, const void* tables, const void* lens, void* m,
    void* l, void* acc, void* out, int B, int Hkv, int G, int D,
    int num_pages, int page_size, int max_pages, int ppb, int num_splits,
    int bps, float scale, int window, float softcap, float kv_scale,
    void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  const int bad = run_decode(
      q_code, kv_code, q, k_pages, v_pages, tables, lens, m, l, acc, B, Hkv,
      G, D, num_pages, page_size, max_pages, ppb, num_splits, bps, scale,
      window, softcap, kv_scale, static_cast<cudaStream_t>(stream));
  if (bad) return bad;
  // the partials (B, Hkv, S, G[, D]) as K3's layout with one Q-block of
  // one token, into (B, 1, Hkv G, D)
  const long long S = num_splits, H = static_cast<long long>(Hkv) * G;
  return combine_partials(q_code, m, l, acc, out, B, Hkv, 1, num_splits, G,
                          D, G, 1, 1, Hkv * S * G, S * G, 0, G, 1,
                          Hkv * S * G * D, S * G * D, 0, G * D, D, H * D, 0,
                          D, stream);
}
