// K3: chunked paged prefill partials for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _prefill_kernel (launcher paged_prefill_partials).  A chunk of C query
// tokens per sequence attends causally, by absolute position, over the
// sequence's paged KV cache: the prefix written by earlier chunks and the
// chunk itself, whose K/V were scattered into the pages before the launch
// (write-then-attend).  A Q-block holds R = q_block * G rows, row r being
// chunk token nq * q_block + r / G of head h * G + r % G.  One CTA per (row
// tile, Q-block, split, kv head, batch) walks the K/V tiles of its split
// (from the rank-clamped blocked table) and emits the un-normalised
// online-softmax partials (m, l, acc) in f32; the split-K combine merges
// them.  Masks as the TPU kernel: kvpos < kv_lens[b] and kvpos <= qpos(row);
// K/V tiles that start at or past kv_lens or past the Q-block's last query
// are skipped; softcap before the mask.  Rows past the chunk read no q
// (zeros) and give finite partials that the combine slices off; a row of a
// split with nothing live emits (NEG_INF, 0, 0).
//
// What bounds it: each query row does 4 D flops per key it attends (q.K
// and p.V), over the whole cached prefix, so at chunks of hundreds of
// tokens it is bound by operations, not bytes, and every input runs on the
// tensor cores, on one of two tiles chosen by the q dtype:
//
// - bf16 q: paged_prefill_kernel_tc, the bf16 tile of flash_tc.cuh (wgmma
//   for q.K and p.V, K/V by TMA into a three-stage ring, two at D = 256,
//   128 rows per CTA, K/V tiles of kBN = 128 keys; 64 at D = 192 and 256);
// - f32 q: paged_prefill_kernel_tf32, the split-TF32 tile of flash_tf32.cuh
//   (every product as three TF32 products, 64 rows per CTA, kBN = 64; 32
//   at D = 192 and 256, with a single stage at D = 256).
//
// The pools are one 2-D tensor map of (num_pages * P) rows of Hkv * D
// columns.  A K/V tile holds up to kBN keys of whole pages, one box per
// page (per 64-column bf16 or 32-column f32 panel) at column h * D and row
// page * P, or, for a page longer than kBN, one box of kBN rows cut from
// it (its rows past the page's end masked).  Each page's box starts at
// stage row j * P8, P8 = P rounded up to 8: 1024 bytes, the period of the
// 128-byte swizzle.  When P is not a multiple of 8 and a tile holds
// several pages, rows P..P8-1 of each are gaps, masked per element (the
// tile's elementwise/live hooks); whole-page tiles keep the column limits
// alone.  What limits the page: nothing in the tile (a box has at most kBN
// rows); the tensor map's row coordinate page * P + row is a 32-bit int,
// so the pool's num_pages * P must stay below 2^31 (the wrapper checks).
// The page ids are read by the producing thread from the split's row of
// the blocked table (L1-cached).  The query rows are gathered in place from
// (B, C, H, D) with zeros past the chunk.  The partials stay un-normalised
// over up to thousands of keys, so the bf16 tile feeds P to p.V as two
// bf16 terms (hi + lo): one term's rounding would exceed the bf16
// tolerance of acc.
//
// Int8 pools (kv_scale > 0), with either q: the ring holds the int8 boxes
// (whole head rows of D bytes, unswizzled, at the same stage rows), and
// each tile is widened into a working stage of the tile's own layout
// (flash_tc.cuh / flash_tf32.cuh, Layout<D, true>).  An int8 value is
// exact in bf16 and in TF32, so the working stage holds the integers
// themselves: kv_scale is folded into the score scale (s = q.k * scale *
// kv_scale) and into acc at the store (acc * kv_scale); l is unchanged.
// On the split-TF32 tile K and V then have no lo part: q.K and p.V are two
// TF32 products each, not three.
#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace ft = flash_tc;
namespace f3 = flash_tf32;

namespace {

struct PrefillParams {
  const void* q;        // (B, C, Hkv * G, D)
  const void* k;        // (num_pages, P, Hkv, D)
  const void* v;
  const int* tables;    // (B, n_blocks, ppb) rank-clamped page ids
  const int* kv_lens;   // (B,) cached tokens incl. the chunk
  const int* q_start;   // (B,) absolute position of chunk token 0
  float* m;             // (B, Hkv, NQ, S, R)
  float* l;
  float* acc;           // (B, Hkv, NQ, S, R, D)
  int B, C, Hkv, G, page_size, n_blocks, ppb, S, bps, q_block, NQ, R,
      n_tiles;
  float scale, softcap, kv_scale;  // kv_scale > 0: int8 pools
};

// -- the tiles ----------------------------------------------------------------
// A K/V tile of the split, for either tile's layout Lay: up to Lay::kBN
// keys of whole pages (npg pages of P <= kBN tokens, one box each, at stage
// rows j * pstride), or, for pages longer than kBN, one box of kBN rows cut
// from a page (cut boxes per page; columns past the page's end are masked).
// Odd: P % 8 != 0, the only pages whose tiles can hold gaps (a template
// argument, so that whole pages compile to the column limits alone).
template <class Lay, bool Odd>
struct PrefillTile {
  static constexpr int kPTerms = 2;  // un-normalised partials: P as hi + lo
  // bytes of a box row in the stage: a 128-byte panel row, or on the int8
  // ring the whole head row
  static constexpr int kRowBytes = Lay::kInt8 ? Lay::kD : 128;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const int* ids;  // the split's rows of the blocked table, bps x ppb
  int P, ppb, npg, cut, box, spb;  // page, pages per KV block, per tile,
                                   // tiles per page, box rows, per block
  int pstride;  // stage rows from one page's box to the next: P rounded up
                // to 8
  bool gaps;    // Odd, and several pages to a tile: masked per element
  int bps, blk_tokens, split0, L, col0, panels;
  float scale, softcap;
  float exp_scale, m_scale;  // scale folded in, unless softcap applies

  // the tile's first page in its KV block, its cut, and its page count
  __device__ void where(int i, int& bb, int& pg0, int& sub, int& np) const {
    const int r = i % spb;
    bb = i / spb;
    pg0 = (r / cut) * npg;
    sub = r % cut;
    np = min(npg, ppb - pg0);
  }
  __device__ void issue(int i, uint32_t kd, uint32_t vd, uint32_t bar) const {
    int bb, pg0, sub, np;
    where(i, bb, pg0, sub, np);
    ft::mbar_expect_tx(
        bar, static_cast<uint32_t>(np * box * kRowBytes * panels * 2));
    for (int j = 0; j < np; ++j) {
      const int row = __ldg(ids + bb * ppb + pg0 + j) * P + sub * box;
      const uint32_t off = static_cast<uint32_t>(j * pstride * kRowBytes);
      for (int c = 0; c < panels; ++c) {
        ft::tma_load_2d(kd + c * Lay::kStagePanel + off, tk, bar,
                        col0 + Lay::kPanelCols * c, row);
        ft::tma_load_2d(vd + c * Lay::kStagePanel + off, tv, bar,
                        col0 + Lay::kPanelCols * c, row);
      }
    }
  }
  // key: the row's query position; live keys are kpos < L, kpos <= qpos.
  // In column space: the columns up to the last live key's (its page j at
  // j * pstride); gap columns below it are masked by live().
  __device__ void bounds(int i, int qpos, int& lo, int& hi) const {
    int bb, pg0, sub, np;
    where(i, bb, pg0, sub, np);
    const int T = cut > 1 ? min(box, P - sub * box) : np * P;
    const int k0 = split0 + bb * blk_tokens + pg0 * P + sub * box;
    const int n = min(T, min(L - k0, qpos - k0 + 1));  // live keys
    lo = 0;
    hi = Odd && gaps && n > 0 ? (n - 1) / P * pstride + (n - 1) % P + 1 : n;
  }
  // the masks are column limits alone, and the gaps between pages
  __device__ bool elementwise(int i) const {
    if (!Odd || !gaps) return false;
    int bb, pg0, sub, np;
    where(i, bb, pg0, sub, np);
    return np > 1;
  }
  __device__ bool live(int, int c) const { return c % pstride < P; }
  __device__ int origin(int) const { return 0; }
  // tiles of the split that start below key `lim` (from the split's first)
  __device__ int count(int lim) const {
    if (lim <= 0) return 0;
    const int rem = lim % blk_tokens;
    const int part = cut > 1 ? (rem / P) * cut + (rem % P + box - 1) / box
                             : (rem + npg * P - 1) / (npg * P);
    return min(bps * spb, (lim / blk_tokens) * spb + part);
  }
  static constexpr int kSteps = 1;  // the softcap
  __device__ int steps() const { return softcap > 0.f ? 1 : 0; }
  template <int N>
  __device__ void apply_step(int, int, const int (&)[2],
                             float (&s)[N / 2]) const {
#pragma unroll
    for (int x = 0; x < N / 2; ++x)
      s[x] = softcap * tanhf(s[x] * scale / softcap);
  }
};

// The tile of CTA (split s, kv head h, batch b) over the maps tk, tv.
template <class L, bool Odd>
__device__ __forceinline__ PrefillTile<L, Odd> make_tile(
    const PrefillParams& p, const CUtensorMap* tk, const CUtensorMap* tv,
    int s, int h, int b) {
  PrefillTile<L, Odd> t;
  t.tk = tk;
  t.tv = tv;
  t.ids =
      p.tables + (static_cast<size_t>(b) * p.n_blocks + s * p.bps) * p.ppb;
  t.P = p.page_size;
  t.ppb = p.ppb;
  t.pstride = (p.page_size + 7) / 8 * 8;
  t.npg = p.page_size <= L::kBN ? min(p.ppb, L::kBN / t.pstride) : 1;
  t.gaps = Odd && t.npg > 1;
  t.cut = (p.page_size + L::kBN - 1) / L::kBN;
  t.box = min(p.page_size, L::kBN);
  t.spb = (p.ppb + t.npg - 1) / t.npg * t.cut;
  t.bps = p.bps;
  t.blk_tokens = p.ppb * p.page_size;
  t.split0 = s * p.bps * t.blk_tokens;
  t.L = p.kv_lens[b];
  t.col0 = h * L::kD;
  t.panels = L::kInt8 ? 1 : L::kD / L::kPanelCols;
  // int8 pools: the working stage holds the integers, kv_scale joins scale
  t.scale = L::kInt8 ? p.scale * p.kv_scale : p.scale;
  t.softcap = p.softcap;
  t.exp_scale = (p.softcap > 0.f ? 1.f : t.scale) * ft::kLog2e;
  t.m_scale = p.softcap > 0.f ? 1.f : t.scale;
  return t;
}

// Where CTA x of the grid sits: its row tile, Q-block and split.
struct PrefillCta {
  int tile, nq, s, q0;  // q0: absolute position of the Q-block's token 0
};

__device__ __forceinline__ PrefillCta prefill_cta(const PrefillParams& p) {
  PrefillCta c;
  c.tile = blockIdx.x % p.n_tiles;
  c.nq = (blockIdx.x / p.n_tiles) % p.NQ;
  c.s = blockIdx.x / (p.n_tiles * p.NQ);
  c.q0 = p.q_start[blockIdx.z] + c.nq * p.q_block;
  return c;
}

// The chunk token of row qr of the Q-block, and its q row (null past the
// chunk or the Q-block).
template <typename T, int D>
__device__ __forceinline__ const T* q_row(const PrefillParams& p,
                                          const PrefillCta& c, int qr) {
  const int tok = c.nq * p.q_block + qr / p.G;
  if (qr >= p.R || tok >= p.C) return nullptr;
  return static_cast<const T*>(p.q) +
         ((static_cast<size_t>(blockIdx.z) * p.C + tok) * (p.Hkv * p.G) +
          blockIdx.y * p.G + qr % p.G) * D;
}

// The (m, l, acc) partials of the thread's rows, acc times `acc_scale`
// (kv_scale on int8 pools); row0 is the CTA's first row of the Q-block.
template <int D>
__device__ __forceinline__ void store_partials(const PrefillParams& p,
                                               const PrefillCta& c, int row0,
                                               const ft::Acc<D>& a,
                                               float acc_scale) {
  const size_t slot =
      ((static_cast<size_t>(blockIdx.z) * p.Hkv + blockIdx.y) * p.NQ + c.nq) *
          p.S + c.s;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qr = row0 + ft::thread_row(hh);
    if (qr >= p.R) continue;
    const size_t o = slot * p.R + qr;
    if (threadIdx.x % 4 == 0) {
      p.m[o] = a.m[hh];
      p.l[o] = a.l[hh];
    }
    float* ag = p.acc + o * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ag + ft::thread_col(j, 0)) =
          make_float2(a.o[4 * j + 2 * hh] * acc_scale,
                      a.o[4 * j + 2 * hh + 1] * acc_scale);
  }
}

// bf16 q: the tile of flash_tc.cuh, 128 rows per CTA; I8: int8 pools; Odd:
// pages of P % 8 != 0.
template <int D, bool I8, bool Odd>
__global__ void __launch_bounds__(ft::kThreads, 1)
    paged_prefill_kernel_tc(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const PrefillParams p) {
  using L = ft::Layout<D, I8>;
  using Tile = PrefillTile<L, Odd>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const PrefillCta c = prefill_cta(p);
  ft::init_ring<L>(gen, base);
  const Tile t = make_tile<L, Odd>(p, &tk, &tv, c.s, blockIdx.y, blockIdx.z);
  // tiles that start below min(L, last query + 1): a prefix of the split
  // (KV blocks, and tiles inside them, past either are skipped)
  const int n = t.count(min(t.L, c.q0 + p.q_block) - t.split0);
  ft::prefetch<L>(t, base, n);

  const int row0 = c.tile * ft::kRows;
  for (int x = threadIdx.x; x < ft::kRows * (D / 8); x += ft::kThreads) {
    const int r = x / (D / 8);
    ft::store_q_chunk<D>(gen + L::kQ, r, x % (D / 8),
                         q_row<__nv_bfloat16, D>(p, c, row0 + r));
  }
  ft::q_ready();

  int key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    key[hh] = c.q0 + (row0 + ft::thread_row(hh)) / p.G;
  ft::Acc<D> a;
  ft::mainloop<D, Tile, L>(t, base, n, key, a);
  store_partials<D>(p, c, row0, a, I8 ? p.kv_scale : 1.f);
}

// f32 q: the split-TF32 tile of flash_tf32.cuh, 64 rows per CTA; I8: int8
// pools; Odd: pages of P % 8 != 0.
template <int D, bool I8, bool Odd>
__global__ void __launch_bounds__(f3::kThreads, 1)
    paged_prefill_kernel_tf32(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const PrefillParams p) {
  using L = f3::Layout<D, I8>;
  using Tile = PrefillTile<L, Odd>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const PrefillCta c = prefill_cta(p);
  ft::init_ring<L>(gen, base);
  const Tile t = make_tile<L, Odd>(p, &tk, &tv, c.s, blockIdx.y, blockIdx.z);
  const int n = t.count(min(t.L, c.q0 + p.q_block) - t.split0);
  ft::prefetch<L>(t, base, n);

  const int row0 = c.tile * f3::kRows;
  for (int x = threadIdx.x; x < f3::kRows * (D / 4); x += f3::kThreads) {
    const int r = x / (D / 4);
    f3::store_q_chunk<D>(gen, r, x % (D / 4),
                         q_row<float, D>(p, c, row0 + r));
  }
  ft::q_ready();

  int key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    key[hh] = c.q0 + (row0 + ft::thread_row(hh)) / p.G;
  ft::Acc<D> a;
  f3::mainloop<D, Tile, L>(t, gen, base, n, key, a);
  store_partials<D>(p, c, row0, a, I8 ? p.kv_scale : 1.f);
}

// The launch of either tile: the pools as one 2-D tensor map of (num_pages
// * P) rows of Hkv * D elements, boxes of min(P, kBN) rows: 64-column bf16
// or 32-column f32 panels (128-byte swizzle), or whole int8 head rows.
template <class L, class Kernel>
int launch_tile(Kernel kernel, const PrefillParams& p, int num_pages,
                int rows_per_cta, bool f32, cudaStream_t st) {
  const uint64_t rows = static_cast<uint64_t>(num_pages) * p.page_size;
  const uint64_t cols = static_cast<uint64_t>(p.Hkv) * L::kD;
  const uint32_t box = p.page_size < L::kBN ? p.page_size : L::kBN;
  CUtensorMap tk, tv;
  int bad;
  if constexpr (L::kInt8) {
    bad = ft::encode_i8_rows(&tk, p.k, cols, rows, L::kD, box);
    if (!bad) bad = ft::encode_i8_rows(&tv, p.v, cols, rows, L::kD, box);
  } else {
    const auto encode = f32 ? f3::encode_f32_sw128 : ft::encode_bf16_sw128;
    const uint64_t row_bytes = cols * (f32 ? 4 : 2);
    bad = encode(&tk, p.k, cols, rows, row_bytes, box);
    if (!bad) bad = encode(&tv, p.v, cols, rows, row_bytes, box);
  }
  if (bad) return bad;
  constexpr size_t bytes = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  PrefillParams q = p;
  q.n_tiles = (p.R + rows_per_cta - 1) / rows_per_cta;
  const dim3 grid(q.n_tiles * q.NQ * q.S, q.Hkv, q.B);
  kernel<<<grid, L::kThreads, bytes, st>>>(tk, tv, q);
  return 0;
}

template <int D, bool I8, bool Odd>
int launch_tc(const PrefillParams& p, int num_pages, cudaStream_t st) {
  return launch_tile<ft::Layout<D, I8>>(paged_prefill_kernel_tc<D, I8, Odd>,
                                        p, num_pages, ft::kRows, false, st);
}

template <int D, bool I8, bool Odd>
int launch_tf32(const PrefillParams& p, int num_pages, cudaStream_t st) {
  return launch_tile<f3::Layout<D, I8>>(
      paged_prefill_kernel_tf32<D, I8, Odd>, p, num_pages, f3::kRows, true,
      st);
}

template <bool I8, bool Odd>
int launch_d(int f32, int D, const PrefillParams& p, int num_pages,
             cudaStream_t st) {
  switch (D * 2 + f32) {
    case 128: return launch_tc<64, I8, Odd>(p, num_pages, st);
    case 256: return launch_tc<128, I8, Odd>(p, num_pages, st);
    case 384: return launch_tc<192, I8, Odd>(p, num_pages, st);
    case 129: return launch_tf32<64, I8, Odd>(p, num_pages, st);
    case 257: return launch_tf32<128, I8, Odd>(p, num_pages, st);
    case 385: return launch_tf32<192, I8, Odd>(p, num_pages, st);
    case 512: return launch_tc<256, I8, Odd>(p, num_pages, st);
    case 513: return launch_tf32<256, I8, Odd>(p, num_pages, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool I8>
int launch_page(int f32, int D, const PrefillParams& p, int num_pages,
                cudaStream_t st) {
  return p.page_size % 8 ? launch_d<I8, true>(f32, D, p, num_pages, st)
                         : launch_d<I8, false>(f32, D, p, num_pages, st);
}

// Either tile: bf16 q (f32 == 0) on the bf16 tile, f32 q (f32 == 1) on the
// split-TF32 tile; pools of q's dtype (kv_scale == 0) or int8 (kv_scale >
// 0); any page of num_pages * page_size < 2^31 rows.
int partials(int f32, const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* kv_lens, const void* q_start,
             void* m, void* l, void* acc, int B, int C, int Hkv, int G, int D,
             int num_pages, int page_size, int n_blocks, int ppb,
             int num_splits, int bps, int q_block, float scale, float softcap,
             float kv_scale, void* stream) {
  if (B == 0 || C == 0 || Hkv == 0) return 0;
  if (q_block < 1 || G < 1 || ppb < 1 || page_size < 1 ||
      n_blocks != num_splits * bps || kv_scale < 0.f ||
      static_cast<int64_t>(num_pages) * page_size >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillParams p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.tables = static_cast<const int*>(tables);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  p.B = B;
  p.C = C;
  p.Hkv = Hkv;
  p.G = G;
  p.page_size = page_size;
  p.n_blocks = n_blocks;
  p.ppb = ppb;
  p.S = num_splits;
  p.bps = bps;
  p.q_block = q_block;
  p.NQ = (C + q_block - 1) / q_block;
  p.R = q_block * G;
  p.n_tiles = 0;  // set by launch_tile, from the tile's rows
  p.scale = scale;
  p.softcap = softcap;
  p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = kv_scale > 0.f
                      ? launch_page<true>(f32, D, p, num_pages, st)
                      : launch_page<false>(f32, D, p, num_pages, st);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 tile: bf16 q, bf16 or int8 pools.
extern "C" int paged_prefill_partials_tc(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, const void* q_start, void* m,
    void* l, void* acc, int B, int C, int Hkv, int G, int D, int num_pages,
    int page_size, int n_blocks, int ppb, int num_splits, int bps,
    int q_block, float scale, float softcap, float kv_scale, void* stream) {
  return partials(0, q, k_pages, v_pages, tables, kv_lens, q_start, m, l, acc,
                  B, C, Hkv, G, D, num_pages, page_size, n_blocks, ppb,
                  num_splits, bps, q_block, scale, softcap, kv_scale, stream);
}

// The split-TF32 tile: f32 q, f32 or int8 pools.
extern "C" int paged_prefill_partials_tf32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, const void* q_start, void* m,
    void* l, void* acc, int B, int C, int Hkv, int G, int D, int num_pages,
    int page_size, int n_blocks, int ppb, int num_splits, int bps,
    int q_block, float scale, float softcap, float kv_scale, void* stream) {
  return partials(1, q, k_pages, v_pages, tables, kv_lens, q_start, m, l, acc,
                  B, C, Hkv, G, D, num_pages, page_size, n_blocks, ppb,
                  num_splits, bps, q_block, scale, softcap, kv_scale, stream);
}
