// K3: chunked paged prefill partials for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _prefill_kernel (launcher paged_prefill_partials).  A chunk of C query
// tokens per sequence attends causally, by absolute position, over the
// sequence's paged KV cache: the prefix written by earlier chunks and the
// chunk itself, whose K/V were scattered into the pages before the launch
// (write-then-attend).  A Q-block holds R = q_block * G rows, row r being
// chunk token nq * q_block + r / G of head h * G + r % G.  One CUDA block
// per (row tile, Q-block, split, kv head, batch) walks the KV blocks of its
// split (ppb pages each, from the rank-clamped blocked table, page ids
// looked up once per KV block) and emits the un-normalised online-softmax
// partials (m, l, acc) in f32; the split-K combine merges them.  Masks as
// the TPU kernel: kvpos < kv_lens[b] and kvpos <= qpos(row); KV blocks that
// start at or past kv_lens or past the Q-block's last query are skipped;
// softcap before the mask; int8 pools times kv_scale.  Rows past the chunk
// read no q (zeros) and give finite partials that the combine slices off;
// a row of a split with nothing live emits (NEG_INF, 0, 0).
//
// What bounds it: each query row does 4 D flops per key it attends (q.K
// and p.V), over the whole cached prefix, so at chunks of hundreds of
// tokens it is bound by operations, not bytes.  Three routes, chosen by
// the wrapper from the dtypes and the page size:
//
// - bf16 q with bf16 pools and page_size % 8 == 0, <= 128 (the bf16 engine's
//   case): paged_prefill_kernel_tc, the shared bf16 tensor-core tile of
//   flash_tc.cuh (wgmma for q.K and p.V, K/V by TMA into a three-stage ring,
//   128 rows per CTA).  The pools are viewed as one 2-D tensor map of
//   (num_pages * P) rows of Hkv * D columns, and a K/V tile of up to kBN
//   tokens (128; 64 at D = 192) is one box of (P rows, 64 columns) per page
//   and 64-column panel, at column h * D and row page * P (a page longer than
//   kBN is cut into boxes of kBN rows).  A box lands at a multiple of 1024
//   bytes, the period of the 128-byte swizzle, hence P % 8 == 0.  The page ids
//   are read by the producing thread from the split's row of the blocked table
//   (L1-cached: the ring leaves no room for a whole table row in shared memory
//   at D = 128). The query rows are gathered in place from (B, C, H, D) with
//   zeros past the chunk.  The partials stay un-normalised over up to
//   thousands of keys, so P enters p.V as two bf16 terms (hi + lo): one term's
//   rounding would exceed the bf16 tolerance of acc.
// - f32 q with f32 pools and the same pages (the engine's default dtype):
//   paged_prefill_kernel_tf32, the split-TF32 tile of flash_tf32.cuh
//   (every product as three TF32 products, 64 rows per CTA, K/V tiles of
//   kBN = 64 keys; 32 at D = 192): the same tensor maps in f32 boxes of 32
//   columns; a page of up to kBN tokens is one box (several to a tile), a
//   longer one is cut into boxes of kBN rows, its last masked at the
//   page's end.
// - int8 pools (either q), or pages that are not a multiple of 8 tokens or
//   are over 128: paged_prefill_kernel, on the CUDA cores, with a pre-scaled
//   f32 q tile of up to 128 rows in shared memory, 32-token K/V sub-tiles
//   gathered through the page ids with 16-byte vector loads (int8 times
//   kv_scale), rows padded against bank conflicts, online softmax in f32
//   and each thread's half of an output row in registers (D / 2 columns,
//   interleaved: 96 at D = 192).  For D = 128 that is ~116 KB of shared
//   memory (D = 192: ~165 KB), above the 48 KB default, hence
//   cudaFuncAttributeMaxDynamicSharedMemorySize.
#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace ft = flash_tc;
namespace f3 = flash_tf32;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // q rows per tile: two threads per row
constexpr int KT = 32;      // kv tokens per shared-memory sub-tile
constexpr int KHALF = KT / 2;

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
  float scale, softcap, kv_scale;
};

template <int D>
constexpr size_t smem_floats() {
  return kRows * (D + 1) + KT * (D + 1) + KT * D + kRows * (KT + 1);
}

template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const PrefillParams p) {
  constexpr int QS = D + 1;
  constexpr int PS = KT + 1;
  constexpr int QV = Vec16<T>::N;    // q elements per 16-byte load
  constexpr int KV = Vec16<TKV>::N;  // K/V elements per 16-byte load
  constexpr int DH = D / 2;          // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // kRows x QS, pre-scaled
  float* k_s = q_s + kRows * QS;   // KT x QS
  float* v_s = k_s + KT * QS;      // KT x D
  float* p_s = v_s + KT * D;       // kRows x PS
  int* page_s = reinterpret_cast<int*>(p_s + kRows * PS);  // ppb page ids

  const int tile = blockIdx.x % p.n_tiles;
  const int nq = (blockIdx.x / p.n_tiles) % p.NQ;
  const int s = blockIdx.x / (p.n_tiles * p.NQ);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int row = tile * kRows + r;  // row of the Q-block
  const bool row_ok = row < p.R;
  const int L = p.kv_lens[b];
  const int q0 = p.q_start[b] + nq * p.q_block;  // position of its token 0
  const int qpos = q0 + row / p.G;
  const int qpos_max = q0 + p.q_block - 1;
  const int H = p.Hkv * p.G;

  for (int c = tid; c < kRows * (D / QV); c += kThreads) {
    const int rr = c / (D / QV), d0 = (c % (D / QV)) * QV;
    const int qr = tile * kRows + rr;
    const int tok = nq * p.q_block + qr / p.G;
    float x[QV];
    if (qr < p.R && tok < p.C) {
      load_vec16(static_cast<const T*>(p.q) +
                     ((static_cast<size_t>(b) * p.C + tok) * H + h * p.G +
                      qr % p.G) * D + d0,
                 x);
    } else {
#pragma unroll
      for (int e = 0; e < QV; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < QV; ++e) q_s[rr * QS + d0 + e] = x[e] * p.scale;
  }

  const size_t tok_stride = static_cast<size_t>(p.Hkv) * D;
  const size_t page_stride = static_cast<size_t>(p.page_size) * tok_stride;
  const TKV* kbase = static_cast<const TKV*>(p.k) + static_cast<size_t>(h) * D;
  const TKV* vbase = static_cast<const TKV*>(p.v) + static_cast<size_t>(h) * D;
  const float kvs = p.kv_scale > 0.f ? p.kv_scale : 1.f;
  const int blk_tokens = p.ppb * p.page_size;

  float m_i = REPRO_NEG_INF, l_i = 0.f;
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  for (int blk = 0; blk < p.bps; ++blk) {
    const int rank = s * p.bps + blk;
    const int first_pos = rank * blk_tokens;
    // the whole block is dead or past the Q-block's last query
    if (first_pos >= L || first_pos > qpos_max) continue;
    __syncthreads();  // the previous block's page ids are consumed
    const int* trow =
        p.tables + (static_cast<size_t>(b) * p.n_blocks + rank) * p.ppb;
    for (int j = tid; j < p.ppb; j += kThreads) page_s[j] = trow[j];
    __syncthreads();

    for (int ks = 0; ks < blk_tokens; ks += KT) {
      const int k0 = first_pos + ks;
      // every later token of the block is masked for every row: skipping
      // leaves (m, l, acc) exactly as an all-masked update would
      if (k0 >= L || k0 > qpos_max) break;
      const int nk = min(KT, blk_tokens - ks);
      __syncthreads();  // the previous sub-tile is consumed
      for (int c = tid; c < KT * (D / KV); c += kThreads) {
        const int rr = c / (D / KV), d0 = (c % (D / KV)) * KV;
        float kx[KV], vx[KV];
        if (rr < nk) {
          const int t = ks + rr;
          const size_t off = page_s[t / p.page_size] * page_stride +
                             (t % p.page_size) * tok_stride + d0;
          load_vec16(kbase + off, kx);
          load_vec16(vbase + off, vx);
        } else {
#pragma unroll
          for (int e = 0; e < KV; ++e) kx[e] = vx[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < KV; ++e) {
          k_s[rr * QS + d0 + e] = kx[e] * kvs;
          v_s[rr * D + d0 + e] = vx[e] * kvs;
        }
      }
      __syncthreads();

      // scores of this thread's row against its half of the sub-tile
      float sv[KHALF];
#pragma unroll
      for (int c = 0; c < KHALF; ++c) sv[c] = 0.f;
      const float* qr = q_s + r * QS;
      const float* kr = k_s + half * KHALF * QS;
      for (int d = 0; d < D; ++d) {
        const float qv = qr[d];
#pragma unroll
        for (int c = 0; c < KHALF; ++c) sv[c] += qv * kr[c * QS + d];
      }
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int c = 0; c < KHALF; ++c) {
        const int cc = half * KHALF + c;
        const int kpos = k0 + cc;
        float x = sv[c];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool live = row_ok && cc < nk && kpos < L && kpos <= qpos;
        sv[c] = live ? x : REPRO_NEG_INF;
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KHALF; ++c) {
        const float pe =
            sv[c] > 0.5f * REPRO_NEG_INF ? expf(sv[c] - m_new) : 0.f;
        p_s[r * PS + half * KHALF + c] = pe;
        sum += pe;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      __syncwarp();  // the row's other half was written by the partner lane

      // acc = acc * alpha + p . V over this thread's interleaved columns.
      // The sub-tile's p . V is summed on its own first: acc, an
      // un-normalised sum over up to thousands of keys, then takes one
      // rounding per sub-tile instead of one per key (f32 partials over a
      // full 2048-key table stay within 2e-5 of the plain version).
      float pv[DH];
#pragma unroll
      for (int i = 0; i < DH; ++i) pv[i] = 0.f;
      const float* pr = p_s + r * PS;
      for (int c = 0; c < nk; ++c) {
        const float pe = pr[c];
        const float* vr = v_s + c * D + half;
#pragma unroll
        for (int i = 0; i < DH; ++i) pv[i] += pe * vr[2 * i];
      }
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(acc[i], alpha, pv[i]);
    }
  }

  if (row_ok) {
    const size_t slot =
        ((static_cast<size_t>(b) * p.Hkv + h) * p.NQ + nq) * p.S + s;
    const size_t o = slot * p.R + row;
    if (half == 0) {
      p.m[o] = m_i;
      p.l[o] = l_i;
    }
    float* ag = p.acc + o * D;
#pragma unroll
    for (int i = 0; i < DH; ++i) ag[2 * i + half] = acc[i];
  }
}

template <typename T, typename TKV, int D>
int launch(const PrefillParams& p, cudaStream_t st) {
  const size_t bytes = smem_floats<D>() * sizeof(float) + p.ppb * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_tiles * p.NQ * p.S, p.Hkv, p.B);
  paged_prefill_kernel<T, TKV, D><<<grid, kThreads, bytes, st>>>(p);
  return 0;
}

template <typename T, int D>
int dispatch_kv(int kv_code, int q_code, const PrefillParams& p,
                cudaStream_t st) {
  if (kv_code == 2) return launch<T, int8_t, D>(p, st);
  if (kv_code != q_code) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, T, D>(p, st);
}

template <int D>
int dispatch_q(int q_code, int kv_code, const PrefillParams& p,
               cudaStream_t st) {
  switch (q_code) {
    case 0: return dispatch_kv<float, D>(kv_code, q_code, p, st);
    case 1: return dispatch_kv<__nv_bfloat16, D>(kv_code, q_code, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- the tensor-core routes ---------------------------------------------------
// A K/V tile of the split, for either tile's layout Lay: up to Lay::kBN
// keys of whole pages (npg pages of P <= kBN tokens, one box each), or, for
// pages longer than kBN, one box of kBN rows cut from a page (cut boxes
// per page; columns past the page's end are masked).
template <class Lay>
struct PrefillTile {
  static constexpr int kPTerms = 2;  // un-normalised partials: P as hi + lo
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const int* ids;  // the split's rows of the blocked table, bps x ppb
  int P, ppb, npg, cut, box, spb;  // page, pages per KV block, per tile,
                                   // tiles per page, box rows, per block
  int bps, blk_tokens, split0, L, col0, panels;
  float scale, softcap;
  float exp_scale, m_scale;  // scale folded in, unless softcap applies

  __device__ void issue(int i, uint32_t kd, uint32_t vd, uint32_t bar) const {
    const int bb = i / spb, r = i % spb;
    const int pg0 = (r / cut) * npg, sub = r % cut;
    const int np = min(npg, ppb - pg0);
    ft::mbar_expect_tx(bar,
                       static_cast<uint32_t>(np * box * 128 * panels * 2));
    for (int j = 0; j < np; ++j) {
      const int row = __ldg(ids + bb * ppb + pg0 + j) * P + sub * box;
      const uint32_t off = static_cast<uint32_t>(j * box * 128);
      for (int c = 0; c < panels; ++c) {
        ft::tma_load_2d(kd + c * Lay::kStagePanel + off, tk, bar,
                        col0 + Lay::kPanelCols * c, row);
        ft::tma_load_2d(vd + c * Lay::kStagePanel + off, tv, bar,
                        col0 + Lay::kPanelCols * c, row);
      }
    }
  }
  // key: the row's query position; live keys are kpos < L, kpos <= qpos
  __device__ void bounds(int i, int qpos, int& lo, int& hi) const {
    const int bb = i / spb, r = i % spb;
    const int pg0 = (r / cut) * npg, sub = r % cut;
    const int T = cut > 1 ? min(box, P - sub * box)
                          : min(npg, ppb - pg0) * P;
    const int k0 = split0 + bb * blk_tokens + pg0 * P + sub * box;
    lo = 0;
    hi = min(T, min(L - k0, qpos - k0 + 1));
  }
  // the masks are column limits alone; the softcap reads no position
  __device__ bool elementwise(int) const { return false; }
  __device__ bool live(int, int) const { return true; }
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
template <class L, int D>
__device__ __forceinline__ PrefillTile<L> make_tile(const PrefillParams& p,
                                                    const CUtensorMap* tk,
                                                    const CUtensorMap* tv,
                                                    int s, int h, int b) {
  PrefillTile<L> t;
  t.tk = tk;
  t.tv = tv;
  t.ids =
      p.tables + (static_cast<size_t>(b) * p.n_blocks + s * p.bps) * p.ppb;
  t.P = p.page_size;
  t.ppb = p.ppb;
  t.npg = p.page_size <= L::kBN ? min(p.ppb, L::kBN / p.page_size) : 1;
  t.cut = (p.page_size + L::kBN - 1) / L::kBN;
  t.box = min(p.page_size, L::kBN);
  t.spb = (p.ppb + t.npg - 1) / t.npg * t.cut;
  t.bps = p.bps;
  t.blk_tokens = p.ppb * p.page_size;
  t.split0 = s * p.bps * t.blk_tokens;
  t.L = p.kv_lens[b];
  t.col0 = h * D;
  t.panels = D / L::kPanelCols;
  t.scale = p.scale;
  t.softcap = p.softcap;
  t.exp_scale = (p.softcap > 0.f ? 1.f : p.scale) * ft::kLog2e;
  t.m_scale = p.softcap > 0.f ? 1.f : p.scale;
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

// The (m, l, acc) partials of the thread's rows; row0 is the CTA's first
// row of the Q-block.
template <int D>
__device__ __forceinline__ void store_partials(const PrefillParams& p,
                                               const PrefillCta& c, int row0,
                                               const ft::Acc<D>& a) {
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
          make_float2(a.o[4 * j + 2 * hh], a.o[4 * j + 2 * hh + 1]);
  }
}

// bf16 q and pools: the tile of flash_tc.cuh, 128 rows per CTA.
template <int D>
__global__ void __launch_bounds__(ft::kThreads, 1)
    paged_prefill_kernel_tc(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const PrefillParams p) {
  using L = ft::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const PrefillCta c = prefill_cta(p);
  ft::init_ring<L>(gen, base);
  const PrefillTile<L> t = make_tile<L, D>(p, &tk, &tv, c.s, blockIdx.y,
                                           blockIdx.z);
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
  ft::mainloop<D>(t, base, n, key, a);
  store_partials<D>(p, c, row0, a);
}

// f32 q and pools: the split-TF32 tile of flash_tf32.cuh, 64 rows per CTA.
template <int D>
__global__ void __launch_bounds__(f3::kThreads, 1)
    paged_prefill_kernel_tf32(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const PrefillParams p) {
  using L = f3::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const PrefillCta c = prefill_cta(p);
  ft::init_ring<L>(gen, base);
  const PrefillTile<L> t = make_tile<L, D>(p, &tk, &tv, c.s, blockIdx.y,
                                           blockIdx.z);
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
  f3::mainloop<D>(t, gen, base, n, key, a);
  store_partials<D>(p, c, row0, a);
}

// The tensor-core launch of either tile: the pools as one 2-D tensor map
// of (num_pages * P) rows of Hkv * D elements, boxes of min(P, kBN) rows.
template <class L, int D, class Kernel>
int launch_tile(Kernel kernel, const PrefillParams& p, int num_pages,
                int rows_per_cta, bool f32, cudaStream_t st) {
  const uint64_t rows = static_cast<uint64_t>(num_pages) * p.page_size;
  const uint64_t cols = static_cast<uint64_t>(p.Hkv) * D;
  const uint32_t box = p.page_size < L::kBN ? p.page_size : L::kBN;
  const auto encode = f32 ? f3::encode_f32_sw128 : ft::encode_bf16_sw128;
  const uint64_t row_bytes = cols * (f32 ? 4 : 2);
  CUtensorMap tk, tv;
  int bad = encode(&tk, p.k, cols, rows, row_bytes, box);
  if (!bad) bad = encode(&tv, p.v, cols, rows, row_bytes, box);
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

template <int D>
int launch_tc(const PrefillParams& p, int num_pages, cudaStream_t st) {
  return launch_tile<ft::Layout<D>, D>(paged_prefill_kernel_tc<D>, p,
                                       num_pages, ft::kRows, false, st);
}

template <int D>
int launch_tf32(const PrefillParams& p, int num_pages, cudaStream_t st) {
  return launch_tile<f3::Layout<D>, D>(paged_prefill_kernel_tf32<D>, p,
                                       num_pages, f3::kRows, true, st);
}

// The entry points' shared argument checks and parameter block.
int fill_params(PrefillParams* p, const void* q, const void* k_pages,
                const void* v_pages, const void* tables, const void* kv_lens,
                const void* q_start, void* m, void* l, void* acc, int B,
                int C, int Hkv, int G, int page_size, int n_blocks, int ppb,
                int num_splits, int bps, int q_block, float scale,
                float softcap, float kv_scale) {
  if (q_block < 1 || G < 1 || ppb < 1 || n_blocks != num_splits * bps)
    return static_cast<int>(cudaErrorInvalidValue);
  p->q = q;
  p->k = k_pages;
  p->v = v_pages;
  p->tables = static_cast<const int*>(tables);
  p->kv_lens = static_cast<const int*>(kv_lens);
  p->q_start = static_cast<const int*>(q_start);
  p->m = static_cast<float*>(m);
  p->l = static_cast<float*>(l);
  p->acc = static_cast<float*>(acc);
  p->B = B;
  p->C = C;
  p->Hkv = Hkv;
  p->G = G;
  p->page_size = page_size;
  p->n_blocks = n_blocks;
  p->ppb = ppb;
  p->S = num_splits;
  p->bps = bps;
  p->q_block = q_block;
  p->NQ = (C + q_block - 1) / q_block;
  p->R = q_block * G;
  p->n_tiles = (p->R + kRows - 1) / kRows;
  p->scale = scale;
  p->softcap = softcap;
  p->kv_scale = kv_scale;
  return 0;
}

// The tensor-core routes, page_size % 8 == 0 and <= 128: bf16 q and pools
// (f32 == 0) on the bf16 tile, f32 q and pools (f32 == 1) on the split-TF32
// tile.
int partials_tc(int f32, const void* q, const void* k_pages,
                const void* v_pages, const void* tables, const void* kv_lens,
                const void* q_start, void* m, void* l, void* acc, int B,
                int C, int Hkv, int G, int D, int num_pages, int page_size,
                int n_blocks, int ppb, int num_splits, int bps, int q_block,
                float scale, float softcap, void* stream) {
  if (B == 0 || C == 0 || Hkv == 0) return 0;
  if (page_size % 8 || page_size > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillParams p;
  int bad = fill_params(&p, q, k_pages, v_pages, tables, kv_lens, q_start, m,
                        l, acc, B, C, Hkv, G, page_size, n_blocks, ppb,
                        num_splits, bps, q_block, scale, softcap, 0.f);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + f32) {
    case 128: bad = launch_tc<64>(p, num_pages, st); break;
    case 256: bad = launch_tc<128>(p, num_pages, st); break;
    case 129: bad = launch_tf32<64>(p, num_pages, st); break;
    case 257: bad = launch_tf32<128>(p, num_pages, st); break;
    case 384: bad = launch_tc<192>(p, num_pages, st); break;
    case 385: bad = launch_tf32<192>(p, num_pages, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_prefill_partials(
    int q_code, int kv_code, const void* q, const void* k_pages,
    const void* v_pages, const void* tables, const void* kv_lens,
    const void* q_start, void* m, void* l, void* acc, int B, int C, int Hkv,
    int G, int D, int page_size, int n_blocks, int ppb, int num_splits,
    int bps, int q_block, float scale, float softcap, float kv_scale,
    void* stream) {
  if (B == 0 || C == 0 || Hkv == 0) return 0;
  PrefillParams p;
  int bad = fill_params(&p, q, k_pages, v_pages, tables, kv_lens, q_start, m,
                        l, acc, B, C, Hkv, G, page_size, n_blocks, ppb,
                        num_splits, bps, q_block, scale, softcap, kv_scale);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: bad = dispatch_q<64>(q_code, kv_code, p, st); break;
    case 128: bad = dispatch_q<128>(q_code, kv_code, p, st); break;
    case 192: bad = dispatch_q<192>(q_code, kv_code, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tensor-core route: bf16 q and pools.
extern "C" int paged_prefill_partials_tc(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, const void* q_start, void* m,
    void* l, void* acc, int B, int C, int Hkv, int G, int D, int num_pages,
    int page_size, int n_blocks, int ppb, int num_splits, int bps,
    int q_block, float scale, float softcap, void* stream) {
  return partials_tc(0, q, k_pages, v_pages, tables, kv_lens, q_start, m, l,
                     acc, B, C, Hkv, G, D, num_pages, page_size, n_blocks,
                     ppb, num_splits, bps, q_block, scale, softcap, stream);
}

// The split-TF32 tensor-core route: f32 q and pools.
extern "C" int paged_prefill_partials_tf32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, const void* q_start, void* m,
    void* l, void* acc, int B, int C, int Hkv, int G, int D, int num_pages,
    int page_size, int n_blocks, int ppb, int num_splits, int bps,
    int q_block, float scale, float softcap, void* stream) {
  return partials_tc(1, q, k_pages, v_pages, tables, kv_lens, q_start, m, l,
                     acc, B, C, Hkv, G, D, num_pages, page_size, n_blocks,
                     ppb, num_splits, bps, q_block, scale, softcap, stream);
}
