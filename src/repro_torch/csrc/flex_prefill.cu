// K4: block-sparse flash attention with FlexAttention semantics, Hopper.
//
// Replaces the TPU kernel repro/kernels/flex_attention/flex_attention.py::
// _flex_kernel (launcher flex_attention_kernel).  One CUDA block per
// (q-tile rows, head, batch) visits only the kv tiles its BlockMask row
// lists (kv_num_blocks / kv_indices), skips the element mask on is_full
// tiles, reads K/V of head h / G (GQA), runs an online softmax in f32 and
// normalises before the single store in the q dtype.  The q_len / kv_len
// validity of the padded tiles always applies.  Tiles are min(128, Q) x
// min(128, K): not powers of two in general, so both the q rows and the kv
// sub-tiles are masked at their ragged edge.
//
// The Pallas kernel traces any mask_mod and score_mod into its body; here
// the wrapper lowers the mods of core/flex (flex_attention.py, lower_mods)
// into a descriptor that the kernel evaluates (FlexParams):
//   mask   an or of up to kMaxTerms terms, each the and of a column range
//          lo <= k < hi per row (lo = q - window + 1; hi = min(max(q + 1,
//          prefix), plen[b]): causal, window, prefix-LM, padding and full
//          are such ranges) and of element predicates (document: docs[b,
//          q] == docs[b, k]; paged: sid[q] == sid[k] and pos[k] <
//          lens[sid[q]]);
//   score  up to kMaxSteps softcap (cap tanh(s / cap)) and ALiBi (s -
//          slopes[h] (q - k), h the query head) steps on the scaled score,
//          before the mask, as in the Pallas body.
// Four kinds are compiled: a one-term mask without predicates (the
// engine's causal & padding and window & padding) runs on per-row column
// limits alone, with no per-element work beyond the edge tiles; any other
// mask evaluates the terms per element on the tiles that are not full
// (kKindElement); a score mod adds its steps per element (kKindScore; the
// scale then applies inside the transform instead of in the exponent).
// Aux reads clamp their indices into the aux tensors, as JAX's gathers do,
// and happen only for in-range rows and keys.
//
// What bounds it: for prompts of hundreds of tokens and more, the q.K and
// p.V products (4 Q K D flops per head, halved by the causal mask) far
// outweigh the bytes, so it is bound by operations, and both routes run
// on the tensor cores, chosen by the wrapper from the dtype alone:
//
// - bf16: flex_fwd_kernel_tc, the shared bf16 tile of flash_tc.cuh (wgmma
//   for q.K and p.V, K/V by TMA into a three-stage ring, two at D = 256,
//   128 rows per CTA).
// - f32 (the engine's default dtype): flex_fwd_kernel_tf32, the
//   split-TF32 tile of flash_tf32.cuh (every product as three TF32
//   products, which keeps the f32 contract; 64 rows per CTA, so a q tile
//   of more than 64 rows takes two CTAs).
//
// One 2-D tensor map over (B * Hkv * K, D) rows serves each of K and V,
// since one head's keys are contiguous; a kv tile of the BlockMask is read
// in boxes of the tile's kBN rows from its first key, and the box's
// columns past kv_blk (the next kv tile's keys, listed or not) are masked
// by their index in the tile.  Rows past q_blk are computed and never
// stored.
#include <cstring>

#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace ft = flash_tc;
namespace f3 = flash_tf32;

namespace {

constexpr int kMaxQBlock = 128;  // q rows per BlockMask tile
// the descriptor's limits and codes (flex_attention.py: MAX_TERMS, ...)
constexpr int kMaxTerms = 8, kMaxPreds = 4, kMaxSteps = 4;
constexpr int kPredDocument = 1, kPredPaged = 2;
constexpr int kStepSoftcap = 1, kStepAlibi = 2;
constexpr int kKindElement = 1, kKindScore = 2;
constexpr int kIntMax = 0x7fffffff;

struct MaskTerm {
  int window;       // lo = q - window + 1 when > 0
  int prefix;       // hi <= max(q + 1, prefix): 0 causal, kIntMax none
  const int* plen;  // hi <= plen[b] when set (padding)
  int preds;        // bit d: predicate d must hold
};

struct Pred {
  int kind;
  const int* a;  // document: docs (nb rows of na); paged: sid (na)
  const int* b;  // paged: pos (nb)
  const int* c;  // paged: lens (nc)
  int na, nb, nc;
};

struct Step {
  int kind;
  float cap;            // softcap
  const float* slopes;  // ALiBi, n of them
  int n;
};

struct FlexParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* nb;
  const int* idx;
  const int* full;
  int B, H, Hkv, Q, K, nq, max_kv, batched, q_blk, kv_blk, q_len, kv_len;
  float scale;
  int nterms, npreds, nsteps;
  MaskTerm term[kMaxTerms];
  Pred pred[kMaxPreds];
  Step step[kMaxSteps];
};

__device__ __forceinline__ int clampi(int x, int n) {
  return min(max(x, 0), n - 1);
}

__device__ __forceinline__ bool pred_holds(const Pred& d, int b, int q,
                                           int k) {
  if (d.kind == kPredDocument) {
    const int* row = d.a + static_cast<size_t>(clampi(b, d.nb)) * d.na;
    return __ldg(row + clampi(q, d.na)) == __ldg(row + clampi(k, d.na));
  }
  const int sq = __ldg(d.a + clampi(q, d.na));
  return sq == __ldg(d.a + clampi(k, d.na)) &&
         __ldg(d.b + clampi(k, d.nb)) < __ldg(d.c + clampi(sq, d.nc));
}

// -- the tensor-core tiles ----------------------------------------------------
// The BlockMask row's kv tiles for either tile's layout L, each read as
// spk tiles of L::kBN keys, masked and scored by the descriptor.
template <class L, int KIND>
struct FlexTile {
  static constexpr int kPTerms = 1;  // the output is normalised
  static constexpr int kSteps = (KIND & kKindScore) ? kMaxSteps : 0;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const FlexParams* p;  // the kernel's parameter block (the descriptor)
  const int* idx;       // this q tile's listed kv tiles
  const int* full;
  int row0;         // (b * Hkv + hk) * K: this head's first row in the maps
  int kv_blk, spk;  // kv tile, and tensor-core tiles per kv tile
  int panels;
  uint32_t tx;      // bytes per K/V tile
  int kv_len, b;
  int win, pre, plen;  // the one-term kinds' range
  int n;            // tensor-core tiles of the row: listed kv tiles x spk
  float scale;
  int nsteps, capbits;       // score steps; bit st: step st is a softcap
  float sv[kMaxSteps];       // per step: 1 / cap, or this head's slope
  float cap[kMaxSteps];      // per softcap step: its cap
  float exp_scale, m_scale;  // score units -> log2 of exp, -> units of m

  __device__ void issue(int i, uint32_t kd, uint32_t vd, uint32_t bar) const {
    const int row = row0 + origin(i);
    ft::mbar_expect_tx(bar, tx);
    for (int c = 0; c < panels; ++c) {
      ft::tma_load_2d(kd + c * L::kStagePanel, tk, bar, L::kPanelCols * c,
                      row);
      ft::tma_load_2d(vd + c * L::kStagePanel, tv, bar, L::kPanelCols * c,
                      row);
    }
  }
  __device__ int origin(int i) const {
    return __ldg(idx + i / spk) * kv_blk + (i % spk) * L::kBN;
  }
  // key: the row's query index, or -1 past q_len (nothing live).  Full
  // tiles take the validity alone; the one-term kinds' other tiles their
  // range as well.
  __device__ void bounds(int i, int key, int& lo, int& hi) const {
    lo = 0;
    if (key < 0) {
      hi = 0;
      return;
    }
    const int ks = (i % spk) * L::kBN, k0 = origin(i);
    hi = min(kv_blk - ks, kv_len - k0);
    if (!(KIND & kKindElement) && !__ldg(full + i / spk)) {
      hi = min(hi, min(max(key + 1, pre), plen) - k0);
      if (win > 0) lo = key + 1 - win - k0;
    }
  }
  __device__ bool elementwise(int i) const {
    return (KIND & kKindElement) && !__ldg(full + i / spk);
  }
  // the or of the descriptor's terms at (q, k)
  __device__ bool live(int q, int k) const {
#pragma unroll 1
    for (int t = 0; t < p->nterms; ++t) {
      const MaskTerm& m = p->term[t];
      if (m.window > 0 && k < q + 1 - m.window) continue;
      if (k >= max(q + 1, m.prefix)) continue;
      if (m.plen != nullptr && k >= __ldg(m.plen + b)) continue;
      bool ok = true;
#pragma unroll 1
      for (int d = 0; d < p->npreds && ok; ++d)
        if ((m.preds >> d) & 1) ok = pred_holds(p->pred[d], b, q, k);
      if (ok) return true;
    }
    return false;
  }
  __device__ int steps() const { return nsteps; }
  // step st over the fragment; the first also applies the scale
  template <int N>
  __device__ void apply_step(int st, int k0, const int (&key)[2],
                             float (&s)[N / 2]) const {
    if (st == 0) {
#pragma unroll
      for (int x = 0; x < N / 2; ++x) s[x] *= scale;
    }
    const float v = sv[st];
    if ((capbits >> st) & 1) {
      const float c = cap[st];
#pragma unroll
      for (int x = 0; x < N / 2; ++x) s[x] = c * tanhf(s[x] * v);
      return;
    }
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * jj + e] -= v * static_cast<float>(
                             key[e >> 1] - k0 - ft::thread_col(jj, e & 1));
  }
};

// The tile of the CTA's q tile (blockIdx.x / halves), head and batch.
template <class L, int D, int KIND>
__device__ __forceinline__ FlexTile<L, KIND> make_tile(
    const FlexParams& p, const CUtensorMap* tk, const CUtensorMap* tv,
    int qb, uint32_t kbox) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_off = (p.batched ? static_cast<size_t>(b) * p.nq : 0) + qb;
  FlexTile<L, KIND> t;
  t.tk = tk;
  t.tv = tv;
  t.p = &p;
  t.idx = p.idx + row_off * p.max_kv;
  t.full = p.full + row_off * p.max_kv;
  t.row0 = (b * p.Hkv + h / (p.H / p.Hkv)) * p.K;
  t.kv_blk = p.kv_blk;
  t.spk = (p.kv_blk + L::kBN - 1) / L::kBN;
  t.panels = D / L::kPanelCols;
  t.tx = 2u * kbox * 128u * t.panels;
  t.kv_len = p.kv_len;
  t.b = b;
  t.win = p.term[0].window;
  t.pre = p.term[0].prefix;
  t.plen = p.term[0].plen != nullptr ? __ldg(p.term[0].plen + b) : kIntMax;
  t.scale = p.scale;
  if (KIND & kKindScore) {
    t.nsteps = p.nsteps;
    t.capbits = 0;
#pragma unroll
    for (int st = 0; st < kMaxSteps; ++st) {
      const Step& sp = p.step[st];
      t.cap[st] = sp.cap;
      if (st >= p.nsteps) {
        t.sv[st] = 0.f;
      } else if (sp.kind == kStepSoftcap) {
        t.capbits |= 1 << st;
        t.sv[st] = 1.f / sp.cap;
      } else {
        t.sv[st] = __ldg(sp.slopes + min(h, sp.n - 1));
      }
    }
    t.exp_scale = ft::kLog2e;  // the transform applies the scale
    t.m_scale = 1.f;
  } else {
    t.exp_scale = p.scale * ft::kLog2e;
    t.m_scale = p.scale;
  }
  t.n = p.nb[row_off] * t.spk;
  return t;
}

// The thread's rows' query indices (-1 past q_len: nothing live) for a CTA
// whose first row is q tile row r0.
__device__ __forceinline__ void row_keys(const FlexParams& p, int q0, int r0,
                                         int (&key)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + r0 + ft::thread_row(hh);
    key[hh] = qrow < p.q_len ? qrow : -1;
  }
}

// Normalise and store the thread's rows (rows r0 + thread_row of the tile).
template <typename T, int D>
__device__ __forceinline__ void store_rows(const FlexParams& p, int q0,
                                           int r0, const ft::Acc<D>& a) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + ft::thread_row(hh);
    if (r >= p.q_blk) continue;
    T* og = static_cast<T*>(p.o) +
            ((static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y) * p.Q + q0 +
             r) * D;
    const float inv = 1.f / fmaxf(a.l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = a.o[4 * j + 2 * hh] * inv;
      const float x1 = a.o[4 * j + 2 * hh + 1] * inv;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(og + ft::thread_col(j, 0)) =
            __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(og + ft::thread_col(j, 0)) =
            make_float2(x0, x1);
    }
  }
}

// bf16: the tile of flash_tc.cuh, one CTA per q tile (up to 128 rows).
template <int D, int KIND>
__global__ void __launch_bounds__(ft::kThreads, 1)
    flex_fwd_kernel_tc(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ FlexParams p,
                       const uint32_t kbox) {
  using L = ft::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const int qb = blockIdx.x, q0 = qb * p.q_blk;
  ft::init_ring<L>(gen, base);
  const FlexTile<L, KIND> t = make_tile<L, D, KIND>(p, &tk, &tv, qb, kbox);
  ft::prefetch<L>(t, base, t.n);

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) +
      ((static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y) * p.Q + q0) * D;
  for (int c = threadIdx.x; c < ft::kRows * (D / 8); c += ft::kThreads) {
    const int r = c / (D / 8);
    ft::store_q_chunk<D>(
        gen + L::kQ, r, c % (D / 8),
        r < p.q_blk ? qg + static_cast<size_t>(r) * D : nullptr);
  }
  ft::q_ready();

  int key[2];
  row_keys(p, q0, 0, key);
  ft::Acc<D> a;
  ft::mainloop<D>(t, base, t.n, key, a);
  store_rows<__nv_bfloat16, D>(p, q0, 0, a);
}

// f32: the split-TF32 tile of flash_tf32.cuh, 64 rows per CTA, so a q
// tile of more than 64 rows takes two CTAs: blockIdx.x = halves * q tile +
// half.
template <int D, int KIND>
__global__ void __launch_bounds__(f3::kThreads, 1)
    flex_fwd_kernel_tf32(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ FlexParams p,
                       const uint32_t kbox) {
  using L = f3::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const int halves = p.q_blk > f3::kRows ? 2 : 1;
  const int qb = blockIdx.x / halves, q0 = qb * p.q_blk;
  const int r0 = (blockIdx.x % halves) * f3::kRows;
  ft::init_ring<L>(gen, base);
  const FlexTile<L, KIND> t = make_tile<L, D, KIND>(p, &tk, &tv, qb, kbox);
  ft::prefetch<L>(t, base, t.n);

  const float* qg =
      static_cast<const float*>(p.q) +
      ((static_cast<size_t>(blockIdx.z) * p.H + blockIdx.y) * p.Q + q0) * D;
  for (int c = threadIdx.x; c < f3::kRows * (D / 4); c += f3::kThreads) {
    const int r = r0 + c / (D / 4);
    f3::store_q_chunk<D>(
        gen, r - r0, c % (D / 4),
        r < p.q_blk ? qg + static_cast<size_t>(r) * D : nullptr);
  }
  ft::q_ready();

  int key[2];
  row_keys(p, q0, r0, key);
  ft::Acc<D> a;
  f3::mainloop<D>(t, gen, base, t.n, key, a);
  store_rows<float, D>(p, q0, r0, a);
}

// Either tile's launch: boxes of min(kBN, B * Hkv * K) rows.
template <class L, int D, class Kernel>
int launch_tile(Kernel kernel, const FlexParams& p, int ctas_per_tile,
                bool f32, cudaStream_t st) {
  const uint64_t rows = static_cast<uint64_t>(p.B) * p.Hkv * p.K;
  const uint32_t kbox = static_cast<uint32_t>(
      rows < static_cast<uint64_t>(L::kBN) ? rows : L::kBN);
  const auto encode = f32 ? f3::encode_f32_sw128 : ft::encode_bf16_sw128;
  const uint64_t row_bytes = static_cast<uint64_t>(D) * (f32 ? 4 : 2);
  CUtensorMap tk, tv;
  int bad = encode(&tk, p.k, D, rows, row_bytes, kbox);
  if (!bad) bad = encode(&tv, p.v, D, rows, row_bytes, kbox);
  if (bad) return bad;
  constexpr size_t bytes = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nq * ctas_per_tile, p.H, p.B);
  kernel<<<grid, L::kThreads, bytes, st>>>(tk, tv, p, kbox);
  return 0;
}

template <int D, int KIND>
int launch(int f32, const FlexParams& p, cudaStream_t st) {
  if (f32)
    return launch_tile<f3::Layout<D>, D>(flex_fwd_kernel_tf32<D, KIND>, p,
                                         p.q_blk > f3::kRows ? 2 : 1, true,
                                         st);
  return launch_tile<ft::Layout<D>, D>(flex_fwd_kernel_tc<D, KIND>, p, 1,
                                       false, st);
}

template <int D>
int dispatch_kind(int f32, int kind, const FlexParams& p, cudaStream_t st) {
  switch (kind) {
    case 0: return launch<D, 0>(f32, p, st);
    case kKindElement: return launch<D, kKindElement>(f32, p, st);
    case kKindScore: return launch<D, kKindScore>(f32, p, st);
    case kKindElement | kKindScore:
      return launch<D, kKindElement | kKindScore>(f32, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The descriptor from the wrapper's int64 words (flex_attention.py,
// _descriptor): three counts, then 4 words per term, 7 per predicate and 3
// per score step.  Returns 0, or cudaErrorInvalidValue for words that do
// not describe `kind`.
int fill_desc(FlexParams* p, int kind, const long long* w, int n) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (w == nullptr || n < 3) return bad;
  const long long nt = w[0], np = w[1], ns = w[2];
  if (nt < 0 || nt > kMaxTerms || np < 0 || np > kMaxPreds || ns < 0 ||
      ns > kMaxSteps || n != 3 + 4 * nt + 7 * np + 3 * ns)
    return bad;
  p->nterms = static_cast<int>(nt);
  p->npreds = static_cast<int>(np);
  p->nsteps = static_cast<int>(ns);
  const long long* x = w + 3;
  for (int t = 0; t < nt; ++t, x += 4) {
    MaskTerm& m = p->term[t];
    m.window = static_cast<int>(x[0]);
    m.prefix = static_cast<int>(x[1]);
    m.plen = reinterpret_cast<const int*>(x[2]);
    m.preds = static_cast<int>(x[3]);
    if (m.preds < 0 || (m.preds >> np)) return bad;
  }
  for (int d = 0; d < np; ++d, x += 7) {
    Pred& r = p->pred[d];
    r.kind = static_cast<int>(x[0]);
    r.a = reinterpret_cast<const int*>(x[1]);
    r.b = reinterpret_cast<const int*>(x[2]);
    r.c = reinterpret_cast<const int*>(x[3]);
    r.na = static_cast<int>(x[4]);
    r.nb = static_cast<int>(x[5]);
    r.nc = static_cast<int>(x[6]);
    const bool doc = r.kind == kPredDocument && r.a && r.na > 0 && r.nb > 0;
    const bool paged = r.kind == kPredPaged && r.a && r.b && r.c &&
                       r.na > 0 && r.nb > 0 && r.nc > 0;
    if (!doc && !paged) return bad;
  }
  for (int st = 0; st < ns; ++st, x += 3) {
    Step& sp = p->step[st];
    sp.kind = static_cast<int>(x[0]);
    sp.n = static_cast<int>(x[2]);
    if (sp.kind == kStepSoftcap) {
      const int32_t bits = static_cast<int32_t>(x[1]);
      memcpy(&sp.cap, &bits, sizeof(float));
    } else if (sp.kind == kStepAlibi && x[1] != 0 && sp.n > 0) {
      sp.slopes = reinterpret_cast<const float*>(x[1]);
    } else {
      return bad;
    }
  }
  const bool element = nt != 1 || p->term[0].preds != 0;
  if (kind != ((element ? kKindElement : 0) | (ns > 0 ? kKindScore : 0)))
    return bad;
  return 0;
}

// The entry points' shared argument checks and parameter block.
int fill_params(FlexParams* p, int kind, const void* q, const void* k,
                const void* v, void* o, const void* kv_num_blocks,
                const void* kv_indices, const void* is_full,
                const void* desc, int desc_len, int B, int H, int Hkv,
                int Q, int K, int nq, int max_kv, int batched, int q_blk,
                int kv_blk, int q_len, int kv_len, float scale) {
  if (q_blk > kMaxQBlock) return static_cast<int>(cudaErrorInvalidValue);
  *p = FlexParams{};
  const int bad =
      fill_desc(p, kind, static_cast<const long long*>(desc), desc_len);
  if (bad) return bad;
  p->q = q;
  p->k = k;
  p->v = v;
  p->o = o;
  p->nb = static_cast<const int*>(kv_num_blocks);
  p->idx = static_cast<const int*>(kv_indices);
  p->full = static_cast<const int*>(is_full);
  p->B = B;
  p->H = H;
  p->Hkv = Hkv;
  p->Q = Q;
  p->K = K;
  p->nq = nq;
  p->max_kv = max_kv;
  p->batched = batched;
  p->q_blk = q_blk;
  p->kv_blk = kv_blk;
  p->q_len = q_len;
  p->kv_len = kv_len;
  p->scale = scale;
  return 0;
}

// The tensor-core routes: f32 == 0 for bf16 q, k, v and o (the bf16
// tile), f32 == 1 for f32 (the split-TF32 tile).
int fwd(int f32, int kind, const void* q, const void* k, const void* v,
        void* o, const void* kv_num_blocks, const void* kv_indices,
        const void* is_full, const void* desc, int desc_len, int B, int H,
        int Hkv, int Q, int K, int D, int nq, int max_kv, int batched,
        int q_blk, int kv_blk, int q_len, int kv_len, float scale,
        void* stream) {
  if (B * H * nq == 0) return 0;
  FlexParams p;
  int bad = fill_params(&p, kind, q, k, v, o, kv_num_blocks, kv_indices,
                        is_full, desc, desc_len, B, H, Hkv, Q, K, nq, max_kv,
                        batched, q_blk, kv_blk, q_len, kv_len, scale);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: bad = dispatch_kind<64>(f32, kind, p, st); break;
    case 128: bad = dispatch_kind<128>(f32, kind, p, st); break;
    case 192: bad = dispatch_kind<192>(f32, kind, p, st); break;
    case 256: bad = dispatch_kind<256>(f32, kind, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and o.
extern "C" int flex_attention_fwd_tc(
    int kind, const void* q, const void* k, const void* v, void* o,
    const void* kv_num_blocks, const void* kv_indices, const void* is_full,
    const void* desc, int desc_len, int B, int H, int Hkv, int Q, int K,
    int D, int nq, int max_kv, int batched, int q_blk, int kv_blk, int q_len,
    int kv_len, float scale, void* stream) {
  return fwd(0, kind, q, k, v, o, kv_num_blocks, kv_indices, is_full, desc,
             desc_len, B, H, Hkv, Q, K, D, nq, max_kv, batched, q_blk,
             kv_blk, q_len, kv_len, scale, stream);
}

// f32 q, k, v and o.
extern "C" int flex_attention_fwd_tf32(
    int kind, const void* q, const void* k, const void* v, void* o,
    const void* kv_num_blocks, const void* kv_indices, const void* is_full,
    const void* desc, int desc_len, int B, int H, int Hkv, int Q, int K,
    int D, int nq, int max_kv, int batched, int q_blk, int kv_blk, int q_len,
    int kv_len, float scale, void* stream) {
  return fwd(1, kind, q, k, v, o, kv_num_blocks, kv_indices, is_full, desc,
             desc_len, B, H, Hkv, Q, K, D, nq, max_kv, batched, q_blk,
             kv_blk, q_len, kv_len, scale, stream);
}
