// K4: block-sparse flash attention with FlexAttention semantics, Hopper.
//
// Replaces the TPU kernel repro/kernels/flex_attention/flex_attention.py::
// _flex_kernel (launcher flex_attention_kernel).  One CUDA block per
// (q-tile rows, head, batch) visits only the kv tiles its BlockMask row
// lists (kv_num_blocks / kv_indices), skips the element mask on is_full
// tiles, reads K/V of head h / G (GQA), runs an online softmax in f32 and
// normalises before the single store in the q dtype.  The mask is a
// compile-time variant: bit 0 causal (k <= q), bit 1 padding (k < lens[b]);
// the q_len / kv_len validity of the padded tiles always applies.  Tiles
// are min(128, Q) x min(128, K): not powers of two in general, so both the
// q rows and the kv sub-tiles are masked at their ragged edge.
//
// What bounds it: for prompts of hundreds of tokens and more, the q.K and
// p.V products (4 Q K D flops per head, halved by the causal mask) far
// outweigh the bytes, so it is bound by operations, and both routes run
// on the tensor cores, chosen by the wrapper from the dtype alone:
//
// - bf16: flex_fwd_kernel_tc, the shared bf16 tile of flash_tc.cuh (wgmma
//   for q.K and p.V, K/V by TMA into a three-stage ring, 128 rows per CTA).
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
#include "common.cuh"
#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace ft = flash_tc;
namespace f3 = flash_tf32;

namespace {

constexpr int kMaxQBlock = 128;  // q rows per BlockMask tile

struct FlexParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* nb;
  const int* idx;
  const int* full;
  const int* lens;
  int B, H, Hkv, Q, K, nq, max_kv, batched, q_blk, kv_blk, q_len, kv_len;
  float scale;
};

// -- the tensor-core tiles ----------------------------------------------------
// The BlockMask row's kv tiles for either tile's layout L, each read as
// spk tiles of L::kBN keys.
template <class L, int VARIANT>
struct FlexTile {
  static constexpr int kPTerms = 1;  // the output is normalised
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const int* idx;   // this q tile's listed kv tiles
  const int* full;
  int row0;         // (b * Hkv + hk) * K: this head's first row in the maps
  int kv_blk, spk;  // kv tile, and tensor-core tiles per kv tile
  int panels;
  uint32_t tx;      // bytes per K/V tile
  int kv_len, plen;
  int n;            // tensor-core tiles of the row: listed kv tiles x spk
  float exp_scale, m_scale;  // scale * log2(e), scale

  __device__ void issue(int i, uint32_t kd, uint32_t vd, uint32_t bar) const {
    const int j = i / spk, ks = (i % spk) * L::kBN;
    const int row = row0 + __ldg(idx + j) * kv_blk + ks;
    ft::mbar_expect_tx(bar, tx);
    for (int c = 0; c < panels; ++c) {
      ft::tma_load_2d(kd + c * L::kStagePanel, tk, bar, L::kPanelCols * c,
                      row);
      ft::tma_load_2d(vd + c * L::kStagePanel, tv, bar, L::kPanelCols * c,
                      row);
    }
  }
  // key: the row's query index, or -1 past q_len (nothing live)
  __device__ int limit(int i, int qrow) const {
    if (qrow < 0) return 0;
    const int j = i / spk, ks = (i % spk) * L::kBN;
    const int k0 = __ldg(idx + j) * kv_blk + ks;
    int lim = min(kv_blk - ks, kv_len - k0);
    if (!__ldg(full + j)) {
      if (VARIANT & 1) lim = min(lim, qrow - k0 + 1);
      if (VARIANT & 2) lim = min(lim, plen - k0);
    }
    return lim;
  }
  // the scale is folded into exp_scale and m_scale
  __device__ bool transform() const { return false; }
  __device__ float score(float x) const { return x; }
};

// The tile of the CTA's q tile (blockIdx.x / halves), head and batch.
template <class L, int D, int VARIANT>
__device__ __forceinline__ FlexTile<L, VARIANT> make_tile(
    const FlexParams& p, const CUtensorMap* tk, const CUtensorMap* tv,
    int qb, uint32_t kbox) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_off = (p.batched ? static_cast<size_t>(b) * p.nq : 0) + qb;
  FlexTile<L, VARIANT> t;
  t.tk = tk;
  t.tv = tv;
  t.idx = p.idx + row_off * p.max_kv;
  t.full = p.full + row_off * p.max_kv;
  t.row0 = (b * p.Hkv + h / (p.H / p.Hkv)) * p.K;
  t.kv_blk = p.kv_blk;
  t.spk = (p.kv_blk + L::kBN - 1) / L::kBN;
  t.panels = D / L::kPanelCols;
  t.tx = 2u * kbox * 128u * t.panels;
  t.kv_len = p.kv_len;
  t.plen = (VARIANT & 2) ? p.lens[b] : 0;
  t.exp_scale = p.scale * ft::kLog2e;
  t.m_scale = p.scale;
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
template <int D, int VARIANT>
__global__ void __launch_bounds__(ft::kThreads, 1)
    flex_fwd_kernel_tc(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FlexParams p, const uint32_t kbox) {
  using L = ft::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const int qb = blockIdx.x, q0 = qb * p.q_blk;
  ft::init_ring<L>(gen, base);
  const FlexTile<L, VARIANT> t = make_tile<L, D, VARIANT>(p, &tk, &tv, qb,
                                                          kbox);
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
template <int D, int VARIANT>
__global__ void __launch_bounds__(f3::kThreads, 1)
    flex_fwd_kernel_tf32(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const FlexParams p, const uint32_t kbox) {
  using L = f3::Layout<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const int halves = p.q_blk > f3::kRows ? 2 : 1;
  const int qb = blockIdx.x / halves, q0 = qb * p.q_blk;
  const int r0 = (blockIdx.x % halves) * f3::kRows;
  ft::init_ring<L>(gen, base);
  const FlexTile<L, VARIANT> t = make_tile<L, D, VARIANT>(p, &tk, &tv, qb,
                                                          kbox);
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

template <int D, int VARIANT>
int launch(int f32, const FlexParams& p, cudaStream_t st) {
  if (f32)
    return launch_tile<f3::Layout<D>, D>(flex_fwd_kernel_tf32<D, VARIANT>, p,
                                         p.q_blk > f3::kRows ? 2 : 1, true,
                                         st);
  return launch_tile<ft::Layout<D>, D>(flex_fwd_kernel_tc<D, VARIANT>, p, 1,
                                       false, st);
}

template <int D>
int dispatch_variant(int f32, int variant, const FlexParams& p,
                     cudaStream_t st) {
  switch (variant) {
    case 0: return launch<D, 0>(f32, p, st);
    case 1: return launch<D, 1>(f32, p, st);
    case 2: return launch<D, 2>(f32, p, st);
    case 3: return launch<D, 3>(f32, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The entry points' shared argument checks and parameter block.
int fill_params(FlexParams* p, int variant, const void* q, const void* k,
                const void* v, void* o, const void* kv_num_blocks,
                const void* kv_indices, const void* is_full, const void* lens,
                int B, int H, int Hkv, int Q, int K, int nq, int max_kv,
                int batched, int q_blk, int kv_blk, int q_len, int kv_len,
                float scale) {
  if (q_blk > kMaxQBlock || ((variant & 2) && lens == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p->q = q;
  p->k = k;
  p->v = v;
  p->o = o;
  p->nb = static_cast<const int*>(kv_num_blocks);
  p->idx = static_cast<const int*>(kv_indices);
  p->full = static_cast<const int*>(is_full);
  p->lens = static_cast<const int*>(lens);
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
int fwd(int f32, int variant, const void* q, const void* k, const void* v,
        void* o, const void* kv_num_blocks, const void* kv_indices,
        const void* is_full, const void* lens, int B, int H, int Hkv, int Q,
        int K, int D, int nq, int max_kv, int batched, int q_blk, int kv_blk,
        int q_len, int kv_len, float scale, void* stream) {
  if (B * H * nq == 0) return 0;
  FlexParams p;
  int bad = fill_params(&p, variant, q, k, v, o, kv_num_blocks, kv_indices,
                        is_full, lens, B, H, Hkv, Q, K, nq, max_kv, batched,
                        q_blk, kv_blk, q_len, kv_len, scale);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: bad = dispatch_variant<64>(f32, variant, p, st); break;
    case 128: bad = dispatch_variant<128>(f32, variant, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and o.
extern "C" int flex_attention_fwd_tc(
    int variant, const void* q, const void* k, const void* v, void* o,
    const void* kv_num_blocks, const void* kv_indices, const void* is_full,
    const void* lens, int B, int H, int Hkv, int Q, int K, int D, int nq,
    int max_kv, int batched, int q_blk, int kv_blk, int q_len, int kv_len,
    float scale, void* stream) {
  return fwd(0, variant, q, k, v, o, kv_num_blocks, kv_indices, is_full,
             lens, B, H, Hkv, Q, K, D, nq, max_kv, batched, q_blk, kv_blk,
             q_len, kv_len, scale, stream);
}

// f32 q, k, v and o.
extern "C" int flex_attention_fwd_tf32(
    int variant, const void* q, const void* k, const void* v, void* o,
    const void* kv_num_blocks, const void* kv_indices, const void* is_full,
    const void* lens, int B, int H, int Hkv, int Q, int K, int D, int nq,
    int max_kv, int batched, int q_blk, int kv_blk, int q_len, int kv_len,
    float scale, void* stream) {
  return fwd(1, variant, q, k, v, o, kv_num_blocks, kv_indices, is_full,
             lens, B, H, Hkv, Q, K, D, nq, max_kv, batched, q_blk, kv_blk,
             q_len, kv_len, scale, stream);
}
