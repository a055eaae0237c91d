// K4: block-sparse flash attention with FlexAttention semantics, Hopper.
//
// Replaces the TPU kernel repro/kernels/flex_attention/flex_attention.py::
// _flex_kernel (launcher flex_attention_kernel).  One CUDA block per
// (q-tile, head, batch) visits only the kv tiles its BlockMask row lists
// (kv_num_blocks / kv_indices), skips the element mask on is_full tiles,
// reads K/V of head h / G (GQA), runs an online softmax in f32 and
// normalises before the single store in the q dtype.  The mask is a
// compile-time variant: bit 0 causal (k <= q), bit 1 padding (k < lens[b]);
// the q_len / kv_len validity of the padded tiles always applies.  Tiles
// are min(128, Q) x min(128, K): not powers of two in general, so both the
// q rows and the kv sub-tiles are masked at their ragged edge.
//
// What bounds it: for prompts of hundreds of tokens and more, the q.K and
// p.V products (4 Q K D flops per head, halved by the causal mask) far
// outweigh the bytes, so it is bound by operations.  Two routes, chosen by
// the wrapper from the dtype alone:
//
// - bf16 (the engine's dtype): flex_fwd_kernel_tc, the shared tensor-core
//   tile of flash_tc.cuh (wgmma for q.K and p.V, K/V by TMA into a
//   three-stage ring).  One 2-D tensor map over (B * Hkv * K, D) rows serves
//   each of K and V, since one head's keys are contiguous; a kv tile of
//   the BlockMask is read in boxes of 128 rows from its first key, and the
//   box's columns past kv_blk (the next kv tile's keys, listed or not) are
//   masked by their index in the tile.  Rows past q_blk are computed and
//   never stored.
// - f32: flex_fwd_kernel, on the CUDA cores (TF32 tensor cores keep about
//   three digits, too few for the f32 contract).  It keeps the operands in
//   shared memory (a 128 x D q tile, 32-row K/V sub-tiles loaded with
//   16-byte vector loads), rows padded to dodge bank conflicts, and each
//   thread's half of an output row in registers.  128-row f32 tiles need
//   ~113 KB of shared memory, above the 48 KB default, hence
//   cudaFuncAttributeMaxDynamicSharedMemorySize.
#include "common.cuh"
#include "flash_tc.cuh"

namespace ft = flash_tc;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // max q rows per block: two threads per row
constexpr int KT = 32;      // kv rows per shared-memory sub-tile
constexpr int KHALF = KT / 2;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * (D + 1) + KT * (D + 1) + KT * D + kRows * (KT + 1));
}

template <typename T, int D, int VARIANT>
__global__ void __launch_bounds__(kThreads) flex_fwd_kernel(const FlexParams p) {
  constexpr int QS = D + 1;
  constexpr int PS = KT + 1;
  constexpr int VEC = Vec16<T>::N;
  constexpr int DH = D / 2;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // kRows x QS, pre-scaled
  float* k_s = q_s + kRows * QS;   // KT x QS
  float* v_s = k_s + KT * QS;      // KT x D
  float* p_s = v_s + KT * D;       // kRows x PS

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qrow = qb * p.q_blk + r;
  const bool row_ok = r < p.q_blk && qrow < p.q_len;

  const T* qg = static_cast<const T*>(p.q) +
                ((static_cast<size_t>(b) * p.H + h) * p.Q +
                 static_cast<size_t>(qb) * p.q_blk) * D;
  const T* kg = static_cast<const T*>(p.k) +
                (static_cast<size_t>(b) * p.Hkv + hk) * p.K * D;
  const T* vg = static_cast<const T*>(p.v) +
                (static_cast<size_t>(b) * p.Hkv + hk) * p.K * D;

  for (int c = tid; c < kRows * (D / VEC); c += kThreads) {
    const int rr = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
    float x[VEC];
    if (rr < p.q_blk) {
      load_vec16(qg + static_cast<size_t>(rr) * D + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[rr * QS + d0 + e] = x[e] * p.scale;
  }

  const size_t row_off = (p.batched ? static_cast<size_t>(b) * p.nq : 0) + qb;
  const int n_blocks = p.nb[row_off];
  const int* idx = p.idx + row_off * p.max_kv;
  const int* full = p.full + row_off * p.max_kv;
  const int plen = (VARIANT & 2) ? p.lens[b] : 0;

  float m_i = REPRO_NEG_INF, l_i = 0.f;
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_blocks; ++j) {
    const int kb = idx[j];
    const bool is_full = full[j] != 0;
    for (int ks = 0; ks < p.kv_blk; ks += KT) {
      const int k0 = kb * p.kv_blk + ks;
      const int nk = min(KT, p.kv_blk - ks);
      __syncthreads();  // previous sub-tile fully consumed
      for (int c = tid; c < KT * (D / VEC); c += kThreads) {
        const int rr = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
        float kx[VEC], vx[VEC];
        if (rr < nk) {
          load_vec16(kg + static_cast<size_t>(k0 + rr) * D + d0, kx);
          load_vec16(vg + static_cast<size_t>(k0 + rr) * D + d0, vx);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[rr * QS + d0 + e] = kx[e];
          v_s[rr * D + d0 + e] = vx[e];
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
        const int kidx = k0 + cc;
        bool live = row_ok && cc < nk && kidx < p.kv_len;
        if (!is_full) {
          if (VARIANT & 1) live = live && kidx <= qrow;
          if (VARIANT & 2) live = live && kidx < plen;
        }
        sv[c] = live ? sv[c] : REPRO_NEG_INF;
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

      // acc = acc * alpha + p . V over this thread's interleaved columns
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= alpha;
      const float* pr = p_s + r * PS;
      for (int c = 0; c < nk; ++c) {
        const float pe = pr[c];
        const float* vr = v_s + c * D + half;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] += pe * vr[2 * i];
      }
    }
  }

  if (r < p.q_blk) {
    T* og = static_cast<T*>(p.o) +
            ((static_cast<size_t>(b) * p.H + h) * p.Q + qrow) * D;
    const float den = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH; ++i) og[2 * i + half] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int D, int VARIANT>
int launch(const FlexParams& p, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flex_fwd_kernel<T, D, VARIANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nq, p.H, p.B);
  flex_fwd_kernel<T, D, VARIANT><<<grid, kThreads, bytes, st>>>(p);
  return 0;
}

template <typename T, int D>
int dispatch_variant(int variant, const FlexParams& p, cudaStream_t st) {
  switch (variant) {
    case 0: return launch<T, D, 0>(p, st);
    case 1: return launch<T, D, 1>(p, st);
    case 2: return launch<T, D, 2>(p, st);
    case 3: return launch<T, D, 3>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dim(int D, int variant, const FlexParams& p, cudaStream_t st) {
  switch (D) {
    case 64: return dispatch_variant<T, 64>(variant, p, st);
    case 128: return dispatch_variant<T, 128>(variant, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- the tensor-core route (bf16) ---------------------------------------------
template <int VARIANT>
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
  float exp_scale, m_scale;  // scale * log2(e), scale

  __device__ void issue(int i, uint32_t kd, uint32_t vd, uint32_t bar) const {
    const int j = i / spk, ks = (i % spk) * ft::kBN;
    const int row = row0 + __ldg(idx + j) * kv_blk + ks;
    ft::mbar_expect_tx(bar, tx);
    for (int c = 0; c < panels; ++c) {
      ft::tma_load_2d(kd + c * ft::kPanelBytes, tk, bar, 64 * c, row);
      ft::tma_load_2d(vd + c * ft::kPanelBytes, tv, bar, 64 * c, row);
    }
  }
  // key: the row's query index, or -1 past q_len (nothing live)
  __device__ int limit(int i, int qrow) const {
    if (qrow < 0) return 0;
    const int j = i / spk, ks = (i % spk) * ft::kBN;
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

template <int D, int VARIANT>
__global__ void __launch_bounds__(ft::kThreads, 1)
    flex_fwd_kernel_tc(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const FlexParams p, const uint32_t kbox) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* gen;
  const uint32_t base = ft::smem_base(tc_smem, &gen);
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qb * p.q_blk;

  ft::init_ring<D>(gen, base);

  const size_t row_off = (p.batched ? static_cast<size_t>(b) * p.nq : 0) + qb;
  FlexTile<VARIANT> t;
  t.tk = &tk;
  t.tv = &tv;
  t.idx = p.idx + row_off * p.max_kv;
  t.full = p.full + row_off * p.max_kv;
  t.row0 = (b * p.Hkv + hk) * p.K;
  t.kv_blk = p.kv_blk;
  t.spk = (p.kv_blk + ft::kBN - 1) / ft::kBN;
  t.panels = D / 64;
  t.tx = 2u * kbox * 128u * (D / 64);
  t.kv_len = p.kv_len;
  t.plen = (VARIANT & 2) ? p.lens[b] : 0;
  t.exp_scale = p.scale * ft::kLog2e;
  t.m_scale = p.scale;
  const int n = p.nb[row_off] * t.spk;
  ft::prefetch<D>(t, base, n);

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            ((static_cast<size_t>(b) * p.H + h) * p.Q + q0) * D;
  for (int c = threadIdx.x; c < ft::kRows * (D / 8); c += ft::kThreads) {
    const int r = c / (D / 8);
    ft::store_q_chunk<D>(
        gen + ft::Layout<D>::kQ, r, c % (D / 8),
        r < p.q_blk ? qg + static_cast<size_t>(r) * D : nullptr);
  }
  ft::q_ready();

  int key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + ft::thread_row(hh);
    key[hh] = qrow < p.q_len ? qrow : -1;
  }
  ft::Acc<D> a;
  ft::mainloop<D>(t, base, n, key, a);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = ft::thread_row(hh);
    if (r >= p.q_blk) continue;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                        ((static_cast<size_t>(b) * p.H + h) * p.Q + q0 + r) * D;
    const float inv = 1.f / fmaxf(a.l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + ft::thread_col(j, 0)) =
          __floats2bfloat162_rn(a.o[4 * j + 2 * hh] * inv,
                                a.o[4 * j + 2 * hh + 1] * inv);
  }
}

template <int D, int VARIANT>
int launch_tc(const FlexParams& p, cudaStream_t st) {
  const uint64_t rows = static_cast<uint64_t>(p.B) * p.Hkv * p.K;
  const uint32_t kbox = static_cast<uint32_t>(
      rows < static_cast<uint64_t>(ft::kBN) ? rows : ft::kBN);
  CUtensorMap tk, tv;
  int bad = ft::encode_bf16_sw128(&tk, p.k, D, rows, D * 2, kbox);
  if (!bad) bad = ft::encode_bf16_sw128(&tv, p.v, D, rows, D * 2, kbox);
  if (bad) return bad;
  constexpr size_t bytes = ft::Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flex_fwd_kernel_tc<D, VARIANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nq, p.H, p.B);
  flex_fwd_kernel_tc<D, VARIANT>
      <<<grid, ft::kThreads, bytes, st>>>(tk, tv, p, kbox);
  return 0;
}

template <int D>
int dispatch_variant_tc(int variant, const FlexParams& p, cudaStream_t st) {
  switch (variant) {
    case 0: return launch_tc<D, 0>(p, st);
    case 1: return launch_tc<D, 1>(p, st);
    case 2: return launch_tc<D, 2>(p, st);
    case 3: return launch_tc<D, 3>(p, st);
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
  if (q_blk > kRows || ((variant & 2) && lens == nullptr))
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

}  // namespace

extern "C" int flex_attention_fwd(
    int dtype_code, int variant, const void* q, const void* k, const void* v,
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
  switch (dtype_code) {
    case 0: bad = dispatch_dim<float>(D, variant, p, st); break;
    case 1: bad = dispatch_dim<__nv_bfloat16>(D, variant, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: bf16 q, k, v and o.
extern "C" int flex_attention_fwd_tc(
    int variant, const void* q, const void* k, const void* v, void* o,
    const void* kv_num_blocks, const void* kv_indices, const void* is_full,
    const void* lens, int B, int H, int Hkv, int Q, int K, int D, int nq,
    int max_kv, int batched, int q_blk, int kv_blk, int q_len, int kv_len,
    float scale, void* stream) {
  if (B * H * nq == 0) return 0;
  FlexParams p;
  int bad = fill_params(&p, variant, q, k, v, o, kv_num_blocks, kv_indices,
                        is_full, lens, B, H, Hkv, Q, K, nq, max_kv, batched,
                        q_blk, kv_blk, q_len, kv_len, scale);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: bad = dispatch_variant_tc<64>(variant, p, st); break;
    case 128: bad = dispatch_variant_tc<128>(variant, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
