// K1: split-K paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _decode_kernel (launcher paged_attention_partials).  One CUDA block per
// (split, kv_head, batch) slot walks the KV tokens of its split through the
// block table, clamped exactly as _blocked_tables clamps it (dense rows: the
// rank never passes the last live page; every id is clamped into the pool),
// and emits the un-normalised online-softmax partials (m, l, acc) in f32.
// An empty split emits (NEG_INF, 0, 0).  Masks as the TPU kernel: liveness
// pos < len, or the ring-slot window mask; softcap; int8 pools times
// kv_scale.
//
// What bounds it: decode reads every live K and V row once and does two
// flops per element read (G = 1 for llama2-7b), so it is a GEMV bound by
// device-memory bandwidth: live K+V bytes / 3.35 TB/s.  The design spends
// its effort on the loads: each K/V row is read with coalesced 16-byte
// vector loads (neighbouring lanes on neighbouring addresses), pages are
// looked up once per tile, and only live tokens are read — dead pages past
// len are never touched.  Scores and the running (m, l) live in shared
// memory; the G x D accumulator stays in registers, split over token
// groups and reduced once at the end.  wgmma/TMA pipelining is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // KV tokens scored per tile

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
  float scale;
  int window;
  float softcap;
  float kv_scale;
  int q_code;  // 0 f32, 1 bf16
};

template <typename TKV, int D, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const DecodeParams p) {
  constexpr int VEC = Vec16<TKV>::N;   // elements per 16-byte load
  constexpr int LPT = D / VEC;         // lanes reading one K/V row
  constexpr int NSG = kThreads / LPT;  // token groups per block
  static_assert(LPT <= 32 && 32 % LPT == 0, "row must fit a warp");

  __shared__ float q_s[G][D];
  __shared__ float sc[G][kTile];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ int page_s[kTile];
  __shared__ float red[NSG * D];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = p.page_size;
  const int L = p.lens[b];

  for (int i = tid; i < G * D; i += kThreads) {
    const size_t off = (static_cast<size_t>(b) * p.Hkv + h) * G * D + i;
    const float x =
        p.q_code == 0
            ? static_cast<const float*>(p.q)[off]
            : __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off]);
    q_s[i / D][i % D] = x * p.scale;
  }
  if (tid < G) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }

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
  const int n_live = max((L + P - 1) / P, 1);

  const int grp = tid / LPT;
  const int lane_in = tid % LPT;
  const int d0 = lane_in * VEC;
  const size_t tok_stride = static_cast<size_t>(p.Hkv) * D;
  const size_t page_stride = static_cast<size_t>(P) * tok_stride;
  const TKV* kbase = static_cast<const TKV*>(p.k) + static_cast<size_t>(h) * D + d0;
  const TKV* vbase = static_cast<const TKV*>(p.v) + static_cast<size_t>(h) * D + d0;
  const float kvs = p.kv_scale > 0.f ? p.kv_scale : 1.f;
  const int* trow = p.tables + static_cast<size_t>(b) * p.max_pages;

  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    // page of every tile token, -1 when the token is dead
    for (int i = tid; i < n; i += kThreads) {
      const int t = t0 + i;
      const int rank = t / P;
      int r = p.window > 0 ? rank : min(rank, n_live - 1);
      r = min(r, p.max_pages - 1);
      const int pg = min(max(trow[r], 0), p.num_pages - 1);
      bool live = true;  // dense: t < L by the range cut above
      if (p.window > 0) {
        const int wrap = ((cur_page - rank) % ring + ring) % ring;
        int pos = (cur_page - wrap) * P + t % P;
        if (pos >= L) pos -= ring * P;
        live = pos >= 0 && pos < L && pos >= L - p.window;
      }
      page_s[i] = live ? pg : -1;
    }
    __syncthreads();

    // scores: LPT lanes per token row, every lane in the loop every pass
    for (int base = 0; base < n; base += NSG) {
      const int i = base + grp;
      const int pg = i < n ? page_s[i] : -1;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (pg >= 0) {
        float kv[VEC];
        load_vec16(kbase + pg * page_stride + ((t0 + i) % P) * tok_stride, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[g] += q_s[g][d0 + e] * kv[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane_in == 0 && i < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float x = part[g] * kvs;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          sc[g][i] = pg >= 0 ? x : REPRO_NEG_INF;
        }
      }
    }
    __syncthreads();

    // online-softmax update of (m, l) per query row; scores -> weights
    for (int g = warp; g < G; g += kWarps) {
      float mx = REPRO_NEG_INF;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[g][i]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float x = sc[g][i];
        const float pe = x > 0.5f * REPRO_NEG_INF ? expf(x - m_new) : 0.f;
        sc[g][i] = pe;
        sum += pe;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + weights . V, token groups in parallel
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
    }
    for (int i = grp; i < n; i += NSG) {
      const int pg = page_s[i];
      if (pg < 0) continue;
      float vv[VEC];
      load_vec16(vbase + pg * page_stride + ((t0 + i) % P) * tok_stride, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pe = sc[g][i] * kvs;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += pe * vv[e];
      }
    }
    __syncthreads();  // page_s / sc are rewritten by the next tile
  }

  const size_t slot = (static_cast<size_t>(b) * p.Hkv + h) * p.S + s;
  if (tid < G) {
    p.m[slot * G + tid] = m_s[tid];
    p.l[slot * G + tid] = l_s[tid];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[grp * D + d0 + e] = acc[g][e];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float x = 0.f;
      for (int j = 0; j < NSG; ++j) x += red[j * D + d];
      p.acc[(slot * G + g) * D + d] = x;
    }
    __syncthreads();
  }
}

template <typename TKV, int D, int G>
void launch(const DecodeParams& p, cudaStream_t st) {
  const dim3 grid(p.S, p.Hkv, p.B);
  paged_decode_kernel<TKV, D, G><<<grid, kThreads, 0, st>>>(p);
}

template <typename TKV, int D>
int dispatch_group(const DecodeParams& p, cudaStream_t st) {
  switch (p.G) {
    case 1: launch<TKV, D, 1>(p, st); return 0;
    case 2: launch<TKV, D, 2>(p, st); return 0;
    case 4: launch<TKV, D, 4>(p, st); return 0;
    case 8: launch<TKV, D, 8>(p, st); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int dispatch_kv(int kv_code, const DecodeParams& p, cudaStream_t st) {
  switch (kv_code) {
    case 0: return dispatch_group<float, D>(p, st);
    case 1: return dispatch_group<__nv_bfloat16, D>(p, st);
    case 2: return dispatch_group<int8_t, D>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_partials(
    int q_code, int kv_code, const void* q, const void* k_pages,
    const void* v_pages, const void* tables, const void* lens, void* m,
    void* l, void* acc, int B, int Hkv, int G, int D, int num_pages,
    int page_size, int max_pages, int ppb, int num_splits, int bps,
    float scale, int window, float softcap, float kv_scale, void* stream) {
  if (B == 0) return 0;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int bad;
  switch (D) {
    case 64: bad = dispatch_kv<64>(kv_code, p, st); break;
    case 128: bad = dispatch_kv<128>(kv_code, p, st); break;
    default: bad = static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
