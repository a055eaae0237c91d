// K2: split-K combine for Hopper (sm_90a), standalone and strided.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _combine_kernel (launcher combine_partials_pallas).  It merges K3's
// partials m, l (B, Hkv, NQ, S, R) and acc (B, Hkv, NQ, S, R, D), f32, over
// the S splits:
//   m* = max_s m_s,  l* = sum_s l_s e^(m_s - m*),
//   o  = sum_s acc_s e^(m_s - m*) / max(l*, 1e-30), cast to the q dtype,
// and writes row r of Q-block nq as token nq * q_block + r / G, head
// h * G + r % G of the output (B, C, H, D); tokens past C are not written.
// Partials and output are taken by strides, so K1's decode layout (B, Hkv,
// S, G[, D]) into (B, Hkv, G, D) is the case of one Q-block of one token,
// and K3's partials are read where they lie.  All-dead rows (every m =
// NEG_INF, l = 0) give exact zeros; at S = 1 the formula is acc / max(l,
// 1e-30), bit for bit the plain normalise (the arithmetic is pinned with
// __fmaf_rn and __fdiv_rn).
//
// What bounds it: it reads the f32 partials once and writes the output
// once, with a handful of flops per element, so it is bound by bytes
// (3.35 TB/s) at K3's sizes, and by latency at the decode layout (0.5 MB
// at the main shape).  The design for bytes:
// - the rows (b, h, nq, r) in one flat order, a tile of them per CTA: one
//   thread per row loads the row's S values of m and l together, once, and
//   turns them into the weights e^(m_s - m*) and the denominator, kept in
//   shared memory with the row's acc and output offsets, behind one
//   barrier;
// - acc is read in 16-byte vectors (4 columns), neighbouring threads on
//   neighbouring columns of a row, and each output written once (16 bytes
//   of f32, 8 of bf16), where the pointers and strides allow; scalars
//   otherwise;
// - up to 32 rows per CTA, fewer where the rows would give fewer than 128
//   CTAs: K3's main chunk shape (8 rows x 512 tokens, 32 heads, q_block
//   128: 131072 rows) takes 4096 CTAs of 256 threads, the decode layout at
//   the main shape (8 x 32 rows) 128 CTAs of 2 rows, about one per SM.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // rows per CTA, at most
constexpr int kMinCtas = 128;  // CTAs to aim for, at least (132 SMs)
constexpr int kThreads = 256;  // threads per CTA, at most
constexpr int kSmemLimit = 48 * 1024;

struct CombineParams {
  const float* m;
  const float* l;
  const float* acc;
  void* out;
  int Hkv, NQ, S, R, D, G, q_block, C;
  int rows;                  // rows per CTA
  int n_rows;                // B Hkv NQ R
  long long ms[5], as[5];    // strides of m and l, of acc (b, h, nq, s, r)
  long long os[3];           // strides of out (b, token, head)
};

template <typename TO, int VEC>
__device__ __forceinline__ void store(TO* o, const float* x);
template <>
__device__ __forceinline__ void store<float, 4>(float* o, const float* x) {
  *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 4>(__nv_bfloat16* o,
                                                        const float* x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = v;
}
template <>
__device__ __forceinline__ void store<float, 1>(float* o, const float* x) {
  *o = x[0];
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 1>(__nv_bfloat16* o,
                                                        const float* x) {
  *o = __float2bfloat16(x[0]);
}

template <typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const CombineParams p) {
  extern __shared__ long long sm[];
  const int first = blockIdx.x * p.rows;
  const int rows = min(p.rows, p.n_rows - first);
  long long* aoff = sm;                 // [rows]: the row's acc
  long long* ooff = aoff + p.rows;      // [rows]: its output, -1 past C
  float* w = reinterpret_cast<float*>(ooff + p.rows);  // [S][rows]: m, then
                                                       // e^(m_s - m*)
  float* ls = w + p.S * p.rows;         // [S][rows]: l
  float* den = ls + p.S * p.rows;       // [rows]: max(l*, 1e-30)

  // per row: where it lies, m*, the weights of its splits, the denominator
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    int i = first + r;
    const int row = i % p.R;
    i /= p.R;
    const int nq = i % p.NQ;
    i /= p.NQ;
    const int h = i % p.Hkv, b = i / p.Hkv;
    const float* m = p.m + b * p.ms[0] + h * p.ms[1] + nq * p.ms[2] +
                     row * p.ms[4];
    const float* l = p.l + (m - p.m);
    float mx = REPRO_NEG_INF;
#pragma unroll 4
    for (int s = 0; s < p.S; ++s) {
      const float m_s = __ldg(m + s * p.ms[3]);
      w[s * p.rows + r] = m_s;
      ls[s * p.rows + r] = __ldg(l + s * p.ms[3]);
      mx = fmaxf(mx, m_s);
    }
    float lsum = 0.f;
    for (int s = 0; s < p.S; ++s) {
      const float c = expf(w[s * p.rows + r] - mx);
      w[s * p.rows + r] = c;
      lsum = __fmaf_rn(ls[s * p.rows + r], c, lsum);
    }
    den[r] = fmaxf(lsum, 1e-30f);
    aoff[r] = b * p.as[0] + h * p.as[1] + nq * p.as[2] + row * p.as[4];
    const int tok = nq * p.q_block + row / p.G;
    ooff[r] = tok < p.C ? b * p.os[0] + tok * p.os[1] +
                              (h * p.G + row % p.G) * p.os[2]
                        : -1;
  }
  __syncthreads();

  // the tile's outputs, VEC columns per thread
  const int vpr = p.D / VEC;
  TO* out = static_cast<TO*>(p.out);
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, d = (i % vpr) * VEC;
    if (ooff[r] < 0) continue;
    const float* a = p.acc + aoff[r] + d;
    float o[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = 0.f;
    for (int s = 0; s < p.S; ++s) {
      float x[VEC];
      if constexpr (VEC == 4) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(a + s * p.as[3]));
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
        x[0] = __ldg(a + s * p.as[3]);
      }
      const float c = w[s * p.rows + r];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fmaf_rn(x[e], c, o[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __fdiv_rn(o[e], den[r]);
    store<TO, VEC>(out + ooff[r] + d, o);
  }
}

template <typename TO>
int launch(const CombineParams& p, bool vec, cudaStream_t st) {
  const int work = p.rows * (vec ? p.D / 4 : p.D);
  const int threads = min(kThreads, (work + 31) / 32 * 32);
  const size_t smem = (4 + 2 * static_cast<size_t>(p.S) + 1) * p.rows * 4;
  const int grid = (p.n_rows - 1) / p.rows + 1;
  if (vec)
    combine_kernel<TO, 4><<<grid, threads, smem, st>>>(p);
  else
    combine_kernel<TO, 1><<<grid, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" int combine_partials(
    int out_code, const void* m, const void* l, const void* acc, void* out,
    int B, int Hkv, int NQ, int S, int R, int D, int G, int q_block, int C,
    long long m_b, long long m_h, long long m_nq, long long m_s,
    long long m_r, long long a_b, long long a_h, long long a_nq,
    long long a_s, long long a_r, long long o_b, long long o_tok,
    long long o_head, void* stream) {
  if (B == 0 || Hkv == 0 || NQ == 0 || R == 0 || C == 0) return 0;
  if (S < 1 || D < 1 || G < 1 || q_block < 1 || R != q_block * G)
    return static_cast<int>(cudaErrorInvalidValue);
  CombineParams p;
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.acc = static_cast<const float*>(acc);
  p.out = out;
  p.Hkv = Hkv;
  p.NQ = NQ;
  p.S = S;
  p.R = R;
  p.D = D;
  p.G = G;
  p.q_block = q_block;
  p.C = C;
  const long long n_rows = static_cast<long long>(B) * Hkv * NQ * R;
  if (n_rows >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.n_rows = static_cast<int>(n_rows);
  const long long ms[5] = {m_b, m_h, m_nq, m_s, m_r};
  const long long as[5] = {a_b, a_h, a_nq, a_s, a_r};
  const long long os[3] = {o_b, o_tok, o_head};
  for (int i = 0; i < 5; ++i) {
    p.ms[i] = ms[i];
    p.as[i] = as[i];
  }
  for (int i = 0; i < 3; ++i) p.os[i] = os[i];
  // rows per CTA: at most 32, fewer where that leaves under kMinCtas CTAs
  // or where the rows' offsets and weights would pass 48 KB of shared
  // memory
  const int fit = kSmemLimit / 4 / (2 * S + 5);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.rows = min(min(kRows, (p.n_rows - 1) / kMinCtas + 1), fit);
  // 16-byte vectors where every row of acc and of out starts on one
  const int item = out_code == 0 ? 4 : 2;
  bool vec = D % 4 == 0 && aligned(acc, 16) && aligned(out, 4 * item);
  for (int i = 0; i < 5; ++i) vec = vec && as[i] % 4 == 0;
  for (int i = 0; i < 3; ++i) vec = vec && os[i] % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0: return launch<float>(p, vec, st);
    case 1: return launch<__nv_bfloat16>(p, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
