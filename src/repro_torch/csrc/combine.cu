// K2: split-K combine for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py::
// _combine_kernel (launcher combine_partials_pallas).  One CUDA block per
// (batch, kv_head); its threads span the G x D outputs and each loops over
// the S splits:
//   m* = max_s m_s,  l* = sum_s l_s e^(m_s - m*),
//   o  = sum_s acc_s e^(m_s - m*) / max(l*, 1e-30), cast to the q dtype.
// All-dead slots (every m = NEG_INF, l = 0) give exact zeros.
//
// What bounds it: it reads the f32 partials once and writes the output
// once, with a handful of flops per element, so it is bound by bytes.  The
// design reads acc with neighbouring threads on neighbouring addresses
// (d is the fastest index), and keeps every intermediate in registers.
#include "common.cuh"

namespace {

template <typename TO>
__global__ void combine_kernel(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               TO* __restrict__ out, int S, int G, int D) {
  const size_t bh = blockIdx.x;
  const float* mb = m + bh * S * G;
  const float* lb = l + bh * S * G;
  const float* ab = acc + bh * S * G * D;
  TO* ob = out + bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = REPRO_NEG_INF;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, mb[s * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < S; ++s) {
      const float c = expf(mb[s * G + g] - mx);
      lsum += lb[s * G + g] * c;
      o += ab[(static_cast<size_t>(s) * G + g) * D + d] * c;
    }
    ob[i] = from_f32<TO>(o / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace

extern "C" int combine_partials(int out_code, const void* m, const void* l,
                                const void* acc, void* out, int B, int Hkv,
                                int S, int G, int D, void* stream) {
  if (B * Hkv == 0) return 0;
  const int threads = min(1024, ((G * D + 31) / 32) * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* ap = static_cast<const float*>(acc);
  switch (out_code) {
    case 0:
      combine_kernel<float><<<B * Hkv, threads, 0, st>>>(
          mp, lp, ap, static_cast<float*>(out), S, G, D);
      break;
    case 1:
      combine_kernel<__nv_bfloat16><<<B * Hkv, threads, 0, st>>>(
          mp, lp, ap, static_cast<__nv_bfloat16*>(out), S, G, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
