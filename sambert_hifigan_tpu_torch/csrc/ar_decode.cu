// K1: the whole autoregressive mel decode (T steps x L post-norm decoder
// layers) in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces: sambert_hifigan_tpu/ops/pallas/decode_kernel.py, pallas_ar_decode
// (body _decode_kernel), the Pallas TPU mega-kernel of the JAX package.
//
// What it computes, per step t and batch row b (zero start frame):
//   x = bf16(prenet2(bf16(relu(prenet1(bf16(prev_mel)))))) + pe[t]
//   per layer l: fused QKV; k, v -> bf16 cache row t; causal self-attention
//   over cache rows 0..t; LN; cross-attention over the precomputed memory K/V
//   with a -1e9 bias on padded frames; LN; FFN (ReLU); LN (eps 1e-5)
//   prev_mel = mel_proj(bf16(x)) -> out[b, t]
// with the Pallas kernel's rounding points: bf16 weights and matmul inputs,
// f32 accumulation, q scaled by 1/sqrt(dh) before its bf16 cast, each q*k
// product rounded to bf16 before the sum over the head, f32 softmax whose
// probabilities are cast to bf16 before the value product, f32 LayerNorm,
// f32 residual stream.
//
// What bounds it on this card: the T x L chain is serial, and every step
// reads all decoder weights (17.3 MB in bf16 at the default config) and the
// attention K/V.  The weights fit in the 50 MB L2, so after step 0 each step
// is bounded by how fast one SM pulls 17.3 MB out of L2, plus the latency of
// ~100 block-wide barriers per step.  The device-memory bound (each input
// read once) is far below that.
//
// Design: one persistent 512-thread block per batch row runs the whole loop
// (rows are independent, so there is no grid-wide barrier).  The step's
// activations, the FFN hidden vector and the attention scores live in shared
// memory; the weights stream from L2 as 16-byte loads (eight bf16 outputs a
// thread, split-K across thread groups when a matrix is narrow).  KV caches
// and memory K/V live in device memory allocated by the wrapper.  The cache
// is written and read inside this kernel, so it is read with plain loads
// (never the read-only path).  Using one SM per row leaves most of the card
// idle at small batch: spreading a row over a cluster is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;

struct Params {
  const __nv_bfloat16* pw1; const float* pb1;
  const __nv_bfloat16* pw2; const float* pb2;
  const __nv_bfloat16* wqkv; const float* bqkv;
  const __nv_bfloat16* wo; const float* bo;
  const __nv_bfloat16* wcq; const float* bcq;
  const __nv_bfloat16* wco; const float* bco;
  const __nv_bfloat16* w1; const float* b1;
  const __nv_bfloat16* w2; const float* b2;
  const float* ln;  // [L, 3, 2, D]
  const __nv_bfloat16* melw; const float* melb;
  const float* pe;  // [>=T, D]
  const __nv_bfloat16* memk;  // [L, B, S, D]
  const __nv_bfloat16* memv;
  const float* membias;  // [B, S]
  __nv_bfloat16* kcache;  // [L, B, T, D]
  __nv_bfloat16* vcache;
  float* out;  // [B, T, NMEL]
  int B, T, S, L, D, H, FF, NMEL;
};

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

__device__ __forceinline__ void fma8(float* acc, const uint4& raw, float x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] = fmaf(x, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(x, f.y, acc[2 * i + 1]);
  }
}

// out[n] = act(sum_k xin[k] * W[k, n] + bias[n]); W bf16 row-major [K, N],
// N % 8 == 0; xin (shared, already bf16-rounded) and out are shared memory.
// red holds 8 * NT floats of split-K partials.  Ends with a barrier.
__device__ void gemv(const float* xin, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias, int K, int N, float* out,
                     float* red, bool relu) {
  const int P = N / 8;
  const int tid = threadIdx.x;
  const uint4* w8 = reinterpret_cast<const uint4*>(W);
  if (P >= NT) {
    for (int p = tid; p < P; p += NT) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < K; ++k) fma8(acc, __ldg(w8 + (size_t)k * P + p), xin[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[j] + bias[p * 8 + j];
        out[p * 8 + j] = relu ? fmaxf(v, 0.f) : v;
      }
    }
    __syncthreads();
    return;
  }
  const int G = NT / P;
  const int g = tid / P, p = tid % P;
  if (g < G) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = g; k < K; k += G) fma8(acc, __ldg(w8 + (size_t)k * P + p), xin[k]);
#pragma unroll
    for (int j = 0; j < 8; ++j) red[g * N + p * 8 + j] = acc[j];
  }
  __syncthreads();
  for (int n = tid; n < N; n += NT) {
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += red[gg * N + n];
    s += bias[n];
    out[n] = relu ? fmaxf(s, 0.f) : s;
  }
  __syncthreads();
}

// vin[i] = bf16(src[i]) for i < n.  Ends with a barrier.
__device__ void round_into(float* vin, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) vin[i] = rbf(src[i]);
  __syncthreads();
}

// x = LayerNorm(x + y) * scale + bias over D, in f32.  Ends with a barrier.
__device__ void add_layer_norm(float* x, const float* y, const float* sb, int D,
                               float* red) {
  const int c = threadIdx.x;
  float v = c < D ? x[c] + y[c] : 0.f;
  const float mean = block_sum(v, red) / D;
  const float dv = c < D ? v - mean : 0.f;
  const float var = block_sum(dv * dv, red) / D;
  if (c < D) x[c] = dv * rsqrtf(var + 1e-5f) * sb[c] + sb[D + c];
  __syncthreads();
}

// att[c] = sum_s bf16(softmax_s(qs_h . K[s, h] + bias[s]))  * V[s, c] over
// s < n, h = head of channel c.  qs is scaled and bf16-rounded; each q*k
// product is rounded to bf16 before the f32 sum, as the Pallas kernel rounds
// it ahead of its head-group matmul.  K/V rows [n, D] bf16.  sc holds
// H x smax scores.  Ends with a barrier.
__device__ void attention(const float* qs, const __nv_bfloat16* Kr,
                          const __nv_bfloat16* Vr, const float* bias, int n,
                          int D, int H, int smax, float* sc, float* red,
                          float* att) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = D / H, d8 = dh / 8;
  for (int s = tid; s < n; s += NT) {
    const uint4* kr = reinterpret_cast<const uint4*>(Kr + (size_t)s * D);
    const float b = bias ? bias[s] : 0.f;
    for (int h = 0; h < H; ++h) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c8 = h * d8; c8 < (h + 1) * d8; ++c8) {
        uint4 raw = kr[c8];
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(hv[i]);
          acc[2 * i] += rbf(qs[c8 * 8 + 2 * i] * f.x);
          acc[2 * i + 1] += rbf(qs[c8 * 8 + 2 * i + 1] * f.y);
        }
      }
      float a = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
      sc[h * smax + s] = a + b;
    }
  }
  __syncthreads();
  for (int h = warp; h < H; h += NW) {
    float* row = sc + h * smax;
    float m = __int_as_float(0xff800000);  // -inf
    for (int s = lane; s < n; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < n; s += 32) row[s] = rbf(row[s] / sum);
  }
  __syncthreads();
  const int G = NT / D;
  const int g = tid / D, c = tid % D;
  if (g < G) {
    const float* row = sc + (c / dh) * smax;
    float a = 0.f;
    for (int s = g; s < n; s += G) a = fmaf(row[s], __bfloat162float(Vr[(size_t)s * D + c]), a);
    red[g * D + c] = a;
  }
  __syncthreads();
  for (int cc = tid; cc < D; cc += NT) {
    float a = 0.f;
    for (int gg = 0; gg < G; ++gg) a += red[gg * D + cc];
    att[cc] = a;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) ar_decode_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, FF = p.FF, NMEL = p.NMEL, H = p.H, T = p.T, S = p.S;
  const int smax = T > S ? T : S;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int wide = max(max(3 * D, FF), D);
  float* x = smem;
  float* tmp = x + D;
  float* vin = tmp + wide;
  float* qs = vin + max(max(FF, D), NMEL);
  float* att = qs + D;
  float* prev = att + D;
  float* lnred = prev + NMEL;
  float* red = lnred + NW;
  float* sc = red + 8 * NT;

  const float sqrt_dh = sqrtf((float)(D / H));
  const float* bias_b = p.membias + (size_t)b * S;
  for (int i = tid; i < NMEL; i += NT) prev[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // prenet + positional encoding
    round_into(vin, prev, NMEL);
    gemv(vin, p.pw1, p.pb1, NMEL, D, tmp, red, true);
    round_into(vin, tmp, D);
    gemv(vin, p.pw2, p.pb2, D, D, x, red, false);
    for (int c = tid; c < D; c += NT) x[c] += p.pe[(size_t)t * D + c];
    __syncthreads();

    for (int l = 0; l < p.L; ++l) {
      const size_t lb = (size_t)l * p.B + b;
      __nv_bfloat16* kc = p.kcache + lb * T * D;
      __nv_bfloat16* vc = p.vcache + lb * T * D;
      const float* ln = p.ln + (size_t)l * 6 * D;
      // self-attention over the cache, this step's K/V written first
      round_into(vin, x, D);
      gemv(vin, p.wqkv + (size_t)l * D * 3 * D, p.bqkv + (size_t)l * 3 * D, D, 3 * D, tmp, red, false);
      for (int c = tid; c < D; c += NT) {
        kc[(size_t)t * D + c] = __float2bfloat16(tmp[D + c]);
        vc[(size_t)t * D + c] = __float2bfloat16(tmp[2 * D + c]);
        qs[c] = rbf(tmp[c] / sqrt_dh);
      }
      __syncthreads();
      attention(qs, kc, vc, nullptr, t + 1, D, H, smax, sc, red, att);
      round_into(vin, att, D);
      gemv(vin, p.wo + (size_t)l * D * D, p.bo + (size_t)l * D, D, D, tmp, red, false);
      add_layer_norm(x, tmp, ln, D, lnred);
      // cross-attention over the memory
      round_into(vin, x, D);
      gemv(vin, p.wcq + (size_t)l * D * D, p.bcq + (size_t)l * D, D, D, tmp, red, false);
      for (int c = tid; c < D; c += NT) qs[c] = rbf(tmp[c] / sqrt_dh);
      __syncthreads();
      attention(qs, p.memk + lb * S * D, p.memv + lb * S * D, bias_b, S, D, H, smax, sc, red, att);
      round_into(vin, att, D);
      gemv(vin, p.wco + (size_t)l * D * D, p.bco + (size_t)l * D, D, D, tmp, red, false);
      add_layer_norm(x, tmp, ln + 2 * D, D, lnred);
      // feed-forward
      round_into(vin, x, D);
      gemv(vin, p.w1 + (size_t)l * D * FF, p.b1 + (size_t)l * FF, D, FF, tmp, red, true);
      round_into(vin, tmp, FF);
      gemv(vin, p.w2 + (size_t)l * FF * D, p.b2 + (size_t)l * D, FF, D, tmp, red, false);
      add_layer_norm(x, tmp, ln + 4 * D, D, lnred);
    }
    round_into(vin, x, D);
    gemv(vin, p.melw, p.melb, D, NMEL, prev, red, false);
    for (int i = tid; i < NMEL; i += NT) p.out[((size_t)b * T + t) * NMEL + i] = prev[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ar_decode_launch(
    const void* pw1, const void* pb1, const void* pw2, const void* pb2,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* wcq, const void* bcq, const void* wco, const void* bco,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln, const void* melw, const void* melb, const void* pe,
    const void* memk, const void* memv, const void* membias,
    void* kcache, void* vcache, void* out,
    int B, int T, int S, int L, int D, int H, int FF, int NMEL, void* stream) {
  Params p;
  p.pw1 = static_cast<const __nv_bfloat16*>(pw1); p.pb1 = static_cast<const float*>(pb1);
  p.pw2 = static_cast<const __nv_bfloat16*>(pw2); p.pb2 = static_cast<const float*>(pb2);
  p.wqkv = static_cast<const __nv_bfloat16*>(wqkv); p.bqkv = static_cast<const float*>(bqkv);
  p.wo = static_cast<const __nv_bfloat16*>(wo); p.bo = static_cast<const float*>(bo);
  p.wcq = static_cast<const __nv_bfloat16*>(wcq); p.bcq = static_cast<const float*>(bcq);
  p.wco = static_cast<const __nv_bfloat16*>(wco); p.bco = static_cast<const float*>(bco);
  p.w1 = static_cast<const __nv_bfloat16*>(w1); p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2); p.b2 = static_cast<const float*>(b2);
  p.ln = static_cast<const float*>(ln);
  p.melw = static_cast<const __nv_bfloat16*>(melw); p.melb = static_cast<const float*>(melb);
  p.pe = static_cast<const float*>(pe);
  p.memk = static_cast<const __nv_bfloat16*>(memk);
  p.memv = static_cast<const __nv_bfloat16*>(memv);
  p.membias = static_cast<const float*>(membias);
  p.kcache = static_cast<__nv_bfloat16*>(kcache);
  p.vcache = static_cast<__nv_bfloat16*>(vcache);
  p.out = static_cast<float*>(out);
  p.B = B; p.T = T; p.S = S; p.L = L; p.D = D; p.H = H; p.FF = FF; p.NMEL = NMEL;

  const int wide = std::max(std::max(3 * D, FF), D);
  const int smax = T > S ? T : S;
  const size_t floats = (size_t)D + wide + std::max(std::max(FF, D), NMEL) + 2 * D + NMEL +
                        NW + 8 * NT + (size_t)H * smax;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ar_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ar_decode_kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
