// K2: one whole HiFi-GAN multi-receptive-field (MRF) block, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: sambert_hifigan_tpu/ops/pallas/mrf_kernel.py, fused_mrf (body
// _mrf_kernel), called once per upsampling stage by
// sambert_hifigan_tpu/models/fused_generator.py.
//
// What it computes: the flax MRF exactly.  For each ResBlock r (kernel k_r)
// and dilation d in its list:
//   t1 = conv_{k_r, dil d}(bf16(lrelu(y))) + b1;  y = y + conv_{k_r, dil 1}(bf16(lrelu(t1))) + b2
// starting from y = bf16(x); the output is the MEAN over ResBlocks of their
// final y.  Every conv zero-pads its own input at the sequence ends (the
// Pallas kernel zero-pads only the block input, a departure this port does
// not reproduce).  bf16 weights and conv inputs, f32 accumulation, f32
// residual stream and output.
//
// What bounds it on this card: operations.  An MRF is 2 * 126 * C^2 FLOP per
// output sample (18 convs, taps 3+7+11 three times, two convs each), about
// 0.6 TFLOP for one 1024-frame utterance over the four generator stages,
// while its activations are a few hundred MB: far above the bf16 ridge
// point, so the tensor cores must do the products.
//
// Design: one launch per conv (18 per MRF plus one rounding pass), each an
// implicit GEMM on the tensor cores (WMMA 16x16x16 bf16, f32 accumulators):
// out[co, t] = sum_k W_k[co, :] @ A[:, t + k*d - pad].  A block owns a
// 32-channel x 128-sample output tile; per 64-channel input group it stages
// the LeakyReLU'd, bf16-rounded input window (tile + (k-1)*d halo, zero
// outside [0, T)) time-major in 16-channel slabs, so that every tap's shifted
// B fragment is a contiguous, 32-byte-aligned 512-byte read, and stages the
// group's weights (pre-packed as 16x16 tiles) beside it.  The epilogue adds
// bias, residual, and the running ResBlock mean.  Intermediates (bf16(x), y,
// t1) round-trip through device memory between convs: fusing the chains on
// chip is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int CO_T = 32;   // output channels per block
constexpr int T_T = 128;   // output samples per block
constexpr int CI_G = 64;   // input channels staged at a time
constexpr int NT = 256;    // 8 warps: 2 (channels) x 4 (time)
constexpr float SLOPE = 0.1f;

enum Mode { kPlain = 0, kResidual = 1, kFinal = 2 };

struct ConvArgs {
  const float* src;            // [B, C, T] conv input before LeakyReLU
  const __nv_bfloat16* w;      // [C/16][C/16][K][16][16] bf16 tiles (co, ci)
  const float* bias;           // [C]
  const float* res;            // residual [B, C, T] (kResidual, kFinal)
  float* dst;                  // t1 (kPlain) or y (kResidual)
  float* acc;                  // MRF output accumulator (kFinal)
  int C, T, K, dil, mode, first, last, nrb;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

__host__ __device__ inline size_t smem_a_bytes(int cig, int te) {
  return align128((size_t)(cig / 16) * te * 16 * sizeof(__nv_bfloat16));
}
__host__ __device__ inline size_t smem_w_bytes(int cig, int K) {
  return align128((size_t)2 * (cig / 16) * K * 256 * sizeof(__nv_bfloat16));
}
__host__ inline size_t smem_bytes(int C, int K, int dil) {
  const int cig = C < CI_G ? C : CI_G;
  const int te = T_T + (K - 1) * dil;
  return smem_a_bytes(cig, te) + smem_w_bytes(cig, K) + (size_t)CO_T * T_T * sizeof(float);
}

__global__ void __launch_bounds__(NT) conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, T = a.T, K = a.K;
  const int t0 = blockIdx.x * T_T, co0 = blockIdx.y * CO_T, b = blockIdx.z;
  const int span = (K - 1) * a.dil, pad = span / 2;
  const int te = T_T + span;
  const int cig = C < CI_G ? C : CI_G;
  const int nq = cig / 16;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + smem_a_bytes(cig, te));
  float* Cs = reinterpret_cast<float*>(smem + smem_a_bytes(cig, te) + smem_w_bytes(cig, K));

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wc = warp & 1, wt = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const float* srcb = a.src + (size_t)b * C * T;
  const int cchunks = C / 16;

  for (int ci0 = 0; ci0 < C; ci0 += cig) {
    __syncthreads();  // the previous group's fragments are consumed
    for (int idx = tid; idx < cig * te; idx += NT) {
      const int ch = idx / te, j = idx - ch * te;
      const int t = t0 - pad + j;
      float v = 0.f;
      if (t >= 0 && t < T) {
        v = srcb[(size_t)(ci0 + ch) * T + t];
        v = v >= 0.f ? v : SLOPE * v;
      }
      As[((ch >> 4) * te + j) * 16 + (ch & 15)] = __float2bfloat16(v);
    }
    const int piece = K * 32;  // uint4 per (co chunk, ci chunk) tap set
    for (int idx = tid; idx < 2 * nq * piece; idx += NT) {
      const int pc = idx / piece, off = idx - pc * piece;
      const int cc = pc / nq, q = pc - cc * nq;
      const uint4* src = reinterpret_cast<const uint4*>(
          a.w + ((size_t)(co0 / 16 + cc) * cchunks + (ci0 / 16 + q)) * K * 256);
      reinterpret_cast<uint4*>(Ws)[(size_t)pc * piece + off] = __ldg(src + off);
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      for (int q = 0; q < nq; ++q) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, Ws + ((size_t)(wc * nq + q) * K + k) * 256, 16);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, As + ((size_t)q * te + wt * 32 + f * 16 + k * a.dil) * 16, 16);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(Cs + (wc * 16) * T_T + wt * 32 + f * 16, acc[f], T_T, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < CO_T * T_T; idx += NT) {
    const int co = idx / T_T, j = idx - co * T_T;
    const int t = t0 + j;
    if (t >= T) continue;
    const size_t g = ((size_t)b * C + co0 + co) * T + t;
    const float v = Cs[idx] + a.bias[co0 + co];
    if (a.mode == kPlain) {
      a.dst[g] = v;
    } else if (a.mode == kResidual) {
      a.dst[g] = a.res[g] + v;
    } else {
      const float y = a.res[g] + v;
      float o = a.first ? y : a.acc[g] + y;
      if (a.last) o = o / (float)a.nrb;
      a.acc[g] = o;
    }
  }
}

__global__ void round_kernel(const float* __restrict__ x, float* __restrict__ x0, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    x0[i] = __bfloat162float(__float2bfloat16(x[i]));
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One MRF: x [B, C, T] f32 -> out [B, C, T] f32.  w_all holds the 18 packed
// conv weights in (ResBlock, dilation, conv1/conv2) order, b_all [n_convs, C].
// x0, y, t1 are [B, C, T] f32 scratch.  ks[nrb], dils[ndil] are host arrays.
extern "C" int mrf_launch(const void* x, const void* w_all, const void* b_all,
                          void* out, void* x0, void* y, void* t1,
                          int B, int C, int T, int nrb, int ndil,
                          const int* ks, const int* dils, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t n = (size_t)B * C * T;
  round_kernel<<<1024, 256, 0, stream>>>(static_cast<const float*>(x), static_cast<float*>(x0), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  size_t max_smem = 0;
  for (int r = 0; r < nrb; ++r)
    for (int i = 0; i < ndil; ++i) {
      const size_t s = smem_bytes(C, ks[r], dils[i]);
      if (s > max_smem) max_smem = s;
    }
  err = cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((T + T_T - 1) / T_T, C / CO_T, B);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(w_all);
  const float* bias = static_cast<const float*>(b_all);
  float* fx0 = static_cast<float*>(x0);
  float* fy = static_cast<float*>(y);
  float* ft1 = static_cast<float*>(t1);
  for (int r = 0; r < nrb; ++r) {
    const int K = ks[r];
    for (int i = 0; i < ndil; ++i) {
      const float* yin = i == 0 ? fx0 : fy;
      ConvArgs c1 = {yin, w, bias, nullptr, ft1, nullptr, C, T, K, dils[i], kPlain, 0, 0, nrb};
      conv_kernel<<<grid, NT, smem_bytes(C, K, dils[i]), stream>>>(c1);
      w += (size_t)C * C * K;
      bias += C;
      const bool final_pair = i == ndil - 1;
      ConvArgs c2 = {ft1, w, bias, yin, final_pair ? nullptr : fy,
                     final_pair ? static_cast<float*>(out) : nullptr, C, T, K, 1,
                     final_pair ? kFinal : kResidual, r == 0, r == nrb - 1, nrb};
      conv_kernel<<<grid, NT, smem_bytes(C, K, 1), stream>>>(c2);
      w += (size_t)C * C * K;
      bias += C;
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
