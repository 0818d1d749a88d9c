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
// What bounds it on this card.  An MRF does 2 * 126 * C^2 FLOP per sample
// (18 convs, taps 3+7+11 three times).  At B = 4 and 1024 frames the four
// generator stages (C = 256, 128, 64, 32 over T = 8192 ... 262144) do 0.54,
// 1.08, 0.54 and 0.27 TFLOP: 0.55, 1.09, 0.55 and 0.27 ms at the 989 TFLOP/s
// bf16 peak, against 0.08 to 0.16 ms to read x and write the output once.
// The function is bound by operations; what a design adds is its own
// traffic.  An intermediate that leaves the chip costs 134 MB per f32 pass
// at stages 1-3 (0.04 ms), and the narrow stages do few FLOP per byte of it
// (2 C^2 k per sample against 2-12 bytes per channel): there the chains stay
// on chip.  The wide stages do enough per byte that one conv per launch with
// bf16 operands in device memory stays near their FLOP time.
//
// Design.  Every conv is an implicit GEMM on the tensor cores, out[co, t] =
// sum_k W_k[co, :] . A[:, t + k*d - pad], issued as wgmma (bf16 in, f32
// accumulators in registers, both operands read by the tensor cores straight
// from shared memory).  Shared operands are K-major in octet planes (see
// smem_desc): a tap's shift by k*d samples is a shift of the descriptor's
// start address, so every tap of a window is read in place.  Shared memory is
// filled by cp.async, zero-filling what lies outside [0, T).
//
// * C = 32, 64 (chain_kernel, one launch per ResBlock): a block runs the
//   whole ResBlock (6 convs) over a window of E = 24576 / C samples (768 or
//   384) and writes its central tile, E minus the chain's halo on each side
//   (the sum of its convs' half-spans: 12 / 36 / 60 samples for k = 3 / 7 /
//   11).  Samples are the wgmma rows (M = 64), output channels the columns
//   (N = C); each of the three warpgroups owns a third of the window's rows,
//   so the f32 residual stream y stays in its registers through the 6 convs.
//   The conv operands bf16(lrelu(y)) and bf16(lrelu(t1)) live in two shared
//   buffers; the weights stream through two stages of taps (a whole conv at
//   C = 32, four taps at C = 64), the next stage's copy under this one's
//   products.  Device memory sees x read once (plus the halo) and the output
//   summed once per ResBlock: 8 f32 passes per MRF (x read 3 times, the
//   output written 3 times and read twice), against about 50 when every
//   conv went through device memory.  What is left is the weights, re-read
//   from L2 for every window (the larger the window, the fewer times), and
//   the latency of the block's serial phases (input, 6 epilogues, output):
//   one block per SM, as y and the accumulators take most of the registers.
// * C % 64 == 0, C >= 128 (conv_kernel, 18 launches after one transposing
//   pass): one warpgroup computes 64 output channels (the rows) x 256
//   samples (N = 256) of one conv, two blocks per SM.  Its stages, each the
//   window rows of 16 input channels and all taps' weights of those channels
//   (packed once per pipeline in exactly this layout, so one stage is one
//   contiguous copy), go through a ring of 2 to 4 with cp.async, several in
//   flight under the products.  Intermediates go through device memory as
//   the bf16 conv operands, time-major [B, T, C], and the f32 y.  t1 is only
//   ever read as bf16(lrelu(t1)), so that form is what conv1 writes.  The
//   epilogue stages the f32 tile in shared memory and reads and writes
//   device memory in whole rows of samples, many loads in flight per thread.
//
// Sequence ends.  Each conv's input must read as zero outside [0, T).  In the
// chain kernel every epilogue that writes a conv operand writes 0 for the
// window rows whose sample lies outside [0, T), and the block input is loaded
// as 0 there; rows beyond the window are zero too.  In the conv kernel the
// operands in device memory hold only [0, T), and the cp.async loads
// zero-fill every row outside it.  Columns near a window's edge hold values
// that are never written out: the valid interval shrinks by each conv's
// half-span, and the halo is their sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SLOPE = 0.1f;
constexpr int MAX_DIL = 8;     // dilations per ResBlock (chain kernel)
constexpr int CHAIN_WG = 3;    // chain_kernel: warpgroups
constexpr int CHAIN_NT = 128 * CHAIN_WG;
constexpr int CONV_NT = 128;   // conv_kernel: one warpgroup
constexpr int CONV_BM = 64;    // conv_kernel: output channels per block
constexpr int CONV_BN = 256;   // conv_kernel: output samples per block
constexpr int CONV_KC = 16;    // conv_kernel: input channels per stage

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : SLOPE * v; }
__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; the destination is zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Shared memory written by threads (cp.async or st.shared) becomes visible to
// the tensor cores' asynchronous reads after this fence and a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// ties the accumulators to this point, so that no read of them moves above a
// wgmma.wait_group (or a write of them below a wgmma)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle.  The operand is stored
// K-major in "octet planes": plane p holds input channels [8p, 8p + 8) of
// every row as 16 contiguous bytes, so a core matrix (8 rows x 16 bytes) is
// 128 contiguous bytes.  lbo: bytes between planes (the K direction); sbo:
// bytes between groups of 8 rows (128).  A start one row further down is 16
// bytes further on: a conv tap's shift is a change of the start address.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D[64 x N] += A[64 x 16] . B[N x 16]^T, f32 accumulators, A and B bf16 in
// shared memory.  Thread (warp w of the warpgroup, lane = 4g + q) holds, for
// n8 block j, d[4j + e] = D[16w + g + 8(e >> 1)][8j + 2q + (e & 1)].
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ---- C = 32, 64: one ResBlock per launch, chained on chip ------------------

struct ChainArgs {
  const float* x;           // [B, C, T] block input
  const bf16* w;            // this ResBlock's 2*ndil convs, each [K][C][C]
  const float* bias;        // [2*ndil][C]
  float* out;               // [B, C, T] sum over ResBlocks, then the mean
  int T, K, ndil, tile, halo, padr, first, last, nrb;
  int dils[MAX_DIL];
};

__host__ __device__ constexpr int chain_window(int C) { return CHAIN_WG * 8192 / C; }
// taps per weight stage: a whole conv (k <= 11) at C = 32, four at C = 64
__host__ __device__ constexpr int chain_taps(int C) { return C == 32 ? 11 : 4; }

// two operand buffers [C/8][E + 2 padr][8] and two weight stages
// [taps][C/8][C][8], bf16
__host__ __device__ inline size_t chain_smem(int C, int padr) {
  return (2 * (size_t)(chain_window(C) + 2 * padr) * C + 2 * (size_t)chain_taps(C) * C * C) *
         sizeof(bf16);
}

template <int C>
__device__ __forceinline__ void wgmma_c(float (&d)[C / 2], uint64_t da, uint64_t db) {
  if constexpr (C == 32) wgmma_n32(d, da, db); else wgmma_n64(d, da, db);
}

// Rows are samples (M = 64 per wgmma), columns are output channels (N = C).
// Warpgroup wg owns window rows [wg WR, (wg + 1) WR), WR = E / CHAIN_WG, as
// MTL tiles of 64.
template <int C>
__global__ void __launch_bounds__(CHAIN_NT, 1) chain_kernel(ChainArgs a) {
  constexpr int E = chain_window(C), WR = E / CHAIN_WG, MTL = WR / 64, NR = C / 2;
  constexpr int TPS = chain_taps(C);
  constexpr int WSTAGE = TPS * C * C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = E + 2 * a.padr;
  bf16* opx = reinterpret_cast<bf16*>(smem);  // bf16(lrelu(y)); row padr + j = window column j
  bf16* opt = opx + C * rows;                 // bf16(lrelu(t1))
  bf16* wbuf = opt + C * rows;                // two stages of TPS taps

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, T = a.T, K = a.K;
  const int ts = blockIdx.x * a.tile - a.halo;         // sample of window column 0
  const int row0 = (warp >> 2) * WR + (warp & 3) * 16 + g;  // this thread's first row
  const int n_convs = 2 * a.ndil;
  auto at = [&](bf16* buf, int j, int co) { return buf + ((co >> 3) * rows + a.padr + j) * 8 + (co & 7); };

  // weight stage: taps [k0, k0 + TPS) of conv cv, as [tap][C/8][C][8]
  auto load_stage = [&](int cv, int k0, int buf) {
    const int n = min(TPS, K - k0);
    const bf16* src = a.w + ((size_t)cv * K + k0) * C * C;
    bf16* dst = wbuf + buf * WSTAGE;
    for (int i = tid; i < n * C * C / 8; i += CHAIN_NT) {
      const int r = i / (C / 8), h = i - r * (C / 8), k = r / C, co = r - k * C;
      cp_async16(dst + ((k * (C / 8) + h) * C + co) * 8, src + (size_t)r * C + h * 8, true);
    }
    cp_commit();
  };
  load_stage(0, 0, 0);

  // the biases, read by the epilogues from shared memory (a global load
  // there would wait behind the epilogue's shared stores)
  __shared__ float sbias[2 * MAX_DIL * C];
  for (int i = tid; i < n_convs * C; i += CHAIN_NT) sbias[i] = __ldg(a.bias + i);

  // rows beyond the window read as zero
  for (int i = tid; i < (C / 8) * a.padr; i += CHAIN_NT) {
    const int p = i / a.padr, r = i - p * a.padr;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(opx + (p * rows + r) * 8) = zero;
    *reinterpret_cast<uint4*>(opt + (p * rows + r) * 8) = zero;
    *reinterpret_cast<uint4*>(opx + (p * rows + a.padr + E + r) * 8) = zero;
    *reinterpret_cast<uint4*>(opt + (p * rows + a.padr + E + r) * 8) = zero;
  }

  // the block input bf16(x), zero outside [0, T); every load is issued
  // before any store, which the compiler could not move a load past
  float y[MTL][NR];
  const float* xb = a.x + (size_t)b * C * T;
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int t = ts + row0 + mt * 64 + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q + (i & 1);
      y[mt][i] = (t >= 0 && t < T) ? bf16r(__ldg(xb + (size_t)co * T + t)) : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int i = 0; i < NR; i += 2) {
      const int j = row0 + mt * 64 + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(at(opx, j, co)) =
          __floats2bfloat162_rn(lrelu(y[mt][i]), lrelu(y[mt][i + 1]));
    }

  int buf = 0;
  float acc[MTL][NR];
  for (int cv = 0; cv < n_convs; ++cv) {
    const bool second = cv & 1;
    const int dd = second ? 1 : a.dils[cv >> 1];
    const int pad = (K - 1) * dd / 2;
    const bf16* src = second ? opt : opx;
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[mt][i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TPS, buf ^= 1) {
      cp_wait_all();
      fence_async_smem();
      wg_wait<0>();
      __syncthreads();  // this stage and the operand have landed; no wgmma reads the other stage
      if (k0 + TPS < K)
        load_stage(cv, k0 + TPS, buf ^ 1);
      else if (cv + 1 < n_convs)
        load_stage(cv + 1, 0, buf ^ 1);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) fence_regs(acc[mt]);
      const int n = min(TPS, K - k0);
      for (int k = 0; k < n; ++k) {
        const bf16* wk = wbuf + buf * WSTAGE + k * C * C;
        const bf16* ak = src + (a.padr + (warp >> 2) * WR + (k0 + k) * dd - pad) * 8;
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks)
#pragma unroll
          for (int mt = 0; mt < MTL; ++mt)
            wgmma_c<C>(acc[mt], smem_desc(ak + (2 * ks * rows + mt * 64) * 8, rows * 16),
                       smem_desc(wk + 2 * ks * C * 8, C * 16));
      }
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt) fence_regs(acc[mt]);

    const bool last_conv = cv == n_convs - 1;
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
      for (int i = 0; i < NR; i += 2) {
        const int j = row0 + mt * 64 + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q;
        const bool inside = ts + j >= 0 && ts + j < T;
        const float v0 = acc[mt][i] + sbias[cv * C + co], v1 = acc[mt][i + 1] + sbias[cv * C + co + 1];
        if (!second) {
          *reinterpret_cast<__nv_bfloat162*>(at(opt, j, co)) =
              inside ? __floats2bfloat162_rn(lrelu(v0), lrelu(v1)) : __floats2bfloat162_rn(0.f, 0.f);
        } else {
          y[mt][i] += v0;
          y[mt][i + 1] += v1;
          if (!last_conv)
            *reinterpret_cast<__nv_bfloat162*>(at(opx, j, co)) =
                inside ? __floats2bfloat162_rn(lrelu(y[mt][i]), lrelu(y[mt][i + 1]))
                       : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
  }

  // the window's central tile: the running sum over ResBlocks, then the
  // mean; the earlier sum is loaded whole before any store
  float* ob = a.out + (size_t)b * C * T;
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int j = row0 + mt * 64 + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q + (i & 1);
      const bool mine = j >= a.halo && j < a.halo + a.tile && ts + j < T;
      acc[mt][i] = (mine && !a.first) ? ob[(size_t)co * T + ts + j] : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int j = row0 + mt * 64 + 8 * ((i >> 1) & 1), co = 8 * (i >> 2) + 2 * q + (i & 1);
      if (j < a.halo || j >= a.halo + a.tile || ts + j >= T) continue;
      float v = acc[mt][i] + y[mt][i];
      if (a.last) v = v / (float)a.nrb;
      ob[(size_t)co * T + ts + j] = v;
    }
}

// ---- C % 64 == 0, C >= 128: one conv per launch ----------------------------

enum Mode { kConv1 = 0, kConv2 = 1, kConv2Last = 2 };

struct ConvArgs {
  const bf16* src;    // [B, T, C] conv operand, bf16(lrelu(.)), time-major
  const bf16* w;      // [C/64][C/16][K][2][64][8]: per (co tile, input slice), a stage's weights
  const float* bias;  // [C]
  const float* res;   // [B, C, T] residual y (kConv2, kConv2Last); x when round_res
  float* y;           // [B, C, T] new y (kConv2)
  float* out;         // [B, C, T] MRF sum, then mean (kConv2Last)
  bf16* dst;          // [B, T, C] next conv operand (kConv1: t1, kConv2: y)
  int C, T, K, dil, mode, round_res, first, last, nrb;
};

// Shared memory: a ring of 2 to 4 stages, each the window rows [t0 - pad,
// t0 + BN + pad) of 16 input channels ([2][ew][8]) and all taps' weights of
// those channels ([K][2][BM][8]), as many as fit in half an SM's shared
// memory (two blocks per SM); reused after the main loop for the f32
// [BM][BN + 1] output tile through which the epilogue reads and writes
// device memory in whole rows.
constexpr size_t CONV_SMEM_HALF = 113 * 1024;
__host__ __device__ inline size_t conv_stage(int K, int dil) {
  return (size_t)(CONV_BN + (K - 1) * dil + K * CONV_BM) * CONV_KC * sizeof(bf16);
}
__host__ __device__ inline int conv_depth(int K, int dil) {
  const size_t d = CONV_SMEM_HALF / conv_stage(K, dil);
  return d < 2 ? 2 : d > 4 ? 4 : (int)d;
}
__host__ __device__ inline size_t conv_smem(int K, int dil) {
  const size_t ring = conv_depth(K, dil) * conv_stage(K, dil);
  const size_t ep = (size_t)CONV_BM * (CONV_BN + 1) * sizeof(float);
  return ring > ep ? ring : ep;
}

// One warpgroup: output channels are the rows (M = 64), samples the columns
// (N = 256), one wgmma per (input slice, tap).
template <int DEPTH>
__global__ void __launch_bounds__(CONV_NT, 2) conv_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int C = a.C, T = a.T, K = a.K, dil = a.dil;
  const int pad = (K - 1) * dil / 2, ew = CONV_BN + 2 * pad;
  const size_t stage = conv_stage(K, dil) / sizeof(bf16);
  const int t0 = blockIdx.x * CONV_BN, co0 = blockIdx.y * CONV_BM, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* srcb = a.src + (size_t)b * T * C;

  // stage q: input channels [16q, 16q + 16); window rows outside [0, T) are
  // zero-filled.  One cp.async group per stage, empty past the last.
  const int nq = C / CONV_KC;
  auto load_stage = [&](int q) {
    if (q < nq) {
      bf16* act = sm + (q % DEPTH) * stage;
      bf16* ws = act + ew * CONV_KC;
      for (int i = tid; i < ew * 2; i += CONV_NT) {
        const int r = i >> 1, h = i & 1, t = t0 - pad + r;
        const bool ok = t >= 0 && t < T;
        cp_async16(act + (h * ew + r) * 8, srcb + (size_t)(ok ? t : 0) * C + q * CONV_KC + h * 8, ok);
      }
      const bf16* wsrc = a.w + ((size_t)blockIdx.y * nq + q) * K * 2 * CONV_BM * 8;
      for (int i = tid; i < K * 2 * CONV_BM; i += CONV_NT) cp_async16(ws + i * 8, wsrc + i * 8, true);
    }
    cp_commit();
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int q = 0; q < DEPTH - 1; ++q) load_stage(q);
  wg_fence();
  fence_regs(acc);
  for (int q = 0; q < nq; ++q) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(DEPTH - 2) : "memory");
    fence_async_smem();
    __syncthreads();  // stage q has landed
    const bf16* act = sm + (q % DEPTH) * stage;
    const bf16* ws = act + ew * CONV_KC;
    for (int k = 0; k < K; ++k)
      wgmma_n256(acc, smem_desc(ws + k * 2 * CONV_BM * 8, CONV_BM * 16),
                 smem_desc(act + k * dil * 8, ew * 16));
    wg_commit();
    wg_wait<1>();  // the products of stage q - 1 are done: its buffer may be refilled
    load_stage(q + DEPTH - 1);
  }
  wg_wait<0>();
  fence_regs(acc);
  cp_wait_all();
  __syncthreads();  // the ring is free: reuse it for the output tile

  // the tile, f32 [co][t], bias added
  constexpr int FLD = CONV_BN + 1, R = 32;
  float* F = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int col = warp * 16 + g + 8 * e2;
    const float bv = __ldg(a.bias + co0 + col);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      F[col * FLD + 8 * j + 2 * tq] = acc[4 * j + 2 * e2] + bv;
      F[col * FLD + 8 * j + 2 * tq + 1] = acc[4 * j + 2 * e2 + 1] + bv;
    }
  }
  __syncthreads();

  // conv2: y = residual + tile, in whole rows of samples, R per thread
  // loaded before any is stored (the compiler may not move a load past a
  // store that could alias it)
  if (a.mode != kConv1) {
    const size_t rowb = ((size_t)b * C + co0) * T;
    for (int base = tid; base < CONV_BM * CONV_BN; base += CONV_NT * R) {
      float res[R], prev[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int idx = base + j * CONV_NT, co = idx / CONV_BN, t = t0 + idx % CONV_BN;
        const bool ok = idx < CONV_BM * CONV_BN && t < T;
        const size_t o = rowb + (size_t)co * T + t;
        res[j] = ok ? a.res[o] : 0.f;
        prev[j] = (ok && a.mode == kConv2Last && !a.first) ? a.out[o] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int idx = base + j * CONV_NT, co = idx / CONV_BN, tt = idx % CONV_BN, t = t0 + tt;
        if (idx >= CONV_BM * CONV_BN || t >= T) continue;
        const size_t o = rowb + (size_t)co * T + t;
        const float v = F[co * FLD + tt] + (a.round_res ? bf16r(res[j]) : res[j]);
        if (a.mode == kConv2Last) {
          float s = prev[j] + v;
          if (a.last) s = s / (float)a.nrb;
          a.out[o] = s;
        } else {
          a.y[o] = v;
          F[co * FLD + tt] = v;
        }
      }
    }
    if (a.mode == kConv2Last) return;
    __syncthreads();
  }

  // the next conv's operand bf16(lrelu(.)), time-major: 8 channels (16
  // bytes) per thread, 8 threads per sample row
  bf16* dstb = a.dst + (size_t)b * T * C;
  for (int i = tid; i < CONV_BN * (CONV_BM / 8); i += CONV_NT) {
    const int row = i / (CONV_BM / 8), c8 = i - row * (CONV_BM / 8), t = t0 + row;
    if (t >= T) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(lrelu(F[(c8 * 8 + j) * FLD + row]));
    *reinterpret_cast<uint4*>(dstb + (size_t)t * C + co0 + c8 * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

// x [B, C, T] f32 -> bf16(lrelu(bf16(x))) [B, T, C], through a 32 x 32 tile
__global__ void operand_kernel(const float* __restrict__ x, bf16* __restrict__ op, int C, int T) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, t0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + tx;
    tile[i][tx] = t < T ? x[((size_t)b * C + c0 + i) * T + t] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + i;
    if (t < T) op[((size_t)b * T + t) * C + c0 + tx] = __float2bfloat16(lrelu(bf16r(tile[tx][i])));
  }
}

int chain_launch(const float* x, const bf16* w, const float* bias, float* out, int B, int C, int T,
                 int nrb, int ndil, const int* ks, const int* dils, const int* tiles,
                 const int* smems, cudaStream_t stream) {
  if (ndil > MAX_DIL) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < nrb; ++r) {
    const int K = ks[r];
    ChainArgs a = {x, w, bias, out, T, K, ndil, 0, 0, 0, r == 0, r == nrb - 1, nrb, {}};
    for (int i = 0; i < ndil; ++i) {
      const int p = (K - 1) * dils[i] / 2;
      a.dils[i] = dils[i];
      a.halo += p + (K - 1) / 2;
      a.padr = p > a.padr ? p : a.padr;
    }
    a.tile = tiles[r];
    // the host plan and this file must agree on the layout
    if (a.tile <= 0 || a.tile + 2 * a.halo != chain_window(C) ||
        (size_t)smems[r] != chain_smem(C, a.padr))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((T + a.tile - 1) / a.tile, B);
    cudaError_t err;
    if (C == 32) {
      err = cudaFuncSetAttribute(chain_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smems[r]);
      if (err == cudaSuccess) chain_kernel<32><<<grid, CHAIN_NT, smems[r], stream>>>(a);
    } else {
      err = cudaFuncSetAttribute(chain_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smems[r]);
      if (err == cudaSuccess) chain_kernel<64><<<grid, CHAIN_NT, smems[r], stream>>>(a);
    }
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    w += (size_t)2 * ndil * K * C * C;
    bias += (size_t)2 * ndil * C;
  }
  return (int)cudaSuccess;
}

int conv_launches(const float* x, const bf16* w, const float* bias, float* out, bf16* x0op,
                  bf16* t1op, bf16* yop, float* y, int B, int C, int T, int nrb, int ndil,
                  const int* ks, const int* dils, const int* tiles, const int* smems,
                  cudaStream_t stream) {
  operand_kernel<<<dim3((T + 31) / 32, C / 32, B), dim3(32, 8), 0, stream>>>(x, x0op, C, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + CONV_BN - 1) / CONV_BN, C / CONV_BM, B);
  int n = 0;
  for (int r = 0; r < nrb; ++r) {
    const int K = ks[r];
    for (int i = 0; i < ndil; ++i) {
      const bool first_pair = i == 0, last_pair = i == ndil - 1;
      const bf16* yin = first_pair ? x0op : yop;
      ConvArgs c1 = {yin, w, bias, nullptr, nullptr, nullptr, t1op,
                     C, T, K, dils[i], kConv1, 0, 0, 0, nrb};
      ConvArgs c2 = {t1op, w + (size_t)K * C * C, bias + C, first_pair ? x : y, y, out, yop,
                     C, T, K, 1, last_pair ? kConv2Last : kConv2, first_pair, r == 0,
                     r == nrb - 1, nrb};
      const ConvArgs* pair[2] = {&c1, &c2};
      for (const ConvArgs* c : pair) {
        if (tiles[n] != CONV_BN || (size_t)smems[n] != conv_smem(c->K, c->dil))
          return (int)cudaErrorInvalidValue;
        void (*kernel)(ConvArgs) = conv_depth(c->K, c->dil) == 2   ? conv_kernel<2>
                                   : conv_depth(c->K, c->dil) == 3 ? conv_kernel<3>
                                                                   : conv_kernel<4>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smems[n]);
        if (err != cudaSuccess) return (int)err;
        kernel<<<grid, CONV_NT, smems[n], stream>>>(*c);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        ++n;
      }
      w += (size_t)2 * K * C * C;
      bias += 2 * C;
    }
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One MRF: x [B, C, T] f32 -> out [B, C, T] f32.  w_all holds the 18 convs'
// weights in (ResBlock, dilation, conv1/conv2) order, each packed for its
// kernel (ops/mrf.py: pack_conv_taps at C = 32, 64, pack_conv_tiles
// otherwise), b_all [n_convs, C].  ks[nrb], dils[ndil] are host arrays;
// tiles[] and smems[] hold the host plan's output tile and shared-memory
// bytes per launch (one per ResBlock for C = 32, 64; one per conv
// otherwise), checked here against this file's own layout.  x0op, t1op, yop
// ([B, T, C] bf16) and y ([B, C, T] f32) are scratch of the per-conv route,
// unused by the chain.
extern "C" int mrf_launch(const void* x, const void* w_all, const void* b_all, void* out,
                          void* x0op, void* t1op, void* yop, void* y,
                          int B, int C, int T, int nrb, int ndil,
                          const int* ks, const int* dils, const int* tiles, const int* smems,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* fx = static_cast<const float*>(x);
  const bf16* w = static_cast<const bf16*>(w_all);
  const float* bias = static_cast<const float*>(b_all);
  float* fout = static_cast<float*>(out);
  if (C == 32 || C == 64)
    return chain_launch(fx, w, bias, fout, B, C, T, nrb, ndil, ks, dils, tiles, smems, stream);
  if (C % CONV_BM == 0)
    return conv_launches(fx, w, bias, fout, static_cast<bf16*>(x0op), static_cast<bf16*>(t1op),
                         static_cast<bf16*>(yop), static_cast<float*>(y), B, C, T, nrb, ndil,
                         ks, dils, tiles, smems, stream);
  return (int)cudaErrorInvalidValue;
}
