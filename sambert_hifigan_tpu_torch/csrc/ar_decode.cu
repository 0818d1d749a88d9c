// K1: the whole autoregressive mel decode (T steps x L post-norm decoder
// layers) in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces: sambert_hifigan_tpu/ops/pallas/decode_kernel.py, pallas_ar_decode
// (body _decode_kernel), the Pallas TPU mega-kernel of the JAX package.
//
// What it computes, per step t = pos0 .. pos0 + steps - 1 and batch row b
// (one chunk of the decode; the whole decode is the chunk pos0 = 0,
// steps = T, where T is the caches' capacity):
//   x = bf16(prenet2(bf16(relu(prenet1(bf16(prev_mel)))))) + pe[t]
//   per layer l: fused QKV; k, v -> bf16 cache row t; causal self-attention
//   over cache rows 0..t; LN; cross-attention over the precomputed memory K/V
//   with a -1e9 bias on padded frames; LN; FFN (ReLU); LN (eps 1e-5)
//   prev_mel = mel_proj(bf16(x)) -> out[b, t - pos0]
// prev_mel is zero at t = 0 and, at t = pos0 > 0, the carried frame before
// the chunk (the f32 value the previous chunk's mel exchange held).  The
// caches persist between chunks in device memory: a chunk reads rows 0..t
// and writes row t, so chained chunks run the same steps as one launch.
// with the Pallas kernel's rounding points: bf16 weights and matmul inputs,
// f32 accumulation, q scaled by 1/sqrt(dh) before its bf16 cast, each q*k
// product rounded to bf16 before the sum over the head, f32 softmax whose
// probabilities are cast to bf16 before the value product, f32 LayerNorm,
// f32 residual stream.
//
// What bounds it on this card.  The T x L chain is serial, so a step's work
// is what one group of SMs can draw and how often it must wait.  At the
// default config (d 256, 8 heads, d_ff 2048, 6 layers) and B = 4,
// T = S = 1024, one step must read the decoder weights once for all rows
// (17.5 MB bf16), the memory K/V of every row (25.2 MB over all S frames)
// and the self-attention caches (12.6 MB on average over the steps): 55 MB a
// step, 56.6 GB a decode, 16.9 ms at 3.35 TB/s.  Memory frames that are
// padding need not be read: at the main path's 33-59 valid frames a step
// needs about 31 MB (9.6 ms a decode).  Weights, memory and caches (67 MB) do
// not fit the 50 MB L2 together, so each step pulls tens of MB through the
// SMs running it, and every exchange between those SMs is a wait on the
// serial chain.  Measured on an H100 80GB HBM3 (700 W, chip_smoke.py): 294 ms
// at the main path's shape, about 0.29 ms a step, 30 times the stream bound:
// the 75 exchanges a step and the latencies of each phase (L2 round trips,
// the instructions it issues) take most of it; the weights' stream, the
// products and the attention each a minority (PERF.md).
//
// Design, against each of those costs:
// * One launch for the whole batch on thread-block clusters (launch_plan in
//   ops/ar_decode.py).  A cluster of C CTAs (16, one per SM) decodes a group
//   of up to 16 batch rows; groups are independent clusters.
// * The rows of a group share one weight stream.  Each CTA owns 1/C of the
//   output columns of every matrix (w2: 1/C of its K rows).  Its slices are
//   packed once per pipeline, in step order and as mma.sync's 16 x 8 B tiles
//   (ops/ar_decode.py's pack_stream), so a chunk is one contiguous bulk copy
//   (the TMA) into a ring of shared-memory stages, NS - 1 chunks ahead, each
//   completing on its stage's mbarrier: the next sub-layers' weights arrive
//   while the current one computes or attends, and ldmatrix reads them
//   without bank conflicts.
// * Products on the tensor cores: mma.sync.m16n8k16 bf16 -> f32, with the
//   group's rows as M (padded to 16); biases added in f32.
// * Activations cross the cluster through distributed shared memory: after a
//   product every CTA sends its column slice to every peer with st.async,
//   which counts the bytes on the peer's mbarrier, and a token arrival; each
//   CTA waits for its own tokens and bytes.  No cluster-scope release fence
//   is needed, which made a cluster barrier with release and acquire the
//   costliest part of each exchange.  LayerNorm is then computed by every CTA on
//   its own copy.  w2 is split over K (the hidden vector never leaves the CTA
//   that made its slice) and reduced over the cluster: each CTA sums the
//   partials of its channel slice and sends the sums to all.  12 exchanges
//   per layer, 75 per step at L = 6.
// * Attention is split over keys, for every row and head of the group: key
//   tile j (KEY_TILE keys) belongs to CTA j % C.  A CTA scores its keys
//   (each q*k product rounded to bf16 before the f32 sum), sends its local
//   max and sum of exp(s - max) (one exchange), rescales every CTA's pair
//   into the global max m and sum Z, forms p = bf16(exp(s - m) / Z) for its
//   keys (exactly the plain version's rounding point, only f32 sums reorder)
//   and sends its partial value sums to the owners of each channel slice
//   (a second exchange), which sum and send the result to all (a third).
//   The CTA that owns key t writes this step's K/V row to the cache, and only
//   it ever reads that row, so the cache needs no barrier across SMs; it is
//   written and read inside this kernel, so it is read with plain loads
//   (never the read-only path).
// * Fully masked memory is skipped exactly.  At launch start each CTA lists,
//   per row, its memory key tiles holding at least one key whose bias is
//   above -5e8; the others are never read.  When the row has an unmasked key,
//   a masked one contributes exp(-1e9 + O(10) - m) = +0.0 in f32 to every sum,
//   so skipping it leaves every bf16(p) bit for bit as the plain version's.
//   A row whose keys are all masked keeps all its tiles (its softmax is
//   uniform in the Pallas kernel and in the plain version alike).
// * The default decoder's widths on 16-CTA clusters run an instantiation with
//   d, heads and cluster size as constants, so the phases' index arithmetic
//   compiles to shifts; other plans run the same code with them read at run
//   time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

// the geometry that ops/ar_decode.py's launch_plan mirrors
constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int MAX_ROWS = 16;
constexpr int KEY_TILE = 8;
constexpr int STAGE_BYTES = 32768;
constexpr int MAX_WARP_TILES = 4;  // n-tiles of 8 columns per warp and product
constexpr int MAX_D = 512;
constexpr float MASKED = -5e8f;  // a memory key with bias <= this is padding
constexpr int UNSCHEDULABLE = -2;

struct Params {
  const bf16* stream;  // [C][stride]: each CTA's weight slices in step order
  const float *pb1, *pb2, *bqkv, *bo, *bcq, *bco, *b1, *b2;
  const float* ln;  // [L, 3, 2, D]
  const float* melb;
  const float* pe;  // [>=T, D]
  const bf16* memk;  // [L, B, S, D]
  const bf16* memv;
  const float* membias;  // [B, S]
  const float* prev;  // [B, NMEL]: the frame before pos0
  bf16* kcache;  // [L, B, T, D]: T is the capacity
  bf16* vcache;
  float* out;  // [B, steps, NMEL]
  int stride, B, T, S, L, D, H, FF, NMEL;
  int pos0, steps;  // this launch's first step and number of steps
  int C, R, NS;  // cluster size, batch rows per cluster, ring stages
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t al16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline size_t zmax(size_t a, size_t b) { return a > b ? a : b; }

// Columns [c0, c0 + n) of an N-column matrix that CTA `rank` of C computes,
// in whole 8-column tiles.
__host__ __device__ inline void col_split(int N, int rank, int C, int& c0, int& n) {
  const int tiles = N / 8;
  c0 = 8 * (rank * tiles / C);
  n = 8 * ((rank + 1) * tiles / C) - c0;
}

// Warps split a product's n-tiles first (nwn of them, a power of two), the
// K steps over the rest (NW / nwn).
__host__ __device__ inline int warps_on_n(int ncols) {
  int nwn = 1;
  while (nwn * 2 <= imin(ncols / 8, NW)) nwn *= 2;
  return nwn;
}

// split-K partials of a product; none when its warps split only columns
__host__ __device__ inline size_t red_bytes(int ncols, int R) {
  const int nwk = ncols == 0 ? 1 : NW / warps_on_n(ncols);
  return nwk == 1 ? 0 : (size_t)nwk * R * ncols * 4;
}

__host__ __device__ inline int widest(int N, int C) {
  int w = 0;
  for (int r = 0; r < C; ++r) {
    int c0, n;
    col_split(N, r, C, c0, n);
    w = imax(w, n);
  }
  return w;
}

// Shared memory of one CTA, region by region (launch_plan's _smem mirrors it).
struct Layout {
  int lda;     // row stride of the A operand, bf16
  int nloc;    // score slots per (row, head)
  int mtiles;  // memory key tiles per CTA
  int vg;      // key groups of the value pass
  int wd, w3, wff, wm;  // widest column slices of the d-, 3d-, d_ff- and n_mels-wide matrices
  int vb;      // floats of one layer's bias slices
  size_t x, a, xb0, xb1, u, ring, vec, small, total;  // byte offsets, total size
  size_t xbytes;
};

__host__ __device__ inline Layout layout(int T, int S, int L, int D, int H, int FF, int NMEL,
                                         int C, int R, int NS) {
  Layout y;
  y.lda = imax(imax(D, NMEL), FF / C) + 8;
  y.nloc = imax(cdiv(cdiv(T, KEY_TILE), C), cdiv(cdiv(S, KEY_TILE), C)) * KEY_TILE;
  y.mtiles = cdiv(cdiv(S, KEY_TILE), C);
  y.vg = imax(1, NT / (R * D / 8));
  y.wd = widest(D, C);
  y.w3 = widest(3 * D, C);
  y.wff = widest(FF, C);
  y.wm = widest(NMEL, C);
  y.vb = y.w3 + 3 * y.wd + y.wff + D / C;
  y.xbytes = al16(zmax(zmax(4 * R * D, 6 * R * D), zmax(8 * C * R * H, 4 * R * NMEL)));
  const size_t scores = (size_t)4 * R * H * y.nloc + (y.vg > 1 ? (size_t)4 * y.vg * R * D : 0);
  size_t red = zmax(red_bytes(y.wd, R), red_bytes(y.w3, R));
  red = zmax(red, zmax(red_bytes(y.wff, R), zmax(red_bytes(y.wm, R), red_bytes(D, R))));
  const size_t vec = (size_t)4 * (L * 6 * D + L * y.vb + 2 * y.wd + y.wm);
  const size_t small = (size_t)8 * (NS + 2) + (size_t)4 * (R * y.mtiles + R);
  y.x = 0;
  y.a = y.x + al16((size_t)4 * R * D);
  y.xb0 = y.a + al16((size_t)2 * 16 * y.lda);
  y.xb1 = y.xb0 + y.xbytes;
  y.u = y.xb1 + y.xbytes;
  y.ring = y.u + al16(zmax(scores, red));
  y.vec = y.ring + (size_t)NS * STAGE_BYTES;
  y.small = y.vec + al16(vec);
  y.total = y.small + al16(small);
  return y;
}

// ---- primitives ---------------------------------------------------------------

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}


// mbarriers and bulk copies (the tensor memory accelerator, 1-D)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// All CTAs of the cluster meet; stores before it (to any CTA's shared memory)
// are visible to every CTA after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `local`'s counterpart in CTA `rank`'s shared memory.
__device__ __forceinline__ uint32_t mapa(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(local)), "r"(rank));
  return out;
}

// Asynchronous stores into CTA k's shared memory (the counterpart of
// `local`), each counted in bytes on CTA k's counterpart of mbarrier `bar`.
__device__ __forceinline__ void send(const void* local, float2 v, int k, const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          mapa(local, k)),
      "f"(v.x), "f"(v.y), "r"(mapa(bar, k))
      : "memory");
}
__device__ __forceinline__ void send(const void* local, float4 v, int k, const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::
          "r"(mapa(local, k)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mapa(bar, k))
      : "memory");
}
__device__ __forceinline__ void send(const void* local, __nv_bfloat162 v, int k,
                                     const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
          mapa(local, k)),
      "r"(*reinterpret_cast<uint32_t*>(&v)), "r"(mapa(bar, k))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&b)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the weight stream ----------------------------------------------------------

// One CTA's slice of one matrix: K rows of ncols, contiguous in its stream,
// copied in chunks of kc rows.
struct Seg {
  int K, ncols, kc;
};

// The matrices of a step, in the order the step uses them (and the stream
// holds them): 0 prenet1, 1 prenet2, 2 + 6l + {0 wqkv, 1 wo, 2 wcq, 3 wco,
// 4 w1, 5 w2}, 2 + 6L mel.  w2 is split over its K rows, the others over
// their columns.
__host__ __device__ inline Seg seg_desc(int idx, int rank, int L, int D, int FF, int NMEL,
                                        int C) {
  int N, K = D;
  if (idx == 0) {
    N = D;
    K = NMEL;
  } else if (idx == 1) {
    N = D;
  } else if (idx == 2 + 6 * L) {
    N = NMEL;
  } else {
    const int j = (idx - 2) % 6;
    if (j == 5) return Seg{FF / C, D, imin(FF / C, STAGE_BYTES / (2 * D) / 16 * 16)};
    N = j == 0 ? 3 * D : j == 4 ? FF : D;
  }
  int c0, n;
  col_split(N, rank, C, c0, n);
  return Seg{K, n, n > 0 ? imin(K, STAGE_BYTES / (2 * n) / 16 * 16) : K};
}

__device__ __forceinline__ Seg seg_desc(const Params& p, int idx, int rank) {
  return seg_desc(idx, rank, p.L, p.D, p.FF, p.NMEL, p.C);
}

// The ring: thread 0 copies each chunk, contiguous in the CTA's stream, with
// one bulk copy that completes on its stage's mbarrier; every thread
// computes on the chunks that have landed, NS - 1 chunks behind the copies.
struct Ring {
  unsigned char* base;
  uint64_t* bars;        // one per stage
  const bf16* w;         // this CTA's stream
  int consumed, issued;  // chunks
  int pseg, pk0;         // the next chunk to copy: segment and first row
  size_t poff;           // and its offset in the stream
  Seg ps;                // and that segment
  int nseg, rank, NS;
};

__device__ __forceinline__ void ring_issue(Ring& g, const Params& p) {
  const Seg& s = g.ps;
  const int n = imin(s.kc, s.K - g.pk0) * s.ncols;
  if (threadIdx.x == 0) {
    const int slot = g.issued % g.NS;
    mbar_expect_tx(g.bars + slot, 2 * n);
    if (n > 0) bulk_copy(g.base + (size_t)slot * STAGE_BYTES, g.w + g.poff, 2 * n, g.bars + slot);
  }
  ++g.issued;
  g.poff += n;
  g.pk0 += s.kc;
  if (g.pk0 >= s.K) {
    g.pk0 = 0;
    if (++g.pseg == g.nseg) {
      g.pseg = 0;
      g.poff = 0;
    }
    g.ps = seg_desc(p, g.pseg, g.rank);
  }
}

// sum_k A[r][k] W[k][col] (+ bias[col]) for segment `idx`'s slice, handed as
// sink(r, col, float2 of columns col, col + 1, k) for r < nr, once per column
// pair and k < fan (the sink's peers, spread over the threads), after a
// barrier.  A is bf16 in shared memory, [16][lda]; rows >= nr
// hold zeros.  red holds the split-K partials.  The caller's next product
// starts with a barrier.
template <class Sink>
__device__ __forceinline__ void product(Ring& g, const Params& p, int idx, const bf16* A, int lda,
                        const float* bias, float* red, int R, int nr, int fan, Sink sink) {
  const Seg s = seg_desc(p, idx, g.rank);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = s.ncols / 8;
  const int nwn = warps_on_n(s.ncols), nwk = NW / nwn;
  const int wn = warp % nwn, wk = warp / nwn;
  float acc[MAX_WARP_TILES][4];
#pragma unroll
  for (int j = 0; j < MAX_WARP_TILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int nchunks = cdiv(s.K, s.kc);
  for (int ch = 0; ch < nchunks; ++ch) {
    mbar_wait(g.bars + g.consumed % g.NS, (g.consumed / g.NS) & 1);
    __syncthreads();  // this chunk landed; every warp is done with the last one
    ring_issue(g, p);
    const bf16* wc = reinterpret_cast<const bf16*>(
        g.base + (size_t)(g.consumed % g.NS) * STAGE_BYTES);
    ++g.consumed;
    if (nt == 0) continue;
    const int k0 = ch * s.kc, ksteps = imin(s.kc, s.K - k0) / 16;
    for (int ks = wk; ks < ksteps; ks += nwk) {
      uint32_t a[4];
      ldsm_x4(a, A + (lane & 15) * lda + k0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < MAX_WARP_TILES; ++j) {
        const int tile = wn + j * nwn;
        if (tile < nt) {
          uint32_t b[2];
          ldsm_x2_trans(b, wc + ((ks * nt + tile) * 16 + (lane & 15)) * 8);
          mma16816(acc[j], a, b);
        }
      }
    }
  }
  const int gid = lane >> 2, tig = lane & 3;
  if (nwk == 1) {  // every column's sum is in one warp's registers
    __syncthreads();  // no warp reads A any more: a sink may write it
#pragma unroll
    for (int j = 0; j < MAX_WARP_TILES; ++j) {
      const int col = (wn + j * nwn) * 8 + tig * 2;
      if (col >= s.ncols) continue;
      const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
      for (int k = 0; k < fan; ++k) {
        if (gid < nr) sink(gid, col, make_float2(acc[j][0] + b0, acc[j][1] + b1), k);
        if (gid + 8 < nr) sink(gid + 8, col, make_float2(acc[j][2] + b0, acc[j][3] + b1), k);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < MAX_WARP_TILES; ++j) {
    const int col = (wn + j * nwn) * 8 + tig * 2;
    if (col >= s.ncols) continue;
    if (gid < R)
      *reinterpret_cast<float2*>(red + ((size_t)wk * R + gid) * s.ncols + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (gid + 8 < R)
      *reinterpret_cast<float2*>(red + ((size_t)wk * R + gid + 8) * s.ncols + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int half = s.ncols / 2;
  for (int e = threadIdx.x; e < nr * half * fan; e += NT) {  // peer-major: lanes share a peer
    const int k = e / (nr * half), i = e - k * (nr * half), r = i / half, col = 2 * (i - r * half);
    float2 v = make_float2(0.f, 0.f);
    for (int q = 0; q < nwk; ++q) {
      const float2 w = *reinterpret_cast<const float2*>(red + ((size_t)q * R + r) * s.ncols + col);
      v.x += w.x;
      v.y += w.y;
    }
    if (bias) {
      v.x += bias[col];
      v.y += bias[col + 1];
    }
    sink(r, col, v, k);
  }
}

// ---- the cluster's exchanges ---------------------------------------------------

// Shared state of one CTA.  Exchange i lands in buffer i & 1 and is counted
// on mbarrier xbar[i & 1]: every CTA sends its data with st.async and a
// token arrival to every peer, and each CTA waits for its tokens and for the
// bytes it expects.  The tokens keep a CTA from running two exchanges ahead
// of a peer, so neither a buffer nor a barrier phase is reused early.
struct Cta {
  const Params* p;
  Layout y;
  unsigned char* smem;
  uint64_t* xbar;
  int D, H, C;  // compile-time constants in the kernel's common instantiation
  int rank, R, nr, b0;
  int xc;  // exchanges done
  __device__ float* xbuf(int i) const {
    return reinterpret_cast<float*>(smem + ((i & 1) ? y.xb1 : y.xb0));
  }
  __device__ float* xin() const { return xbuf(xc - 1); }  // what the last exchange brought
  __device__ float* xout() const { return xbuf(xc); }     // where this exchange's sends go
  __device__ const uint64_t* bar() const { return xbar + (xc & 1); }
  // Ends this exchange once `bytes` have landed here.
  __device__ void sync(int bytes) {
    __syncthreads();  // this CTA is done reading the buffer its peers fill next
    const uint64_t* b = bar();
    if ((int)threadIdx.x < C)
      asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                       mapa(b, threadIdx.x))
                   : "memory");
    if (threadIdx.x == 0) mbar_expect_tx(const_cast<uint64_t*>(b), bytes);
    mbar_wait(const_cast<uint64_t*>(b), (xc >> 1) & 1);
    ++xc;
  }
};

// Peer k's dst[r * ld + col] = v (two columns), f32.
__device__ __forceinline__ void push2(const Cta& c, float* dst, int ld, int r, int col, float2 v,
                                      int k) {
  send(dst + r * ld + col, v, k, c.bar());
}

// The owners' half of a split reduction: slots [C][R][D/C] in the last
// exchange's buffer hold every CTA's partial of this CTA's channel slice;
// each peer gets dst[r][rank * D/C + c] = sum over CTAs (+ bias[c]).
__device__ __forceinline__ void reduce_push_all(const Cta& c, int D, const float* bias) {
  const int dc = D / c.C, q = dc / 4, C = c.C, R = c.R;
  const float* slots = c.xin();
  float* dst = c.xout();
  for (int e = threadIdx.x; e < c.nr * q * C; e += NT) {  // peer-major: lanes share a peer
    const int pr = e / (c.nr * q), i = e - pr * (c.nr * q), r = i / q, cl = (i - r * q) * 4;
    float4 a = bias ? *reinterpret_cast<const float4*>(bias + cl) : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < C; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(slots + (k * R + r) * dc + cl);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    a.x += s.x; a.y += s.y; a.z += s.z; a.w += s.w;
    send(dst + r * D + c.rank * dc + cl, a, pr, c.bar());
  }
}

// Sends CTA `rank`'s partial of channels [ch, ch + n) of row r to be summed
// by the owner of the channel slice, into slot [rank][r][D / C].
template <typename V>
__device__ __forceinline__ void send_partial(const Cta& c, int r, int ch, V v) {
  const int dc = c.D / c.C;
  send(c.xout() + (c.rank * c.R + r) * dc + ch % dc, v, ch / dc, c.bar());
}

// The cluster's sum of every CTA's [R][D] partial (+ this CTA's slice of the
// bias), once the partials are sent: each owner adds up its channel slice
// and sends it to all (two exchanges).  Returns where the sum is.
__device__ __forceinline__ float* cluster_sum(Cta& c, const float* bias) {
  const int D = c.D;
  c.sync(c.C * c.nr * (D / c.C) * 4);
  reduce_push_all(c, D, bias);
  c.sync(c.nr * D * 4);
  return c.xin();
}

// x[r] = LayerNorm(x[r] + y[r]) * scale + bias over D, in f32, one warp per
// row; A[r] = bf16(x[r]).  sb: scale then bias, in shared memory.
__device__ __forceinline__ void add_layer_norm(float* x, const float* y, const float* sb, int D, int nr,
                               bf16* A, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nv = D / 32;
  for (int r = warp; r < nr; r += NW) {
    float v[MAX_D / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      v[i] = i < nv ? x[r * D + lane + 32 * i] + y[r * D + lane + 32 * i] : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      v[i] = i < nv ? v[i] - mean : 0.f;
      q += v[i] * v[i];
    }
    const float inv = rsqrtf(warp_sum(q) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      if (i < nv) {
        const int ch = lane + 32 * i;
        const float o = v[i] * inv * sb[ch] + sb[D + ch];
        x[r * D + ch] = o;
        A[r * lda + ch] = __float2bfloat16(o);
      }
    }
  }
}

// A[r][c] = bf16(src[r * D + c]) for r < nr, c < D.
__device__ __forceinline__ void round_rows(bf16* A, int lda, const float* src, int D, int nr) {
  for (int e = threadIdx.x; e < nr * D / 2; e += NT) {
    const int r = (2 * e) / D, ch = 2 * e - r * D;
    const float2 v = *reinterpret_cast<const float2*>(src + 2 * e);
    *reinterpret_cast<__nv_bfloat162*>(A + r * lda + ch) = __floats2bfloat162_rn(v.x, v.y);
  }
}

// Attention of rows r < nr over their keys, split over the cluster's CTAs.
// q: bf16 [R][D] (scaled, rounded) in the last exchange's buffer.  self:
// keys 0..t of the cache (key tile j on CTA j % C); else the memory, on this
// CTA's listed tiles.  Returns att f32 [R][D] (three exchanges).
__device__ __forceinline__ float* attention(Cta& c, bool self, int t, const bf16* Kb, const bf16* Vb,
                          size_t row_stride, float* u, const int* mt, const int* mkeys) {
  const Params& p = *c.p;
  const int D = c.D, H = c.H, dh = D / H, R = c.R, nr = c.nr, C = c.C, rank = c.rank;
  const int nloc = c.y.nloc, mtiles = c.y.mtiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* q = reinterpret_cast<const bf16*>(c.xin());
  float* sc = u;
  // this CTA's keys: self, the tiles j = rank, rank + C, ... up to key t
  int nself = 0;
  if (self) {
    const int jt = t / KEY_TILE;
    if (jt >= rank) {
      const int ntile = (jt - rank) / C + 1;
      nself = ((jt - rank) % C == 0) ? (ntile - 1) * KEY_TILE + (t - jt * KEY_TILE + 1)
                                     : ntile * KEY_TILE;
    }
  }
  auto nkeys = [&](int r) { return self ? nself : mkeys[r]; };
  auto key_of = [&](int r, int li) {
    const int j = self ? (li / KEY_TILE) * C + rank : mt[r * mtiles + li / KEY_TILE];
    return j * KEY_TILE + li % KEY_TILE;
  };

  // scores: one thread per (row, key, head)
  int total = 0;
  for (int r = 0; r < nr; ++r) total += nkeys(r) * H;
  for (int e0 = tid; e0 < total; e0 += 2 * NT) {  // two items a pass: loads first
    int rr[2], lis[2], hs[2], keys[2];
    uint4 kraw[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = e0 + i * NT;
      rr[i] = -1;
      if (e >= total) continue;
      int r = 0, rem = e;
      while (rem >= nkeys(r) * H) rem -= nkeys(r++) * H;
      rr[i] = r;
      lis[i] = rem / H;
      hs[i] = rem - lis[i] * H;
      keys[i] = key_of(r, lis[i]);
      const uint4* kr =
          reinterpret_cast<const uint4*>(Kb + r * row_stride + (size_t)keys[i] * D + hs[i] * dh);
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8)
        if (c8 < dh / 8) kraw[i][c8] = kr[c8];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rr[i] < 0) continue;
      const int r = rr[i];
      const uint4* qr = reinterpret_cast<const uint4*>(q + r * D + hs[i] * dh);
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      auto dot8 = [&](const uint4& kk, const uint4& qq) {
        const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&kk);
        const __nv_bfloat162* qh = reinterpret_cast<const __nv_bfloat162*>(&qq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 kf = __bfloat1622float2(kh[j]), qf = __bfloat1622float2(qh[j]);
          acc[2 * j] += rbf(qf.x * kf.x);
          acc[2 * j + 1] += rbf(qf.y * kf.y);
        }
      };
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8)
        if (c8 < dh / 8) dot8(kraw[i][c8], qr[c8]);
      for (int c8 = 4; c8 < dh / 8; ++c8)  // heads wider than 32
        dot8(reinterpret_cast<const uint4*>(Kb + r * row_stride + (size_t)keys[i] * D +
                                            hs[i] * dh)[c8], qr[c8]);
      float sv = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
      if (!self) sv += p.membias[(size_t)(c.b0 + r) * p.S + keys[i]];
      sc[(r * H + hs[i]) * nloc + lis[i]] = sv;
    }
  }
  __syncthreads();
  // exchange 1: each CTA's max and sum of exp(s - max) per (row, head)
  float2* stats = reinterpret_cast<float2*>(c.xout());  // [C][R][H]
  for (int pr = warp; pr < nr * H; pr += NW) {
    const int r = pr / H, n = nkeys(r);
    const float* row = sc + pr * nloc;
    float m = __int_as_float(0xff800000);  // -inf
    for (int li = lane; li < n; li += 32) m = fmaxf(m, row[li]);
    m = warp_max(m);
    float z = 0.f;
    for (int li = lane; li < n; li += 32) z += expf(row[li] - m);
    z = warp_sum(z);
    if (lane < C) send(stats + (rank * R + r) * H + pr % H, make_float2(m, z), lane, c.bar());
  }
  c.sync(C * nr * H * 8);
  // the global max and sum (every CTA adds the same terms in the same order),
  // then p = bf16(exp(s - m) / z) for this CTA's keys
  stats = reinterpret_cast<float2*>(c.xin());
  for (int pr = warp; pr < nr * H; pr += NW) {
    const float2 st = lane < C ? stats[lane * R * H + pr]
                               : make_float2(__int_as_float(0xff800000), 0.f);
    const float m = warp_max(st.x);
    const float z = warp_sum(st.y > 0.f ? st.y * expf(st.x - m) : 0.f);
    float* row = sc + pr * nloc;
    const int n = nkeys(pr / H);
    for (int li = lane; li < n; li += 32) row[li] = rbf(expf(row[li] - m) / z);
  }
  __syncthreads();
  // exchanges 2 and 3: partial value sums, eight channels a thread
  const int G = c.y.vg, d8 = D / 8;
  float* vred = sc + (size_t)R * H * nloc;
  for (int e = tid; e < R * d8 * G; e += NT) {
    const int c8 = e % d8, r = (e / d8) % R, g = e / (R * d8);
    if (r >= nr) continue;
    const int ch = 8 * c8, n = nkeys(r);
    const float* prow = sc + (r * H + ch / dh) * nloc;
    const bf16* vb = Vb + r * row_stride + ch;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int li = g; li < n; li += G) {
      const float pv = prow[li];
      const uint4 raw = *reinterpret_cast<const uint4*>(vb + (size_t)key_of(r, li) * D);
      const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(vh[i]);
        a[2 * i] = fmaf(pv, v.x, a[2 * i]);
        a[2 * i + 1] = fmaf(pv, v.y, a[2 * i + 1]);
      }
    }
    if (G == 1) {
      send_partial(c, r, ch, make_float4(a[0], a[1], a[2], a[3]));
      send_partial(c, r, ch + 4, make_float4(a[4], a[5], a[6], a[7]));
    } else {
      float* dst = vred + ((size_t)g * R + r) * D + ch;
      reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int e = tid; e < nr * d8; e += NT) {
      const int r = e / d8, ch = 8 * (e - r * d8);
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int g = 0; g < G; ++g) {
        const float* v = vred + ((size_t)g * R + r) * D + ch;
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] += v[j];
      }
      send_partial(c, r, ch, make_float4(a[0], a[1], a[2], a[3]));
      send_partial(c, r, ch + 4, make_float4(a[4], a[5], a[6], a[7]));
    }
  }
  return cluster_sum(c, nullptr);
}

// TD, TH, TC: d, heads and cluster size as compile-time constants, or 0 to
// read them from p (the plan's other shapes).
template <int TD, int TH, int TC>
__global__ void __launch_bounds__(NT, 1) ar_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Cta c;
  c.p = &p;
  c.D = TD ? TD : p.D;
  c.H = TH ? TH : p.H;
  c.C = TC ? TC : p.C;
  c.y = layout(p.T, p.S, p.L, c.D, c.H, p.FF, p.NMEL, c.C, p.R, p.NS);
  c.smem = smem;
  c.R = p.R;
  c.rank = (int)cg::this_cluster().block_rank();
  c.b0 = (blockIdx.x / c.C) * p.R;
  c.nr = imin(p.R, p.B - c.b0);
  c.xc = 0;
  const int D = c.D, T = p.T, S = p.S, L = p.L, R = p.R, nr = c.nr, C = c.C, rank = c.rank;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lda = c.y.lda, mtiles = c.y.mtiles;
  float* x = reinterpret_cast<float*>(smem + c.y.x);
  bf16* A = reinterpret_cast<bf16*>(smem + c.y.a);
  float* u = reinterpret_cast<float*>(smem + c.y.u);
  float* vec = reinterpret_cast<float*>(smem + c.y.vec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + c.y.small);
  c.xbar = bars + p.NS;
  int* mt = reinterpret_cast<int*>(c.xbar + 2);
  int* mkeys = mt + R * mtiles;
  const float sqrt_dh = sqrtf((float)(D / c.H));

  // LayerNorm parameters of every layer and this CTA's bias slices, kept in
  // shared memory: vln [L][3][2][D], then per layer [bqkv | bo | bcq | bco |
  // b1 | b2] slices, then [pb1 | pb2 | melb] slices.
  float* vln = vec;
  float* vlb = vln + L * 6 * D;
  float* vpre = vlb + L * c.y.vb;
  for (int i = tid; i < L * 6 * D; i += NT) vln[i] = p.ln[i];
  {
    int c0, n;
    for (int l = 0; l < L; ++l) {
      float* o = vlb + l * c.y.vb;
      col_split(3 * D, rank, C, c0, n);
      for (int i = tid; i < n; i += NT) o[i] = p.bqkv[(size_t)l * 3 * D + c0 + i];
      o += c.y.w3;
      col_split(D, rank, C, c0, n);
      for (int i = tid; i < n; i += NT) {
        o[i] = p.bo[(size_t)l * D + c0 + i];
        o[c.y.wd + i] = p.bcq[(size_t)l * D + c0 + i];
        o[2 * c.y.wd + i] = p.bco[(size_t)l * D + c0 + i];
      }
      o += 3 * c.y.wd;
      col_split(p.FF, rank, C, c0, n);
      for (int i = tid; i < n; i += NT) o[i] = p.b1[(size_t)l * p.FF + c0 + i];
      o += c.y.wff;
      for (int i = tid; i < D / C; i += NT) o[i] = p.b2[(size_t)l * D + rank * (D / C) + i];
    }
    col_split(D, rank, C, c0, n);
    for (int i = tid; i < n; i += NT) {
      vpre[i] = p.pb1[c0 + i];
      vpre[c.y.wd + i] = p.pb2[c0 + i];
    }
    col_split(p.NMEL, rank, C, c0, n);
    for (int i = tid; i < n; i += NT) vpre[2 * c.y.wd + i] = p.melb[c0 + i];
  }
  for (int i = tid; i < 16 * lda; i += NT) A[i] = __float2bfloat16(0.f);
  for (int i = tid; i < R * D; i += NT) x[i] = 0.f;
  // each row's memory key tiles on this CTA that hold an unmasked key (all
  // of them when the row has none), in key order
  for (int r = warp; r < nr; r += NW) {
    const float* bias = p.membias + (size_t)(c.b0 + r) * S;
    bool any = false;
    for (int s = lane; s < S; s += 32) any |= bias[s] > MASKED;
    any = __any_sync(0xffffffffu, any);
    int cnt = 0, keys = 0;
    for (int base = 0; base < mtiles; base += 32) {
      const int i = base + lane, j = i * C + rank;
      bool act = false;
      if (i < mtiles && j * KEY_TILE < S) {
        act = !any;
        for (int k = j * KEY_TILE; k < imin(S, (j + 1) * KEY_TILE) && !act; ++k)
          act = bias[k] > MASKED;
      }
      const unsigned m = __ballot_sync(0xffffffffu, act);
      if (act) mt[r * mtiles + cnt + __popc(m & ((1u << lane) - 1))] = j;
      keys += (int)warp_sum(act ? (float)imin(KEY_TILE, S - j * KEY_TILE) : 0.f);
      cnt += __popc(m);
    }
    if (lane == 0) mkeys[r] = keys;
  }
  Ring g;
  g.base = smem + c.y.ring;
  g.bars = bars;
  if (tid == 0) {
    for (int i = 0; i < p.NS; ++i) mbar_init(bars + i, 1);
    for (int i = 0; i < 2; ++i) mbar_init(c.xbar + i, C + 1);  // C tokens and this CTA's bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  g.w = p.stream + (size_t)rank * p.stride;
  g.poff = 0;
  g.consumed = g.issued = 0;
  g.pseg = g.pk0 = 0;
  g.nseg = 3 + 6 * L;
  g.rank = rank;
  g.NS = p.NS;
  g.ps = seg_desc(p, 0, rank);
  for (int i = 0; i < g.NS - 1; ++i) ring_issue(g, p);
  cluster_sync();  // every peer runs before anyone writes to its shared memory

  int c0, n;
  for (int t = p.pos0; t < p.pos0 + p.steps; ++t) {
    const float pe_c = p.pe[(size_t)t * D + tid % D];  // used after the prenet
    // prenet: A = bf16(prev mel): the last exchange's, the carried frame at
    // the chunk's first step, zero at t = 0
    if (t > p.pos0)
      round_rows(A, lda, c.xin(), p.NMEL, nr);
    else if (t > 0)
      round_rows(A, lda, p.prev + (size_t)c.b0 * p.NMEL, p.NMEL, nr);
    col_split(D, rank, C, c0, n);
    float* dst = c.xout();
    product(g, p, 0, A, lda, vpre, u, R, nr, C, [&](int r, int col, float2 v, int k) {
      push2(c, dst, D, r, c0 + col, make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f)), k);
    });
    c.sync(nr * D * 4);
    round_rows(A, lda, c.xin(), D, nr);
    dst = c.xout();
    product(g, p, 1, A, lda, vpre + c.y.wd, u, R, nr, C,
            [&](int r, int col, float2 v, int k) { push2(c, dst, D, r, c0 + col, v, k); });
    c.sync(nr * D * 4);
    for (int e = tid; e < nr * D; e += NT) {  // e % D == tid % D: NT is a multiple of D
      const float v = c.xin()[e] + pe_c;
      x[e] = v;
      A[(e / D) * lda + e % D] = __float2bfloat16(v);
    }
    const int owner_t = (t / KEY_TILE) % C;
    for (int l = 0; l < L; ++l) {
      const int sb = 2 + 6 * l;
      const float* ln = vln + l * 6 * D;
      const float* lb = vlb + l * c.y.vb;
      const size_t cache_row = (size_t)T * D, mem_row = (size_t)S * D;
      bf16* kc = p.kcache + ((size_t)l * p.B + c.b0) * cache_row;
      bf16* vc = p.vcache + ((size_t)l * p.B + c.b0) * cache_row;
      // --- self-attention: Q to every CTA, this step's K/V to key t's owner
      col_split(3 * D, rank, C, c0, n);
      {
        bf16* qo = reinterpret_cast<bf16*>(c.xout());
        bf16* kvo = qo + R * D;  // [R][2D]
        product(g, p, sb, A, lda, lb, u, R, nr, C, [&](int r, int col, float2 v, int k) {
          col += c0;
          if (col < D) {
            send(qo + r * D + col, __floats2bfloat162_rn(v.x / sqrt_dh, v.y / sqrt_dh), k,
                 c.bar());
          } else if (k == 0) {
            send(kvo + r * 2 * D + col - D, __floats2bfloat162_rn(v.x, v.y), owner_t, c.bar());
          }
        });
      }
      c.sync(nr * D * 2 + (rank == owner_t ? nr * 2 * D * 2 : 0));
      if (rank == owner_t) {
        const bf16* kvi = reinterpret_cast<const bf16*>(c.xin()) + R * D;
        for (int e = tid; e < nr * (2 * D / 8); e += NT) {
          const int r = e / (2 * D / 8), c8 = (e % (2 * D / 8)) * 8;
          const uint4 v = *reinterpret_cast<const uint4*>(kvi + r * 2 * D + c8);
          bf16* to = (c8 < D ? kc + c8 : vc + c8 - D) + r * cache_row + (size_t)t * D;
          *reinterpret_cast<uint4*>(to) = v;
        }
      }
      __syncthreads();
      round_rows(A, lda, attention(c, true, t, kc, vc, cache_row, u, mt, mkeys), D, nr);
      col_split(D, rank, C, c0, n);
      dst = c.xout();
      product(g, p, sb + 1, A, lda, lb + c.y.w3, u, R, nr, C,
              [&](int r, int col, float2 v, int k) { push2(c, dst, D, r, c0 + col, v, k); });
      c.sync(nr * D * 4);
      add_layer_norm(x, c.xin(), ln, D, nr, A, lda);
      // --- cross-attention over the memory
      {
        bf16* qo = reinterpret_cast<bf16*>(c.xout());
        product(g, p, sb + 2, A, lda, lb + c.y.w3 + c.y.wd, u, R, nr, C,
                [&](int r, int col, float2 v, int k) {
                  send(qo + r * D + c0 + col, __floats2bfloat162_rn(v.x / sqrt_dh, v.y / sqrt_dh),
                       k, c.bar());
                });
      }
      c.sync(nr * D * 2);
      round_rows(A, lda,
                 attention(c, false, t, p.memk + ((size_t)l * p.B + c.b0) * mem_row,
                           p.memv + ((size_t)l * p.B + c.b0) * mem_row, mem_row, u, mt, mkeys),
                 D, nr);
      dst = c.xout();
      product(g, p, sb + 3, A, lda, lb + c.y.w3 + 2 * c.y.wd, u, R, nr, C,
              [&](int r, int col, float2 v, int k) { push2(c, dst, D, r, c0 + col, v, k); });
      c.sync(nr * D * 4);
      add_layer_norm(x, c.xin(), ln + 2 * D, D, nr, A, lda);
      // --- feed-forward: this CTA's slice of the hidden vector stays here,
      // as the A operand of its K rows of w2
      product(g, p, sb + 4, A, lda, lb + c.y.w3 + 3 * c.y.wd, u, R, nr, 1,
              [&](int r, int col, float2 v, int) {
                *reinterpret_cast<__nv_bfloat162*>(A + r * lda + col) =
                    __floats2bfloat162_rn(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
              });
      product(g, p, sb + 5, A, lda, nullptr, u, R, nr, 1, [&](int r, int col, float2 v, int) {
        send_partial(c, r, col, v);
      });
      add_layer_norm(x, cluster_sum(c, lb + c.y.w3 + 3 * c.y.wd + c.y.wff), ln + 4 * D, D, nr,
                     A, lda);
    }
    // mel projection: to every CTA (the next step's prenet input) and out
    col_split(p.NMEL, rank, C, c0, n);
    dst = c.xout();
    product(g, p, 2 + 6 * L, A, lda, vpre + 2 * c.y.wd, u, R, nr, C,
            [&](int r, int col, float2 v, int k) {
              push2(c, dst, p.NMEL, r, c0 + col, v, k);
              if (k == 0)
                *reinterpret_cast<float2*>(
                    p.out + ((size_t)(c.b0 + r) * p.steps + t - p.pos0) * p.NMEL + c0 + col) = v;
            });
    c.sync(nr * p.NMEL * 4);
  }
  for (int i = g.consumed; i < g.issued; ++i) mbar_wait(bars + i % g.NS, (i / g.NS) & 1);
  cluster_sync();  // no peer still sends to this CTA
}

}  // namespace

extern "C" const char* error_string(int err) {
  return err == UNSCHEDULABLE ? "the cluster cannot be scheduled on this card"
                              : cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan (cluster size C, rows per cluster R, clusters `groups`, key tile,
// ring stages and stage bytes, shared memory per CTA) comes from
// ops/ar_decode.py's launch_plan and is checked here against this file's own
// layout.  The launch decodes steps [pos0, pos0 + steps) of the T the caches
// hold; a chunk outside [0, T) is refused.  Returns 0, a cudaError_t, or
// UNSCHEDULABLE when cudaOccupancyMaxActiveClusters finds no place for one
// cluster.
extern "C" int ar_decode_launch(
    const void* stream, const void* pb1, const void* pb2, const void* bqkv, const void* bo,
    const void* bcq, const void* bco, const void* b1, const void* b2, const void* ln,
    const void* melb, const void* pe, const void* memk, const void* memv, const void* membias,
    const void* prev, void* kcache, void* vcache, void* out,
    int stride, int B, int T, int S, int L, int D, int H, int FF, int NMEL, int pos0, int steps,
    int C, int R, int groups, int key_tile, int stages, int stage_bytes, int smem,
    void* cuda_stream) {
  Params p;
  p.stream = static_cast<const bf16*>(stream);
  p.pb1 = static_cast<const float*>(pb1); p.pb2 = static_cast<const float*>(pb2);
  p.bqkv = static_cast<const float*>(bqkv); p.bo = static_cast<const float*>(bo);
  p.bcq = static_cast<const float*>(bcq); p.bco = static_cast<const float*>(bco);
  p.b1 = static_cast<const float*>(b1); p.b2 = static_cast<const float*>(b2);
  p.ln = static_cast<const float*>(ln);
  p.melb = static_cast<const float*>(melb);
  p.pe = static_cast<const float*>(pe);
  p.memk = static_cast<const bf16*>(memk);
  p.memv = static_cast<const bf16*>(memv);
  p.membias = static_cast<const float*>(membias);
  p.prev = static_cast<const float*>(prev);
  p.kcache = static_cast<bf16*>(kcache);
  p.vcache = static_cast<bf16*>(vcache);
  p.out = static_cast<float*>(out);
  p.stride = stride; p.B = B; p.T = T; p.S = S; p.L = L; p.D = D; p.H = H; p.FF = FF; p.NMEL = NMEL;
  p.pos0 = pos0; p.steps = steps;
  p.C = C; p.R = R; p.NS = stages;

  // the host plan and this file must agree on the layout
  const bool pow2_c = C == 1 || C == 2 || C == 4 || C == 8 || C == 16;
  const bool pow2_d = D == 32 || D == 64 || D == 128 || D == 256 || D == 512;
  if (!pow2_c || !pow2_d || B < 1 || T < 1 || S < 1 || L < 1 || R < 1 || R > MAX_ROWS ||
      pos0 < 0 || steps < 1 || pos0 + steps > T ||
      groups != cdiv(B, R) || key_tile != KEY_TILE || stage_bytes != STAGE_BYTES ||
      stages < 2 || stages > 8 || D % (8 * C) || FF % (16 * C) ||
      NMEL % 16 || D % H || (D / H) % 8 ||
      imax(imax(widest(D, C), widest(3 * D, C)), imax(widest(FF, C), D)) >
          8 * MAX_WARP_TILES * NW ||
      (size_t)smem != layout(T, S, L, D, H, FF, NMEL, C, R, stages).total)
    return (int)cudaErrorInvalidValue;
  int longest = 0;  // the stream's row: the longest CTA's slices
  for (int rank = 0; rank < C; ++rank) {
    int n = 0;
    for (int i = 0; i < 3 + 6 * L; ++i) {
      const Seg s = seg_desc(i, rank, L, D, FF, NMEL, C);
      n += s.K * s.ncols;
    }
    longest = imax(longest, n);
  }
  if (stride != longest) return (int)cudaErrorInvalidValue;

  // the default decoder's widths on 16-CTA clusters get constant shapes
  void (*kernel)(Params) = D == 256 && H == 8 && C == 16 ? ar_decode_kernel<256, 8, 16>
                                                         : ar_decode_kernel<0, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(cuda_stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return UNSCHEDULABLE;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
