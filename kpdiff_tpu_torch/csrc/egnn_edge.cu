// Dense EGNN edge messages and aggregation for NVIDIA Hopper (sm_90a), kernel v5.
//
// Replaces the TPU kernel kpdiff_tpu/ops/pallas/egnn_edge.py::fused_dense_edge_split
// (body `_kernel`, pl.pallas_call at line 174). For every batch element b and
// every pair (s, d) of the (Ns, Nd) grid with adj[b, s, d] set, it computes
// the edge chain m, its gate and the coordinate chain's scalar k, and sums
// them onto destinations:
//   agg_h[b, d] = sum_s gate * m        agg_x[b, d] = sum_s k * (x_s - x_d + 1e-30)
// with dij = |x_s - x_d + 1e-30|. As in `_kernel`, the width H = Hm + 1 is
// split into a main block of Hm channels and the last (timestep) channel:
//   m1   = silu(a_s + a_d + dij * w_dij)                      (H channels)
//   m2   = silu(m1[:Hm] @ W2[:Hm, :Hm] + m1[Hm] * W2[Hm, :Hm] + b2[:Hm])
//   e2   = silu(sum_k rnd(m1[k] * W2[k, Hm]) + m1[Hm] * W2[Hm, Hm] + b2[Hm])
//   gate = sigmoid(sum_c rnd(m2[c] * attw[c]) + e2 * attw[Hm] + atb)
//   agg_h[b, d, :Hm] = sum_s gate * m2, agg_h[b, d, Hm] = sum_s gate * e2
// and the coordinate chain the same way through W2c, with
//   k = tanh(sum_c rnd(c2[c] * wout[c]) + ce2 * wout[Hm]) * coords_range / (dij + 1)
// (tanh optional). The first layers' per-node projections a_* come in
// precomputed. Numerics follow `_kernel` in bf16 mode (rnd(x): x rounded to
// bf16, to nearest even): the pre-activation, each main-block silu and m2
// are rounded to bf16, the main product accumulates in f32, the t-channel
// row term enters the f32 accumulator before the cast, the t-channel column
// is a sum of bf16-rounded products in f32, and e2, the gate and every
// reduction stay in f32.
//
// What bounds it: on paper, operations. The main block's two (Hm x Hm) second
// layers take 2 * 2 * Hm^2 FLOPs per active pair on the tensor cores (262
// kFLOP at Hm = 256): 2,048 SM clocks a 64-row tile. Inputs and outputs are
// O(N * H) bytes. In practice the CUDA cores bound it: matching the
// reference's bf16 rounding places costs about 20 instructions per pair,
// channel and chain (the first layer and the epilogue, each with a silu on
// the special-function unit), several times the tensor-core time, and the
// accumulator (128 registers a thread) leaves room for few warps to hide
// their latency. The design (bf16):
//   * the reference's split: the main block is one tensor-core shape,
//     wgmma m64n256k16 over K = 256, at both shipped widths (257 and 256);
//     the t-channel's row, column and corner run on the CUDA cores in f32.
//     Main blocks wider than 256 (H up to 288) take two N halves of 144
//     with K padded to 320 and one consumer a block (correctness route);
//   * W2's main block is packed once on the host (ops/cuda/egnn_edge.py::
//     pack_w2) into the image the wgmma B descriptor reads: K-major, 128-byte
//     swizzle, K permuted within each 16-wide step so that a thread's four A
//     channels of a step are four consecutive a_* elements (one 8-byte load
//     of bf16 rows);
//   * a persistent grid of at most one block per SM, the blocks split evenly
//     between the chains. A block copies its chain's packed main block into
//     shared memory once, by bulk asynchronous copies completing on one
//     mbarrier, while it sets up; it stays resident for every tile;
//   * warp specialisation: two consumer warpgroups (208 registers a thread,
//     by setmaxnreg) and a helper warpgroup (88). Each consumer owns an
//     interleaved share of the flattened (b, d) destinations (every n-th,
//     so that batch elements with many and few pairs spread evenly); two
//     helper warps serve it. They compact the mask 64 positions at a time
//     (ballots) into destination-major 64-row tiles, full across destination
//     and batch boundaries, load the rows' positions and t-channel inputs,
//     and run up to two tiles ahead of the consumer (two sets of rows);
//   * the consumer computes the first layer straight into the A fragments
//     (wgmma with A from registers), two k-steps of a_* loads ahead, one
//     product in flight while the next step's A is computed; then the
//     epilogue in registers: t-channel row, bias, silu, the row products
//     with attw / wout reduced across the quad. The edge chain stages m (bf16)
//     in shared memory;
//   * while the consumer multiplies the next tile, its helper warps sum the
//     staged tile in row order: a thread owns four columns and carries
//     its per-destination sums in registers across tiles, writing a
//     destination's sums once when its rows end (the coordinate chain: one
//     warp sum a run of rows). The gate enters the sum in f32. Consumers and
//     helpers hand tiles over through named barriers (rows full, epilogue
//     done, staging free). No atomics: two launches give bitwise equal
//     outputs.
// The list mode (bf16; template LIST) takes the pairs from a destination-major
// neighbor list in place of adj: idx (B, Nd, cap) int32 source indices and
// valid (B, Nd, cap), the pair (s = idx[b, d, j], d) active where valid[b, d,
// j] is set. Only the helpers' compaction differs: their cursor walks the cap
// slots of each destination (contiguous, so the flag and index loads of a
// step coalesce) instead of its Ns sources, and a row's source is the slot's
// index. A sparse graph's list holds a few slots a destination where its mask
// holds Ns positions (the all-atom kk: cap 24 against 384). The rows come
// destination by destination in slot order; where a destination's valid
// slots name ascending sources, the tiles, and so the sums, are those of the
// mask mode on the list's mask, bit for bit. A valid slot whose index lies
// outside [0, Ns) adds nothing.
// The f32 mode (a tight check of the algorithm, off the main path) keeps a
// simple CUDA-core design with W2 read from global memory.
//
// C interface (loaded with ctypes): egnn_edge_dense_launch (adj) and
// egnn_edge_list_launch (idx, valid; bf16) return the cudaError_t of the
// launch; egnn_edge_error_string names it; egnn_edge_wgmma_probe runs the
// product alone on one 64-row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_H = 288;   // width limit (main block up to 287 channels)
constexpr int TD = 16;       // f32 mode: destinations per block
constexpr int ST = 64;       // f32 mode: sources per tile of the pair walk
constexpr int TM = 64;       // bf16 mode: pair rows per tile (the m64 of wgmma)
constexpr int WGT = 128;     // threads of a warpgroup
constexpr int HT = 64;       // helper threads serving a consumer warpgroup (the mask positions of a compaction step)
constexpr int BULK = 32768;  // bytes per bulk copy of the main block
// f32 mode
constexpr int THREADS_F32 = 512;
constexpr int MR_F32 = 64;
constexpr int MAX_HP_F32 = (MAX_H + 15) / 16 * 16;
static_assert(MAX_HP_F32 <= THREADS_F32, "f32 mode: one column per thread");

struct Params {
  const void *a_es, *a_ed, *a_cs, *a_cd;   // (B,Ns,H), (B,Nd,H) bf16 or f32, row stride lda
  const float *w_edij, *w_cdij;            // (H) f32
  const void *w2e_main, *w2c_main;         // (NP * KP) bf16 or f32: pack_w2's image
  const float *w2e_tail, *w2c_tail;        // (NP + KP + 4) f32: t-channel row, column, corner
  const float *b2e, *b2c, *attw, *wout;    // (H) f32
  const float *atb;                        // (1) f32
  const float *x_s, *x_d;                  // (B,Ns,3), (B,Nd,3) f32
  const uint8_t *adj;                      // (B,Ns,Nd)
  float *agg_h, *agg_x;                    // (B,Nd,H), (B,Nd,3) f32
  int B, Ns, Nd, H, lda, KP, NP;
  int edge_blocks;                         // v5: blocks 0 .. edge_blocks - 1 run the edge chain, the rest the coordinate chain
  int use_tanh;
  float coords_range;
  const int *nbr_idx;                      // list mode: (B,Nd,cap) source indices
  const uint8_t *nbr_valid;                // list mode: (B,Nd,cap)
  int cap;                                 // list mode: slots a destination
};

// Phase clocks (a profiling build only: nvcc -DEGNN_EDGE_PHASE_CLOCKS). Each
// warp adds the SM clocks it spends in each phase; barrier waits are a phase
// of their own. Lane 0 of each warp adds its totals to g_phase_clocks at exit.
enum Phase { PH_SETUP, PH_W2, PH_LAYER1, PH_PRODUCT, PH_EPILOGUE, PH_AGG, PH_BARRIER, N_PHASES };
#ifdef EGNN_EDGE_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[4][N_PHASES];  // by chain: consumer warps, then helper warps
#define CLK_BEGIN                              \
  unsigned long long clk_t = clock64();        \
  unsigned long long clk_acc[N_PHASES] = {};
#define CLK(ph)                                \
  do {                                         \
    const unsigned long long n_ = clock64();   \
    clk_acc[ph] += n_ - clk_t;                 \
    clk_t = n_;                                \
  } while (0)
#define CLK_END(row)                                                                     \
  if ((threadIdx.x & 31) == 0)                                                           \
    for (int i_ = 0; i_ < N_PHASES; ++i_) atomicAdd(&g_phase_clocks[row][i_], clk_acc[i_]);
#else
#define CLK_BEGIN
#define CLK(ph)
#define CLK_END(row)
#endif
// the 128 threads of warpgroup g (named barrier 1 + g); closes phase `ph`
// and counts the wait as PH_BARRIER
#define WG_SYNC(ph, g)                                                           \
  do {                                                                           \
    CLK(ph);                                                                     \
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (g)), "n"(WGT) : "memory");        \
    CLK(PH_BARRIER);                                                             \
  } while (0)

// silu(x) = x * sigmoid(x) in f32 (exact expf)
__device__ __forceinline__ float silu_f32(float x) { return x / (1.0f + expf(-x)); }

// two floats -> bf16x2 (round to nearest even, one cvt), low half = lo
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
// bf16x2 add / multiply, each result rounded to bf16. The explicit .rn keeps
// ptxas from contracting a multiply and an add into one fma, which would
// round once where the reference rounds twice.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
constexpr uint32_t HALF2 = 0x3f003f00u;  // bf16x2 (0.5, 0.5)
__device__ __forceinline__ float tanh_approx(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x));
  return t;
}
// silu of both halves as the TPU kernel's `_silu` computes it in bf16:
// rnd(x * rnd(rnd(tanh(x / 2)) / 2 + 1 / 2)) (x / 2 and t / 2 are exact). tanh
// is the hardware's f32 approximation (relative error ~2^-11, an eighth of
// bf16's step) rounded to bf16; the bf16x2 form of tanh.approx errs by up
// to a step and moved the sums by 1e-2 of their scale.
__device__ __forceinline__ uint32_t silu_bf16x2(uint32_t x) {
  const uint32_t h = mul_bf16x2(x, HALF2);
  const uint32_t t = pack_bf16x2(tanh_approx(bf16_lo(h)), tanh_approx(bf16_hi(h)));
  uint32_t s;
  asm("fma.rn.bf16x2 %0, %1, %2, %2;" : "=r"(s) : "r"(t), "r"(HALF2));
  return mul_bf16x2(x, s);
}
// the first layer of two channels (a_s, a_d already bf16): rnd(silu(rnd(rnd(a_s + a_d) + rnd(rnd(dij) * rnd(w)))))
__device__ __forceinline__ uint32_t first_layer2(uint32_t s, uint32_t d, uint32_t dij2, uint32_t w2) {
  return silu_bf16x2(add_bf16x2(add_bf16x2(s, d), mul_bf16x2(dij2, w2)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Offset of W2[k, n] (k, n < Hm) in pack_w2's main-block image: K-blocks of
// 64, then n, then 16-byte chunks of 8 K elements swizzled by n % 8 (the
// 128-byte swizzle), with the channels of each 16-wide k-step permuted so
// that logical slot j = 8 hi + 2 q + lo holds channel 4 q + 2 hi + lo.
__host__ __device__ inline size_t main_index(int k, int n, int NP) {
  const int r = k & 15;
  const int j = (k & ~15) | (((r >> 1) & 1) << 3) | ((r >> 2) << 1) | (r & 1);
  const int kb = j >> 6, c = (j >> 3) & 7, e = j & 7;
  return (size_t(kb) * NP + n) * 64 + ((c ^ (n & 7)) << 3) + e;
}

// ---- Hopper building blocks: wgmma, mbarrier, bulk copy

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from touching an accumulator register across a wgmma wait
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// Matrix descriptor of a K-major operand with the 128-byte swizzle: start
// address >> 4, leading byte offset 16 (unused by this layout), stride byte
// offset 1024 (between 8-row groups of 128-byte rows), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) | (uint64_t(1) << 62);
}

// d (+)= A (64 x 16 bf16, registers) * B (16 x N bf16, shared memory through desc), f32; scale_d 0 drops d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[72], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// global -> shared bulk asynchronous copy (16-byte aligned, size a multiple of 16), completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
// copies `bytes` (a multiple of 16) into shared memory on bar, in BULK pieces; one thread
__device__ __forceinline__ void load_resident(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  for (uint32_t off = 0; off < bytes; off += BULK) {
    bulk_g2s(static_cast<char*>(dst) + off, static_cast<const char*>(src) + off, min(uint32_t(BULK), bytes - off),
             bar);
  }
}

// the first 1024-byte aligned address of dynamic shared memory (the 128-byte
// swizzle repeats every 1024 bytes). Pointer arithmetic on the shared array
// keeps the compiler's knowledge that the result is shared: a round trip
// through an integer turns every access into a generic load or store.
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
}

}  // namespace

namespace {

// ---- the bf16 kernel (v5)

// One tile's rows in shared memory, written by the helper warps, read by the
// consumer warpgroup; val / tval written by the consumer, read by the helper.
struct alignas(16) TileRows {
  int as_row[TM];              // a_s row (b * Ns + s) and a_d row (g) of each row; 0 past the pairs
  int ad_row[TM];
  float dij[TM];
  float dx[TM][3];
  float e1[TM];                // the t-channel's first layer (a bf16 value)
  int g[TM];                   // flattened destination b * Nd + d, -1 past the pairs
  float val[TM];               // gate (edge) or coordinate coefficient k, 0 past the pairs
  float tval[TM];              // gate * e2: the edge chain's t-channel message
  int seg[TM + 1];             // first row of each run of rows with one destination, then n
  int nseg;
  int n;                       // rows of the tile; 0: no more tiles
};

// Per-consumer state in shared memory: the helper's compaction and the rows of up to NBUF tiles.
template <int NBUF>
struct alignas(16) WgTile {
  int2 pl[TM];                 // (g, s) of a tile's rows, from the compaction
  unsigned masks[2][2];        // compaction ballots of the two helper warps, by step parity
  TileRows rows[NBUF];
};

// The block's chain vectors in shared memory (main block padded with zeros).
template <int NP, int KP>
struct ChainVecs {
  uint32_t wdij2[KP / 2];  // rnd(w_dij) pairs
  uint32_t wcol2[KP / 2];  // rnd(W2[:Hm, Hm]) pairs
  float wrow[NP];          // W2[Hm, :Hm]
  float b2[NP];
  uint16_t wv[NP];         // rnd(attw) or rnd(wout)
  float wdij_e, w_cc, b_e, wv_e, atb;
  uint64_t bar;            // the main block's bulk copies
};

// NCW consumer warpgroups and one helper warpgroup a block. Two helper warps
// serve each consumer: the next tiles' compaction and rows run ahead of the
// consumer (NBUF tiles of rows), and the sums of a tile run while the
// consumer multiplies the next one.
template <int NPW, int NPASS, int KP, int NCW>
struct V5 {
  static constexpr int NP = NPW * NPASS;          // padded main width (wgmma N, all passes)
  static constexpr int NK = KP / 16;              // k-steps
  static constexpr int WGS = NCW;
  static constexpr int THREADS = (NCW + 1) * WGT;
  static constexpr int NBUF = NCW == 2 ? 2 : 1;   // the wide variant has shared memory for one set of rows
  static constexpr int SSTR = NP * 2 + 16;        // staging row stride, bytes: conflict-free stores
  static constexpr int CQT = (NP / 4 + HT - 1) / HT;  // groups of four columns a helper thread sums
  static constexpr size_t W2_BYTES = size_t(NP) * KP * 2;
  static constexpr size_t VEC = W2_BYTES;
  static constexpr size_t TILE = VEC + align16(sizeof(ChainVecs<NP, KP>));
  static constexpr size_t STAGE = TILE + align16(sizeof(WgTile<NBUF>)) * NCW;
  static constexpr size_t SMEM = STAGE + size_t(TM) * SSTR * NCW + 1024;  // + alignment of the base
  static_assert(NP % 16 == 0 && KP % 64 == 0 && NPW % 8 == 0 && NPW <= 256, "wgmma shape");
  static_assert((NP * 128) % 1024 == 0 && (NPW * 128) % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
};

template <int NPW>
__device__ __forceinline__ void wgmma_tile(float (&d)[NPW / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tile<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  wgmma_m64n256k16(d, a, desc, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_tile<144>(float (&d)[72], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  wgmma_m64n144k16(d, a, desc, scale_d);
}

// keeps channels past the main block at zero (v holds channels k0, k0 + 1)
__device__ __forceinline__ uint32_t main_only(uint32_t v, int k0, int Hm) {
  return k0 >= Hm ? 0u : (k0 + 1 >= Hm ? (v & 0xffffu) : v);
}

// named barriers: a consumer warpgroup and its helper warps hand tiles over
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// barrier ids of consumer c: its rows of buffer b are full, its epilogue is done,
// its staging buffer is free; and its helper warps' own barrier
__host__ __device__ constexpr int bar_full(int c, int b) { return 1 + 5 * c + b; }
__host__ __device__ constexpr int bar_epi(int c) { return 3 + 5 * c; }
__host__ __device__ constexpr int bar_free(int c) { return 4 + 5 * c; }
__host__ __device__ constexpr int bar_help(int c) { return 5 + 5 * c; }
constexpr int HAND = WGT + HT;  // threads of a hand-over barrier: a consumer and its helper warps

template <int NPW, int NPASS, int KP, int NCW, bool LIST>
__global__ void __launch_bounds__((NCW + 1) * WGT, 1) egnn_edge_v5_kernel(Params p) {
  using C = V5<NPW, NPASS, KP, NCW>;
  constexpr int NP = C::NP, NK = C::NK, NBUF = C::NBUF;
  using Vecs = ChainVecs<NP, KP>;
  using Wg = WgTile<NBUF>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  Vecs* vec = reinterpret_cast<Vecs*>(smem + C::VEC);
  const int tid = threadIdx.x, wg = tid / WGT, lane = tid & 31;
  const int chain = int(blockIdx.x) >= p.edge_blocks;
  const int cblk = chain ? blockIdx.x - p.edge_blocks : blockIdx.x;
  const int nblk = chain ? gridDim.x - p.edge_blocks : p.edge_blocks;
  const int H = p.H, Hm = H - 1, Ns = p.Ns, Nd = p.Nd, lda = p.lda;
  CLK_BEGIN

  // the chain's main block, resident for the whole launch: bulk copies on one mbarrier
  if (tid == 0) mbar_init(&vec->bar, 1);
  __syncthreads();
  if (tid == 0) load_resident(smem, chain ? p.w2c_main : p.w2e_main, uint32_t(C::W2_BYTES), &vec->bar);
  {
    const float* tail = chain ? p.w2c_tail : p.w2e_tail;
    const float* w_dij = chain ? p.w_cdij : p.w_edij;
    const float* b2 = chain ? p.b2c : p.b2e;
    const float* wv = chain ? p.wout : p.attw;
    for (int k2 = tid; k2 < KP / 2; k2 += C::THREADS) {
      const int k = 2 * k2;
      vec->wdij2[k2] = pack_bf16x2(k < Hm ? w_dij[k] : 0.0f, k + 1 < Hm ? w_dij[k + 1] : 0.0f);
      vec->wcol2[k2] = pack_bf16x2(tail[NP + k], tail[NP + k + 1]);
    }
    for (int c = tid; c < NP; c += C::THREADS) {
      vec->wrow[c] = tail[c];
      vec->b2[c] = c < Hm ? b2[c] : 0.0f;
      vec->wv[c] = __bfloat16_as_ushort(__float2bfloat16_rn(c < Hm ? wv[c] : 0.0f));
    }
    if (tid == 0) {
      vec->wdij_e = w_dij[Hm];
      vec->w_cc = tail[NP + KP];
      vec->b_e = b2[Hm];
      vec->wv_e = wv[Hm];
      vec->atb = *p.atb;
    }
  }
  __syncthreads();

  if (wg == NCW) {
    // ================= helper warps: two a consumer warpgroup (the wide variant's last two idle)
    // the block starts at 168 registers a thread (384 threads); the consumers' increase to 208
    // waits until the helpers have released what it takes: 256 * 208 + 128 * 88 <= 384 * 168.
    // (232 / 40 starved the helpers: 17% slower on an H100; 200 / 104 made the consumers spill)
    if constexpr (NCW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 88;" ::: "memory");
    const int hw = (tid - NCW * WGT) >> 5, c = hw >> 1, hp = hw & 1, ht = tid - NCW * WGT - c * HT;
    if (c >= NCW) return;
    Wg* ws = reinterpret_cast<Wg*>(smem + C::TILE + align16(sizeof(Wg)) * c);
    const unsigned char* stage = smem + C::STAGE + size_t(TM) * C::SSTR * c;
    const unsigned lt = (1u << lane) - 1u;
    // consumer c's destinations of the flattened g = b * Nd + d: g = wgi + j * nwg for j < nj. Interleaved,
    // not contiguous: the real graphs' pair counts vary by batch element (ligand sizes), and a contiguous
    // share of destinations made some consumers do twice the work of others (0.300 against 0.175 ms at ll48)
    const int G = p.B * Nd, nwg = nblk * NCW, wgi = cblk * NCW + c;
    const int nj = wgi < G ? (G - wgi + nwg - 1) / nwg : 0;
    const uint16_t* a_s = static_cast<const uint16_t*>(chain ? p.a_cs : p.a_es);
    const uint16_t* a_d = static_cast<const uint16_t*>(chain ? p.a_cd : p.a_ed);
    const int NW = LIST ? p.cap : Ns;  // positions a destination: its sources, or its list slots
    int cur_j = 0, cur_s = 0;  // compaction cursor: the j-th destination, position cur_s
    int out_j = 0;             // the next destination to write: wgi + out_j * nwg
    float agg[C::CQT][4];      // edge chain: this thread's column sums of that destination
#pragma unroll
    for (int i = 0; i < C::CQT; ++i) agg[i][0] = agg[i][1] = agg[i][2] = agg[i][3] = 0.0f;
    float agg_t = 0.0f, agg_x[2] = {0.0f, 0.0f};  // t-channel (warp 0); agg_x components hp, hp + 2
    const uint8_t* adj = p.adj;
    auto mask_at = [=](int cj, int cs) {  // the mask at this thread's position of a step from cursor (cj, cs)
      const int s = cs + ht, j = cj + s / Ns;
      if (j >= nj) return false;
      const int g = wgi + j * nwg, b = g / Nd;
      return adj[(size_t(b) * Ns + s - (j - cj) * Ns) * Nd + g - b * Nd] != 0;
    };
    int src = 0;  // list mode: the source at this thread's position, loaded with its flag
    auto slot_at = [&](int cj, int cs) {  // list mode: the flag at this thread's position (slot) of a step
      const int s = cs + ht, j = cj + s / NW;
      if (j >= nj) return false;
      const size_t at = size_t(wgi + j * nwg) * NW + s - (j - cj) * NW;
      const bool v = p.nbr_valid[at] != 0;
      src = p.nbr_idx[at];  // beside the flag's load, not after it: every slot holds an index
      return v && unsigned(src) < unsigned(Ns);
    };
    bool f = LIST ? slot_at(cur_j, cur_s) : mask_at(cur_j, cur_s);  // the next step's flag, loaded a step ahead

    // writes destination wgi + out_j * nwg's sums (this thread's part), clears them and moves on
#define FLUSH()                                                                      \
  do {                                                                               \
    const size_t og_ = size_t(wgi) + size_t(out_j) * nwg;                            \
    if (chain == 0) {                                                                \
      float* o_ = p.agg_h + og_ * H;                                                 \
      _Pragma("unroll") for (int i_ = 0; i_ < C::CQT; ++i_) {                        \
        _Pragma("unroll") for (int e_ = 0; e_ < 4; ++e_) {                           \
          const int c_ = 4 * (ht + HT * i_) + e_;                                    \
          if (c_ < Hm) o_[c_] = agg[i_][e_];                                         \
          agg[i_][e_] = 0.0f;                                                        \
        }                                                                            \
      }                                                                              \
      if (ht == 0) o_[Hm] = agg_t;                                                   \
      agg_t = 0.0f;                                                                  \
    } else if (lane == 0) {                                                          \
      p.agg_x[og_ * 3 + hp] = agg_x[0];                                              \
      if (hp == 0) p.agg_x[og_ * 3 + 2] = agg_x[1];                                  \
    }                                                                                \
    agg_x[0] = agg_x[1] = 0.0f;                                                      \
    ++out_j;                                                                         \
  } while (0)

    // produces the next tile into rows[b]: compaction of the next TM active pairs from the cursor,
    // destination-major, then the rows; returns their number (0 at the end of the range)
    auto produce = [&](int b) {
      TileRows& R = ws->rows[b];
      int filled = 0, par = 0;
      while (filled < TM && cur_j < nj) {
        int s = cur_s + ht;
        const int jj = cur_j + s / NW, gg = wgi + jj * nwg;
        s -= (jj - cur_j) * NW;
        const unsigned m = __ballot_sync(0xffffffffu, f);
        if (lane == 0) ws->masks[par][hp] = m;
        CLK(PH_SETUP);
        named_sync(bar_help(c), HT);
        CLK(PH_BARRIER);
        const unsigned m0 = ws->masks[par][0], m1 = ws->masks[par][1];
        const int total = __popc(m0) + __popc(m1);
        const int pos = filled + (hp ? __popc(m0) : 0) + __popc(m & lt);
        if (f && pos < TM) ws->pl[pos] = make_int2(gg, LIST ? src : s);
        int adv = HT;
        if (filled + total > TM) {  // full: the next tile starts at the (TM - filled)-th active position
          int need = TM - filled;
          unsigned mm = m0;
          int wi = 0;
          if (__popc(m0) <= need) {
            need -= __popc(m0);
            mm = m1;
            wi = 1;
          }
          for (int i = 0; i < need; ++i) mm &= mm - 1u;
          adv = 32 * wi + __ffs(mm) - 1;
          filled = TM;
        } else {
          filled += total;
        }
        cur_s += adv;
        cur_j += cur_s / NW;
        cur_s %= NW;
        par ^= 1;
        f = LIST ? slot_at(cur_j, cur_s) : mask_at(cur_j, cur_s);  // this tile's next step, or the next tile's first
      }
      CLK(PH_SETUP);
      named_sync(bar_help(c), HT);  // the pair list is complete
      CLK(PH_BARRIER);
      const int n = filled;
      {  // row ht: positions, distances and the t-channel's first layer
        int as = 0, ad = 0, g = -1;
        float dij = 0.0f, dx0 = 0.0f, dx1 = 0.0f, dx2 = 0.0f, e1 = 0.0f;
        if (ht < n) {
          const int2 e = ws->pl[ht];
          g = e.x;
          as = (g / Nd) * Ns + e.y;
          ad = g;
          const float* xs = p.x_s + size_t(as) * 3;
          const float* xd = p.x_d + size_t(g) * 3;
          dx0 = xs[0] - xd[0] + 1e-30f;
          dx1 = xs[1] - xd[1] + 1e-30f;
          dx2 = xs[2] - xd[2] + 1e-30f;
          dij = sqrtf(dx0 * dx0 + dx1 * dx1 + dx2 * dx2);
          const uint32_t pre = add_bf16x2(add_bf16x2(a_s[size_t(as) * lda + Hm], a_d[size_t(ad) * lda + Hm]),
                                          mul_bf16x2(pack_bf16x2(dij, 0.0f), pack_bf16x2(vec->wdij_e, 0.0f)));
          e1 = bf16_lo(silu_bf16x2(pre));
        }
        R.as_row[ht] = as;
        R.ad_row[ht] = ad;
        R.dij[ht] = dij;
        R.dx[ht][0] = dx0;
        R.dx[ht][1] = dx1;
        R.dx[ht][2] = dx2;
        R.e1[ht] = e1;
        R.g[ht] = g;
      }
      CLK(PH_SETUP);
      named_sync(bar_help(c), HT);  // the rows' destinations are complete
      CLK(PH_BARRIER);
      if (hp == 0) {  // the runs of rows with one destination
        int k = 0;
#pragma unroll
        for (int h = 0; h < TM; h += 32) {
          const int r = h + lane;
          const bool start = r < n && (r == 0 || R.g[r] != R.g[r - 1]);
          const unsigned bal = __ballot_sync(0xffffffffu, start);
          if (start) R.seg[k + __popc(bal & lt)] = r;
          k += __popc(bal);
        }
        if (lane == 0) {
          R.seg[k] = n;
          R.nseg = k;
          R.n = n;
        }
      }
      CLK(PH_SETUP);
      named_arrive(bar_full(c, b), HAND);
      return n;
    };

    // the first NBUF tiles, then: a tile's sums once its epilogue is done, and the tile NBUF further on
    int n_next = produce(0), ended = n_next == 0;
    int n_ahead = 0;
    if (NBUF == 2 && !ended) {
      n_ahead = produce(1);
      ended = n_ahead == 0;
    }
    for (int i = 0; n_next > 0; ++i) {
      const int b = i % NBUF;
      TileRows& R = ws->rows[b];
      named_sync(bar_epi(c), HAND);
      CLK(PH_BARRIER);
      if (chain == 0) {  // run by run, in row order; a destination's sums are written when its rows end
        for (int k = 0; k < R.nseg; ++k) {
          const int ra = R.seg[k], rb = R.seg[k + 1];
          const int g = R.g[ra];
          while (wgi + out_j * nwg < g) FLUSH();
#pragma unroll 4
          for (int r = ra; r < rb; ++r) {
            const float v = R.val[r];
#pragma unroll
            for (int i2 = 0; i2 < C::CQT; ++i2) {
              if (ht + HT * i2 < NP / 4) {
                const uint2 mm = *reinterpret_cast<const uint2*>(stage + r * C::SSTR + 8 * (ht + HT * i2));
                agg[i2][0] = fmaf(v, bf16_lo(mm.x), agg[i2][0]);
                agg[i2][1] = fmaf(v, bf16_hi(mm.x), agg[i2][1]);
                agg[i2][2] = fmaf(v, bf16_lo(mm.y), agg[i2][2]);
                agg[i2][3] = fmaf(v, bf16_hi(mm.y), agg[i2][3]);
              }
            }
          }
          if (hp == 0) {  // the t-channel: lanes over the run's rows, then a warp sum
            float x = 0.0f;
            for (int r = ra + lane; r < rb; r += 32) x += R.tval[r];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
            agg_t += x;
          }
        }
      } else {  // warp hp sums components hp (and 2) of k * dx over each run: lanes over rows, then a warp sum
        for (int k = 0; k < R.nseg; ++k) {
          const int ra = R.seg[k], rb = R.seg[k + 1];
          const int g = R.g[ra];
          while (wgi + out_j * nwg < g) FLUSH();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j == 0 || hp == 0) {
              const int comp = j ? 2 : hp;
              float x = 0.0f;
              for (int r = ra + lane; r < rb; r += 32) x = fmaf(R.val[r], R.dx[r][comp], x);
#pragma unroll
              for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
              agg_x[j] += x;
            }
          }
        }
      }
      CLK(PH_AGG);
      const int n_after = NBUF == 2 ? n_ahead : 0;  // rows of tile i + 1 when already produced
      int n_new = 0;
      if (NBUF == 2) {
        if (n_after > 0) named_arrive(bar_free(c), HAND);  // tile i + 1's epilogue may write the staging buffer
        if (!ended) {
          n_new = produce(b);  // tile i + 2 into this tile's rows
          ended = n_new == 0;
        }
        n_next = n_after;
        n_ahead = n_new;
      } else {
        if (!ended) {
          n_new = produce(0);
          ended = n_new == 0;
        }
        if (n_new > 0) named_arrive(bar_free(c), HAND);
        n_next = n_new;
      }
    }
    while (out_j < nj) FLUSH();  // the last destinations, and those without pairs
#undef FLUSH
    CLK(PH_AGG);
    CLK_END(2 + chain)
    return;
  }

  // ================= consumer warpgroup wg: first layer, product, epilogue
  if constexpr (NCW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 208;" ::: "memory");
  const int t = tid % WGT, w = t >> 5;
  Wg* ws = reinterpret_cast<Wg*>(smem + C::TILE + align16(sizeof(Wg)) * wg);
  unsigned char* stage = smem + C::STAGE + size_t(TM) * C::SSTR * wg;
  const uint16_t* a_s = static_cast<const uint16_t*>(chain ? p.a_cs : p.a_es);
  const uint16_t* a_d = static_cast<const uint16_t*>(chain ? p.a_cd : p.a_ed);
  const int q = lane & 3, r0 = 16 * w + (lane >> 2), r1 = r0 + 8;
  const uint64_t desc0 = sw128_desc(smem_addr(smem));
  bool w2_ready = false;
  for (int i = 0;; ++i) {
    TileRows& R = ws->rows[i % NBUF];
    CLK(PH_EPILOGUE);
    named_sync(bar_full(wg, i % NBUF), HAND);
    CLK(PH_BARRIER);
    const int nrows = R.n;
    if (nrows == 0) break;

    // ---- first layer into the A fragments, two k-steps of loads ahead of the product; then the epilogue
    float acc[NPW / 2];  // written by the first k-step's product (scale_d 0)
    const uint16_t* as0 = a_s + size_t(R.as_row[r0]) * lda;
    const uint16_t* ad0 = a_d + size_t(R.ad_row[r0]) * lda;
    const uint16_t* as1 = a_s + size_t(R.as_row[r1]) * lda;
    const uint16_t* ad1 = a_d + size_t(R.ad_row[r1]) * lda;
    const float dijf0 = R.dij[r0], dijf1 = R.dij[r1];
    const uint32_t dij_0 = pack_bf16x2(dijf0, dijf0), dij_1 = pack_bf16x2(dijf1, dijf1);
    const float e1_0 = R.e1[r0], e1_1 = R.e1[r1];
    float e2_0 = 0.0f, e2_1 = 0.0f, dot0 = 0.0f, dot1 = 0.0f;
    if (!w2_ready) {
      CLK(PH_SETUP);
      mbar_wait(&vec->bar, 0);
      w2_ready = true;
      CLK(PH_W2);
    }
    // a thread's four channels of a k-step, rows r0 and r1: a_s, a_d as bf16x2 pairs (zero past the main block)
    struct Step {
      uint2 s0, d0, s1, d1;
    };
    auto load_step = [&](int kt) {
      const int k = 16 * kt + 4 * q;
      Step v;
      const uint2 z = make_uint2(0u, 0u);
      const bool in = kt < NK && k < Hm;
      v.s0 = in ? *reinterpret_cast<const uint2*>(as0 + k) : z;
      v.d0 = in ? *reinterpret_cast<const uint2*>(ad0 + k) : z;
      v.s1 = in ? *reinterpret_cast<const uint2*>(as1 + k) : z;
      v.d1 = in ? *reinterpret_cast<const uint2*>(ad1 + k) : z;
      return v;
    };
#pragma unroll
    for (int pass = 0; pass < NPASS; ++pass) {
      Step ahead0 = load_step(0), ahead1 = load_step(1);  // two k-steps of loads in flight
#pragma unroll
      for (int kt = 0; kt < NK; ++kt) {
        const int k = 16 * kt + 4 * q;  // this thread's channels k .. k + 3 of the step
        const Step cur = ahead0;
        ahead0 = ahead1;
        if (kt + 2 < NK) ahead1 = load_step(kt + 2);
        const uint2 wd = *reinterpret_cast<const uint2*>(&vec->wdij2[k >> 1]);
        uint32_t a[4];
        a[0] = first_layer2(cur.s0.x, cur.d0.x, dij_0, wd.x);
        a[1] = first_layer2(cur.s1.x, cur.d1.x, dij_1, wd.x);
        a[2] = first_layer2(cur.s0.y, cur.d0.y, dij_0, wd.y);
        a[3] = first_layer2(cur.s1.y, cur.d1.y, dij_1, wd.y);
        if (16 * kt + 16 > Hm) {  // the step reaches past the main block: its channels there stay zero
          a[0] = main_only(a[0], k, Hm);
          a[1] = main_only(a[1], k, Hm);
          a[2] = main_only(a[2], k + 2, Hm);
          a[3] = main_only(a[3], k + 2, Hm);
        }
        if (pass == 0) {  // the t-channel column: sum of rnd(m1 * rnd(w_col)) in f32
          const uint2 wc = *reinterpret_cast<const uint2*>(&vec->wcol2[k >> 1]);
          const uint32_t p00 = mul_bf16x2(a[0], wc.x), p02 = mul_bf16x2(a[2], wc.y);
          const uint32_t p10 = mul_bf16x2(a[1], wc.x), p12 = mul_bf16x2(a[3], wc.y);
          e2_0 += (bf16_lo(p00) + bf16_hi(p00)) + (bf16_lo(p02) + bf16_hi(p02));
          e2_1 += (bf16_lo(p10) + bf16_hi(p10)) + (bf16_lo(p12) + bf16_hi(p12));
        }
        CLK(PH_LAYER1);
        if (kt >= 2) wgmma_wait<1>();  // at most one product in flight while this step's is issued
        wgmma_fence();
        const uint32_t off = (kt >> 2) * (NP * 128) + (kt & 3) * 32 + pass * (NPW * 128);
        wgmma_tile<NPW>(acc, a, desc0 + (off >> 4), kt > 0);
        wgmma_commit();
        CLK(PH_PRODUCT);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i2 = 0; i2 < NPW / 2; ++i2) fence_operand(acc[i2]);
      CLK(PH_PRODUCT);
      if (pass == 0 && i > 0) {  // the helper is done summing the previous tile's staged m
        named_sync(bar_free(wg), HAND);
        CLK(PH_BARRIER);
      }

      // epilogue of this pass: acc[4 j + i] holds C[row (i < 2 ? r0 : r1)][column 8 j + 2 q + (i & 1)]
#pragma unroll
      for (int j = 0; j < NPW / 8; ++j) {
        const int cc = pass * NPW + 8 * j + 2 * q;
        const float2 wr = *reinterpret_cast<const float2*>(&vec->wrow[cc]);
        const float2 bb = *reinterpret_cast<const float2*>(&vec->b2[cc]);
        const uint32_t wv2 = *reinterpret_cast<const uint32_t*>(&vec->wv[cc]);
        // m2 = rnd(silu(rnd((C + e1 * w_row) + b2))): the row term enters the f32 sum by an fma (the
        // reference rounds e1 * w_row first: an f32 difference, as the tensor cores' order of summation is)
        const uint32_t m0 = silu_bf16x2(pack_bf16x2(__fadd_rn(__fmaf_rn(e1_0, wr.x, acc[4 * j]), bb.x),
                                                    __fadd_rn(__fmaf_rn(e1_0, wr.y, acc[4 * j + 1]), bb.y)));
        const uint32_t m1 = silu_bf16x2(pack_bf16x2(__fadd_rn(__fmaf_rn(e1_1, wr.x, acc[4 * j + 2]), bb.x),
                                                    __fadd_rn(__fmaf_rn(e1_1, wr.y, acc[4 * j + 3]), bb.y)));
        const uint32_t q0 = mul_bf16x2(m0, wv2), q1 = mul_bf16x2(m1, wv2);
        dot0 += bf16_lo(q0) + bf16_hi(q0);
        dot1 += bf16_lo(q1) + bf16_hi(q1);
        if (chain == 0) {
          *reinterpret_cast<uint32_t*>(stage + r0 * C::SSTR + 2 * cc) = m0;
          *reinterpret_cast<uint32_t*>(stage + r1 * C::SSTR + 2 * cc) = m1;
        }
      }
    }

    // ---- the rows' scalars: reduce over the quad, then lane q = 0 writes rows r0 and r1
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
      e2_0 += __shfl_xor_sync(0xffffffffu, e2_0, o);
      e2_1 += __shfl_xor_sync(0xffffffffu, e2_1, o);
    }
    if (q == 0) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = i2 ? r1 : r0;
        const float e2 = silu_f32(__fadd_rn(__fadd_rn(i2 ? e2_1 : e2_0, __fmul_rn(i2 ? e1_1 : e1_0, vec->w_cc)),
                                            vec->b_e));
        const float dot = __fadd_rn(i2 ? dot1 : dot0, __fmul_rn(e2, vec->wv_e));
        float v, tv = 0.0f;
        if (chain == 0) {
          v = 1.0f / (1.0f + expf(-(dot + vec->atb)));
          tv = e2 * v;
        } else {
          const float sc = p.use_tanh ? tanhf(dot) * p.coords_range : dot;
          v = sc / ((i2 ? dijf1 : dijf0) + 1.0f);
        }
        R.val[r] = r < nrows ? v : 0.0f;
        R.tval[r] = r < nrows ? tv : 0.0f;
      }
    }
    CLK(PH_EPILOGUE);
    named_arrive(bar_epi(wg), HAND);  // staged m and the rows' scalars are complete
  }
  if (!w2_ready) mbar_wait(&vec->bar, 0);  // no bulk copy outlives the block
  CLK(PH_EPILOGUE);
  CLK_END(chain)
}

using Main = V5<256, 1, 256, 2>;  // main block up to 256: one m64n256k16 pass, two consumer warpgroups
using Wide = V5<144, 2, 320, 1>;  // main block 257 .. 287: two N halves of 144, K padded to 320, one consumer

// The product alone on one 64-row tile, for the chip check: out (64 x 256 f32)
// = a (64 x 256 bf16, row-major) @ the main block packed by pack_w2 (Hm <= 256),
// through the same descriptors, fragments and channel order as the kernel.
__global__ void __launch_bounds__(WGT, 1) wgmma_probe_kernel(const __nv_bfloat16* a, const void* img, float* out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Main::W2_BYTES);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, q = lane & 3;
  const int r0 = 16 * w + (lane >> 2), r1 = r0 + 8;
  if (t == 0) {
    mbar_init(bar, 1);
    load_resident(smem, img, uint32_t(Main::W2_BYTES), bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  const uint64_t desc0 = sw128_desc(smem_addr(smem));
#pragma unroll
  for (int kt = 0; kt < Main::NK; ++kt) {
    const int k = 16 * kt + 4 * q;
    uint32_t f[4] = {a32[(r0 * 256 + k) >> 1], a32[(r1 * 256 + k) >> 1], a32[(r0 * 256 + k + 2) >> 1],
                     a32[(r1 * 256 + k + 2) >> 1]};
    wgmma_fence();
    wgmma_tile<256>(acc, f, desc0 + (((kt >> 2) * (256 * 128) + (kt & 3) * 32) >> 4), kt > 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * q;
    out[r0 * 256 + c] = acc[4 * j];
    out[r0 * 256 + c + 1] = acc[4 * j + 1];
    out[r1 * 256 + c] = acc[4 * j + 2];
    out[r1 * 256 + c + 1] = acc[4 * j + 3];
  }
}

}  // namespace

namespace {

// ---- the f32 kernel: a check of the algorithm on the CUDA cores

// Compacts the active pairs of sources [s0, s0 + ST) onto the block's
// destinations, destination-major, as s | dl << 16 into plist, and returns
// their number. Warp w takes destinations w, w + nwarps, ...; masks holds
// 2 * TD words of scratch. Holds two block barriers.
__device__ __forceinline__ int compact_tile(const uint8_t* adj, int Ns, int Nd, int b, int d0, int nd_here, int s0,
                                           int* plist, unsigned* masks) {
  static_assert(ST == 64, "two ballots per destination");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int ns_here = min(ST, Ns - s0);
  for (int dl = warp; dl < TD; dl += nwarps) {
    const uint8_t* col = adj + (size_t(b) * Ns + s0) * Nd + d0 + dl;
    const bool live = dl < nd_here;
    const bool f0 = live && lane < ns_here && col[size_t(lane) * Nd] != 0;
    const bool f1 = live && lane + 32 < ns_here && col[size_t(lane + 32) * Nd] != 0;
    const unsigned m0 = __ballot_sync(0xffffffffu, f0), m1 = __ballot_sync(0xffffffffu, f1);
    if (lane == 0) {
      masks[2 * dl] = m0;
      masks[2 * dl + 1] = m1;
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  for (int dl = warp; dl < TD; dl += nwarps) {
    int off = 0;
    for (int i = 0; i < 2 * dl; ++i) off += __popc(masks[i]);
    const unsigned m0 = masks[2 * dl], m1 = masks[2 * dl + 1];
    if (m0 & (1u << lane)) plist[off + __popc(m0 & lt)] = (s0 + lane) | (dl << 16);
    if (m1 & (1u << lane)) plist[off + __popc(m0) + __popc(m1 & lt)] = (s0 + lane + 32) | (dl << 16);
  }
  int total = 0;
  for (int i = 0; i < 2 * TD; ++i) total += __popc(masks[i]);
  __syncthreads();
  return total;
}

// W2[k, n] of the full (H x H) second layer from pack_w2's operands (f32)
__device__ __forceinline__ float w2_at(const float* main, const float* tail, int k, int n, int Hm, int NP, int KP) {
  if (k < Hm) return n < Hm ? main[main_index(k, n, NP)] : tail[NP + k];
  return n < Hm ? tail[n] : tail[NP + KP];
}

__host__ __device__ inline size_t f32_smem_bytes(int HP) {
  return size_t(2) * MR_F32 * HP * 4      // A, C
         + size_t(TD) * HP * 4            // per-destination agg_h sums
         + align16(size_t(TD) * ST * 4)   // pair list of a source tile
         + align16(size_t(2) * TD * 4)    // compaction masks
         + size_t(MR_F32) * 4 * 7         // dij, dx[3], v, s, dl of the chunk's rows
         + size_t(3) * HP * 4             // w_dij, b2, wv of the block's chain
         + align16(size_t(TD) * 3 * 4);   // agg_x sums
}

// One block owns 16 destinations of one batch element and one chain; chunks
// of 64 pair rows go through shared memory (first layer A, product C,
// epilogue in place), W2 is read from its packed operands in global memory,
// and each destination's sums are kept in shared memory across chunks and
// source tiles. The full H x H product equals the reference's split in f32.
__global__ void __launch_bounds__(THREADS_F32, 1) egnn_edge_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WARPS = THREADS_F32 / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d0 = blockIdx.x * TD, chain = blockIdx.z;
  const int nd_here = min(TD, p.Nd - d0);
  const int H = p.H, HP = (H + 15) / 16 * 16, Ns = p.Ns, Nd = p.Nd, lda = p.lda, Hm = H - 1;

  float* A = reinterpret_cast<float*>(smem);
  float* C = A + MR_F32 * HP;
  float* acc_h = C + MR_F32 * HP;
  unsigned char* ptr = reinterpret_cast<unsigned char*>(acc_h + TD * HP);
  int* plist = reinterpret_cast<int*>(ptr);
  ptr += align16(size_t(TD) * ST * 4);
  unsigned* masks = reinterpret_cast<unsigned*>(ptr);
  ptr += align16(size_t(2) * TD * 4);
  float* row_dij = reinterpret_cast<float*>(ptr);
  float* row_dx = row_dij + MR_F32;  // MR x 3
  float* row_v = row_dx + 3 * MR_F32;
  int* row_s = reinterpret_cast<int*>(row_v + MR_F32);
  int* row_dl = row_s + MR_F32;
  float* v_wdij = reinterpret_cast<float*>(row_dl + MR_F32);
  float* v_b2 = v_wdij + HP;
  float* v_wv = v_b2 + HP;
  float* acc_x = v_wv + HP;

  const float* a_s = static_cast<const float*>(chain ? p.a_cs : p.a_es);
  const float* a_d = static_cast<const float*>(chain ? p.a_cd : p.a_ed);
  const float* w_dij = chain ? p.w_cdij : p.w_edij;
  const float* b2 = chain ? p.b2c : p.b2e;
  const float* wv = chain ? p.wout : p.attw;
  const float* Wm = reinterpret_cast<const float*>(chain ? p.w2c_main : p.w2e_main);
  const float* Wt = chain ? p.w2c_tail : p.w2e_tail;
  for (int i = tid; i < TD * HP; i += THREADS_F32) acc_h[i] = 0.0f;
  if (tid < TD * 3) acc_x[tid] = 0.0f;
  for (int k = tid; k < HP; k += THREADS_F32) {
    const bool in = k < H;
    v_wdij[k] = in ? w_dij[k] : 0.0f;
    v_b2[k] = in ? b2[k] : 0.0f;
    v_wv[k] = in ? wv[k] : 0.0f;
  }
  const float atb = *p.atb;

  for (int s0 = 0; s0 < Ns; s0 += ST) {
    const int npairs = compact_tile(p.adj, Ns, Nd, b, d0, nd_here, s0, plist, masks);
    for (int base = 0; base < npairs; base += MR_F32) {
      const int nrows = min(MR_F32, npairs - base);
      if (tid < nrows) {
        const int e = plist[base + tid];
        const int s = e & 0xffff, dl = e >> 16;
        const float* xs = p.x_s + (size_t(b) * Ns + s) * 3;
        const float* xd = p.x_d + (size_t(b) * Nd + d0 + dl) * 3;
        const float dx0 = xs[0] - xd[0] + 1e-30f;
        const float dx1 = xs[1] - xd[1] + 1e-30f;
        const float dx2 = xs[2] - xd[2] + 1e-30f;
        row_dx[3 * tid] = dx0;
        row_dx[3 * tid + 1] = dx1;
        row_dx[3 * tid + 2] = dx2;
        row_dij[tid] = sqrtf(dx0 * dx0 + dx1 * dx1 + dx2 * dx2);
        row_s[tid] = s;
        row_dl[tid] = dl;
      }
      __syncthreads();

      // first layer: A[r, k] = silu(a_s[s, k] + a_d[d, k] + dij * w_dij[k]), zero past the rows
      for (int r = warp; r < MR_F32; r += WARPS) {
        const bool live = r < nrows;
        const float* as = a_s + (size_t(b) * Ns + (live ? row_s[r] : 0)) * lda;
        const float* ad = a_d + (size_t(b) * Nd + d0 + (live ? row_dl[r] : 0)) * lda;
        const float dij = live ? row_dij[r] : 0.0f;
        for (int k = lane; k < HP; k += 32) {
          A[r * HP + k] = live && k < H ? silu_f32(as[k] + ad[k] + dij * v_wdij[k]) : 0.0f;
        }
      }
      __syncthreads();

      // second layer: thread n computes column n of C = A @ W2 for all rows
      for (int n = tid; n < H; n += THREADS_F32) {
        float acc[MR_F32];
#pragma unroll
        for (int r = 0; r < MR_F32; ++r) acc[r] = 0.0f;
        for (int k = 0; k < H; ++k) {
          const float w = w2_at(Wm, Wt, k, n, Hm, p.NP, p.KP);
#pragma unroll
          for (int r = 0; r < MR_F32; ++r) acc[r] = fmaf(A[r * HP + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < MR_F32; ++r) C[r * HP + n] = acc[r];
      }
      __syncthreads();

      // epilogue: m = silu(C + b2) in place, the row product m . wv, and the row's coefficient
      for (int r = warp; r < nrows; r += WARPS) {
        float dot = 0.0f;
        for (int k = lane; k < H; k += 32) {
          const float m = silu_f32(C[r * HP + k] + v_b2[k]);
          C[r * HP + k] = m;
          dot += m * v_wv[k];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane == 0) {
          if (chain == 0) {
            row_v[r] = 1.0f / (1.0f + expf(-(dot + atb)));
          } else {
            const float sc = p.use_tanh ? tanhf(dot) * p.coords_range : dot;
            row_v[r] = sc / (row_dij[r] + 1.0f);
          }
        }
      }
      __syncthreads();

      // aggregate onto destinations, in pair order (deterministic)
      if (chain == 0) {
        for (int n = tid; n < H; n += THREADS_F32) {
          for (int r = 0; r < nrows; ++r) acc_h[row_dl[r] * HP + n] += C[r * HP + n] * row_v[r];
        }
      } else if (tid < TD * 3) {
        const int d = tid / 3, comp = tid - 3 * d;
        for (int r = 0; r < nrows; ++r) {
          if (row_dl[r] == d) acc_x[tid] += row_v[r] * row_dx[3 * r + comp];
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (chain == 0) {
    for (int idx = tid; idx < nd_here * H; idx += THREADS_F32) {
      const int dl = idx / H, c = idx - dl * H;
      p.agg_h[(size_t(b) * Nd + d0 + dl) * H + c] = acc_h[dl * HP + c];
    }
  } else if (tid < nd_here * 3) {
    p.agg_x[(size_t(b) * Nd + d0) * 3 + tid] = acc_x[tid];
  }
}

size_t smem_bytes(int H, bool bf16) {
  if (!bf16) return f32_smem_bytes((H + 15) / 16 * 16);
  return H - 1 <= 256 ? Main::SMEM : Wide::SMEM;
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// positions: the helpers' compaction positions of the launch (B * Nd * Ns, or B * Nd * cap in the list mode)
template <class V, class K>
cudaError_t launch_v5(K kernel, const Params& p, long long positions, cudaStream_t st) {
  const size_t smem = V::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  // one block per SM at most, half on each chain (an H100 ran slower with 3% more or fewer
  // on the edge chain, whose helpers also sum m), and about two dense tiles of work for each
  // consumer warpgroup
  const int nsm = sm_count();
  if (nsm < 2) return cudaErrorInvalidDevice;
  const long long dense = positions;
  long long want = (dense + 2 * TM * V::WGS - 1) / (2 * TM * V::WGS);  // blocks a chain could use
  want = want < 1 ? 1 : (want > nsm / 2 ? nsm / 2 : want);
  Params q = p;
  q.edge_blocks = int(want);
  const int coord = int(want);
  kernel<<<q.edge_blocks + coord, V::THREADS, smem, st>>>(q);
  return cudaGetLastError();
}

// The tracer's device timer (kpdiff_tpu_torch/utils/profiling.py): one thread
// reads %globaltimer. buf: [previous stamp's time, replays, ns per slot]. A
// stamp with slot >= 0 adds the time since the previous stamp to that slot; the
// replay's first stamp (slot < 0) counts the replay. The stamps of one graph
// run one after another on its stream, so plain adds suffice.
__global__ void kpdiff_device_stamp_kernel(unsigned long long* buf, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (slot < 0)
    buf[1] += 1;
  else
    buf[2 + slot] += now - buf[0];
  buf[0] = now;
}

}  // namespace

extern "C" {

int kpdiff_device_stamp(unsigned long long* buf, int slot, void* stream) {
  kpdiff_device_stamp_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(buf, slot);
  return int(cudaGetLastError());
}

// Kernel nodes and all nodes of the graph that `stream` is capturing, read
// from the graph under construction (in relaxed capture mode, so that the
// queries cannot invalidate a capture in global mode).
int kpdiff_capture_kernel_nodes(void* stream, long long* kernels, long long* nodes) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t e = cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return int(e);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  e = cudaStreamGetCaptureInfo(reinterpret_cast<cudaStream_t>(stream), &status, nullptr, &graph);
  size_t n = 0;
  if (e == cudaSuccess && (status != cudaStreamCaptureStatusActive || graph == nullptr)) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaGraphGetNodes(graph, nullptr, &n);
  long long k = 0;
  if (e == cudaSuccess && n > 0) {
    cudaGraphNode_t* all = new cudaGraphNode_t[n];
    e = cudaGraphGetNodes(graph, all, &n);
    for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
      cudaGraphNodeType type;
      e = cudaGraphNodeGetType(all[i], &type);
      k += e == cudaSuccess && type == cudaGraphNodeTypeKernel;
    }
    delete[] all;
  }
  cudaError_t restore = cudaThreadExchangeStreamCaptureMode(&mode);
  if (e == cudaSuccess) e = restore;
  *kernels = k;
  *nodes = (long long)n;
  return int(e);
}

size_t egnn_edge_dense_smem_bytes(int H, int bf16) { return smem_bytes(H, bf16 != 0); }

int egnn_edge_dense_max_h() { return MAX_H; }

// (KP, NP) of pack_w2's main-block image for width H
int egnn_edge_dense_main_kp(int H) { return H - 1 <= 256 ? 256 : 320; }
int egnn_edge_dense_main_np(int H) { return H - 1 <= 256 ? 256 : 288; }

// The checks both modes make; sets *done where nothing is left to launch: no destinations, or no
// sources (zero sums).
static cudaError_t launch_prelude(int B, int Ns, int Nd, int H, int lda, float* agg_h, float* agg_x, cudaStream_t st,
                                  bool* done) {
  *done = true;
  if (B == 0 || Nd == 0) return cudaSuccess;
  if (H < 2 || H > MAX_H || Ns > 0xffff || lda % 4 != 0 || lda < H || (long long)B * Nd > 0x7fffffff ||
      (long long)B * Ns > 0x7fffffff)  // row indices b * Ns + s and b * Nd + d are ints
    return cudaErrorInvalidValue;
  if (Ns == 0) {  // no pairs: zero sums
    cudaError_t e = cudaMemsetAsync(agg_h, 0, size_t(B) * Nd * H * 4, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(agg_x, 0, size_t(B) * Nd * 3 * 4, st);
    return e;
  }
  *done = false;
  return cudaSuccess;
}

int egnn_edge_dense_launch(const void* a_es, const void* a_ed, const void* a_cs, const void* a_cd,
                           const float* w_edij, const float* w_cdij, const void* w2e_main, const float* w2e_tail,
                           const float* b2e, const float* attw, const float* atb, const void* w2c_main,
                           const float* w2c_tail, const float* b2c, const float* wout, const float* x_s,
                           const float* x_d, const uint8_t* adj, float* agg_h, float* agg_x, int B, int Ns, int Nd,
                           int H, int lda, int use_tanh, float coords_range, int bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bool done;
  cudaError_t e = launch_prelude(B, Ns, Nd, H, lda, agg_h, agg_x, st, &done);
  if (done || e != cudaSuccess) return int(e);
  const int KP = egnn_edge_dense_main_kp(H), NP = egnn_edge_dense_main_np(H);
  Params p{a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e_main, w2c_main, w2e_tail, w2c_tail, b2e, b2c, attw, wout,
           atb, x_s, x_d, adj, agg_h, agg_x, B, Ns, Nd, H, lda, KP, NP, 0, use_tanh, coords_range};
  if (bf16) {
    const long long positions = (long long)B * Nd * Ns;
    if (H - 1 <= 256) return int(launch_v5<Main>(egnn_edge_v5_kernel<256, 1, 256, 2, false>, p, positions, st));
    return int(launch_v5<Wide>(egnn_edge_v5_kernel<144, 2, 320, 1, false>, p, positions, st));
  }
  const size_t smem = smem_bytes(H, false);
  e = cudaFuncSetAttribute(egnn_edge_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((Nd + TD - 1) / TD, B, 2);  // z: the chain (0 edge, 1 coordinate)
  egnn_edge_f32_kernel<<<grid, THREADS_F32, smem, st>>>(p);
  return int(cudaGetLastError());
}

// The list mode (bf16 only): the operands of egnn_edge_dense_launch with idx (B,Nd,cap) int32 and
// valid (B,Nd,cap) in place of adj.
int egnn_edge_list_launch(const void* a_es, const void* a_ed, const void* a_cs, const void* a_cd,
                          const float* w_edij, const float* w_cdij, const void* w2e_main, const float* w2e_tail,
                          const float* b2e, const float* attw, const float* atb, const void* w2c_main,
                          const float* w2c_tail, const float* b2c, const float* wout, const float* x_s,
                          const float* x_d, const int* idx, const uint8_t* valid, float* agg_h, float* agg_x, int B,
                          int Ns, int Nd, int cap, int H, int lda, int use_tanh, float coords_range, void* stream) {
  if (cap < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  bool done;
  cudaError_t e = launch_prelude(B, Ns, Nd, H, lda, agg_h, agg_x, st, &done);
  if (done || e != cudaSuccess) return int(e);
  const int KP = egnn_edge_dense_main_kp(H), NP = egnn_edge_dense_main_np(H);
  Params p{a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e_main, w2c_main, w2e_tail, w2c_tail, b2e, b2c, attw, wout,
           atb, x_s, x_d, nullptr, agg_h, agg_x, B, Ns, Nd, H, lda, KP, NP, 0, use_tanh, coords_range,
           idx, valid, cap};
  const long long positions = (long long)B * Nd * cap;
  if (H - 1 <= 256) return int(launch_v5<Main>(egnn_edge_v5_kernel<256, 1, 256, 2, true>, p, positions, st));
  return int(launch_v5<Wide>(egnn_edge_v5_kernel<144, 2, 320, 1, true>, p, positions, st));
}

int egnn_edge_wgmma_probe(const void* a, const void* img, float* out, void* stream) {
  const size_t smem = Main::W2_BYTES + 16 + 1024;
  cudaError_t e = cudaFuncSetAttribute(wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  wgmma_probe_kernel<<<1, WGT, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), img, out);
  return int(cudaGetLastError());
}

const char* egnn_edge_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

#ifdef EGNN_EDGE_PHASE_CLOCKS
int egnn_edge_phase_clocks_count() { return N_PHASES; }

int egnn_edge_phase_clocks_reset() {
  static const unsigned long long zeros[4][N_PHASES] = {};
  return int(cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));
}

// out: 4 * N_PHASES totals: the edge and the coordinate chain's consumer warps, then their helper warps
int egnn_edge_phase_clocks_read(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(unsigned long long) * 4 * N_PHASES));
}
#endif

}  // extern "C"
