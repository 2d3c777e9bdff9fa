// GVP edge messages over a destination-major neighbor list, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs its GVP messages as XLA
// operations. The function is kpdiff_tpu_torch/models/gvp.py::
// GVPEdgeMessages.nbr (and `pairs` with the gathered nodes as sources, the lk
// edges), for the dynamics' configuration: scalars S = 256, vector channels
// V = 16, a chain of three GVPs, no edge features, no destination features,
// bf16 compute. For every flattened destination g = b * Nd + d and every
// valid slot j of its list (source s = idx[g, j], valid[g, j] set, 0 <= s <
// Ns) it computes the message chain on the edge (s, d) and writes the sum (or
// the mean over the valid slots) into out_s[g] (S) and out_v[g] (V x 3), f32:
//   diff = x_s - x_d, dij = sqrt(max(|diff|^2, 1e-8)) + 1e-8, unit = diff / dij,
//   rbf_k = exp(-((dij - mu_k) / sigma)^2), k < 16;
//   GVP0: Vh = unit (x) Wh0[0] + Q[s] (17 channels), Vu = Vh Wu0,
//         f = silu(P[s] + rbf K0r + |Vh| K0n + b0), gates sigmoid(f G0 + gb0) on Vu;
//   GVP1, GVP2: Vh = V Wh, Vu = Vh Wu, f = silu([f, |Vh|] K + b), gates on Vu.
// P = h_src K0[:S] and Q = v_src Wh0[1:] are the per-node pieces of GVP0,
// computed once per source node before the launch (one matrix product, the
// wrapper's `node_rows`), so the kernel gathers rows instead of multiplying
// per slot. Rounding follows the reference in bf16: every product and sum
// that the reference rounds is rounded here (to nearest even), the channel
// norms and the sums over edges are f32; exp and the reciprocal of the
// sigmoids are the hardware's approximations (below bf16's step).
//
// What bounds it: operations. GVP1 and GVP2 each multiply [f, |Vh|] (272) by
// a 272 x 256 matrix: 2 * 2 * 272 * 256 FLOPs an edge on the tensor cores,
// about 0.3 MFLOP with the small maps. The all-atom kk list holds about 50k
// valid edges of its 295k slots: 16 GFLOP a layer, 0.02 ms at the H100's
// 989 TFLOP/s. Bytes are small (node rows, the list, the sums). In practice
// the CUDA cores bound it, at 18x that bound (0.26 ms at the all-atom kk on
// an H100): the reference's rounding places, the activations (two
// special-function operations a value) and the sums, issued by one warp a
// scheduler; without the tensor-core products it ran 7% faster, without
// the activations 32%, without the sums 13%.
// The design:
//   * one warpgroup a block, one block a SM (213 KB of shared memory); the
//     blocks take interleaved destinations (g = block + i * grid), so that
//     graphs with many and few edges spread evenly;
//   * compaction: the block walks its destinations' slots 128 at a time,
//     ballots the valid ones and fills tiles of 64 edge rows, destination
//     after destination in slot order; padding slots cost no tensor work;
//   * the chain in registers, in mma fragment layouts: a warp owns 16 rows,
//     and the accumulator layout of one product is the A-fragment layout of
//     the next, so no per-edge tensor leaves the SM. The two 256 x 256 blocks
//     of GVP1 and GVP2 run as wgmma m64n128k16 (A from registers, B from
//     shared memory, f32 accumulators), one N half at a time; every smaller
//     product (the vector maps, the norm and rbf rows, the gates) is an
//     mma.sync m16n8k16 on operands packed once on the host in fragment order
//     (`pack_weights` in ops/cuda/gvp_message.py) and kept in shared memory;
//   * the two large matrices (128 KB each) do not fit beside each other: they
//     stream from L2 in pieces of 16 KB (one K-block of 64 by one N half,
//     the 128-byte swizzled image the wgmma descriptor reads) through a ring
//     of six slots, bulk asynchronous copies completing on mbarriers; a slot
//     is refilled as soon as the products that read it are done;
//   * aggregation: GVP2's messages go to shared memory as bf16 and each
//     thread sums its columns over the tile's rows in row order, carrying the
//     open destination across tiles. No atomics: two launches agree bitwise.
//
// C interface (loaded with ctypes): gvp_message_launch returns the
// cudaError_t of the launch; gvp_message_error_string names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 256;            // scalar width
constexpr int V = 16;             // vector channels
constexpr int NRBF = 16;          // rbf channels
constexpr int ROWW = S + 3 * 32;  // node row (bf16): P (S), then Q as [component][32 channels]
constexpr int TM = 64;            // edge rows a tile
constexpr int THREADS = 128;      // one warpgroup
constexpr int RING = 6;           // weight pieces in flight
constexpr int PIECE = 64 * 128;   // bf16 elements of a piece: a K-block of 64 by an N half of 128
constexpr int PIECE_BYTES = PIECE * 2;
constexpr int N_PIECES = 16;      // GVP1 and GVP2, two halves of four K-blocks each
constexpr int SST = S / 2 + 4;    // stage row stride (words): conflict-free fragment stores
constexpr int VST = 28;           // vector stage row stride (words): 3 x 16 bf16 used

// The small matrices in mma fragment order (32-bit words, bf16 pairs): a
// K x N matrix is (K / 16) x (N / 8) fragments of 32 lanes x 2 words.
constexpr int fw(int k, int n) { return (k / 16) * (n / 8) * 64; }
constexpr int OFF_WU0 = 0;                       // Wu0, rows padded to 32
constexpr int OFF_KR0 = OFF_WU0 + fw(32, V);     // K0 rows of the rbf
constexpr int OFF_KN0 = OFF_KR0 + fw(NRBF, S);   // K0 rows of |Vh| (17, padded to 32)
constexpr int OFF_G0 = OFF_KN0 + fw(32, S);      // gates of GVP0
constexpr int L_WH = 0, L_WU = fw(V, V), L_KN = 2 * fw(V, V), L_G = L_KN + fw(V, S);
constexpr int L_SIZE = L_G + fw(S, V);           // GVP1 or GVP2: Wh, Wu, K rows of |Vh|, gates
constexpr int OFF_L1 = OFF_G0 + fw(S, V);
constexpr int OFF_L2 = OFF_L1 + L_SIZE;
constexpr int FRAG_WORDS = OFF_L2 + L_SIZE;
// f32 vectors: the biases and the gates' biases (values rounded to bf16), Wh0[0] (rounded, 32), rbf centres
constexpr int VO_B = 0;
constexpr int VO_GB = VO_B + 3 * S;
constexpr int VO_WH0 = VO_GB + 3 * V;
constexpr int VO_MU = VO_WH0 + 32;
constexpr int VEC_FLOATS = VO_MU + NRBF;
constexpr int BULK = 32768;
static_assert((FRAG_WORDS * 4) % 16 == 0 && (VEC_FLOATS * 4) % 16 == 0, "bulk copies move multiples of 16 bytes");

struct Params {
  const uint16_t* a_src;   // (B * Ns, ROWW) bf16 node rows
  const float *x_src, *x_dst;  // (B * Ns, 3), (B * Nd, 3)
  const int* idx;          // (B * Nd, cap)
  const uint8_t* valid;    // (B * Nd, cap)
  const uint32_t* frags;   // FRAG_WORDS
  const float* vecs;       // VEC_FLOATS
  const uint16_t* big;     // N_PIECES * PIECE bf16: GVP1's then GVP2's 256 x 256 block
  float *out_s, *out_v;    // (B * Nd, S), (B * Nd, V, 3)
  int B, Ns, Nd, cap, mean;
  float sigma;
};

struct Smem {
  uint16_t ring[RING][PIECE];  // first: 1024-byte aligned, as the 128-byte swizzle needs
  uint32_t frags[FRAG_WORDS];
  float vecs[VEC_FLOATS];
  uint32_t stage[TM][SST];     // the rows' P, then GVP2's scalars (bf16 pairs)
  uint32_t vstage[TM][VST];    // GVP2's vectors, [component][channel] bf16
  int row_src[TM];             // b * Ns + s
  int row_g[TM];               // b * Nd + d
  int row_j[TM];               // the destination's ordinal in the block, -1 past the rows
  int cnt[THREADS / 32];       // compaction: valid slots of each warp's positions
  int cursor;                  // compaction: the position after a full tile's last row
  alignas(8) uint64_t full[RING];
  uint64_t wbar;
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment of the base

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the first 1024-byte aligned address of dynamic shared memory, by pointer arithmetic on the
// shared array (a round trip through an integer turns every access into a generic one)
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
}

// two floats -> bf16x2 (round to nearest even), low half = lo
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// sigmoid and silu from the hardware's exp2 and reciprocal approximations (relative errors near 2^-22,
// far below the bf16 step the results are rounded to); the IEEE forms took several times the
// instructions (the kernel, latency-bound at one warp a scheduler, ran 1.6x slower with them)
__device__ __forceinline__ float sigmoid(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + __expf(-x)));
  return r;
}
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// ---- Hopper building blocks: mbarrier, bulk copy, wgmma; and mma.sync

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
// global -> shared bulk asynchronous copy (16-byte aligned, a multiple of 16 bytes), completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
// copies `bytes` in BULK pieces on bar (expect_tx made by the caller); one thread
__device__ __forceinline__ void bulk_pieces(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += BULK)
    bulk_g2s(static_cast<char*>(dst) + off, static_cast<const char*>(src) + off, min(uint32_t(BULK), bytes - off),
             bar);
}

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

// d += A (64 x 16 bf16, registers) * B (16 x 128 bf16, shared memory through desc), f32
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

// d (4 f32) += a (16 x 16 bf16) * b (16 x 8 bf16), one warp, m16n8k16 fragment layouts:
// a: (row g, k 2q..2q+1), (row g+8, same), (row g, k 2q+8..), (row g+8, k 2q+8..); b: (k 2q.., n g), (k 2q+8.., n g);
// d: (row g, n 2q, 2q+1), (row g+8, n 2q, 2q+1)  [g = lane / 4, q = lane % 4]
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
// fragment (kt, nt) of a matrix with nt_count N-tiles, this lane's two words
__device__ __forceinline__ uint2 frag(const uint32_t* m, int nt_count, int kt, int nt, int lane) {
  return *reinterpret_cast<const uint2*>(m + ((kt * nt_count + nt) * 32 + lane) * 2);
}
// the accumulators of two N-tiles (16 x 16 f32) as the A fragment of the next product, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[8]) {
  a[0] = pack(c[0], c[1]);
  a[1] = pack(c[2], c[3]);
  a[2] = pack(c[4], c[5]);
  a[3] = pack(c[6], c[7]);
}
// rnd(a (16 rows x 16 channels) @ m (16 x 16, fragment order))
__device__ __forceinline__ void vmap(uint32_t (&out)[4], const uint32_t (&a)[4], const uint32_t* m, int lane) {
  float c[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  mma(c, a, frag(m, 2, 0, 0, lane));
  mma(c + 4, a, frag(m, 2, 0, 1, lane));
  c_to_a(out, c);
}
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c)), 1e-8f));
}
// per-channel norms of the three components' fragments, rounded: the A fragment of the |Vh| rows
__device__ __forceinline__ void norms(uint32_t (&n)[4], const uint32_t (&x)[4], const uint32_t (&y)[4],
                                      const uint32_t (&z)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    n[i] = pack(norm3(lo16(x[i]), lo16(y[i]), lo16(z[i])), norm3(hi16(x[i]), hi16(y[i]), hi16(z[i])));
}
// vectors out = rnd(rnd(sigmoid(rnd(rnd(gacc) + gb))) * Vu), gacc in the accumulator layout of two N-tiles
__device__ __forceinline__ void gate_vectors(uint32_t (&vo)[3][4], const float (&gacc)[8], const float* gb,
                                             const uint32_t (&vu)[3][4], int q) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = rnd(sigmoid(rnd(rnd(gacc[i]) + gb[(i >= 4 ? 8 : 0) + 2 * q + (i & 1)])));
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) vo[c][k] = pack(s[2 * k] * lo16(vu[c][k]), s[2 * k + 1] * hi16(vu[c][k]));
}

// ---- the weight ring: piece P of the launch is image piece P % N_PIECES in slot P % RING

__device__ __forceinline__ void issue_piece(Smem& sm, const uint16_t* big, uint32_t piece) {
  const uint32_t slot = piece % RING;
  mbar_expect_tx(&sm.full[slot], PIECE_BYTES);
  bulk_g2s(sm.ring[slot], big + size_t(piece % N_PIECES) * PIECE, PIECE_BYTES, &sm.full[slot]);
}
// the products reading piece `done` are complete: its slot takes piece done + RING
__device__ __forceinline__ void release(Smem& sm, const uint16_t* big, uint32_t done) {
  __syncthreads();
  if (threadIdx.x == 0) issue_piece(sm, big, done + RING);
}

// acc (one N half, 64 x 128) += F (64 x 256, A fragments) @ the half's four pieces
__device__ __forceinline__ void half_gemm(Smem& sm, const uint16_t* big, uint32_t& piece, float (&acc)[64],
                                          const uint32_t (&F)[64]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint32_t slot = piece % RING;
    mbar_wait(&sm.full[slot], (piece / RING) & 1);
    const uint32_t base = smem_addr(sm.ring[slot]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kt = 4 * kb + i;
      wgmma_n128(acc, F[4 * kt], F[4 * kt + 1], F[4 * kt + 2], F[4 * kt + 3], sw128_desc(base + 32 * i));
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      release(sm, big, piece - 1);
    }
    ++piece;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
  release(sm, big, piece - 1);
}

// GVP1 or GVP2 on the tile: F (scalars, A fragments) and VA (vectors, A fragments) in, out.
// LAST: the scalars go to sm.stage instead of F.
template <bool LAST>
__device__ __forceinline__ void gvp_layer(Smem& sm, const uint16_t* big, uint32_t& piece, const uint32_t* L,
                                          const float* b, const float* gb, uint32_t (&F)[64], uint32_t (&VA)[3][4],
                                          int lane, int q, int r0, int r1) {
  uint32_t vh[3][4], vu[3][4], nA[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) vmap(vh[c], VA[c], L + L_WH, lane);
  norms(nA, vh[0], vh[1], vh[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) vmap(vu[c], vh[c], L + L_WU, lane);
  uint32_t Fn[64];
  float gacc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float acc[64];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {  // the |Vh| rows of the matrix
      acc[4 * jj] = acc[4 * jj + 1] = acc[4 * jj + 2] = acc[4 * jj + 3] = 0.0f;
      mma(&acc[4 * jj], nA, frag(L + L_KN, 32, 0, 16 * h + jj, lane));
    }
    half_gemm(sm, big, piece, acc, F);
    uint32_t ga[4];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {  // f = rnd(silu(rnd(rnd(acc) + b))); columns 128 h + 8 jj + 2 q, + 1
      const int col = 128 * h + 8 * jj + 2 * q;
      const float b0 = b[col], b1 = b[col + 1];
      const uint32_t lo = pack(silu(rnd(rnd(acc[4 * jj]) + b0)), silu(rnd(rnd(acc[4 * jj + 1]) + b1)));
      const uint32_t hi = pack(silu(rnd(rnd(acc[4 * jj + 2]) + b0)), silu(rnd(rnd(acc[4 * jj + 3]) + b1)));
      const int kt = 8 * h + jj / 2, part = (jj & 1) * 2;
      ga[part] = lo;
      ga[part + 1] = hi;
      if (LAST) {
        sm.stage[r0][64 * h + 4 * jj + q] = lo;
        sm.stage[r1][64 * h + 4 * jj + q] = hi;
      } else {
        Fn[4 * kt + part] = lo;
        Fn[4 * kt + part + 1] = hi;
      }
      if (jj & 1) {
        mma(gacc, ga, frag(L + L_G, 2, kt, 0, lane));
        mma(gacc + 4, ga, frag(L + L_G, 2, kt, 1, lane));
      }
    }
  }
  if (!LAST) {
#pragma unroll
    for (int i = 0; i < 64; ++i) F[i] = Fn[i];
  }
  gate_vectors(VA, gacc, gb, vu, q);
}

__device__ __forceinline__ void write_dest(const Params& p, size_t g, float s0, float s1, float v, int cnt, int tid) {
  if (p.mean) {
    const float c = fmaxf(float(cnt), 1.0f);
    s0 = __fdiv_rn(s0, c);
    s1 = __fdiv_rn(s1, c);
    v = __fdiv_rn(v, c);
  }
  *reinterpret_cast<float2*>(p.out_s + g * S + 2 * tid) = make_float2(s0, s1);
  if (tid < 3 * V) p.out_v[g * (3 * V) + (tid % V) * 3 + tid / V] = v;
}

__global__ void __launch_bounds__(THREADS, 1) gvp_message_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8;  // this thread's rows in the fragment layouts
  const int G = p.B * p.Nd, nwg = gridDim.x, wgi = blockIdx.x;
  const int nj = wgi < G ? (G - wgi + nwg - 1) / nwg : 0;  // destinations g = wgi + j * nwg, j < nj
  const int cap = p.cap, npos = nj * cap;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&sm.full[i], 1);
    mbar_init(&sm.wbar, 1);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.wbar, uint32_t(FRAG_WORDS + VEC_FLOATS) * 4);
    bulk_pieces(sm.frags, p.frags, FRAG_WORDS * 4, &sm.wbar);
    bulk_pieces(sm.vecs, p.vecs, VEC_FLOATS * 4, &sm.wbar);
    for (uint32_t i = 0; i < RING; ++i) issue_piece(sm, p.big, i);
  }
  mbar_wait(&sm.wbar, 0);
  const float* vecs = sm.vecs;

  int cur = 0;         // compaction cursor over the block's positions j * cap + slot
  uint32_t piece = 0;  // weight pieces consumed
  int acc_j = -1;      // the destination whose sums are open (carried across tiles)
  float as0 = 0.0f, as1 = 0.0f, av = 0.0f;  // its sums: columns 2 tid, 2 tid + 1; vector element tid
  int acnt = 0;
  for (;;) {
    // ---- compaction: the next TM valid slots from the cursor, destination-major
    int n = 0;
    while (n < TM && cur < npos) {
      const int pos = cur + tid;
      bool f = false;
      int src = 0, jj = 0, gg = 0;
      if (pos < npos) {
        jj = pos / cap;
        gg = wgi + jj * nwg;
        const size_t at = size_t(gg) * cap + (pos - jj * cap);
        const int s = p.idx[at];
        f = p.valid[at] != 0 && unsigned(s) < unsigned(p.Ns);
        src = (gg / p.Nd) * p.Ns + s;
      }
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (lane == 0) sm.cnt[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        const int c = sm.cnt[w];
        total += c;
        before += w < warp ? c : 0;
      }
      const int rank = n + before + __popc(m & ((1u << lane) - 1u));
      if (f && rank < TM) {
        sm.row_src[rank] = src;
        sm.row_g[rank] = gg;
        sm.row_j[rank] = jj;
      }
      const bool full = n + total > TM;
      if (full && f && rank == TM - 1) sm.cursor = pos + 1;  // the next tile starts after the TM-th
      __syncthreads();
      if (full) {
        cur = sm.cursor;
        n = TM;
      } else {
        cur += THREADS;
        n += total;
      }
    }
    if (tid >= n && tid < TM) {  // rows past the edges: any node, no destination
      sm.row_src[tid] = 0;
      sm.row_g[tid] = 0;
      sm.row_j[tid] = -1;
    }
    __syncthreads();
    if (n == 0) break;

    // ---- the rows' P into the stage (16-byte copies, a row per warp instruction, all loads in flight)
    {
      constexpr int NCP = TM * 32 / THREADS;
      uint4 cp[NCP];
#pragma unroll
      for (int i = 0; i < NCP; ++i) {
        const int e = tid + i * THREADS;
        cp[i] = *reinterpret_cast<const uint4*>(p.a_src + size_t(sm.row_src[e >> 5]) * ROWW + 8 * (e & 31));
      }
#pragma unroll
      for (int i = 0; i < NCP; ++i) {
        const int e = tid + i * THREADS;
        *reinterpret_cast<uint4*>(&sm.stage[e >> 5][4 * (e & 31)]) = cp[i];
      }
    }

    // ---- geometry of rows r0, r1 (each thread of a quad computes its rows')
    float un[2][3], dd[2];
    int srow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0;
      srow[i] = sm.row_src[r];
      const float* xs = p.x_src + size_t(srow[i]) * 3;
      const float* xd = p.x_dst + size_t(sm.row_g[r]) * 3;
      const float d0 = __fsub_rn(xs[0], xd[0]), d1 = __fsub_rn(xs[1], xd[1]), d2 = __fsub_rn(xs[2], xd[2]);
      dd[i] = __fadd_rn(norm3(d0, d1, d2), 1e-8f);
      un[i][0] = rnd(__fdiv_rn(d0, dd[i]));
      un[i][1] = rnd(__fdiv_rn(d1, dd[i]));
      un[i][2] = rnd(__fdiv_rn(d2, dd[i]));
    }
    uint32_t rbfA[4];  // A fragment of the rbf channels 2q, 2q+1 (regs 0, 1) and 8 + 2q, 9 + 2q (regs 2, 3)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ch = (k >= 2 ? 8 : 0) + 2 * q;
      const float d = dd[k & 1];
      const float t0 = __fdiv_rn(__fsub_rn(d, vecs[VO_MU + ch]), p.sigma);
      const float t1 = __fdiv_rn(__fsub_rn(d, vecs[VO_MU + ch + 1]), p.sigma);
      rbfA[k] = pack(__expf(-__fmul_rn(t0, t0)), __expf(-__fmul_rn(t1, t1)));
    }

    // ---- GVP0: Vh = rnd(rnd(unit * Wh0[0]) + Q), 17 channels padded to 32 (two k-steps)
    uint32_t vh0[2][3][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = k & 1, ch = 16 * ks + (k >= 2 ? 8 : 0) + 2 * q;
          const uint32_t qv =
              *reinterpret_cast<const uint32_t*>(p.a_src + size_t(srow[i]) * ROWW + S + 32 * c + ch);
          vh0[ks][c][k] = pack(rnd(un[i][c] * vecs[VO_WH0 + ch]) + lo16(qv),
                               rnd(un[i][c] * vecs[VO_WH0 + ch + 1]) + hi16(qv));
        }
    uint32_t VA[3][4], vu[3][4], n0[2][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // Vu = rnd(Vh @ Wu0)
      float cc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma(cc, vh0[ks][c], frag(sm.frags + OFF_WU0, 2, ks, 0, lane));
        mma(cc + 4, vh0[ks][c], frag(sm.frags + OFF_WU0, 2, ks, 1, lane));
      }
      c_to_a(vu[c], cc);
    }
    norms(n0[0], vh0[0][0], vh0[0][1], vh0[0][2]);
    norms(n0[1], vh0[1][0], vh0[1][1], vh0[1][2]);
    __syncthreads();  // the stage holds the rows' P

    // f = rnd(silu(rnd(rnd(rnd(P + rnd(rbf K0r)) + rnd(|Vh| K0n)) + b0))), N-tile by N-tile
    uint32_t F[64];
    float gacc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    {
      uint32_t ga[4];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(cr, rbfA, frag(sm.frags + OFF_KR0, 32, 0, j, lane));
        mma(cn, n0[0], frag(sm.frags + OFF_KN0, 32, 0, j, lane));
        mma(cn, n0[1], frag(sm.frags + OFF_KN0, 32, 1, j, lane));
        const uint32_t p0 = sm.stage[r0][4 * j + q], p1 = sm.stage[r1][4 * j + q];
        const int col = 8 * j + 2 * q;
        const float b0 = vecs[VO_B + col], b1 = vecs[VO_B + col + 1];
        const float pv[4] = {lo16(p0), hi16(p0), lo16(p1), hi16(p1)};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = silu(rnd(rnd(rnd(pv[e] + rnd(cr[e])) + rnd(cn[e])) + (e & 1 ? b1 : b0)));
        const int kt = j / 2, part = (j & 1) * 2;
        ga[part] = F[4 * kt + part] = pack(y[0], y[1]);
        ga[part + 1] = F[4 * kt + part + 1] = pack(y[2], y[3]);
        if (j & 1) {
          mma(gacc, ga, frag(sm.frags + OFF_G0, 2, kt, 0, lane));
          mma(gacc + 4, ga, frag(sm.frags + OFF_G0, 2, kt, 1, lane));
        }
      }
    }
    gate_vectors(VA, gacc, vecs + VO_GB, vu, q);

    // ---- GVP1, GVP2 (its scalars into the stage)
    gvp_layer<false>(sm, p.big, piece, sm.frags + OFF_L1, vecs + VO_B + S, vecs + VO_GB + V, F, VA, lane, q, r0, r1);
    __syncthreads();  // every thread is done reading the stage's P
    gvp_layer<true>(sm, p.big, piece, sm.frags + OFF_L2, vecs + VO_B + 2 * S, vecs + VO_GB + 2 * V, F, VA, lane, q,
                    r0, r1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sm.vstage[r0][8 * c + q] = VA[c][0];
      sm.vstage[r1][8 * c + q] = VA[c][1];
      sm.vstage[r0][8 * c + 4 + q] = VA[c][2];
      sm.vstage[r1][8 * c + 4 + q] = VA[c][3];
    }
    __syncthreads();

    // ---- sums over the tile's rows in row order; a destination is written when its rows end
    const uint16_t* vrow = reinterpret_cast<const uint16_t*>(&sm.vstage[0][0]);
    for (int r = 0; r < n; ++r) {
      const int jr = sm.row_j[r];
      if (jr != acc_j) {
        if (acc_j >= 0) write_dest(p, size_t(wgi) + size_t(acc_j) * nwg, as0, as1, av, acnt, tid);
        for (int jz = acc_j + 1; jz < jr; ++jz) write_dest(p, size_t(wgi) + size_t(jz) * nwg, 0.0f, 0.0f, 0.0f, 0, tid);
        acc_j = jr;
        as0 = as1 = av = 0.0f;
        acnt = 0;
      }
      const uint32_t m = sm.stage[r][tid];
      as0 += lo16(m);
      as1 += hi16(m);
      if (tid < 3 * V) av += __uint_as_float(uint32_t(vrow[r * (2 * VST) + tid]) << 16);
      ++acnt;
    }
    __syncthreads();  // before the next compaction rewrites the rows and the stage
  }
  if (acc_j >= 0) write_dest(p, size_t(wgi) + size_t(acc_j) * nwg, as0, as1, av, acnt, tid);
  for (int jz = acc_j + 1; jz < nj; ++jz) write_dest(p, size_t(wgi) + size_t(jz) * nwg, 0.0f, 0.0f, 0.0f, 0, tid);
  if (tid == 0)  // no bulk copy outlives the block: the pieces issued ahead
    for (uint32_t i = piece; i < piece + RING; ++i) mbar_wait(&sm.full[i % RING], (i / RING) & 1);
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace

extern "C" {

size_t gvp_message_smem_bytes() { return SMEM_BYTES; }
int gvp_message_frag_words() { return FRAG_WORDS; }
int gvp_message_vec_floats() { return VEC_FLOATS; }
int gvp_message_node_width() { return ROWW; }

int gvp_message_launch(const void* a_src, const float* x_src, const float* x_dst, const int* idx,
                       const uint8_t* valid, const void* frags, const float* vecs, const void* big, float* out_s,
                       float* out_v, int B, int Ns, int Nd, int cap, int mean, float sigma, void* stream) {
  if (B < 0 || Ns < 0 || Nd < 0 || cap < 1) return int(cudaErrorInvalidValue);
  if (B == 0 || Nd == 0) return 0;
  if ((long long)B * Nd * cap > 0x7fffffff || (long long)B * Ns > 0x7fffffff) return int(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(gvp_message_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  const int nsm = sm_count();
  if (nsm < 1) return int(cudaErrorInvalidDevice);
  // one block a SM at most, each with a few tiles of slots at least
  const long long G = (long long)B * Nd;
  long long want = ((long long)B * Nd * cap + 4 * TM - 1) / (4 * TM);
  want = want < 1 ? 1 : want > nsm ? nsm : want;
  want = want > G ? G : want;
  Params p{static_cast<const uint16_t*>(a_src), x_src, x_dst, idx, valid, static_cast<const uint32_t*>(frags), vecs,
           static_cast<const uint16_t*>(big), out_s, out_v, B, Ns, Nd, cap, mean, sigma};
  gvp_message_kernel<<<int(want), THREADS, SMEM_BYTES, st>>>(p);
  return int(cudaGetLastError());
}

const char* gvp_message_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
