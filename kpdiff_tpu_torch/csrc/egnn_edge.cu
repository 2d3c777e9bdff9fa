// Dense EGNN edge messages and aggregation for NVIDIA Hopper (sm_90a), kernel v4.
//
// Replaces the TPU kernel kpdiff_tpu/ops/pallas/egnn_edge.py::fused_dense_edge_split
// (body `_kernel`, pl.pallas_call at line 174). For every batch element b and
// every pair (s, d) of the (Ns, Nd) grid with adj[b, s, d] set, it computes
//   dij  = |x_s - x_d + 1e-30|
//   m    = silu(silu(a_es[s] + a_ed[d] + dij * w_edij) @ W2e + b2e)
//   gate = sigmoid(m . attw + atb)
//   c    = silu(silu(a_cs[s] + a_cd[d] + dij * w_cdij) @ W2c + b2c)
//   k    = tanh(c . wout) * coords_range (tanh optional), / (dij + 1)
// and aggregates onto destinations:
//   agg_h[b, d] = sum_s gate * m        agg_x[b, d] = sum_s k * (x_s - x_d + 1e-30)
// The first layers' per-node projections a_* come in precomputed (they are
// plain node-level matrix products). Numerics follow `_kernel`: in bf16 mode
// the pre-activation, each silu and the lin2 output are rounded to bf16 (silu
// through the hardware tanh, as `_silu` does), the lin2 product and every
// reduction accumulate in f32. (rnd(x) in the comments below: x rounded to
// bf16, to nearest even.)
//
// What bounds it: operations. The two (H x H) second layers take 2 * 2 * H^2
// FLOPs per active pair (264 kFLOP at H = 257) on the tensor cores; the
// elementwise work (two silu-activated H-wide rows per pair and chain) runs
// on the CUDA cores and the special-function unit. Inputs and outputs are
// O(N * H) bytes. What the design does about it (bf16 mode):
//   * grid (Nd / 16, B, 2): a block owns 16 destinations of one batch
//     element and ONE chain (blockIdx.z: 0 edge, 1 coordinate), so its W2
//     (HP x HP bf16) is copied into shared memory once, by cp.async, while
//     the block compacts its active pairs;
//   * the sources are walked in tiles of 64, so shared memory does not grow
//     with Ns; pairs that the adjacency masks out are skipped (their terms
//     are exactly zero);
//   * the block's 16 warps form four groups of 4. Each group takes every
//     fourth 16-row chunk of the pair list and runs first layer, product,
//     epilogue and aggregation on it with 128-thread named barriers only, so
//     one group's CUDA-core phases overlap another's tensor-core product.
//     16 warps (128 registers each, a few bytes spilled) hide more latency
//     than 8 warps with 32-row chunks (226 registers), which ran slower on
//     an H100;
//   * the product runs transposed, C^T = W2^T A^T, through mma.sync m16n8k16
//     (bf16 in, f32 accumulate) fed by ldmatrix from tiles padded to a row
//     stride of HP + 8 (560 bytes at HP = 272: the 8 rows of every 8 x 8
//     fragment fall on distinct banks). A warp owns 4-5 16-column tiles of
//     W2 across the chunk's 16 rows: 14 FLOP per shared-memory byte;
//   * the epilogue stays in registers: bias, silu and the row products with
//     attw / wout run on the accumulator fragments (bf16x2 arithmetic where
//     the reference rounds to bf16), the row sums cross the 4 warps through
//     a 256-byte exchange;
//   * the sum gate * m over sources is a second mma: agg[d, c] += G[d, r]
//     M[r, c], with G[d, r] = gate[r] where pair r has destination d. The
//     transposed product leaves M^T in exactly the register layout of the
//     B operand, and gate goes in as two bf16 terms (hi + lo, 16 bits of
//     mantissa; its value is not rounded to bf16). Per-destination sums live
//     in registers; groups are combined in a fixed order at the end: the
//     result is deterministic, without atomics.
// The f32 mode (a tight check of the algorithm, off the main path) keeps a
// simple CUDA-core design with W2 streamed from global memory.
//
// C interface (loaded with ctypes): egnn_edge_dense_launch returns the
// cudaError_t of the launch; egnn_edge_error_string names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 16;       // destinations per block (the m16 of the aggregation mma)
constexpr int ST = 64;       // sources per tile of the pair walk
constexpr int MAX_HP = 288;  // padded width limit
// bf16 mode
constexpr int NG = 4;                  // warp groups per block, one chunk in flight each
constexpr int GW = 4;                  // warps per group
constexpr int THREADS = NG * GW * 32;  // 512
constexpr int RC = 16;                 // pair rows per chunk
constexpr int NT = RC / 8;             // 8-row tiles of a chunk (n of the product mma)
constexpr int RW = RC / GW;            // rows a warp sets up in the first layer
static_assert(RC % 16 == 0 && RC <= 32 && RW <= 8, "chunk shape");
constexpr int MAXT = (MAX_HP / 16 + GW - 1) / GW;  // 16-column tiles a warp owns
// f32 mode
constexpr int THREADS_F32 = 512;
constexpr int MR_F32 = 64;
static_assert(MAX_HP <= THREADS_F32, "f32 mode: one column per thread");

struct Params {
  const float *a_es, *a_ed, *a_cs, *a_cd;  // (B,Ns,H), (B,Nd,H) f32
  const float *w_edij, *w_cdij;            // (H) f32
  const void *w2e, *w2c;                   // (HP,HP) bf16 or f32, zero padded
  const float *b2e, *b2c, *attw, *wout;    // (H) f32
  const float *atb;                        // (1) f32
  const float *x_s, *x_d;                  // (B,Ns,3), (B,Nd,3) f32
  const uint8_t *adj;                      // (B,Ns,Nd)
  float *agg_h, *agg_x;                    // (B,Nd,H), (B,Nd,3) f32
  int B, Ns, Nd, H, HP;
  int use_tanh;
  float coords_range;
};

// Phase clocks (a profiling build only: nvcc -DEGNN_EDGE_PHASE_CLOCKS). Each
// warp adds the SM clocks it spends in each phase; barrier waits are a phase
// of their own. Lane 0 of each warp adds its totals to g_phase_clocks at exit.
enum Phase { PH_SETUP, PH_W2, PH_LAYER1, PH_PRODUCT, PH_EPILOGUE, PH_AGG, PH_BARRIER, N_PHASES };
#ifdef EGNN_EDGE_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[N_PHASES];
#define CLK_BEGIN                              \
  unsigned long long clk_t = clock64();        \
  unsigned long long clk_acc[N_PHASES] = {};
#define CLK(ph)                                \
  do {                                         \
    const unsigned long long n_ = clock64();   \
    clk_acc[ph] += n_ - clk_t;                 \
    clk_t = n_;                                \
  } while (0)
#define CLK_END                                                                          \
  if ((threadIdx.x & 31) == 0)                                                           \
    for (int i_ = 0; i_ < N_PHASES; ++i_) atomicAdd(&g_phase_clocks[i_], clk_acc[i_]);
#else
#define CLK_BEGIN
#define CLK(ph)
#define CLK_END
#endif
// a block barrier that closes phase `ph` and counts its wait as PH_BARRIER
#define SYNC(ph)     \
  do {               \
    CLK(ph);         \
    __syncthreads(); \
    CLK(PH_BARRIER); \
  } while (0)
// the same for the 128 threads of warp group g (named barrier 1 + g)
#define GSYNC(ph, g)                                                    \
  do {                                                                  \
    CLK(ph);                                                            \
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (g)), "r"(GW * 32) : "memory"); \
    CLK(PH_BARRIER);                                                    \
  } while (0)

__device__ __forceinline__ float tanh_approx(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x));
  return t;
}

// silu(x) = x * sigmoid(x). bf16 mode: sigmoid(x) = 0.5 * tanh(x / 2) + 0.5 with
// the hardware tanh (one MUFU op, relative error ~2^-11, below bf16's rounding
// step; the TPU kernel's `_silu` takes the same form). f32 mode: exact expf.
template <bool BF16>
__device__ __forceinline__ float silu(float x) {
  if constexpr (BF16) {
    return x * fmaf(0.5f, tanh_approx(0.5f * x), 0.5f);
  } else {
    return x / (1.0f + expf(-x));
  }
}

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
// silu of both halves, rounded back to bf16x2
__device__ __forceinline__ uint32_t silu_bf16x2(uint32_t v) {
  return pack_bf16x2(silu<true>(bf16_lo(v)), silu<true>(bf16_hi(v)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

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

}  // namespace

namespace {

// Shared memory of the bf16 kernel, in carve order.
struct Bf16Layout {
  size_t w2, a, vec_wdij, vec_b2, vec_wv, plist, masks, meta, total;
};

// Per-group chunk metadata: two parities so that a group's next chunk can
// be set up while its slower warps still read this one's.
struct GroupMeta {
  int dl[2][RC];       // destination of each row, -1 for a row past the pairs
  float dij[2][RC];    // |dx|
  float dx[2][RC][3];  // x_s - x_d + 1e-30
  float dotp[GW][RC];  // the warps' partial row products with attw / wout
  float px[TD * 3];    // the group's agg_x partial sums (coordinate chain)
};

__host__ __device__ inline Bf16Layout bf16_layout(int HP) {
  const int STR = HP + 8;
  Bf16Layout l;
  size_t off = 0;
  l.w2 = off, off += align16(size_t(HP) * STR * 2);
  l.a = off, off += align16(size_t(NG) * RC * STR * 2);
  l.vec_wdij = off, off += align16(size_t(HP) * 2);
  l.vec_b2 = off, off += align16(size_t(HP) * 4);
  l.vec_wv = off, off += align16(size_t(HP) * 2);
  l.plist = off, off += align16(size_t(TD) * ST * 4);
  l.masks = off, off += align16(size_t(2) * TD * 4);
  l.meta = off, off += align16(sizeof(GroupMeta) * NG);
  l.total = off;
  return l;
}

__global__ void __launch_bounds__(THREADS, 1) egnn_edge_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / GW, gw = warp % GW;  // warp group, warp within it
  const int b = blockIdx.y, d0 = blockIdx.x * TD, chain = blockIdx.z;
  const int nd_here = min(TD, p.Nd - d0);
  const int H = p.H, HP = p.HP, Ns = p.Ns, Nd = p.Nd, STR = HP + 8;
  CLK_BEGIN

  const Bf16Layout L = bf16_layout(HP);
  __nv_bfloat16* W2s = reinterpret_cast<__nv_bfloat16*>(smem + L.w2);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + L.a) + size_t(grp) * RC * STR;
  uint32_t* v_wdij2 = reinterpret_cast<uint32_t*>(smem + L.vec_wdij);  // bf16x2 pairs
  float* v_b2 = reinterpret_cast<float*>(smem + L.vec_b2);
  const uint16_t* v_wv = reinterpret_cast<const uint16_t*>(smem + L.vec_wv);
  int* plist = reinterpret_cast<int*>(smem + L.plist);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + L.masks);
  GroupMeta* gm = reinterpret_cast<GroupMeta*>(smem + L.meta) + grp;

  // W2 of this block's chain into shared memory (row stride STR), in flight
  // while the block compacts its pairs
  {
    const char* w2g = reinterpret_cast<const char*>(chain ? p.w2c : p.w2e);
    const int cpr = HP / 8;  // 16-byte pieces per row
    for (int i = tid; i < HP * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(W2s + size_t(r) * STR + c * 8, w2g + (size_t(r) * HP + c * 8) * 2);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  CLK(PH_W2);
  {
    const float* w_dij = chain ? p.w_cdij : p.w_edij;
    const float* b2 = chain ? p.b2c : p.b2e;
    const float* wv = chain ? p.wout : p.attw;
    uint16_t* wv_out = reinterpret_cast<uint16_t*>(smem + L.vec_wv);
    for (int k = tid; k < HP; k += THREADS) {
      v_b2[k] = k < H ? b2[k] : 0.0f;
      wv_out[k] = __bfloat16_as_ushort(__float2bfloat16_rn(k < H ? wv[k] : 0.0f));
      if (!(k & 1)) v_wdij2[k >> 1] = pack_bf16x2(k < H ? w_dij[k] : 0.0f, k + 1 < H ? w_dij[k + 1] : 0.0f);
    }
    if (gw * 32 + lane < TD * 3) gm->px[gw * 32 + lane] = 0.0f;
  }
  const float atb = *p.atb;

  // this warp's 16-column tiles of the product: [t0, t0 + tcount)
  const int nt = HP / 16, per = nt / GW, extra = nt % GW;
  const int t0 = gw * per + min(gw, extra), tcount = per + (gw < extra ? 1 : 0);
  const int cbase = 16 * t0;
  // ldmatrix row / column of this lane's address within a 16 x 16 tile
  const int lrow = (lane & 7) + 8 * (lane >> 4), lcol = 8 * ((lane >> 3) & 1);
  const uint32_t a_sm = smem_addr(A), w_sm = smem_addr(W2s);

  float aggacc[MAXT][2][4];  // edge chain: agg_h[d, c] fragments (d 16 x this warp's columns)
#pragma unroll
  for (int j = 0; j < MAXT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) aggacc[j][h][i] = 0.0f;

  const float* a_s = chain ? p.a_cs : p.a_es;
  const float* a_d = chain ? p.a_cd : p.a_ed;
  int par = 0;
  for (int s0 = 0; s0 < Ns; s0 += ST) {
    CLK(PH_SETUP);
    const int npairs = compact_tile(p.adj, Ns, Nd, b, d0, nd_here, s0, plist, masks);
    CLK(PH_SETUP);
    if (s0 == 0) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      SYNC(PH_W2);
    }
    const int nchunks = (npairs + RC - 1) / RC;
    for (int ci = grp; ci < nchunks; ci += NG) {
      const int base = ci * RC, nrows = min(RC, npairs - base);

      // ---- first layer: warp gw sets up rows RW gw .. RW gw + RW - 1 of the chunk
      int my_s = 0, my_dl = -1;
      float my_dij = 0.0f;
      {
        const int r = RW * gw + (lane % RW);
        if (lane < RW && r < nrows) {
          const int e = plist[base + r];
          my_s = e & 0xffff;
          my_dl = e >> 16;
          const float* xs = p.x_s + (size_t(b) * Ns + my_s) * 3;
          const float* xd = p.x_d + (size_t(b) * Nd + d0 + my_dl) * 3;
          const float dx0 = xs[0] - xd[0] + 1e-30f;
          const float dx1 = xs[1] - xd[1] + 1e-30f;
          const float dx2 = xs[2] - xd[2] + 1e-30f;
          gm->dx[par][r][0] = dx0;
          gm->dx[par][r][1] = dx1;
          gm->dx[par][r][2] = dx2;
          my_dij = sqrtf(dx0 * dx0 + dx1 * dx1 + dx2 * dx2);
        }
        if (lane < RW) {
          gm->dl[par][r] = my_dl;
          gm->dij[par][r] = my_dij;
        }
      }
      for (int i = 0; i < RW; ++i) {
        const int s = __shfl_sync(0xffffffffu, my_s, i), dl = __shfl_sync(0xffffffffu, my_dl, i);
        const float dij = __shfl_sync(0xffffffffu, my_dij, i);
        uint32_t* arow = reinterpret_cast<uint32_t*>(A + (RW * gw + i) * STR);
        if (dl < 0) {  // a row past the pairs: zeros (its gate and scalar are set to 0 below)
          for (int k2 = lane; k2 < HP / 2; k2 += 32) arow[k2] = 0u;
          continue;
        }
        const float* as = a_s + (size_t(b) * Ns + s) * H;
        const float* ad = a_d + (size_t(b) * Nd + d0 + dl) * H;
        const uint32_t dij2 = pack_bf16x2(dij, dij);
        constexpr int KP = (MAX_HP / 2 + 31) / 32;
        float xs[2 * KP], xd[2 * KP];
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k = 2 * (lane + 32 * j);
          xs[2 * j] = k < H ? as[k] : 0.0f;
          xs[2 * j + 1] = k + 1 < H ? as[k + 1] : 0.0f;
          xd[2 * j] = k < H ? ad[k] : 0.0f;
          xd[2 * j + 1] = k + 1 < H ? ad[k + 1] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          const int k2 = lane + 32 * j, k = 2 * k2;
          if (k2 < HP / 2) {
            // pre = rnd(rnd(rnd(a_s) + rnd(a_d)) + rnd(rnd(dij) * rnd(w_dij))), then rnd(silu(pre))
            const uint32_t pre = add_bf16x2(add_bf16x2(pack_bf16x2(xs[2 * j], xs[2 * j + 1]),
                                                       pack_bf16x2(xd[2 * j], xd[2 * j + 1])),
                                            mul_bf16x2(dij2, v_wdij2[k2]));
            uint32_t v = silu_bf16x2(pre);
            if (k >= H) {
              v = 0u;
            } else if (k + 1 >= H) {
              v &= 0xffffu;
            }
            arow[k2] = v;
          }
        }
      }
      GSYNC(PH_LAYER1, grp);

      // ---- product, transposed: acc[j][n] = (W2^T A^T) tile (columns 16 j.., rows 8 n..)
      float acc[MAXT][NT][4];
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.0f;
      for (int kt = 0; kt < nt; ++kt) {
        uint32_t bf[NT / 2][4];  // B fragments of rows 16 h .. 16 h + 15
#pragma unroll
        for (int h = 0; h < NT / 2; ++h) ldmatrix_x4(bf[h], a_sm + ((16 * h + lrow) * STR + kt * 16 + lcol) * 2);
#pragma unroll
        for (int j = 0; j < MAXT; ++j) {
          if (j < tcount) {
            uint32_t af[4];
            ldmatrix_x4_trans(af, w_sm + ((kt * 16 + lrow) * STR + cbase + 16 * j + lcol) * 2);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (8 * n < nrows) mma_bf16(acc[j][n], af, bf[n >> 1][(n & 1) * 2], bf[n >> 1][(n & 1) * 2 + 1]);
            }
          }
        }
      }
      CLK(PH_PRODUCT);

      // ---- epilogue in registers: m = rnd(silu(rnd(C + b2))), row products rnd(m * wv)
      // acc[j][n][i] holds C[row 8 n + 2 (lane % 4) + (i & 1)][column cbase + 16 j + lane / 4 + 8 (i >> 1)]
      float dot[NT][2];
      uint32_t mb[MAXT][NT][2];  // m as bf16x2 over rows (2q, 2q + 1): the aggregation's B operand
#pragma unroll
      for (int n = 0; n < NT; ++n) dot[n][0] = dot[n][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < tcount) {
          const int c_lo = cbase + 16 * j + (lane >> 2), c_hi = c_lo + 8;
          const float b_lo = v_b2[c_lo], b_hi = v_b2[c_hi];
          const uint32_t w_lo = uint32_t(v_wv[c_lo]) * 0x10001u, w_hi = uint32_t(v_wv[c_hi]) * 0x10001u;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t m_lo = silu_bf16x2(pack_bf16x2(acc[j][n][0] + b_lo, acc[j][n][1] + b_lo));
            const uint32_t m_hi = silu_bf16x2(pack_bf16x2(acc[j][n][2] + b_hi, acc[j][n][3] + b_hi));
            const uint32_t q_lo = mul_bf16x2(m_lo, w_lo), q_hi = mul_bf16x2(m_hi, w_hi);
            dot[n][0] += bf16_lo(q_lo) + bf16_lo(q_hi);
            dot[n][1] += bf16_hi(q_lo) + bf16_hi(q_hi);
            mb[j][n][0] = m_lo;
            mb[j][n][1] = m_hi;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = dot[n][i];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) gm->dotp[gw][8 * n + 2 * lane + i] = v;
        }
      }
      GSYNC(PH_EPILOGUE, grp);

      // lane r: row r's gate (edge) or coordinate coefficient, 0 past the pairs
      const int lr = lane % RC;
      const int dl_r = gm->dl[par][lr];
      float val;
      {
        float dsum = 0.0f;
#pragma unroll
        for (int w = 0; w < GW; ++w) dsum += gm->dotp[w][lr];
        if (chain == 0) {
          val = 1.0f / (1.0f + expf(-(dsum + atb)));
        } else {
          const float sc = p.use_tanh ? tanhf(dsum) * p.coords_range : dsum;
          val = sc / (gm->dij[par][lr] + 1.0f);
        }
        if (dl_r < 0) val = 0.0f;
      }
      CLK(PH_EPILOGUE);

      if (chain == 0) {
        // ---- agg_h[d, c] += sum_r G[d, r] m[r, c] on the tensor cores, G = gate where dl == d,
        // as hi + lo bf16 terms
        const int q = lane & 3, dq = lane >> 2;
#pragma unroll
        for (int s = 0; s < RC / 16; ++s) {
          uint32_t ghi[4], glo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = dq + 8 * (i & 1), r = 16 * s + 2 * q + 8 * (i >> 1);
            const float g0 = __shfl_sync(0xffffffffu, val, r), g1 = __shfl_sync(0xffffffffu, val, r + 1);
            const int l0 = __shfl_sync(0xffffffffu, dl_r, r), l1 = __shfl_sync(0xffffffffu, dl_r, r + 1);
            const float x0 = l0 == d ? g0 : 0.0f, x1 = l1 == d ? g1 : 0.0f;
            ghi[i] = pack_bf16x2(x0, x1);
            glo[i] = pack_bf16x2(x0 - bf16_lo(ghi[i]), x1 - bf16_hi(ghi[i]));
          }
#pragma unroll
          for (int j = 0; j < MAXT; ++j) {
            if (j < tcount && 16 * s < nrows) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                mma_bf16(aggacc[j][h], ghi, mb[j][2 * s][h], mb[j][2 * s + 1][h]);
                mma_bf16(aggacc[j][h], glo, mb[j][2 * s][h], mb[j][2 * s + 1][h]);
              }
            }
          }
        }
      } else if (gw < 2) {
        // ---- agg_x partials: thread t < 48 of the group owns (destination t / 3, component t % 3)
        const int t = gw * 32 + lane, d = t / 3, comp = t - 3 * d;
        float ax = 0.0f;
        for (int r = 0; r < RC; ++r) {
          const float v = __shfl_sync(0xffffffffu, val, r);
          const int l = __shfl_sync(0xffffffffu, dl_r, r);
          if (t < TD * 3 && l == d) ax += v * gm->dx[par][r][comp];
        }
        if (t < TD * 3) gm->px[t] += ax;
      }
      CLK(PH_AGG);
      par ^= 1;
    }
    SYNC(PH_AGG);  // the next tile's compaction overwrites the pair list
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // Ns == 0: nothing was waited for
  __syncthreads();

  // ---- combine the groups in a fixed order and write this block's outputs
  if (chain == 0) {
    float* cbuf = reinterpret_cast<float*>(smem + L.a);  // TD x HP f32, over the A tiles
    for (int g = 0; g < NG; ++g) {
      if (grp == g) {
        const int q = lane & 3, dq = lane >> 2;
#pragma unroll
        for (int j = 0; j < MAXT; ++j) {
          if (j < tcount) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float* o = cbuf + (dq + 8 * (i >> 1)) * HP + cbase + 16 * j + 8 * h + 2 * q + (i & 1);
                *o = g == 0 ? aggacc[j][h][i] : *o + aggacc[j][h][i];
              }
            }
          }
        }
      }
      SYNC(PH_AGG);
    }
    for (int idx = tid; idx < nd_here * H; idx += THREADS) {
      const int dl = idx / H, c = idx - dl * H;
      p.agg_h[(size_t(b) * Nd + d0 + dl) * H + c] = cbuf[dl * HP + c];
    }
  } else if (tid < nd_here * 3) {
    const GroupMeta* all = reinterpret_cast<const GroupMeta*>(smem + L.meta);
    float v = 0.0f;
    for (int g = 0; g < NG; ++g) v += all[g].px[tid];
    p.agg_x[(size_t(b) * Nd + d0) * 3 + tid] = v;
  }
  CLK(PH_AGG);
  CLK_END
}

}  // namespace

namespace {

__host__ __device__ inline size_t f32_smem_bytes(int HP) {
  return size_t(2) * MR_F32 * HP * 4      // A, C
         + size_t(TD) * HP * 4            // per-destination agg_h sums
         + align16(size_t(TD) * ST * 4)   // pair list of a source tile
         + align16(size_t(2) * TD * 4)    // compaction masks
         + size_t(MR_F32) * 4 * 7         // dij, dx[3], v, s, dl of the chunk's rows
         + size_t(3) * HP * 4             // w_dij, b2, wv of the block's chain
         + align16(size_t(TD) * 3 * 4);   // agg_x sums
}

// f32 mode: a check of the algorithm on the CUDA cores. One block owns 16
// destinations of one batch element and one chain; chunks of 64 pair rows
// go through shared memory (first layer A, product C, epilogue in place),
// W2 is streamed from global memory, and each destination's sums are kept
// in shared memory across chunks and source tiles.
__global__ void __launch_bounds__(THREADS_F32, 1) egnn_edge_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WARPS = THREADS_F32 / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d0 = blockIdx.x * TD, chain = blockIdx.z;
  const int nd_here = min(TD, p.Nd - d0);
  const int H = p.H, HP = p.HP, Ns = p.Ns, Nd = p.Nd;

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

  const float* a_s = chain ? p.a_cs : p.a_es;
  const float* a_d = chain ? p.a_cd : p.a_ed;
  const float* w_dij = chain ? p.w_cdij : p.w_edij;
  const float* b2 = chain ? p.b2c : p.b2e;
  const float* wv = chain ? p.wout : p.attw;
  const float* W = reinterpret_cast<const float*>(chain ? p.w2c : p.w2e);
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
        const float* as = a_s + (size_t(b) * Ns + (live ? row_s[r] : 0)) * H;
        const float* ad = a_d + (size_t(b) * Nd + d0 + (live ? row_dl[r] : 0)) * H;
        const float dij = live ? row_dij[r] : 0.0f;
        for (int k = lane; k < HP; k += 32) {
          A[r * HP + k] = live && k < H ? silu<false>(as[k] + ad[k] + dij * v_wdij[k]) : 0.0f;
        }
      }
      __syncthreads();

      // second layer: thread n computes column n of C = A @ W2 for all rows
      for (int n = tid; n < H; n += THREADS_F32) {
        float acc[MR_F32];
#pragma unroll
        for (int r = 0; r < MR_F32; ++r) acc[r] = 0.0f;
        for (int k = 0; k < H; ++k) {
          const float w = W[size_t(k) * HP + n];
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
          const float m = silu<false>(C[r * HP + k] + v_b2[k]);
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

size_t smem_bytes(int HP, bool bf16) { return bf16 ? bf16_layout(HP).total : f32_smem_bytes(HP); }

}  // namespace

extern "C" {

size_t egnn_edge_dense_smem_bytes(int HP, int bf16) { return smem_bytes(HP, bf16 != 0); }

int egnn_edge_dense_max_hp() { return MAX_HP; }

int egnn_edge_dense_launch(const float* a_es, const float* a_ed, const float* a_cs, const float* a_cd,
                           const float* w_edij, const float* w_cdij, const void* w2e, const float* b2e,
                           const float* attw, const float* atb, const void* w2c, const float* b2c,
                           const float* wout, const float* x_s, const float* x_d, const uint8_t* adj,
                           float* agg_h, float* agg_x, int B, int Ns, int Nd, int H, int HP, int use_tanh,
                           float coords_range, int bf16, void* stream) {
  if (B == 0 || Nd == 0) return 0;
  if (HP % 16 != 0 || HP < H || HP > MAX_HP || Ns > 0xffff) return int(cudaErrorInvalidValue);
  Params p{a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, w2c, b2e, b2c, attw, wout, atb,
           x_s, x_d, adj, agg_h, agg_x, B, Ns, Nd, H, HP, use_tanh, coords_range};
  const size_t smem = smem_bytes(HP, bf16 != 0);
  const dim3 grid((Nd + TD - 1) / TD, B, 2);  // z: the chain (0 edge, 1 coordinate)
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = cudaFuncSetAttribute(egnn_edge_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    egnn_edge_bf16_kernel<<<grid, THREADS, smem, st>>>(p);
  } else {
    e = cudaFuncSetAttribute(egnn_edge_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    egnn_edge_f32_kernel<<<grid, THREADS_F32, smem, st>>>(p);
  }
  return int(cudaGetLastError());
}

const char* egnn_edge_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

#ifdef EGNN_EDGE_PHASE_CLOCKS
int egnn_edge_phase_clocks_count() { return N_PHASES; }

int egnn_edge_phase_clocks_reset() {
  static const unsigned long long zeros[N_PHASES] = {};
  return int(cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));
}

int egnn_edge_phase_clocks_read(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(unsigned long long) * N_PHASES));
}
#endif

}  // extern "C"
