// Dense EGNN edge messages and aggregation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel kpdiff_tpu/ops/pallas/egnn_edge.py::fused_dense_edge_split
// (body `_kernel`). For every batch element b and every pair (s, d) of the
// (Ns, Nd) grid with adj[b, s, d] set, it computes
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
// reduction accumulate in f32.
//
// What bounds it: operations. The two (H x H) second layers take 2 * 2 * H^2
// FLOPs per pair (264 kFLOP at H = 257) on the tensor cores; the elementwise
// work (two silu-activated H-wide rows per pair and chain) runs on the CUDA
// cores and the special-function unit. Inputs and outputs are O(N * H) bytes.
// The design keeps every per-pair tensor on the chip:
//   * one block of 512 threads owns TD destinations of one batch element and
//     walks over their active pairs (adj set) in chunks of MR rows; the sum
//     over sources stays inside the block, so there are no atomics and the
//     result is deterministic;
//   * a chunk's pre-activations (MR x HP bf16), its lin2 product (MR x HP f32,
//     aliasing the former) and the second-layer weights (HP x HP bf16, 148 KB
//     at H = 257) live in shared memory; the chains run one after the other,
//     so only one W2 is resident at a time;
//   * the lin2 product runs on the tensor cores through WMMA (bf16 in, f32
//     accumulate); pairs that the adjacency masks out are skipped, as their
//     terms are exactly zero.
// The f32 mode (a tight check of the algorithm) streams W2 from global
// memory through the CUDA cores.
//
// C interface (loaded with ctypes): egnn_edge_dense_launch returns the
// cudaError_t of the launch; egnn_edge_error_string names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int TD = 16;      // destinations per block
constexpr int MR = 64;      // pair rows per chunk (4 WMMA row tiles)
constexpr int MAX_HP = 288; // padded width limit: 18 column tiles
constexpr int COL_GROUPS = WARPS / 4;                               // warps per WMMA row tile
constexpr int MAX_TPW = (MAX_HP / 16 + COL_GROUPS - 1) / COL_GROUPS; // column tiles a warp owns
static_assert(MAX_HP <= THREADS, "one agg_h column per thread");

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

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// silu(x) = x * sigmoid(x). bf16 mode: sigmoid(x) = 0.5 * tanh(x / 2) + 0.5 with
// the hardware tanh (one MUFU op, relative error ~2^-11, below bf16's rounding
// step; the TPU kernel's `_silu` takes the same form). f32 mode: exact expf.
template <bool BF16>
__device__ __forceinline__ float silu(float x) {
  if constexpr (BF16) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * x));
    return x * fmaf(0.5f, t, 0.5f);
  } else {
    return x / (1.0f + expf(-x));
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t smem_bytes(int Ns, int HP, bool bf16) {
  size_t w = bf16 ? align16(size_t(HP) * HP * 2) : 0;     // resident W2 (bf16 mode)
  size_t buf = size_t(MR) * HP * 4 * (bf16 ? 1 : 2);     // A|C union (bf16) or A, C (f32)
  size_t plist = align16(size_t(TD) * Ns * 4);
  size_t rows = size_t(MR) * 4 * 7;                       // dij, dx[3], rowv, s, dl
  size_t vecs = size_t(3) * HP * 4;                        // w_dij, b2, wv of the running chain
  return w + buf + plist + rows + vecs;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) egnn_edge_dense_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_npairs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d0 = blockIdx.x * TD;
  const int nd_here = min(TD, p.Nd - d0);
  const int H = p.H, HP = p.HP, Ns = p.Ns, Nd = p.Nd;

  unsigned char* ptr = smem;
  __nv_bfloat16* Wsm = reinterpret_cast<__nv_bfloat16*>(ptr);
  if (BF16) ptr += align16(size_t(HP) * HP * 2);
  float* C = reinterpret_cast<float*>(ptr);
  void* A = ptr;  // bf16 mode: A aliases the start of C
  ptr += size_t(MR) * HP * 4;
  if (!BF16) {
    A = C;
    C = reinterpret_cast<float*>(ptr);
    ptr += size_t(MR) * HP * 4;
  }
  int* plist = reinterpret_cast<int*>(ptr);
  ptr += align16(size_t(TD) * Ns * 4);
  float* row_dij = reinterpret_cast<float*>(ptr);
  float* row_dx = row_dij + MR;       // MR x 3
  float* row_v = row_dx + 3 * MR;     // gate (edge) or coordinate scalar (coord)
  int* row_s = reinterpret_cast<int*>(row_v + MR);
  int* row_dl = row_s + MR;
  float* v_wdij = reinterpret_cast<float*>(row_dl + MR);  // rounded to the compute dtype
  float* v_b2 = v_wdij + HP;
  float* v_wv = v_b2 + HP;                                 // rounded to the compute dtype

  // Zero this block's outputs: destinations without an active pair stay 0.
  // Thread t owns column t of agg_h, thread c < 3 owns component c of
  // agg_x: the same threads write the sums below.
  for (int dl = 0; dl < nd_here; ++dl) {
    float* out = p.agg_h + (size_t(b) * Nd + d0 + dl) * H;
    for (int n = tid; n < H; n += THREADS) out[n] = 0.0f;
  }
  if (tid < 3) {
    for (int dl = 0; dl < nd_here; ++dl) p.agg_x[(size_t(b) * Nd + d0 + dl) * 3 + tid] = 0.0f;
  }

  // Active pairs of this block, destination-major, compacted by warp 0.
  if (warp == 0) {
    int off = 0;
    for (int base = 0; base < TD * Ns; base += 32) {
      const int idx = base + lane;
      bool f = false;
      int entry = 0;
      if (idx < TD * Ns) {
        const int dl = idx / Ns, s = idx - dl * Ns;
        if (dl < nd_here) {
          f = p.adj[(size_t(b) * Ns + s) * Nd + d0 + dl] != 0;
          entry = s | (dl << 16);
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) plist[off + __popc(m & ((1u << lane) - 1u))] = entry;
      off += __popc(m);
    }
    if (lane == 0) s_npairs = off;
  }
  __syncthreads();
  const int npairs = s_npairs;
  if (npairs == 0) return;

  const float atb = *p.atb;

  for (int chain = 0; chain < 2; ++chain) {
    const float* a_s = chain ? p.a_cs : p.a_es;
    const float* a_d = chain ? p.a_cd : p.a_ed;
    const float* w_dij = chain ? p.w_cdij : p.w_edij;
    const float* b2 = chain ? p.b2c : p.b2e;
    const float* wv = chain ? p.wout : p.attw;
    const void* w2 = chain ? p.w2c : p.w2e;

    if (BF16) {  // W2 into shared memory, 16 bytes a thread per step
      const uint4* src = reinterpret_cast<const uint4*>(w2);
      uint4* dst = reinterpret_cast<uint4*>(Wsm);
      const int nvec = HP * HP / 8;
#pragma unroll 4
      for (int i = tid; i < nvec; i += THREADS) dst[i] = src[i];
    }
    for (int k = tid; k < HP; k += THREADS) {
      const bool in = k < H;
      v_wdij[k] = in ? rnd<BF16>(w_dij[k]) : 0.0f;
      v_b2[k] = in ? b2[k] : 0.0f;
      v_wv[k] = in ? rnd<BF16>(wv[k]) : 0.0f;
    }
    __syncthreads();

    // running sums of the current destination (pairs are destination-major)
    int cur = -1;
    float acc0 = 0.0f;

    for (int base = 0; base < npairs; base += MR) {
      const int nrows = min(MR, npairs - base);

      if (tid < MR && tid < nrows) {
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

      // first layer: A[r, k] = silu(a_s[s, k] + a_d[d, k] + dij * w_dij[k]); the
      // loop over k is unrolled so that a lane has all its loads in flight
      for (int r = warp; r < MR; r += WARPS) {
        const bool live = r < nrows;
        const float* as = a_s + (size_t(b) * Ns + (live ? row_s[r] : 0)) * H;
        const float* ad = a_d + (size_t(b) * Nd + d0 + (live ? row_dl[r] : 0)) * H;
        const float dij = live ? rnd<BF16>(row_dij[r]) : 0.0f;
        float xs[MAX_HP / 32], xd[MAX_HP / 32];
#pragma unroll
        for (int j = 0; j < MAX_HP / 32; ++j) {
          const int k = lane + 32 * j;
          const bool in = live && k < H;
          xs[j] = in ? as[k] : 0.0f;
          xd[j] = in ? ad[k] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < MAX_HP / 32; ++j) {
          const int k = lane + 32 * j;
          if (k < HP) {
            float v = 0.0f;
            if (live && k < H) {
              const float pre = rnd<BF16>(rnd<BF16>(rnd<BF16>(xs[j]) + rnd<BF16>(xd[j]))
                                          + rnd<BF16>(dij * v_wdij[k]));
              v = rnd<BF16>(silu<BF16>(pre));
            }
            if (BF16) {
              reinterpret_cast<__nv_bfloat16*>(A)[r * HP + k] = __float2bfloat16_rn(v);
            } else {
              reinterpret_cast<float*>(A)[r * HP + k] = v;
            }
          }
        }
      }
      __syncthreads();

      // second layer: C = A @ W2 (f32 accumulation)
      if constexpr (BF16) {
        const __nv_bfloat16* Ab = reinterpret_cast<const __nv_bfloat16*>(A);
        // warp w: row tile w % 4, column group w / 4 (a contiguous run of tiles)
        const int nt = HP / 16, rt = warp & 3, g = warp >> 2;
        const int per = nt / COL_GROUPS, extra = nt % COL_GROUPS;
        const int t0 = g * per + min(g, extra), tcount = per + (g < extra ? 1 : 0);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_TPW];
#pragma unroll
        for (int j = 0; j < MAX_TPW; ++j) wmma::fill_fragment(acc[j], 0.0f);
        for (int kt = 0; kt < nt; ++kt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, Ab + rt * 16 * HP + kt * 16, HP);
#pragma unroll
          for (int j = 0; j < MAX_TPW; ++j) {
            if (j < tcount) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, Wsm + kt * 16 * HP + (t0 + j) * 16, HP);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
        __syncthreads();  // every warp is done reading A, which C overwrites
#pragma unroll
        for (int j = 0; j < MAX_TPW; ++j) {
          if (j < tcount) {
            wmma::store_matrix_sync(C + rt * 16 * HP + (t0 + j) * 16, acc[j], HP, wmma::mem_row_major);
          }
        }
      } else {
        const float* Af = reinterpret_cast<const float*>(A);
        const float* W = reinterpret_cast<const float*>(w2);
        for (int n = tid; n < H; n += THREADS) {
          float acc[MR];
#pragma unroll
          for (int r = 0; r < MR; ++r) acc[r] = 0.0f;
          for (int k = 0; k < H; ++k) {
            const float w = W[size_t(k) * HP + n];
#pragma unroll
            for (int r = 0; r < MR; ++r) acc[r] = fmaf(Af[r * HP + k], w, acc[r]);
          }
#pragma unroll
          for (int r = 0; r < MR; ++r) C[r * HP + n] = acc[r];
        }
      }
      __syncthreads();

      // epilogue: m = silu(C + b2) in place, and the row product m . wv
      for (int r = warp; r < nrows; r += WARPS) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_HP / 32; ++j) {
          const int k = lane + 32 * j;
          if (k < H) {
            const float m = rnd<BF16>(silu<BF16>(rnd<BF16>(C[r * HP + k] + v_b2[k])));
            C[r * HP + k] = m;
            dot += rnd<BF16>(m * v_wv[k]);
          }
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
        for (int r = 0; r < nrows; ++r) {
          const int dl = row_dl[r];
          if (dl != cur) {
            if (cur >= 0 && tid < H) p.agg_h[(size_t(b) * Nd + d0 + cur) * H + tid] = acc0;
            cur = dl;
            acc0 = 0.0f;
          }
          if (tid < H) acc0 += C[r * HP + tid] * row_v[r];
        }
      } else if (tid < 3) {
        for (int r = 0; r < nrows; ++r) {
          const int dl = row_dl[r];
          if (dl != cur) {
            if (cur >= 0) p.agg_x[(size_t(b) * Nd + d0 + cur) * 3 + tid] = acc0;
            cur = dl;
            acc0 = 0.0f;
          }
          acc0 += row_v[r] * row_dx[3 * r + tid];
        }
      }
      __syncthreads();
    }

    if (cur >= 0) {
      if (chain == 0) {
        if (tid < H) p.agg_h[(size_t(b) * Nd + d0 + cur) * H + tid] = acc0;
      } else if (tid < 3) {
        p.agg_x[(size_t(b) * Nd + d0 + cur) * 3 + tid] = acc0;
      }
    }
    __syncthreads();  // W2 of the next chain overwrites shared memory
  }
}

}  // namespace

extern "C" {

size_t egnn_edge_dense_smem_bytes(int Ns, int HP, int bf16) { return smem_bytes(Ns, HP, bf16 != 0); }

int egnn_edge_dense_max_hp() { return MAX_HP; }

int egnn_edge_dense_launch(const float* a_es, const float* a_ed, const float* a_cs, const float* a_cd,
                           const float* w_edij, const float* w_cdij, const void* w2e, const float* b2e,
                           const float* attw, const float* atb, const void* w2c, const float* b2c,
                           const float* wout, const float* x_s, const float* x_d, const uint8_t* adj,
                           float* agg_h, float* agg_x, int B, int Ns, int Nd, int H, int HP, int use_tanh,
                           float coords_range, int bf16, void* stream) {
  if (B == 0 || Nd == 0) return 0;
  if (HP % 16 != 0 || HP < H || HP > MAX_HP) return int(cudaErrorInvalidValue);
  Params p{a_es, a_ed, a_cs, a_cd, w_edij, w_cdij, w2e, w2c, b2e, b2c, attw, wout, atb,
           x_s, x_d, adj, agg_h, agg_x, B, Ns, Nd, H, HP, use_tanh, coords_range};
  const size_t smem = smem_bytes(Ns, HP, bf16 != 0);
  const dim3 grid((Nd + TD - 1) / TD, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = cudaFuncSetAttribute(egnn_edge_dense_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    egnn_edge_dense_kernel<true><<<grid, THREADS, smem, st>>>(p);
  } else {
    e = cudaFuncSetAttribute(egnn_edge_dense_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    egnn_edge_dense_kernel<false><<<grid, THREADS, smem, st>>>(p);
  }
  return int(cudaGetLastError());
}

const char* egnn_edge_error_string(int code) { return cudaGetErrorString(cudaError_t(code)); }

}  // extern "C"
