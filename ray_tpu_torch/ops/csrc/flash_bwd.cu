// Flash-attention backward for Hopper: dQ (K3) and dK/dV (K4).
//
// Replaces the TPU kernels ray_tpu/ops/attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _flash_bwd). Both recompute the
// attention probabilities from the forward's per-row logsumexp instead of
// storing them:
//   P  = exp(Q K^T * scale - lse)      (0 where masked: causal, key >= S)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale      delta = rowsum(dO * O), computed
//                                      outside (as the JAX package does)
//   K3: dQ = dS K                      K4: dV = P^T dO,  dK = dS^T Q
// P is rounded to the input dtype before the dV product and dS before the
// dQ and dK products, as the TPU kernels do; accumulators are fp32 and the
// outputs are written in the input dtype.
//
// Layout: q/dO/dQ [B, S, H, hd], k/v/dK/dV [B, S, Hkv, hd], lse/delta flat
// [B*H, S] fp32 (row b*H + h). head_dim: any multiple of 8 (hd past 128
// in the chunked bodies below); each
// body is compiled at D = 64 and 128, and a smaller hd is zero-filled up
// to D in shared memory (zero columns add nothing to a score or to dP, and
// no output column is stored past hd) by the PAD instantiations; hd 64 and
// 128 run bodies with hd known at compile time. GQA: query head h reads kv head
// h / (H / Hkv) through strides (no repeat, no transpose). K4's block owns
// one k tile of one kv head and loops over the g = H / Hkv query heads of
// its group itself, so the GQA sum of dK/dV happens in registers: no
// atomics, deterministic. A ragged S is masked in the kernel (padded query
// rows load as zero, give P = 0 and write nothing).
//
// What bounds it: at the training shape [16, 1024, 12, 64] causal bf16,
// K3 does 3 and K4 4 products of 2*D FLOPs per (q, k) pair over
// S(S+1)/2 pairs per head (38.7 and 51.6 GFLOP) against 127 and 153 MB of
// inputs and outputs; on the tensor cores each would take about as long
// for its bytes as for its products (~40-50 us).
//
// K4's bf16 body (`flash_bwd_dkv_wgmma_kernel`) runs its four products on
// the tensor cores with wgmma. One warpgroup owns the 64-key tile; K and
// V sit in swizzled shared memory once, and Q, dO, lse and delta tiles
// stream through a 2-stage cp.async ring. Per q tile: S^T = K Q^T and
// dP^T = V dO^T are shared-memory wgmmas (64 keys x BQ queries); P^T and
// dS^T are formed on the accumulator registers; dV += bf16(P^T) dO and
// dK += bf16(dS^T) Q take them as the register A operand with dO and Q
// read MN-major from the same tiles. dK and dV stay in registers over the
// whole query group. BQ is 64 at D = 64 and 32 at D = 128, where the two
// [64, D] accumulators take 128 registers a thread. The elementwise work
// between the products sets the pace (ptxas: ~200 registers, two blocks an
// SM), so tiles that no mask cuts skip the per-element mask tests, and
// the exponential is one FMA and one ex2.approx.
//
// K3's bf16 body (`flash_bwd_dq_wgmma_kernel`) is K2's shape with K4's
// score products: one warpgroup owns a 64-row q tile (longest rows first),
// Q and dO sit in swizzled shared memory once, and K and V tiles of 64
// keys stream through a 2-stage cp.async ring. Per k tile: S = Q K^T and
// dP = dO V^T are shared-memory wgmmas; P and dS are formed on the
// accumulator registers (lse and delta of a thread's two rows stay in
// registers); dQ += bf16(dS) K takes dS as the register A operand with K
// read MN-major from the same tile, so nothing is transposed or goes back
// through shared memory. Accumulators: 32 + 32 + D/2 registers a thread.
//
// The fp32 bodies (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`) do the
// products with fp32 FMAs on the CUDA cores (tensor cores would take fp32
// as TF32, and the fp32 path is the one the train-exact checks hold to the
// plain version). Every tile sits row-major in shared memory as fp32; in the
// score products a thread owns 4 consecutive rows of one operand and 4
// rows 16 apart of the other, so each float4 read along D is either a
// warp broadcast or lands on distinct banks (row pitch D + 4 floats).
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int kThreads = 256;

template <int D>
struct Tiles {
  static constexpr int LD = D + 4;    // row pitch of a [64][D] tile
  static constexpr int LDT = 64 + 4;  // row pitch of a [64][64] tile
  static constexpr int tile = 64 * LD;
  // K3: Q, dO, K, V tiles + dS^T [BK][BQ]
  static constexpr int dq_bytes = (4 * tile + BK * LDT) * 4;
  // K4: K, V, Q, dO tiles + P and dS [BQ][BK] + lse and delta [BQ]
  static constexpr int dkv_bytes = (4 * tile + 2 * BQ * LDT + 2 * BQ) * 4;
};

// rows [r0, r0 + 64) of a [S, stride] tensor, hd (<= D) columns from
// `src`, as fp32 into dst[64][LD]; rows at or beyond S and columns at or
// beyond hd are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int r0, int S,
                                          int hd) {
  constexpr int LD = D + 4;
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * C4; idx += kThreads) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int s = r0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < S && c < hd)
      rt::VecLoad<T, 4>::run(src + (size_t)s * stride + c, x);
    *reinterpret_cast<float4*>(&dst[r * LD + c]) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// s[i][j] = A[a0 + i] . B[b0 + 16 j] and t[i][j] = C[a0 + i] . E[b0 + 16 j]
// over D columns: the two score products of a tile, sharing the loop.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* C,
                                             const float* Bt, const float* E,
                                             int a0, int b0, float s[4][4],
                                             float t[4][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 b[4], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(&Bt[(b0 + 16 * j) * LD + d]);
      e[j] = *reinterpret_cast<const float4*>(&E[(b0 + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&A[(a0 + i) * LD + d]);
      const float4 c = *reinterpret_cast<const float4*>(&C[(a0 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += dot4(a, b[j]);
        t[i][j] += dot4(c, e[j]);
      }
    }
  }
}

// acc[i][c] += sum_r W[r][w0 + i] * X[r][x0 + c] over the 64 rows r of a
// [64][LDT] weight tile and a [64][LD] operand tile.
template <int D>
__device__ __forceinline__ void accumulate(const float* W, const float* X,
                                           int w0, int x0,
                                           float acc[4][D / 16]) {
  constexpr int LD = D + 4;
  constexpr int LDT = 64 + 4;
  constexpr int CW = D / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 wa = *reinterpret_cast<const float4*>(&W[r * LDT + w0]);
    const float w[4] = {wa.x, wa.y, wa.z, wa.w};
    float x[CW];
#pragma unroll
    for (int c4 = 0; c4 < CW / 4; ++c4) {
      const float4 xa =
          *reinterpret_cast<const float4*>(&X[r * LD + x0 + 4 * c4]);
      x[4 * c4 + 0] = xa.x;
      x[4 * c4 + 1] = xa.y;
      x[4 * c4 + 2] = xa.z;
      x[4 * c4 + 3] = xa.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] += w[i] * x[c];
  }
}

// K3: one block per (q tile, b * H + h); walks the k tiles up to the
// causal diagonal.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int Hkv, int hd_arg, int causal,
                    float scale) {
  using L = Tiles<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int CW = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + L::tile;
  float* Ks = dOs + L::tile;
  float* Vs = Ks + L::tile;
  float* dSt = Vs + L::tile;  // [BK][LDT]: dS transposed, rounded to T

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows 4*rg .. 4*rg+3 of the q tile
  const int kc = tid % 16;  // keys kc + 16*j of a k tile (score phase)
  const int cg = tid % 16;  // columns cg*CW .. of dQ (accumulate phase)
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * hd;

  load_tile<T, D>(Qs, q + q_off, q_stride, q0, S, hd);
  load_tile<T, D>(dOs, dout + q_off, q_stride, q0, S, hd);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    row_lse[i] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    row_delta[i] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    nk = nk < last ? nk : last;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, S, hd);
    load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, S, hd);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, dOs, Ks, Vs, 4 * rg, kc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + kc + 16 * j;
        const bool keep = qi < S && kj < S && !(causal && kj > qi);
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dSt[(kc + 16 * j) * L::LDT + 4 * rg + i] =
            rt::round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    }
    __syncthreads();
    accumulate<D>(dSt, Ks, 4 * rg, cg * CW, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi >= S) continue;
    T* o = dq + q_off + (size_t)qi * q_stride + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (cg * CW + c < hd) o[c] = rt::from_float<T>(acc[i][c]);
  }
}

// K4: one block per (k tile, b * Hkv + kv head); loops over the g query
// heads of the group and over the q tiles from the causal diagonal on.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int Hkv, int hd_arg,
                     int causal, float scale) {
  using L = Tiles<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int CW = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::tile;
  float* Qs = Vs + L::tile;
  float* dOs = Qs + L::tile;
  float* Ps = dOs + L::tile;     // [BQ][LDT]: P, rounded to T
  float* dSs = Ps + BQ * L::LDT;  // [BQ][LDT]: dS, rounded to T
  float* lse_s = dSs + BQ * L::LDT;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int kr = tid / 16;  // keys 4*kr .. 4*kr+3 of the k tile
  const int qc = tid % 16;  // queries qc + 16*i of a q tile (score phase)
  const int cg = tid % 16;  // columns cg*CW .. of dK/dV
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int g = H / Hkv;
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * hd;

  load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, S, hd);
  load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, S, hd);
  float acc_k[4][CW], acc_v[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const size_t bh = (size_t)b * H + h;
    const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(Qs, q + q_off, q_stride, q0, S, hd);
      load_tile<T, D>(dOs, dout + q_off, q_stride, q0, S, hd);
      if (tid < BQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < S ? lse[bh * S + qi] : 0.f;
        delta_s[tid] = qi < S ? delta[bh * S + qi] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];  // [key i][query j], transposed scores
      two_products<D>(Ks, Vs, Qs, dOs, 4 * kr, qc, st, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = qc + 16 * j;
        const int qi = q0 + ql;
        const float l = lse_s[ql], dl = delta_s[ql];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 4 * kr + i;
          const bool keep = qi < S && kj < S && !(causal && kj > qi);
          const float pf = keep ? expf(st[i][j] * scale - l) : 0.f;
          p[i] = rt::round_to<T>(pf);
          ds[i] = rt::round_to<T>(pf * (dpt[i][j] - dl) * scale);
        }
        *reinterpret_cast<float4*>(&Ps[ql * L::LDT + 4 * kr]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&dSs[ql * L::LDT + 4 * kr]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      accumulate<D>(Ps, dOs, 4 * kr, cg * CW, acc_v);
      accumulate<D>(dSs, Qs, 4 * kr, cg * CW, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * kr + i;
    if (kj >= S) continue;
    const size_t off = kv_off + (size_t)kj * kv_stride + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      if (cg * CW + c >= hd) continue;
      dk[off + c] = rt::from_float<T>(acc_k[i][c]);
      dv[off + c] = rt::from_float<T>(acc_v[i][c]);
    }
  }
}

// ---- K3 and K4 past hd 128, fp32 and bf16: the chunked bodies ----
//
// The fp32 bodies' design with the head_dim cut into nc = ceil(hd / DC)
// chunks of DC = 128 columns (a run-time count), so four [64][DC] fp32
// tiles (132 KB) take the place of four [64][hd] ones (266 KB at 256,
// past a block's 227 KB). The score products sum over the chunks one
// after the other (each chunk's tiles loaded in turn into the same
// buffers); the dS (and P) tile then stays in shared memory while the
// operand of the accumulate product is loaded chunk by chunk, each into
// its own fp32 accumulator of 4 rows x 8 columns a thread. A block keeps
// OC = 2 output chunks in registers; past 256 the grid's z axis takes
// ceil(nc / OC) blocks per tile, each recomputing the scores over all of
// hd for its own two chunks, so one body serves every width. The
// tensor-core bodies cannot take D = 256 as they are: K4's dK and dV at
// N = 256 would take 256 accumulator registers a thread. Every tile is
// read from device memory once more per chunk than the narrow bodies read
// it (K3 reloads Q and dO for each k tile, K4 K and V for each q tile,
// both from L2); right and simple first, fast later (PERF.md).
constexpr int DC = 128;

// s[i][j] += A[a0 + i] . B[b0 + 16 j] and t[i][j] += C[a0 + i] . E[b0 + 16 j]
// over DC columns (two_products without the zeroing: the next chunk's sums).
__device__ __forceinline__ void two_products_add(const float* A,
                                                 const float* C,
                                                 const float* Bt,
                                                 const float* E, int a0,
                                                 int b0, float s[4][4],
                                                 float t[4][4]) {
  constexpr int LD = DC + 4;
#pragma unroll 2
  for (int d = 0; d < DC; d += 4) {
    float4 b[4], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(&Bt[(b0 + 16 * j) * LD + d]);
      e[j] = *reinterpret_cast<const float4*>(&E[(b0 + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&A[(a0 + i) * LD + d]);
      const float4 c = *reinterpret_cast<const float4*>(&C[(a0 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += dot4(a, b[j]);
        t[i][j] += dot4(c, e[j]);
      }
    }
  }
}

constexpr int OC = 2;  // output chunks a block keeps in registers

// Both score products of a tile pair over all nc chunks: the chunks' tiles
// of A, C (rows r_a) and B, E (rows r_b) loaded in turn into the four DC
// buffers. On return the last chunk's tiles are in the buffers.
template <typename T>
__device__ __forceinline__ void chunked_products(
    float* As, float* Cs, float* Bs, float* Es, const T* a, const T* c,
    const T* b, const T* e, size_t a_stride, size_t b_stride, int r_a,
    int r_b, int S, int hd, int nc, int a0, int b0, float s[4][4],
    float t[4][4]) {
  for (int ch = 0; ch < nc; ++ch) {
    const int o = ch * DC;
    __syncthreads();  // the previous readers of the buffers are done
    load_tile<T, DC>(As, a + o, a_stride, r_a, S, hd - o);
    load_tile<T, DC>(Cs, c + o, a_stride, r_a, S, hd - o);
    load_tile<T, DC>(Bs, b + o, b_stride, r_b, S, hd - o);
    load_tile<T, DC>(Es, e + o, b_stride, r_b, S, hd - o);
    __syncthreads();
    if (ch == 0)
      two_products<DC>(As, Cs, Bs, Es, a0, b0, s, t);
    else
      two_products_add(As, Cs, Bs, Es, a0, b0, s, t);
  }
}

// K3 past hd 128: one block per (q tile, b * H + h, pair of output
// chunks), as flash_bwd_dq_kernel.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int S, int H, int Hkv, int hd_arg, int causal,
                         float scale) {
  using L = Tiles<DC>;
  constexpr int CW = DC / 16;
  const int hd = PAD ? hd_arg : D;
  const int nc = (hd + DC - 1) / DC;  // chunks of hd
  const int c0 = blockIdx.z * OC;     // the block's first output chunk
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + L::tile;
  float* Ks = dOs + L::tile;
  float* Vs = Ks + L::tile;
  float* dSt = Vs + L::tile;  // [BK][LDT]: dS transposed, rounded to T

  const int tid = threadIdx.x;
  const int rg = tid / 16, kc = tid % 16, cg = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * hd;

  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    row_lse[i] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    row_delta[i] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
  }
  float acc[OC][4][CW];
#pragma unroll
  for (int o = 0; o < OC; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[o][i][c] = 0.f;

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    nk = nk < last ? nk : last;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    float s[4][4], dp[4][4];
    chunked_products<T>(Qs, dOs, Ks, Vs, q + q_off, dout + q_off,
                        k + kv_off, v + kv_off, q_stride, kv_stride, q0, k0,
                        S, hd, nc, 4 * rg, kc, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + kc + 16 * j;
        const bool keep = qi < S && kj < S && !(causal && kj > qi);
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dSt[(kc + 16 * j) * L::LDT + 4 * rg + i] =
            rt::round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    }
    __syncthreads();
    // the block's chunks, the last first: the last chunk of K is in Ks;
    // the others are loaded one at a time
#pragma unroll
    for (int o = OC - 1; o >= 0; --o) {
      const int ch = c0 + o;
      if (ch >= nc) continue;
      if (ch != nc - 1) {
        __syncthreads();
        load_tile<T, DC>(Ks, k + kv_off + ch * DC, kv_stride, k0, S,
                         hd - ch * DC);
        __syncthreads();
      }
      accumulate<DC>(dSt, Ks, 4 * rg, cg * CW, acc[o]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi >= S) continue;
    T* o = dq + q_off + (size_t)qi * q_stride;
#pragma unroll
    for (int oo = 0; oo < OC; ++oo)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int col = (c0 + oo) * DC + cg * CW + c;
        if (col < hd) o[col] = rt::from_float<T>(acc[oo][i][c]);
      }
  }
}

// K4 past hd 128: one block per (k tile, b * Hkv + kv head, pair of
// output chunks), as flash_bwd_dkv_kernel.
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int H, int Hkv, int hd_arg, int causal,
                          float scale) {
  using L = Tiles<DC>;
  constexpr int CW = DC / 16;
  const int hd = PAD ? hd_arg : D;
  const int nc = (hd + DC - 1) / DC;  // chunks of hd
  const int c0 = blockIdx.z * OC;     // the block's first output chunk
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::tile;
  float* Qs = Vs + L::tile;
  float* dOs = Qs + L::tile;
  float* Ps = dOs + L::tile;      // [BQ][LDT]: P, rounded to T
  float* dSs = Ps + BQ * L::LDT;  // [BQ][LDT]: dS, rounded to T
  float* lse_s = dSs + BQ * L::LDT;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int kr = tid / 16, qc = tid % 16, cg = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int g = H / Hkv;
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * hd;

  float acc_k[OC][4][CW], acc_v[OC][4][CW];
#pragma unroll
  for (int o = 0; o < OC; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc_k[o][i][c] = acc_v[o][i][c] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const size_t bh = (size_t)b * H + h;
    const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      float st[4][4], dpt[4][4];  // [key i][query j], transposed scores
      chunked_products<T>(Ks, Vs, Qs, dOs, k + kv_off, v + kv_off,
                          q + q_off, dout + q_off, kv_stride, q_stride, k0,
                          q0, S, hd, nc, 4 * kr, qc, st, dpt);
      // lse_s and delta_s: their last readers finished before the loads'
      // first barrier; the next barrier is after the P and dS stores
      if (tid < BQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < S ? lse[bh * S + qi] : 0.f;
        delta_s[tid] = qi < S ? delta[bh * S + qi] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = qc + 16 * j;
        const int qi = q0 + ql;
        const float l = lse_s[ql], dl = delta_s[ql];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 4 * kr + i;
          const bool keep = qi < S && kj < S && !(causal && kj > qi);
          const float pf = keep ? expf(st[i][j] * scale - l) : 0.f;
          p[i] = rt::round_to<T>(pf);
          ds[i] = rt::round_to<T>(pf * (dpt[i][j] - dl) * scale);
        }
        *reinterpret_cast<float4*>(&Ps[ql * L::LDT + 4 * kr]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&dSs[ql * L::LDT + 4 * kr]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      // the block's chunks, the last first: the last chunk of Q and dO
      // is in Qs and dOs; the others are loaded one at a time
#pragma unroll
      for (int o = OC - 1; o >= 0; --o) {
        const int ch = c0 + o;
        if (ch >= nc) continue;
        if (ch != nc - 1) {
          __syncthreads();
          load_tile<T, DC>(Qs, q + q_off + ch * DC, q_stride, q0, S,
                           hd - ch * DC);
          load_tile<T, DC>(dOs, dout + q_off + ch * DC, q_stride, q0, S,
                           hd - ch * DC);
          __syncthreads();
        }
        accumulate<DC>(Ps, dOs, 4 * kr, cg * CW, acc_v[o]);
        accumulate<DC>(dSs, Qs, 4 * kr, cg * CW, acc_k[o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * kr + i;
    if (kj >= S) continue;
    const size_t off = kv_off + (size_t)kj * kv_stride;
#pragma unroll
    for (int oo = 0; oo < OC; ++oo)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int col = (c0 + oo) * DC + cg * CW + c;
        if (col >= hd) continue;
        dk[off + col] = rt::from_float<T>(acc_k[oo][i][c]);
        dv[off + col] = rt::from_float<T>(acc_v[oo][i][c]);
      }
  }
}

// ---- K4's bf16 body: wgmma products, cp.async staging ----

namespace wg {

constexpr int BK = 64;         // keys per block: the wgmma M
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

template <int D>
struct DkvTiles {
  static constexpr int BQ = D == 64 ? 64 : 32;  // queries per streamed tile
  static constexpr int kv = BK * D * 2;         // the K or V tile, bytes
  static constexpr int qt = BQ * D * 2;         // a Q or dO tile
  // a stage: Q, dO, then lse and delta [BQ] fp32 in a 1024-byte slot
  static constexpr int stage = 2 * qt + 1024;
  static constexpr int bytes = 2 * kv + 2 * stage + 1024;  // + align slack
};

template <int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int H, int Hkv, int hd_arg, int causal,
                           float scale) {
  using L = DkvTiles<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int BQ = L::BQ;
  constexpr int SR = BQ / 2;  // score accumulator registers
  constexpr int DR = D / 2;   // dK / dV accumulator registers
  extern __shared__ uint8_t smem[];
  const uint32_t raw = hop::smem_addr(smem);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + L::kv;
  const uint32_t sStage = sV + L::kv;
  const uint8_t* base = smem + (sK - raw);  // sK as a generic pointer

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int g = H / Hkv;
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t kv_off = (size_t)b * S * kv_stride + (size_t)kvh * hd;
  const int first = causal ? k0 / BQ : 0;
  const int nqt = (S + BQ - 1) / BQ - first;  // q tiles per head
  const int n = g * nqt;

  // Stage the q tile of iteration `it` (head kvh * g + it / nqt).
  auto fetch = [&](int it, uint32_t st) {
    const int h = kvh * g + it / nqt;
    const int q0 = (first + it % nqt) * BQ;
    const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
    hop::load_tile<BQ, D, kThreads>(st, q + q_off, q_stride, q0, S, hd);
    hop::load_tile<BQ, D, kThreads>(st + L::qt, dout + q_off, q_stride, q0,
                                    S, hd);
    const int j = tid % BQ, qi = q0 + j;
    const float* row = (tid < BQ ? lse : delta) + ((size_t)b * H + h) * S;
    if (tid < 2 * BQ)
      hop::cp_async4(st + 2 * L::qt + 4 * tid, row + (qi < S ? qi : 0),
                     qi < S);
  };
  hop::load_tile<BK, D, kThreads>(sK, k + kv_off, kv_stride, k0, S, hd);
  hop::load_tile<BK, D, kThreads>(sV, v + kv_off, kv_stride, k0, S, hd);
  fetch(0, sStage);
  hop::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc_k[DR], acc_v[DR];
#pragma unroll
  for (int i = 0; i < DR; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const uint32_t st = sStage + (it & 1) * L::stage;
    const int q0 = (first + it % nqt) * BQ;
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    __syncthreads();  // tile it landed; every reader of the other stage done
    if (it + 1 < n) {
      fetch(it + 1, sStage + ((it + 1) & 1) * L::stage);
      hop::cp_async_commit();
    }

    float sc[SR], dp[SR];  // [key][query]: S^T, then P^T; dP^T, then dS^T
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::Mma<BQ>::ss(sc, hop::desc_k<BK>(sK, kk), hop::desc_k<BQ>(st, kk),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::Mma<BQ>::ss(dp, hop::desc_k<BK>(sV, kk),
                       hop::desc_k<BQ>(st + L::qt, kk), kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    const float* lse_s =
        reinterpret_cast<const float*>(base + (st - sK) + 2 * L::qt);
    const float* delta_s = lse_s + BQ;
    // the masks (causal, key or query >= S) cut into this tile
    const bool edge =
        q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int ql = hop::acc_col(tid, i);
      float p = hop::exp2_approx(fmaf(sc[i], sl2, -lse_s[ql] * kLog2e));
      if (edge) {
        const int kj = k0 + hop::acc_row(tid, i), qi = q0 + ql;
        if (qi >= S || kj >= S || (causal && kj > qi)) p = 0.f;
      }
      sc[i] = p;
      dp[i] = p * (dp[i] - delta_s[ql]) * scale;
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // bf16 P^T and dS^T
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hop::to_a(sc, kk, pa[kk]);
      hop::to_a(dp, kk, da[kk]);
    }
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hop::Mma<D>::rs(acc_v, pa[kk], hop::desc_mn<BQ>(st + L::qt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hop::Mma<D>::rs(acc_k, da[kk], hop::desc_mn<BQ>(st, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc_v);
    hop::fence_regs(acc_k);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + hop::acc_row(tid, 2 * r);
    if (kj >= S) continue;
    const size_t off = kv_off + (size_t)kj * kv_stride + 2 * (tid & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= hd) continue;
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    }
  }
}

// ---- K3's bf16 body: wgmma products, cp.async staging ----

template <int D>
struct DqTiles {
  static constexpr int BQ = 64;           // query rows per block: the M
  static constexpr int BK = 64;           // keys per streamed tile
  static constexpr int qt = BQ * D * 2;   // the Q or dO tile, bytes
  static constexpr int kv = BK * D * 2;   // a K or V tile
  // Q, dO, then two stages of (K, V); slack to align the first to 1024
  static constexpr int bytes = 2 * qt + 4 * kv + 1024;
};

template <int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int H, int Hkv,
                          int hd_arg, int causal, float scale) {
  using L = DqTiles<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int SR = BK / 2;  // score accumulator registers
  constexpr int DR = D / 2;   // dQ accumulator registers
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (hop::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sdO = sQ + L::qt;
  const uint32_t sKV = sdO + L::qt;  // stage st: K, then V

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const size_t q_off = (size_t)b * S * q_stride + (size_t)h * hd;
  const bf16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * hd;
  const bf16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * hd;

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    nk = nk < last ? nk : last;
  }
  hop::load_tile<BQ, D, kThreads>(sQ, q + q_off, q_stride, q0, S, hd);
  hop::load_tile<BQ, D, kThreads>(sdO, dout + q_off, q_stride, q0, S, hd);
  hop::load_tile<BK, D, kThreads>(sKV, kb, kv_stride, 0, S, hd);
  hop::load_tile<BK, D, kThreads>(sKV + L::kv, vb, kv_stride, 0, S, hd);
  hop::cp_async_commit();

  // lse (in log2 units, negated) and delta of this thread's two rows;
  // rows at or beyond S are never stored, so their values do not matter
  const float sl2 = scale * kLog2e;
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + hop::acc_row(tid, 2 * r);
    nl[r] = qi < S ? -lse[(size_t)bh * S + qi] * kLog2e : 0.f;
    dl[r] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
  }
  float acc[DR];
#pragma unroll
  for (int i = 0; i < DR; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const uint32_t sK = sKV + (kt & 1) * 2 * L::kv;
    const uint32_t sV = sK + L::kv;
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    __syncthreads();  // tile kt landed; every reader of the other stage done
    if (kt + 1 < nk) {
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * L::kv;
      hop::load_tile<BK, D, kThreads>(nK, kb, kv_stride, k0 + BK, S, hd);
      hop::load_tile<BK, D, kThreads>(nK + L::kv, vb, kv_stride, k0 + BK, S,
                                      hd);
      hop::cp_async_commit();
    }

    float sc[SR], dp[SR];  // [query][key]: S, then dS; dP
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::Mma<BK>::ss(sc, hop::desc_k<BQ>(sQ, kk), hop::desc_k<BK>(sK, kk),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::Mma<BK>::ss(dp, hop::desc_k<BQ>(sdO, kk), hop::desc_k<BK>(sV, kk),
                       kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    // the masks (causal, key >= S) cut into this tile
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = (i >> 1) & 1;
      float p = hop::exp2_approx(fmaf(sc[i], sl2, nl[r]));
      if (edge) {
        const int kj = k0 + hop::acc_col(tid, i);
        if (kj >= S || (causal && kj > q0 + hop::acc_row(tid, i))) p = 0.f;
      }
      sc[i] = p * (dp[i] - dl[r]) * scale;
    }
    uint32_t da[BK / 16][4];  // dS in bf16: the A operand of dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::to_a(sc, kk, da[kk]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::Mma<D>::rs(acc, da[kk], hop::desc_mn<BK>(sK, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + hop::acc_row(tid, 2 * r);
    if (qi >= S) continue;
    bf16* row = dq + q_off + (size_t)qi * q_stride + 2 * (tid & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

}  // namespace wg

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  int B, S, H, Hkv, hd, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool PAD>
int launch_dq(const Args& a) {
  static bool attr = false;
  const int bytes = Tiles<D>::dq_bytes;
  if (int e = allow_smem(flash_bwd_dq_kernel<T, D, PAD>, bytes, &attr))
    return e;
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D, PAD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.S, a.H, a.Hkv, a.hd, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool PAD>
int launch_dkv(const Args& a) {
  static bool attr = false;
  const int bytes = Tiles<D>::dkv_bytes;
  if (int e = allow_smem(flash_bwd_dkv_kernel<T, D, PAD>, bytes, &attr))
    return e;
  dim3 grid((a.S + BK - 1) / BK, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, D, PAD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H,
      a.Hkv, a.hd, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 bodies stage their tiles by cp.async: 16-byte-aligned tensors
// (and 4-byte lse / delta) only.
bool misaligned(const Args& a) {
  auto u = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  return (u(a.q) | u(a.k) | u(a.v) | u(a.dout) | u(a.out0) | u(a.out1)) %
             16 ||
         (u(a.lse) | u(a.delta)) % 4;
}

// K3 past 128, both types: the chunked CUDA-core body.
template <typename T, int D, bool PAD>
int launch_dq_wide(const Args& a) {
  static bool attr = false;
  const int bytes = Tiles<DC>::dq_bytes;
  if (int e = allow_smem(flash_bwd_dq_wide_kernel<T, D, PAD>, bytes, &attr))
    return e;
  const int nc = (a.hd + DC - 1) / DC;
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H, (nc + OC - 1) / OC);
  flash_bwd_dq_wide_kernel<T, D, PAD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.S, a.H, a.Hkv, a.hd, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K4 past 128, both types: the chunked CUDA-core body.
template <typename T, int D, bool PAD>
int launch_dkv_wide(const Args& a) {
  static bool attr = false;
  const int bytes = Tiles<DC>::dkv_bytes;
  if (int e = allow_smem(flash_bwd_dkv_wide_kernel<T, D, PAD>, bytes, &attr))
    return e;
  const int nc = (a.hd + DC - 1) / DC;
  dim3 grid((a.S + BK - 1) / BK, a.B * a.Hkv, (nc + OC - 1) / OC);
  flash_bwd_dkv_wide_kernel<T, D, PAD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H,
      a.Hkv, a.hd, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K4 in bf16: the tensor-core body.
template <int D, bool PAD>
int launch_dkv_wgmma(const Args& a) {
  using wg::bf16;
  if (misaligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  static bool attr = false;
  const int bytes = wg::DkvTiles<D>::bytes;
  if (int e = allow_smem(wg::flash_bwd_dkv_wgmma_kernel<D, PAD>, bytes,
                         &attr))
    return e;
  dim3 grid((a.S + wg::BK - 1) / wg::BK, a.B * a.Hkv);
  wg::flash_bwd_dkv_wgmma_kernel<D, PAD>
      <<<grid, wg::kThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.S,
      a.H, a.Hkv, a.hd, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K3 in bf16: the tensor-core body.
template <int D, bool PAD>
int launch_dq_wgmma(const Args& a) {
  using wg::bf16;
  using L = wg::DqTiles<D>;
  if (misaligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  static bool attr = false;
  if (int e = allow_smem(wg::flash_bwd_dq_wgmma_kernel<D, PAD>, L::bytes,
                         &attr))
    return e;
  dim3 grid((a.S + L::BQ - 1) / L::BQ, a.B * a.H);
  wg::flash_bwd_dq_wgmma_kernel<D, PAD><<<grid, wg::kThreads, L::bytes,
                                     a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.out0), a.S, a.H, a.Hkv, a.hd, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV, typename T, int D, bool PAD>
int run(const Args& a) {
  if constexpr (D == 256 && DKV) {
    return launch_dkv_wide<T, D, PAD>(a);
  } else if constexpr (D == 256) {
    return launch_dq_wide<T, D, PAD>(a);
  } else if constexpr (DKV && std::is_same_v<T, __nv_bfloat16>) {
    return launch_dkv_wgmma<D, PAD>(a);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dq_wgmma<D, PAD>(a);
  } else if constexpr (DKV) {
    return launch_dkv<T, D, PAD>(a);
  } else {
    return launch_dq<T, D, PAD>(a);
  }
}

// Runs f(Width<D, PAD>{}) for head_dim hd (a multiple of 8): the body
// compiled at D = 64 for hd <= 64, at 128 up to 128, else the chunked
// bodies (D = 256: its PAD instantiation takes any hd past 128), with PAD
// when hd differs from D (tile columns past hd zero-filled). hd 64, 128
// and 256 run the bodies with hd known to the compiler.
template <int D_, bool PAD_>
struct Width {
  static constexpr int D = D_;
  static constexpr bool PAD = PAD_;
};

template <typename F>
int by_width(int hd, F f) {
  if (hd == 64) return f(Width<64, false>{});
  if (hd == 128) return f(Width<128, false>{});
  if (hd == 256) return f(Width<256, false>{});
  if (hd < 8 || hd % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (hd > 128) return f(Width<256, true>{});
  return hd < 64 ? f(Width<64, true>{}) : f(Width<128, true>{});
}


template <bool DKV>
int dispatch(int dtype, const Args& a) {
  if (dtype == 0)
    return by_width(a.hd, [&](auto w) {
      using W = decltype(w);
      return run<DKV, float, W::D, W::PAD>(a);
    });
  if (dtype == 1)
    return by_width(a.hd, [&](auto w) {
      using W = decltype(w);
      return run<DKV, __nv_bfloat16, W::D, W::PAD>(a);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/dout/dq [B, S, H, hd]; k/v [B, S, Hkv, hd]; lse/delta [B*H, S] fp32;
// hd a multiple of 8. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int S,
                               int H, int Hkv, int hd, int causal,
                               float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, S, H, Hkv,
               hd, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, a);
}

// As above; writes dk and dv [B, S, Hkv, hd].
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int S, int H, int Hkv, int hd, int causal,
                                float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, S, H, Hkv, hd,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, a);
}
