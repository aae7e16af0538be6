// Flash-attention forward for Hopper.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd): causal or full attention with an fp32 running max, sum
// and accumulator, causal tiles above the diagonal skipped, keys at or
// beyond S masked, P cast to V's dtype before the PV product, and an
// optional per-row logsumexp (flat [B*H, S] fp32, not the TPU's
// 128-lane copy).
//
// Layout: q/out [B, S, H, hd], k/v [B, S, Hkv, hd] (GQA: head i reads kv
// head i / (H / Hkv)). The kernel reads the model's layout through
// strides, so no transpose or head repeat is materialized, and it masks a
// ragged S itself instead of padding to a tile multiple. head_dim: any
// multiple of 8 up to 256; each body is compiled at D = 64 and 128, and a
// smaller hd is zero-filled up to D in shared memory (zero columns add
// nothing to a score and no output column is stored past hd) by the PAD
// instantiations; hd 64 and 128 run bodies with hd known at compile time.
// hd 136-256 run the CUDA-core body below at D = 256, in both types: a
// 64-row wgmma tile's O at N = 256 alone would take 128 registers a
// thread, and that body's four fp32 tiles at D = 256 (218 KB) still fit
// one block's shared memory. It is right and simple, one block an SM;
// making it fast is later work (PERF.md).
//
// What bounds it: at [8, 1024, 12, 64] causal bf16 the work is ~12.9
// GFLOP against ~50 MB of q/k/v/out; at the H100 data sheet's rates
// (989 TFLOP/s bf16 tensor cores, 3.35 TB/s) moving the bytes takes
// slightly longer than the products, so it is bytes-bound on the tensor
// cores, and the softmax's exponentials (16 a clock per SM) come next.
//
// Two bodies. bf16 (`flash_fwd_wgmma_kernel`): both products on the
// tensor cores with wgmma. One warpgroup owns a 64-row q tile of one head;
// Q sits in swizzled shared memory once, and 64-key K/V tiles stream
// through a 2-stage cp.async ring, the next tile in flight while this one
// computes. S = Q K^T is a shared-memory wgmma; the online softmax runs on
// the accumulator registers; P is rounded to bf16 in registers and is the
// register A operand of the PV wgmma (V read MN-major), so P never goes
// through shared memory. The softmax (exponentials on the SFU, the row
// max over raw scores, the scale folded into one FMA) is what a tile
// waits on; five such blocks share an SM (102 registers, 41 KB at D = 64)
// and hide each other's softmax, products and copies. Fewer, larger
// blocks measured slower on an H100: two warpgroups sharing a 128-row
// block, and an in-warpgroup overlap of softmax with the PV product (128
// registers, four blocks an SM). fp32 (`flash_fwd_kernel`, also bf16 at
// D = 256): the products as fp32 FMAs on the CUDA cores (tensor cores
// would take fp32 as TF32, and the fp32 path is the one the exactness
// checks hold to the plain version): Q and K stored transposed so each
// thread's 4x4 score tile and 4x(D/16) output tile come from float4
// shared-memory loads.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int LDQ = BQ + 4;  // QsT [D][LDQ]
  static constexpr int LDK = BK + 4;  // KsT [D][LDK]
  static constexpr int LDV = D + 4;   // Vs  [BK][LDV]
  static constexpr int LDP = BQ + 4;  // PsT [BK][LDP]
  static constexpr int floats = D * LDQ + D * LDK + BK * LDV + BK * LDP;
  static constexpr int bytes = floats * 4;
};

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hkv, int hd_arg,
                 int causal, float scale) {
  using L = Smem<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int CW = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* QsT = smem;
  float* KsT = QsT + D * L::LDQ;
  float* Vs = KsT + D * L::LDK;
  float* PsT = Vs + BK * L::LDV;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows 4*rg .. 4*rg+3 of the q tile
  const int kg = tid % 16;  // keys 4*kg .. 4*kg+3 of a k tile
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_stride = (size_t)H * hd;    // between sequence positions
  const size_t kv_stride = (size_t)Hkv * hd;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * hd;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * hd;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * hd;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    QsT[d * L::LDQ + r] =
        s < S && d < hd ? rt::to_float(qb[s * q_stride + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    nk = nk < last ? nk : last;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int s = k0 + j;
      const bool ok = s < S && d < hd;
      KsT[d * L::LDK + j] = ok ? rt::to_float(kb[s * kv_stride + d]) : 0.f;
      Vs[j * L::LDV + d] = ok ? rt::to_float(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &QsT[d * L::LDQ + 4 * rg]);
      const float4 ka = *reinterpret_cast<const float4*>(
          &KsT[d * L::LDK + 4 * kg]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * kg + j;
        float x = sc[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        PsT[(4 * kg + j) * L::LDP + 4 * rg + i] = rt::round_to<T>(p);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(
          &PsT[j * L::LDP + 4 * rg]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[CW];
#pragma unroll
      for (int c4 = 0; c4 < CW / 4; ++c4) {
        const float4 va = *reinterpret_cast<const float4*>(
            &Vs[j * L::LDV + kg * CW + 4 * c4]);
        vv[4 * c4 + 0] = va.x;
        vv[4 * c4 + 1] = va.y;
        vv[4 * c4 + 2] = va.z;
        vv[4 * c4 + 3] = va.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * rg + i;
    if (qi >= S) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* o = out + (size_t)b * S * q_stride + qi * q_stride + (size_t)h * hd +
           kg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (kg * CW + c < hd) o[c] = rt::from_float<T>(acc[i][c] / ls);
    if (lse != nullptr && kg == 0) lse[(size_t)bh * S + qi] = m[i] + logf(ls);
  }
}

template <typename T, int D, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int hd, int causal, float scale,
           cudaStream_t stream) {
  using L = Smem<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D, PAD><<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hkv, hd,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 body: wgmma products, cp.async staging ----

namespace wg {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
using bf16 = __nv_bfloat16;

template <int D>
struct Smem {
  static constexpr int tile = 64 * D * 2;  // one [64][D] bf16 tile
  // Q, then two stages of (K, V); slack to align the first tile to 1024
  static constexpr int bytes = 5 * tile + 1024;
};

template <int D, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int Hkv,
                       int hd_arg, int causal, float scale) {
  using L = Smem<D>;
  const int hd = PAD ? hd_arg : D;  // the head_dim (<= D)
  constexpr int OR = D / 2;  // output accumulator registers
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (hop::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + L::tile;  // stage st: K, then V

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const size_t q_stride = (size_t)H * hd;
  const size_t kv_stride = (size_t)Hkv * hd;
  const bf16* qb = q + (size_t)b * S * q_stride + (size_t)h * hd;
  const bf16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * hd;
  const bf16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * hd;

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / BK + 1;
    nk = nk < last ? nk : last;
  }
  hop::load_tile<BQ, D, kThreads>(sQ, qb, q_stride, q0, S, hd);
  hop::load_tile<BK, D, kThreads>(sKV, kb, kv_stride, 0, S, hd);
  hop::load_tile<BK, D, kThreads>(sKV + L::tile, vb, kv_stride, 0, S, hd);
  hop::cp_async_commit();

  const float sl2 = scale * kLog2e;  // scores in log2 units
  float o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // this thread's part

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const uint32_t sK = sKV + (kt & 1) * 2 * L::tile;
    const uint32_t sV = sK + L::tile;
    hop::cp_async_wait_all();
    hop::fence_async_smem();
    __syncthreads();  // tile kt landed; every reader of the other stage done
    if (kt + 1 < nk) {
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * L::tile;
      hop::load_tile<BK, D, kThreads>(nK, kb, kv_stride, k0 + BK, S, hd);
      hop::load_tile<BK, D, kThreads>(nK + L::tile, vb, kv_stride, k0 + BK,
                                      S, hd);
      hop::cp_async_commit();
    }

    float s[BK / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::Mma<BK>::ss(s, hop::desc_k<BQ>(sQ, kk), hop::desc_k<BK>(sK, kk),
                       kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(s);

    // the row max over raw scores (scale > 0), scaled once per row
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (edge) {
        const int key = k0 + hop::acc_col(tid, i);
        if (key >= S || (causal && key > q0 + hop::acc_row(tid, i)))
          s[i] = kNegInf;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], hop::quad_max(mx[r]) * sl2);
      alpha[r] = hop::exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = hop::exp2_approx(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
      l[(i >> 1) & 1] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[BK / 16][4];  // P in bf16: the A operand of O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::to_a(s, kk, pa[kk]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::Mma<D>::rs(o, pa[kk], hop::desc_mn<BK>(sV, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(o);
  }

  bf16* ob = out + (size_t)b * S * q_stride + (size_t)h * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + hop::acc_row(tid, 2 * r);
    const float ls = fmaxf(hop::quad_sum(l[r]), 1e-30f);
    if (qi >= S) continue;
    const float inv = 1.f / ls;
    bf16* row = ob + (size_t)qi * q_stride + 2 * (tid & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && (tid & 3) == 0)
      lse[(size_t)bh * S + qi] = m[r] * kLn2 + logf(ls);
  }
}

template <int D, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int hd, int causal, float scale,
           cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);  // cp.async: 16 B
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_wgmma_kernel<D, PAD><<<grid, kThreads, Smem<D>::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, H, Hkv,
      hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// Runs f(Width<D, PAD>{}) for head_dim hd (a multiple of 8 from 8 to 256):
// the body compiled at D = 64 for hd <= 64, at 128 up to 128, else at
// 256, with PAD when hd < D (its tile columns past hd zero-filled). hd 64,
// 128 and 256 run the bodies with hd known to the compiler.
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
  if (hd < 8 || hd > 256 || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd > 128) return f(Width<256, true>{});
  return hd < 64 ? f(Width<64, true>{}) : f(Width<128, true>{});
}

}  // namespace

// q/out [B, S, H, hd]; k/v [B, S, Hkv, hd]; lse [B*H, S] fp32 or null.
// hd: a multiple of 8 from 8 to 256 (run at D = 64 up to 64, 128 up to
// 128, else 256). dtype: 0 = float32 (CUDA-core body), 1 = bfloat16
// (tensor-core body; the CUDA-core body at D = 256).
// Returns a cudaError_t.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int S, int H,
                            int Hkv, int hd, int causal, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return by_width(hd, [&](auto w) {
      using W = decltype(w);
      return launch<float, W::D, W::PAD>(q, k, v, out, l, B, S, H, Hkv, hd,
                                         causal, scale, s);
    });
  if (dtype == 1)
    return by_width(hd, [&](auto w) {
      using W = decltype(w);
      if constexpr (W::D == 256)
        return launch<__nv_bfloat16, W::D, W::PAD>(q, k, v, out, l, B, S, H,
                                                   Hkv, hd, causal, scale,
                                                   s);
      else
        return wg::launch<W::D, W::PAD>(q, k, v, out, l, B, S, H, Hkv, hd,
                                        causal, scale, s);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
