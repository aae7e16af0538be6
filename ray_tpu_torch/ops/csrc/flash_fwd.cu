// Flash-attention forward for Hopper.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd): causal or full attention with an fp32 running max, sum
// and accumulator, causal tiles above the diagonal skipped, keys at or
// beyond S masked, P cast to V's dtype before the PV product, and an
// optional per-row logsumexp (flat [B*H, S] fp32, not the TPU's
// 128-lane copy).
//
// Layout: q/out [B, S, H, D], k/v [B, S, Hkv, D] (GQA: head i reads kv
// head i / (H / Hkv)). The kernel reads the model's layout through
// strides, so no transpose or head repeat is materialized, and it masks a
// ragged S itself instead of padding to a tile multiple.
//
// What bounds it: at [8, 1024, 12, 64] causal bf16 the work is ~12.9
// GFLOP against ~50 MB of q/k/v/out; at the H100 data sheet's rates
// (989 TFLOP/s bf16 tensor cores, 3.35 TB/s) moving the bytes takes
// slightly longer than the products, so on tensor cores it would be
// bytes-bound. This first version does the products with fp32 FMAs on
// the CUDA cores (no mma/wgmma yet), which makes it bound by
// operations: one block owns a 64-row q tile of one head and streams
// 64-key K/V tiles through shared memory (Q and K stored transposed so
// each thread's 4x4 score tile and 4x(D/16) output tile come from float4
// shared-memory loads: 16 FMAs per two 16-byte loads). Tensor-core
// products (mma.sync/wgmma), TMA staging and double buffering are left for
// a later change.
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int Hkv, int causal,
                 float scale) {
  using L = Smem<D>;
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
  const size_t q_stride = (size_t)H * D;    // between sequence positions
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * S * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * D;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    QsT[d * L::LDQ + r] = s < S ? rt::to_float(qb[s * q_stride + d]) : 0.f;
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
      const bool ok = s < S;
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
    T* o = out + (size_t)b * S * q_stride + qi * q_stride + (size_t)h * D +
           kg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[c] = rt::from_float<T>(acc[i][c] / ls);
    if (lse != nullptr && kg == 0) lse[(size_t)bh * S + qi] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int H, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  using L = Smem<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int Hkv, int causal,
               float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, lse, B, S, H, Hkv, causal, scale, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, lse, B, S, H, Hkv, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/out [B, S, H, D]; k/v [B, S, Hkv, D]; lse [B*H, S] fp32 or null.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int S, int H,
                            int Hkv, int D, int causal, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, l, B, S, H, Hkv, causal, scale,
                             s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, l, B, S, H, Hkv, causal,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
