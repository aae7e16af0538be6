// Paged-KV decode attention for Hopper (one query token per slot).
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_dma_kernel
// (launched by _paged_decode_dma, n_q = 1): flash decode over a slot's
// page table, fp32 online softmax, GQA heads sharing one pass over KV.
//
// Pool layout (the port's choice): [hkv, num_pages, page, hd] per layer,
// i.e. the engine's pool is [L, hkv, N, page, hd]. Each token's head row
// is hd contiguous elements (128 B for hd 64 in bf16), so one warp reads
// one token's K (or V) row as a single coalesced 128/256-byte access.
// The JAX layout puts hd before page only for Mosaic's (8, 128) tiling.
//
// What bounds it: bytes. Per call it must read every attended token's K
// and V row once (about 15.7 MB at 32 slots x ~160 tokens x 12 kv heads x
// hd 64 in bf16) and does g/2 FMAs per byte read (g = h/hkv), far below
// the card's operations-per-byte ridge. The design therefore reads each K/V row
// exactly once per kv head for all g = h/hkv query heads of the group
// (grid = (slot, kv head)), keeps q and the accumulators in registers,
// and gives each warp U tokens at a time so U independent row loads are
// in flight before the first score is needed. No page copies, no scalar
// prefetch: a block reads its own page-table row. Four warps split the
// slot's tokens and merge their (max, sum, acc) states through shared
// memory at the end. Splitting long sequences across blocks
// (flash-decoding) is left for a later change.
//
// Semantics match the TPU kernel: a slot attends positions < length,
// capped at P pages; a slot with nothing to attend returns 0.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kNeg = -0.7f * FLT_MAX;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int num_pages, int page, int P, float scale) {
  constexpr int VEC = HD / 32;        // head-dim elements per lane
  constexpr int U = G <= 2 ? 8 : 4;   // tokens per warp iteration
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int hkv = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = hkv * G;

  int eff = lengths[b];
  eff = eff < 0 ? 0 : eff;
  eff = eff < P * page ? eff : P * page;

  float qv[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    rt::VecLoad<T, VEC>::run(
        q + ((size_t)b * h + kvh * G + gi) * HD + lane * VEC, qv[gi]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[gi][c] = 0.f;
  }

  const int* row = tables + (size_t)b * P;
  const size_t head_base = (size_t)kvh * num_pages;
  for (int t0 = warp * U; t0 < eff; t0 += kWarps * U) {
    float kf[U][VEC], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < eff) {
        const int pid = row[t / page];
        const size_t off =
            ((head_base + pid) * page + (t % page)) * HD + lane * VEC;
        rt::VecLoad<T, VEC>::run(k_pages + off, kf[u]);
        rt::VecLoad<T, VEC>::run(v_pages + off, vf[u]);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) kf[u][c] = vf[u][c] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < VEC; ++c) part += qv[gi][c] * kf[u][c];
        s[u] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
      float cmax = kNeg;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = (t0 + u < eff) ? s[u] * scale : kNeg;
        cmax = fmaxf(cmax, s[u]);
      }
      const float m_new = fmaxf(m[gi], cmax);
      const float alpha = expf(m[gi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = (t0 + u < eff) ? expf(s[u] - m_new) : 0.f;
        psum += s[u];
      }
      l[gi] = l[gi] * alpha + psum;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float a = acc[gi][c] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a += s[u] * vf[u][c];
        acc[gi][c] = a;
      }
      m[gi] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) sm_acc[warp][gi][lane * VEC + c] = acc[gi][c];
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int gi = idx / HD;
    const int d = idx % HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][gi] - mx);
      lsum += sm_l[w][gi] * f;
      a += sm_acc[w][gi][d] * f;
    }
    if (lsum == 0.f) lsum = 1.f;
    out[((size_t)b * h + kvh * G + gi) * HD + d] =
        rt::from_float<T>(a / lsum);
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* tables, void* out, int B, int hkv, int num_pages,
           int page, int P, float scale, cudaStream_t stream) {
  dim3 grid(B, hkv);
  paged_decode_kernel<T, HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lengths, tables, static_cast<T*>(out),
      num_pages, page, P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(int G, const void* q, const void* kp, const void* vp,
               const int* lengths, const int* tables, void* out, int B,
               int hkv, int num_pages, int page, int P, float scale,
               cudaStream_t s) {
  switch (G) {
#define RT_G(g)                                                          \
  case g:                                                                \
    return launch<T, HD, g>(q, kp, vp, lengths, tables, out, B, hkv,     \
                            num_pages, page, P, scale, s);
    RT_G(1) RT_G(2) RT_G(3) RT_G(4) RT_G(5) RT_G(6) RT_G(7) RT_G(8)
#undef RT_G
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_hd(int hd, int G, const void* q, const void* kp, const void* vp,
                const int* lengths, const int* tables, void* out, int B,
                int hkv, int num_pages, int page, int P, float scale,
                cudaStream_t s) {
  if (hd == 64)
    return dispatch_g<T, 64>(G, q, kp, vp, lengths, tables, out, B, hkv,
                             num_pages, page, P, scale, s);
  if (hd == 128)
    return dispatch_g<T, 128>(G, q, kp, vp, lengths, tables, out, B, hkv,
                              num_pages, page, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, hkv*G, hd]; k_pages/v_pages [hkv, num_pages, page, hd];
// lengths [B] int32; tables [B, P] int32; out [B, hkv*G, hd].
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int rt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const int* lengths,
                               const int* tables, void* out, int B, int hkv,
                               int G, int hd, int num_pages, int page, int P,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, G, q, k_pages, v_pages, lengths, tables,
                              out, B, hkv, num_pages, page, P, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, G, q, k_pages, v_pages, lengths,
                                      tables, out, B, hkv, num_pages, page, P,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
