// Paged-KV verify attention for Hopper: S query tokens per slot.
//
// Two kernels from one body:
// - K1' paged_verify_kernel replaces ray_tpu/ops/paged_attention.py::
//   _dma_kernel in verify mode (n_q = S, launched by _paged_verify_dma):
//   query j of a slot sits at position lengths-1+j and attends positions
//   < lengths + j, capped at P pages.
// - K5 paged_verify_insert_kernel replaces ::_fused_kernel (launched by
//   _verify_insert_dma): K1' with the S new tokens' K/V written into the
//   pool at positions lengths-1 ... lengths+S-2 in the same launch.
//
// Pool layout (the port's, as K1's): [hkv, num_pages, page, hd] for one
// layer; the engine's pool is [L, hkv, N, page, hd] and the wrapper passes
// the layer's base pointer. q and out are [B, S, h, hd], knew/vnew
// [B, S, hkv, hd].
//
// What bounds it: bytes, as for K1. A call reads every attended token's K
// and V row once per kv head (about 16 MB at 32 slots x ~165 tokens x 12
// kv heads x hd 64 in bf16) and does 2*g*S FMAs per element read, far
// below the card's operations-per-byte ridge. The design is K1's: grid
// (slot, kv head, row group), four warps split the slot's tokens, each
// keeps fp32 (max, sum, acc) per query row in registers, and the warps
// merge through shared memory. The g*S query rows of a kv head (g = h/hkv,
// query index minor as in the TPU kernel's fold) go in groups of RG <= 8
// rows; each group is one block, so a kv head with more than 8 rows reads
// its K/V rows once per group (the later reads mostly hit L2).
//
// K5's insert: the TPU kernel merges the new columns into the page while
// it streams through VMEM and DMAs the page back. Here the block for
// (slot, kv head) takes the new tokens' K/V rows for the attention
// straight from knew/vnew (the very values it stores), reads only
// positions < lengths-1 from the pool, and stores the new rows as plain
// bit copies: no read of the pool ever follows a store to the same
// address, so no ordering between the two is needed. A write whose page
// index is >= P is dropped, as in the TPU kernel. Only scratch page 0 can
// be written by several blocks at once (inactive slots, all-zero table
// rows), which its garbage-by-contract allows.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kNeg = -0.7f * FLT_MAX;

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = unsigned int;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
};

template <typename T, int HD, int RG, bool INSERT, typename PoolPtr>
__device__ __forceinline__ void verify_body(
    const T* __restrict__ q, PoolPtr k_pages, PoolPtr v_pages,
    const T* __restrict__ knew, const T* __restrict__ vnew,
    const int* __restrict__ lengths, const int* __restrict__ tables,
    T* __restrict__ out, int S, int G, int num_pages, int page, int P,
    float scale) {
  constexpr int VEC = HD / 32;        // head-dim elements per lane
  constexpr int U = RG <= 2 ? 8 : 4;  // tokens per warp iteration
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int hkv = gridDim.y;
  const int r0 = blockIdx.z * RG;     // first query row of this block
  const int R = G * S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = hkv * G;
  const int cap = P * page;
  const int len = lengths[b];
  // Positions >= base come from knew/vnew (K5); K1' reads the pool only.
  const int base = INSERT ? len - 1 : cap;
  const int* row = tables + (size_t)b * P;
  const size_t head_base = (size_t)kvh * num_pages;

  if constexpr (INSERT) {
    using B_t = typename Bits<T>::type;
    const int n = blockIdx.z == 0 ? S * HD : 0;  // one row group writes
    for (int idx = threadIdx.x; idx < n; idx += kWarps * 32) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int pos = base + j;
      if (pos < 0 || pos >= cap) continue;
      const size_t dst =
          ((head_base + row[pos / page]) * page + pos % page) * HD + d;
      const size_t src = (((size_t)b * S + j) * hkv + kvh) * HD + d;
      reinterpret_cast<B_t*>(k_pages)[dst] =
          reinterpret_cast<const B_t*>(knew)[src];
      reinterpret_cast<B_t*>(v_pages)[dst] =
          reinterpret_cast<const B_t*>(vnew)[src];
    }
  }

  // Row i of the group is query row r = r0 + i: query head kvh*G + r/S,
  // token j = r%S, causal limit min(len + j, cap).
  float qv[RG][VEC];
  int lim[RG];
  int eff = 0;
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int r = r0 + i;
    if (r < R) {
      const int j = r % S;
      rt::VecLoad<T, VEC>::run(
          q + (((size_t)b * S + j) * h + kvh * G + r / S) * HD + lane * VEC,
          qv[i]);
      int l = len + j;
      l = l < 0 ? 0 : (l < cap ? l : cap);
      lim[i] = l;
      eff = eff > l ? eff : l;
    } else {
      lim[i] = 0;
#pragma unroll
      for (int c = 0; c < VEC; ++c) qv[i][c] = 0.f;
    }
  }

  float m[RG], l[RG], acc[RG][VEC];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = warp * U; t0 < eff; t0 += kWarps * U) {
    float kf[U][VEC], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < eff) {
        if (INSERT && t >= base) {
          const size_t off =
              (((size_t)b * S + (t - base)) * hkv + kvh) * HD + lane * VEC;
          rt::VecLoad<T, VEC>::run(knew + off, kf[u]);
          rt::VecLoad<T, VEC>::run(vnew + off, vf[u]);
        } else {
          const size_t off =
              ((head_base + row[t / page]) * page + (t % page)) * HD +
              lane * VEC;
          rt::VecLoad<T, VEC>::run(k_pages + off, kf[u]);
          rt::VecLoad<T, VEC>::run(v_pages + off, vf[u]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) kf[u][c] = vf[u][c] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      if (r0 + i >= R) continue;  // uniform across the block
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < VEC; ++c) part += qv[i][c] * kf[u][c];
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
        s[u] = (t0 + u < lim[i]) ? s[u] * scale : kNeg;
        cmax = fmaxf(cmax, s[u]);
      }
      const float m_new = fmaxf(m[i], cmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = (t0 + u < lim[i]) ? expf(s[u] - m_new) : 0.f;
        psum += s[u];
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float a = acc[i][c] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a += s[u] * vf[u][c];
        acc[i][c] = a;
      }
      m[i] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][RG];
  __shared__ float sm_l[kWarps][RG];
  __shared__ float sm_acc[kWarps][RG][HD];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) sm_acc[warp][i][lane * VEC + c] = acc[i][c];
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RG * HD; idx += kWarps * 32) {
    const int i = idx / HD;
    const int d = idx % HD;
    const int r = r0 + i;
    if (r >= R) break;  // rows past R come last in idx order
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][i] - mx);
      lsum += sm_l[w][i] * f;
      a += sm_acc[w][i][d] * f;
    }
    if (lsum == 0.f) lsum = 1.f;
    out[(((size_t)b * S + r % S) * h + kvh * G + r / S) * HD + d] =
        rt::from_float<T>(a / lsum);
  }
}

// K1': the pools are only read (read-only, non-aliased: the compiler may
// use the non-coherent load path).
template <typename T, int HD, int RG>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int S, int G, int num_pages, int page, int P,
                    float scale) {
  verify_body<T, HD, RG, false>(q, k_pages, v_pages, nullptr, nullptr,
                                lengths, tables, out, S, G, num_pages, page,
                                P, scale);
}

// K5: the pools are written, so they are plain (coherent) pointers.
template <typename T, int HD, int RG>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_insert_kernel(const T* __restrict__ q, T* k_pages, T* v_pages,
                           const T* __restrict__ knew,
                           const T* __restrict__ vnew,
                           const int* __restrict__ lengths,
                           const int* __restrict__ tables,
                           T* __restrict__ out, int S, int G, int num_pages,
                           int page, int P, float scale) {
  verify_body<T, HD, RG, true>(q, k_pages, v_pages, knew, vnew, lengths,
                               tables, out, S, G, num_pages, page, P, scale);
}

struct Args {
  const void* q;
  void* k_pages;
  void* v_pages;
  const void* knew;
  const void* vnew;
  const int* lengths;
  const int* tables;
  void* out;
  int B, S, hkv, G, num_pages, page, P;
  float scale;
  bool insert;
};

template <typename T, int HD, int RG>
int launch(const Args& a, cudaStream_t stream) {
  const int R = a.G * a.S;
  dim3 grid(a.B, a.hkv, (R + RG - 1) / RG);
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  if (a.insert) {
    paged_verify_insert_kernel<T, HD, RG><<<grid, kWarps * 32, 0, stream>>>(
        q, static_cast<T*>(a.k_pages), static_cast<T*>(a.v_pages),
        static_cast<const T*>(a.knew), static_cast<const T*>(a.vnew),
        a.lengths, a.tables, out, a.S, a.G, a.num_pages, a.page, a.P,
        a.scale);
  } else {
    paged_verify_kernel<T, HD, RG><<<grid, kWarps * 32, 0, stream>>>(
        q, static_cast<const T*>(a.k_pages), static_cast<const T*>(a.v_pages),
        a.lengths, a.tables, out, a.S, a.G, a.num_pages, a.page, a.P,
        a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows per block: the least of 2, 4, 8 that holds all g*S rows, else 8.
template <typename T, int HD>
int dispatch_rows(const Args& a, cudaStream_t s) {
  const int R = a.G * a.S;
  if (R <= 2) return launch<T, HD, 2>(a, s);
  if (R <= 4) return launch<T, HD, 4>(a, s);
  return launch<T, HD, 8>(a, s);
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t s) {
  if (hd == 64) return dispatch_rows<T, 64>(a, s);
  if (hd == 128) return dispatch_rows<T, 128>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, S, hkv*G, hd]; k_pages/v_pages [hkv, num_pages, page, hd] (one
// layer); knew/vnew [B, S, hkv, hd] (read only when insert != 0);
// lengths [B] int32 (the causal limit of query 0); tables [B, P] int32;
// out [B, S, hkv*G, hd]. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t.
extern "C" int rt_paged_verify(const void* q, void* k_pages, void* v_pages,
                               const void* knew, const void* vnew,
                               const int* lengths, const int* tables,
                               void* out, int B, int S, int hkv, int G,
                               int hd, int num_pages, int page, int P,
                               float scale, int dtype, int insert,
                               void* stream) {
  if (S < 1 || G < 1 || G * S > 40 || (insert && (!knew || !vnew)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   k_pages, v_pages,   knew, vnew, lengths, tables, out,
               B,   S,       hkv,       G,    num_pages,     page,   P,
               scale, insert != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, a, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
