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
// What bounds it: bytes. A call reads every attended token's K and V row
// once per kv head (about 16 MB at 32 slots x ~165 tokens x 12 kv heads x
// hd 64 in bf16) and does about g*S FMAs per element read, far below the
// card's operations-per-byte ridge, so the design keeps many bytes in
// flight and the math on the CUDA cores, in fp32 as the TPU kernel
// computes it (q, K and V upcast, P kept fp32 for the PV sum).
//
// Design, as the TPU kernel's page DMAs: one block of 8 warps owns one
// (slot, kv head) and a row group of at most 40 of its g*S query rows;
// the grid is (slot, kv head, row group). The verify step's rows (g*S
// <= 40 in most configs) fit one group, so each K/V row is read from HBM
// once; more rows take more groups (the wrapper's plan, `verify_plan` in
// paged_attention.py, balances them), each re-reading the slot's KV. q
// (fp32) and the slot's page-table row go into shared memory once. The
// slot's positions are cut into chunks of C tokens that never cross a
// page (C = min(page, 16 KB of K)); a chunk of
// one page is one contiguous block of C x hd elements, for K and for V.
// Thread 0 moves each chunk with two bulk copies (cp.async.bulk, the
// TMA's untiled form) into a ring of stages (64 KB in all: 2 stages of
// 32 KB at bf16 hd 64, more for small pages), each stage completing on
// its own mbarrier; the ring is refilled as stages free up. At the serving
// shape (lengths 128-191, page 128) the whole slot is in flight at once.
// A thread takes rows RB = 5 at a time (the verify step's S = 5 rows per
// query head fill a set; other counts are padded to Rp). Per chunk:
//   scores: a thread owns a key and a set of RB rows and sums the products
//           along hd from shared memory (K's 16-byte pieces read in a
//           rotated order so a warp's reads hit distinct banks; q as
//           float4): no cross-lane sum per token;
//   softmax: one warp per row reduces the chunk's max and sum (one
//           shuffle reduction per row per chunk) and updates the row's
//           running (max, sum);
//   PV:     a thread owns (RB rows, 4 columns of hd, key split) and sums
//           P x V over its keys of the chunk from shared memory into
//           registers; the key splits' partials are added once, at the
//           end, in a fixed order.
// Three blocks share an SM (at most 80 registers a thread): a block's
// time is mostly the latency of its chunks' copies and phases, which the
// other blocks hide.
// A row's causal limit is min(lengths + j, P * page); a row with nothing
// to attend returns zeros.
//
// K5's insert: positions >= lengths-1 take their K/V from knew/vnew,
// never from the pool: every row group's bulk copies stop below
// lengths-1, and the new rows are written into the stage in shared memory
// before the chunk's scores. Row group 0 alone stores the new rows into
// the pool, as bit copies, after its last copy has landed, so no copy of
// any group reads an address a block writes. A write whose page index is
// >= P is dropped, as in the TPU kernel. Only scratch page 0 can be
// written by several blocks at once (inactive slots, all-zero table
// rows), which its garbage-by-contract allows.
//
// head_dim: any multiple of 8 (a row is then a multiple of 16 bytes, as
// the bulk copies need; the wrapper zero-pads any other head_dim up to
// one). hd 64 and 128 have instantiations of their own (HD = hd); every
// other hd runs an HD = 0 instantiation, the same body with hd read at
// run time, on the real rows (stage, q and partials all hd wide). HMAX
// bounds the run-time hd: 128 for hd up to 128 (one PV item a thread),
// 256 above it (two PV items a thread, 40 more accumulator registers, so
// two blocks an SM instead of three; the shared memory, ~112 KB at bf16
// hd 256, allows two anyway). Past 256, HMAX = 0: ceil(hd / 128) PV items
// a thread at 40 rows, taken in turns with their sums in shared memory
// ([Rp][hd] fp32 beside q) and one key split, so one body serves every
// width; the plan (verify_plan) gives a group at most 40 x 256 / hd rows,
// which keeps q and the sums the size they have at hd 256.
#include <cfloat>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 40;        // query rows a block; the plan's cap
constexpr int RB = 5;               // query rows a thread takes at a time
constexpr int kMaxStages = 16;
constexpr int kChunkBytes = 16384;  // a chunk's K (or V) bytes, at most
constexpr int kMaxSplit = 16;       // key splits of the PV sum
constexpr int kRingBytes = 65536;   // the ring of stages
constexpr int kSmemLimit = 200 * 1024;
constexpr float kNeg = -0.7f * FLT_MAX;

// Tokens per chunk and stages of the ring for a page size (host and
// device agree through the launch arguments).
struct Plan {
  int chunk, stages;
};

// Bytes of the ring: its stages, and at least the PV partials that reuse
// it at the end: [KS][Rp][hd] fp32, at most 20 * kThreads floats when
// KS > 1 (KS * Rp * hd <= 4 * RB * kThreads) and kMaxRows * hd when KS = 1.
// Past 256 (HMAX = 0) the sums stay in their own [Rp][hd] buffer.
template <typename T>
__host__ __device__ inline size_t ring_bytes(int hd, int chunk, int stages,
                                             bool wide) {
  const size_t ring = (size_t)stages * 2 * chunk * hd * sizeof(T);
  const size_t red = wide ? 0
                          : (size_t)(kMaxRows * hd > 20 * kThreads
                                         ? kMaxRows * hd
                                         : 20 * kThreads) *
                                4;
  return ring > red ? ring : red;
}

// A chunk is at most kChunkBytes of K and at most 128 tokens (a chunk's
// scores sit in shared memory, [Rp][chunk] fp32).
template <typename T>
Plan plan(int hd, int page) {
  Plan p;
  p.chunk = kChunkBytes / (hd * (int)sizeof(T));
  if (p.chunk > 128) p.chunk = 128;
  if (p.chunk < 1) p.chunk = 1;  // a row past kChunkBytes (hd > 4096 fp32)
  if (page < p.chunk) p.chunk = page;
  p.stages = kRingBytes / (2 * p.chunk * hd * (int)sizeof(T));
  if (p.stages < 1) p.stages = 1;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  return p;
}

// Rows are padded to Rp, a multiple of RB (the verify step's S = 5 rows
// per query head fill it, for any g). HD: the head_dim, or 0 for one read
// from `hd_arg` at run time; HMAX: its bound, 0 for none (the sums in
// shared memory).
template <typename T, int HD, int HMAX, bool INSERT, typename PoolPtr>
__device__ __forceinline__ void verify_body(
    const T* __restrict__ q, PoolPtr k_pages, PoolPtr v_pages,
    const T* __restrict__ knew, const T* __restrict__ vnew,
    const int* __restrict__ lengths, const int* __restrict__ tables,
    T* __restrict__ out, int S, int G, int rows, int hd_arg, int num_pages,
    int page, int P, float scale, int chunk, int stages) {
  constexpr int E = hop::Vec16<T>::N;  // elements per 16 bytes
  const int hd = HD ? HD : hd_arg;
  const int CH = hd / E;      // 16-byte pieces per row
  const int C4 = hd / 4;      // 4-column slices per row
  constexpr bool WIDE = HMAX == 0;
  constexpr int NI =  // PV items per thread, at most (hd <= HMAX)
      WIDE ? 1
           : ((kMaxRows + RB - 1) / RB * ((HD ? HD : HMAX) / 4) + kThreads -
              1) / kThreads;
  static_assert(E % 4 == 0, "q pieces are read as float4");
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bars[kMaxStages];
  __shared__ float row_m[kMaxRows], row_l[kMaxRows], row_a[kMaxRows];
  __shared__ int row_lim[kMaxRows];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int hkv = gridDim.y;
  const int tid = threadIdx.x;
  // Row r of the block is row row0 + r of the (slot, kv head): query head
  // kvh*G + (row0 + r)/S, token j = (row0 + r)%S.
  const int row0 = blockIdx.z * rows;
  const int R = min(rows, G * S - row0);
  const int Rp = (R + RB - 1) / RB * RB;
  const int h = hkv * G;
  const int cap = P * page;
  const int len = lengths[b];
  // Positions >= base come from knew/vnew (K5); K1' reads the pool only.
  const int base = INSERT ? len - 1 : cap;
  const size_t head_base = (size_t)kvh * num_pages;

  const int stage_elems = chunk * hd;  // one chunk of K (or V)
  T* ring = reinterpret_cast<T*>(smem);
  float* qs =
      reinterpret_cast<float*>(smem + ring_bytes<T>(hd, chunk, stages, WIDE));
  float* accs = qs + Rp * hd;                        // WIDE: [Rp][hd]
  float* sc = accs + (WIDE ? Rp * hd : 0);           // [Rp][chunk]
  int* tab = reinterpret_cast<int*>(sc + Rp * chunk);  // used pages

  // The last row attends the most: positions < eff.
  int eff = len + S - 1;
  eff = eff < 0 ? 0 : (eff < cap ? eff : cap);
  const int np = (eff + page - 1) / page;
  const int cpp = (page + chunk - 1) / chunk;  // chunks per page
  const int nc = np == 0 ? 0
                         : (np - 1) * cpp +
                               (eff - (np - 1) * page + chunk - 1) / chunk;
  int pool_end = base < eff ? base : eff;  // copies stop below this
  pool_end = pool_end < 0 ? 0 : pool_end;

  for (int i = tid; i < np; i += kThreads) tab[i] = tables[(size_t)b * P + i];
  for (int i = tid; i < Rp * hd; i += kThreads) {
    const int r = row0 + i / hd, d = i % hd;
    qs[i] = r < row0 + R ? rt::to_float(q[(((size_t)b * S + r % S) * h +
                                            kvh * G + r / S) * hd + d])
                         : 0.f;
    if (WIDE) accs[i] = 0.f;
  }
  if (tid < Rp) {  // padded rows attend nothing
    const int l = tid < R ? len + (row0 + tid) % S : 0;
    row_lim[tid] = l < 0 ? 0 : (l < cap ? l : cap);
    row_m[tid] = kNeg;
    row_l[tid] = 0.f;
    row_a[tid] = 1.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      hop::mbar_init(hop::smem_addr(&bars[s]), 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  // Chunk c: positions [t0, t0 + n) of one page, as (t0, n).
  auto span = [&](int c) {
    const int o = (c % cpp) * chunk;
    const int t0 = (c / cpp) * page + o;
    int n = chunk < page - o ? chunk : page - o;
    n = n < eff - t0 ? n : eff - t0;
    return make_int2(t0, n);
  };
  // Thread 0: move chunk c's pool rows into its stage.
  auto fetch = [&](int c) {
    const int2 sp = span(c);
    const int t0 = sp.x, n = sp.y;
    const int st = c % stages;
    const uint32_t bar = hop::smem_addr(&bars[st]);
    int nb = pool_end - t0 < n ? pool_end - t0 : n;
    nb = nb < 0 ? 0 : nb;
    const uint32_t bytes = nb * hd * sizeof(T);
    hop::mbar_expect_tx(bar, 2 * bytes);
    if (bytes) {
      const size_t off =
          ((head_base + tab[t0 / page]) * page + t0 % page) * hd;
      const uint32_t dst = hop::smem_addr(ring + (size_t)st * 2 * stage_elems);
      hop::bulk_copy_g2s(dst, k_pages + off, bytes, bar);
      hop::bulk_copy_g2s(dst + stage_elems * sizeof(T), v_pages + off, bytes,
                         bar);
    }
  };
  if (tid == 0)
    for (int c = 0; c < nc && c < stages; ++c) fetch(c);

  float acc[NI][RB][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.f;
  const int warp = tid / 32, lane = tid % 32;
  // PV items: (group of RB rows, 4 columns) pairs, times KS key splits
  // when the pairs alone would leave threads idle
  const int pairs = Rp / RB * C4;
  int KS = WIDE || pairs >= kThreads ? 1 : kThreads / pairs;
  KS = KS < kMaxSplit ? KS : kMaxSplit;

  for (int c = 0; c < nc; ++c) {
    const int2 sp = span(c);
    const int t0 = sp.x, n = sp.y;
    const int st = c % stages;
    T* Ks = ring + (size_t)st * 2 * stage_elems;
    const T* Vs = Ks + stage_elems;
    hop::mbar_wait(hop::smem_addr(&bars[st]), (c / stages) & 1);
    if constexpr (INSERT) {
      const int f0 = t0 > base ? t0 : base;  // first row from knew/vnew
      if (f0 < t0 + n) {                     // uniform across the block
        for (int i = tid; i < (t0 + n - f0) * CH; i += kThreads) {
          const int t = f0 + i / CH, e = (i % CH) * E;
          const size_t src =
              (((size_t)b * S + (t - base)) * hkv + kvh) * hd + e;
          T* dst = Ks + (t - t0) * hd + e;
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(knew + src);
          *reinterpret_cast<uint4*>(dst + stage_elems) =
              *reinterpret_cast<const uint4*>(vnew + src);
        }
        hop::fence_async_smem();  // before a later bulk copy reuses it
        __syncthreads();
      }
    }

    // scores: item = (key kk, rows r0 .. r0 + RB - 1)
    for (int it = tid; it < chunk * (Rp / RB); it += kThreads) {
      const int kk = it % chunk, r0 = (it / chunk) * RB;
      if (kk >= n) continue;
      const T* krow = Ks + kk * hd;
      float s[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int p = 0; p < CH; ++p) {
        const int e = ((p + kk) % CH) * E;
        float kf[E];
        hop::Vec16<T>::load(krow + e, kf);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
#pragma unroll
          for (int x = 0; x < E; x += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + (r0 + i) * hd + e + x);
            s[i] = fmaf(qv.x, kf[x], s[i]);
            s[i] = fmaf(qv.y, kf[x + 1], s[i]);
            s[i] = fmaf(qv.z, kf[x + 2], s[i]);
            s[i] = fmaf(qv.w, kf[x + 3], s[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) sc[(r0 + i) * chunk + kk] = s[i] * scale;
    }
    __syncthreads();

    // softmax: warp w updates rows w, w + 8, ...; scores become P
    for (int r = warp; r < R; r += kThreads / 32) {
      const int lim = row_lim[r] - t0;  // keys kk < lim are attended
      float* sr = sc + r * chunk;
      float mx = kNeg;
      for (int kk = lane; kk < n; kk += 32)
        if (kk < lim) mx = fmaxf(mx, sr[kk]);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, hop::warp_max(mx));
      float sum = 0.f;
      for (int kk = lane; kk < n; kk += 32) {
        const float p = kk < lim ? expf(sr[kk] - m_new) : 0.f;
        sr[kk] = p;
        sum += p;
      }
      sum = hop::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // PV: item = (key split ks, rows r0 .. r0 + RB - 1, columns d .. d + 3);
    // split ks sums keys ks, ks + KS, ... of each chunk into its own partial
    if constexpr (WIDE) {  // one split; items in turns, sums in accs
      for (int it = tid; it < pairs; it += kThreads) {
        const int r0 = it / C4 * RB, d = it % C4 * 4;
        float x[RB][4];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float a = row_a[r0 + j];
          const float4 s4 =
              *reinterpret_cast<const float4*>(accs + (r0 + j) * hd + d);
          x[j][0] = s4.x * a;
          x[j][1] = s4.y * a;
          x[j][2] = s4.z * a;
          x[j][3] = s4.w * a;
        }
        const float* pr = sc + r0 * chunk;
#pragma unroll 2
        for (int kk = 0; kk < n; ++kk) {
          float vf[4];
          rt::VecLoad<T, 4>::run(Vs + kk * hd + d, vf);
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const float p = pr[j * chunk + kk];
#pragma unroll
            for (int y = 0; y < 4; ++y) x[j][y] = fmaf(p, vf[y], x[j][y]);
          }
        }
#pragma unroll
        for (int j = 0; j < RB; ++j)
          *reinterpret_cast<float4*>(accs + (r0 + j) * hd + d) =
              make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < (WIDE ? 0 : NI); ++i) {
      const int it = tid + i * kThreads;
      const int ks = it / pairs, r0 = it % pairs / C4 * RB, d = it % C4 * 4;
      if (it < pairs * KS) {
        float x[RB][4];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float a = row_a[r0 + j];
#pragma unroll
          for (int y = 0; y < 4; ++y) x[j][y] = acc[i][j][y] * a;
        }
        const float* pr = sc + r0 * chunk;
#pragma unroll 2
        for (int kk = ks; kk < n; kk += KS) {
          float vf[4];
          rt::VecLoad<T, 4>::run(Vs + kk * hd + d, vf);
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const float p = pr[j * chunk + kk];
#pragma unroll
            for (int y = 0; y < 4; ++y) x[j][y] = fmaf(p, vf[y], x[j][y]);
          }
        }
#pragma unroll
        for (int j = 0; j < RB; ++j)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[i][j][y] = x[j][y];
      }
    }
    __syncthreads();  // every reader of this stage and of the scores done
    if (tid == 0 && c + stages < nc) {
      hop::fence_async_smem();
      fetch(c + stages);
    }
  }

  // Sum the key splits' partials through the (now idle) ring, then
  // divide by the row sums (WIDE: the one split's sums, in accs).
  float* red = WIDE ? accs : reinterpret_cast<float*>(smem);  // [KS][Rp][hd]
#pragma unroll
  for (int i = 0; i < (WIDE ? 0 : NI); ++i) {
    const int it = tid + i * kThreads;
    if (it < pairs * KS) {
      const int ks = it / pairs, r0 = it % pairs / C4 * RB, d = it % C4 * 4;
#pragma unroll
      for (int j = 0; j < RB; ++j)
        *reinterpret_cast<float4*>(red + (ks * Rp + r0 + j) * hd + d) =
            make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                        acc[i][j][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, rr = row0 + r;
    float x = 0.f;
    for (int ks = 0; ks < KS; ++ks) x += red[ks * Rp * hd + i];
    const float l = row_l[r];
    out[(((size_t)b * S + rr % S) * h + kvh * G + rr / S) * hd + d] =
        rt::from_float<T>(l > 0.f ? x / l : 0.f);
  }

  if constexpr (INSERT) {
    // Row group 0 writes; every copy of this block has landed (each chunk
    // was waited for), and the other groups' copies stop below base.
    if (blockIdx.z != 0) return;
    for (int i = tid; i < S * CH; i += kThreads) {
      const int j = i / CH, e = (i % CH) * E;
      const int pos = base + j;
      if (pos < 0 || pos >= cap) continue;
      const size_t dst =
          ((head_base + tab[pos / page]) * page + pos % page) * hd + e;
      const size_t src = (((size_t)b * S + j) * hkv + kvh) * hd + e;
      *reinterpret_cast<uint4*>(k_pages + dst) =
          *reinterpret_cast<const uint4*>(knew + src);
      *reinterpret_cast<uint4*>(v_pages + dst) =
          *reinterpret_cast<const uint4*>(vnew + src);
    }
  }
}

// K1': the pools are only read.
template <typename T, int HD, int HMAX>
__global__ void __launch_bounds__(kThreads, HMAX > 128 ? 2 : 3)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int S, int G, int rows, int hd, int num_pages, int page,
                    int P, float scale, int chunk, int stages) {
  verify_body<T, HD, HMAX, false>(q, k_pages, v_pages, nullptr, nullptr,
                                  lengths, tables, out, S, G, rows, hd,
                                  num_pages, page, P, scale, chunk, stages);
}

// K5: the pools are written, so they are plain pointers.
template <typename T, int HD, int HMAX>
__global__ void __launch_bounds__(kThreads, HMAX > 128 ? 2 : 3)
paged_verify_insert_kernel(const T* __restrict__ q, T* k_pages, T* v_pages,
                           const T* __restrict__ knew,
                           const T* __restrict__ vnew,
                           const int* __restrict__ lengths,
                           const int* __restrict__ tables,
                           T* __restrict__ out, int S, int G, int rows,
                           int hd, int num_pages, int page, int P,
                           float scale, int chunk, int stages) {
  verify_body<T, HD, HMAX, true>(q, k_pages, v_pages, knew, vnew, lengths,
                                 tables, out, S, G, rows, hd, num_pages,
                                 page, P, scale, chunk, stages);
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
  int B, S, hkv, G, rows, hd, num_pages, page, P;
  float scale;
  bool insert;
};

// Raise a kernel's dynamic shared-memory allowance to `bytes`.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *allowed = bytes;
  return 0;
}

template <typename T, int HD, int HMAX>
int launch(const Args& a, cudaStream_t stream) {
  const Plan pl = plan<T>(a.hd, a.page);
  const int Rp = (a.rows + RB - 1) / RB * RB;
  const size_t bytes = ring_bytes<T>(a.hd, pl.chunk, pl.stages, HMAX == 0) +
                       (size_t)Rp * a.hd * 4 * (HMAX == 0 ? 2 : 1) +
                       (size_t)Rp * pl.chunk * 4 + (size_t)a.P * 4;
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.B, a.hkv, (a.G * a.S + a.rows - 1) / a.rows);
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  if (a.insert) {
    static int allowed = 0;
    if (int e = allow_smem(paged_verify_insert_kernel<T, HD, HMAX>,
                           (int)bytes, &allowed))
      return e;
    paged_verify_insert_kernel<T, HD, HMAX><<<grid, kThreads, bytes,
                                              stream>>>(
        q, static_cast<T*>(a.k_pages), static_cast<T*>(a.v_pages),
        static_cast<const T*>(a.knew), static_cast<const T*>(a.vnew),
        a.lengths, a.tables, out, a.S, a.G, a.rows, a.hd, a.num_pages,
        a.page, a.P, a.scale, pl.chunk, pl.stages);
  } else {
    static int allowed = 0;
    if (int e = allow_smem(paged_verify_kernel<T, HD, HMAX>, (int)bytes,
                           &allowed))
      return e;
    paged_verify_kernel<T, HD, HMAX><<<grid, kThreads, bytes, stream>>>(
        q, static_cast<const T*>(a.k_pages), static_cast<const T*>(a.v_pages),
        a.lengths, a.tables, out, a.S, a.G, a.rows, a.hd, a.num_pages,
        a.page, a.P, a.scale, pl.chunk, pl.stages);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const Args& a, cudaStream_t s) {
  if (a.hd == 64) return launch<T, 64, 64>(a, s);
  if (a.hd == 128) return launch<T, 128, 128>(a, s);
  if (a.hd < 128) return launch<T, 0, 128>(a, s);
  if (a.hd <= 256) return launch<T, 0, 256>(a, s);
  return launch<T, 0, 0>(a, s);
}

}  // namespace

// q [B, S, hkv*G, hd]; k_pages/v_pages [hkv, num_pages, page, hd] (one
// layer); knew/vnew [B, S, hkv, hd] (read only when insert != 0);
// lengths [B] int32 (the causal limit of query 0); tables [B, P] int32;
// out [B, S, hkv*G, hd]; hd a multiple of 8. Pointers
// 16-byte aligned (the bulk copies).
// `rows` (1-40): query rows a block, from the plan (verify_plan in
// paged_attention.py); the grid takes ceil(G*S / rows) row groups.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int rt_paged_verify(const void* q, void* k_pages, void* v_pages,
                               const void* knew, const void* vnew,
                               const int* lengths, const int* tables,
                               void* out, int B, int S, int hkv, int G,
                               int rows, int hd, int num_pages, int page,
                               int P, float scale, int dtype, int insert,
                               void* stream) {
  if (S < 1 || G < 1 || rows < 1 || rows > kMaxRows || page < 1 ||
      hd < 8 || hd % 8 ||
      (G * S + rows - 1) / rows > 65535 || (insert && (!knew || !vnew)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k_pages, v_pages, knew, vnew,      lengths, tables,
               out,  B,       S,       hkv,  G,         rows,    hd,
               num_pages,     page,    P,    scale,     insert != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(a, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
