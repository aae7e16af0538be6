// Paged-KV decode attention for Hopper (one query token per slot).
//
// Replaces the TPU kernel ray_tpu/ops/paged_attention.py::_dma_kernel
// (launched by _paged_decode_dma, n_q = 1): attention of each slot's query
// heads over its page table, fp32 softmax, GQA heads sharing one pass over
// KV.
//
// Pool layout (the port's choice): [hkv, num_pages, page, hd] per layer,
// i.e. the engine's pool is [L, hkv, N, page, hd]. A run of a page's
// tokens is one contiguous block of rows x hd elements, for K and for V,
// so one bulk copy moves it. The JAX layout puts hd before page only for
// Mosaic's (8, 128) tiling.
//
// What bounds it: bytes. A call must read every attended token's K and V
// row once per kv head (about 15.6 MB at 32 slots x ~160 tokens x 12 kv
// heads x hd 64 in bf16) and does g FLOP per byte read (g = h/hkv <= 8 in
// every config of the repo), below even the CUDA cores' ~20 FLOP/byte
// ridge. So the design puts many bytes in flight at once and keeps the
// math in fp32 on the CUDA cores, as the TPU kernel computes it (q, K and
// V upcast; P kept fp32). The tensor cores would round P to bf16 or take
// fp32 as TF32, and have nothing to gain here.
//
// Design: split-KV over a thread-block cluster, in one launch. The grid
// is (splits, hkv x row groups, slots); a cluster is the `splits` blocks
// of one (slot, kv head, row group), launched with cudaLaunchKernelEx.
// The wrapper's plan (`decode_plan` in paged_attention.py) fixes the
// split length (a power of two), the splits (<= 8, the portable cluster
// size) and the chunk from the shapes alone (slots x kv heads, P, page,
// hd), never from the lengths: more splits only while a call has fewer
// blocks than the card has SMs. At the serving shape (32 slots x 12 kv
// heads, P = 2, page 128) a call is 384 blocks of one 256-token split,
// all in flight at once; one slot's long table gets 8 splits. Each block:
//   - thread 0 reads the slot's length and the split's page id and moves
//     the split's K and V rows into shared memory with bulk copies
//     (cp.async.bulk under an mbarrier) in chunks that never cross a
//     page, through a ring of 1 or 2 stages; the other threads meanwhile
//     put q (fp32) into shared memory;
//   - scores: a thread per key sums q . k along hd from shared memory
//     (K's 16-byte pieces read in a rotated order, so a warp's reads hit
//     distinct banks): no per-token shuffle;
//   - softmax: one block reduction per chunk (each thread holds its key's
//     scores; warp shuffles, then the warps' partials through shared
//     memory): the rows' max, P = exp(s - max) into shared memory, the
//     rows' sums; every thread carries the rows' running (max, sum);
//   - PV: a thread owns (4 columns of hd, key split) and sums P x V over
//     its keys from shared memory into registers; the key splits' partials
//     are added once, at the end, in a fixed order.
// Each block then stores its (m, l, acc[rows][hd]) into its slot of rank
// 0's shared memory (distributed shared memory; a relaxed cluster arrive
// at the start and its wait before the first store make sure rank 0 has
// started). After a cluster barrier, rank 0 merges the splits in rank
// order and writes the rows out; nothing reads the other blocks' shared
// memory, so they exit. No atomics, no second kernel: the output is the
// same bits from run to run.
//
// Semantics match the TPU kernel: a slot attends positions < min(length,
// P * page); a slot with length <= 0 returns zeros; table entries of
// scratch page 0 are read like any page; a split with nothing to attend
// contributes (m = -inf, l = 0).
//
// head_dim: any multiple of 8 (a row is then a multiple of 16 bytes, as
// the bulk copies need; the wrapper zero-pads any other head_dim up to
// one). hd 64 and 128 have instantiations of their own (HD = hd, every
// loop bound known to the compiler); every other hd runs an HD = 0
// instantiation, the same body with hd read at run time. Shared memory
// holds the real rows (a chunk is still one contiguous run of n x hd
// elements); the PV items are (4 columns, key split) pairs of the real
// hd, threads past the last whole key split idle in PV. Past hd 512 (more
// 4-column slices than threads) the WIDE instantiation takes over: one
// key split, each thread walks its slices in turns of kThreads x 4
// columns with the rows' PV sums in shared memory ([RT][hd] fp32), so
// one body serves every width. The plan (decode_plan) keeps a block's
// shared memory inside the budget, with fewer splits, then fewer rows, as
// hd grows; at hd 256 a chunk is at most 16 KB of K (16 fp32 tokens), the
// key splits' partials at most kThreads x 4 floats a row, the cluster's
// accs 8 x 8 x 256 fp32 (64 KB).
#include <cfloat>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kMaxChunk = kThreads;  // a thread per key of a chunk
constexpr int kSmemLimit = 227 * 1024;  // a block's, on an H100
constexpr float kNeg = -0.7f * FLT_MAX;

// Shared memory of a block: the ring of K/V stages (reused at the end for
// the key splits' partials, [kThreads / (hd / 4)][RT][hd] fp32 <= 2 KB x
// RT), q [RT][hd] fp32, WIDE's PV sums [RT][hd] fp32, the chunk's P
// [RT][chunk] fp32 and, read in rank 0 only, the cluster's partial accs
// [splits][RT][hd] fp32.
template <typename T, int RT>
__host__ __device__ inline size_t ring_bytes(int hd, int chunk, int stages) {
  const size_t ring = (size_t)stages * 2 * chunk * hd * sizeof(T);
  const size_t red = (size_t)kThreads * 4 * RT * 4;
  return ring > red ? ring : red;
}

template <typename T, int RT>
__host__ __device__ inline size_t smem_bytes(int hd, int chunk, int stages,
                                             int splits, bool wide) {
  return ring_bytes<T, RT>(hd, chunk, stages) +
         (size_t)RT * (hd + chunk + splits * hd + (wide ? hd : 0)) * 4;
}

// The widest head_dim whose 4-column slices the threads cover in one
// turn; WIDE instantiations run the wider ones.
constexpr int kWideHd = 4 * kThreads;

// RT: rows (query heads) a block holds, padded to a power of two; the
// block's real rows are `rows` (the last row group may hold fewer). HD:
// the head_dim, or 0 for one read from `hd_arg` at run time. WIDE: the
// PV sums in shared memory, for hd past kWideHd.
template <typename T, int HD, int RT, bool WIDE>
__global__ void __launch_bounds__(kThreads, RT <= 2 ? 12 : 6)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int G, int rows, int hd_arg, int num_pages, int page,
                    int P, int split_len, int chunk, int stages,
                    float scale) {
  constexpr int E = hop::Vec16<T>::N;  // elements per 16 bytes
  const int hd = HD ? HD : hd_arg;
  const int CH = hd / E;               // 16-byte pieces per row
  const int Q4 = hd / 4;               // 4-column slices per row
  const int KS = WIDE ? 1 : kThreads / Q4;  // key splits of the PV sum
  constexpr int NW = kThreads / 32;
  // a compiled head_dim's column slices divide the threads evenly
  static_assert((HD == 0 || kThreads % (HD / 4) == 0) && E % 4 == 0,
                "layout");
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bars[2];
  __shared__ float warp_m[NW][RT], warp_s[NW][RT];  // per-warp max, sum
  __shared__ float gm[kMaxSplits][RT], gl[kMaxSplits][RT];  // rank 0's

  // Every block of the cluster arrives here and waits just before its
  // first store into rank 0's shared memory (which must have started).
  hop::cluster_arrive_relaxed();
  const int split = hop::cluster_rank();  // == blockIdx.x: a cluster spans x
  const int splits = gridDim.x;
  const int groups = (G + rows - 1) / rows;
  const int kvh = blockIdx.y / groups;
  const int head0 = kvh * G + (blockIdx.y % groups) * rows;
  const int nr = min(rows, (kvh + 1) * G - head0);  // this block's rows
  const int h = gridDim.y / groups * G;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cap = P * page;

  const int s0 = split * split_len;
  // Thread 0 loads the split's first page id beside the length, so the
  // two loads are in flight together (s0 < P * page by the plan).
  const int pid0 = tid == 0 ? tables[(size_t)b * P + s0 / page] : 0;
  int len = lengths[b];
  len = len < 0 ? 0 : (len < cap ? len : cap);
  const int n_tok = max(0, min(s0 + split_len, len) - s0);
  const int nc = (n_tok + chunk - 1) / chunk;  // chunks of this split

  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(
      smem + ring_bytes<T, RT>(hd, chunk, stages));  // [RT][hd]
  float* accs = qs + RT * hd;                        // WIDE: [RT][hd]
  float* sc = accs + (WIDE ? RT * hd : 0);           // [RT][chunk]
  float* gacc = sc + RT * chunk;                     // [splits][RT][hd]
  const size_t stage_elems = (size_t)chunk * hd;     // one chunk of K (or V)
  const size_t head_base = (size_t)kvh * num_pages;

  // Thread 0: move chunk c (positions s0 + c chunk ..., within one page)
  // into its stage.
  auto fetch = [&](int c) {
    const int t0 = s0 + c * chunk;
    const int n = min(chunk, s0 + n_tok - t0);
    const int st = c % stages;
    const uint32_t bar = hop::smem_addr(&bars[st]);
    const uint32_t bytes = n * hd * sizeof(T);
    const int pid = c == 0 ? pid0 : tables[(size_t)b * P + t0 / page];
    const size_t off = ((head_base + pid) * page + t0 % page) * hd;
    const uint32_t dst = hop::smem_addr(ring + st * 2 * stage_elems);
    hop::mbar_expect_tx(bar, 2 * bytes);
    hop::bulk_copy_g2s(dst, k_pages + off, bytes, bar);
    hop::bulk_copy_g2s(dst + stage_elems * sizeof(T), v_pages + off, bytes,
                       bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      hop::mbar_init(hop::smem_addr(&bars[s]), 1);
    hop::mbar_init_fence();
    for (int c = 0; c < nc && c < stages; ++c) fetch(c);
  }
  for (int i = tid; i < RT * hd; i += kThreads) {
    const int r = i / hd;
    qs[i] = r < nr ? rt::to_float(q[((size_t)b * h + head0 + r) * hd +
                                    i % hd])
                   : 0.f;
    if (WIDE) accs[i] = 0.f;
  }
  __syncthreads();

  // Every thread carries the rows' running (max, sum); acc is its PV item:
  // columns dq .. dq + 3 over keys ks, ks + KS, ... of each chunk. Rows
  // past nr (q padded with zeros) are computed and never written out.
  float m[RT], l[RT], acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[r][y] = 0.f;
  }
  const int warp = tid / 32, lane = tid % 32;
  // threads past the last whole key split (hd / 4 not dividing kThreads)
  // take no PV item
  const int dq = tid % Q4 * 4, ks = tid / Q4;
  const bool pv_item = !WIDE && (HD || ks < KS);

  for (int c = 0; c < nc; ++c) {
    const int n = min(chunk, n_tok - c * chunk);
    const int st = c % stages;
    const T* Ks = ring + st * 2 * stage_elems;
    const T* Vs = Ks + stage_elems;
    hop::mbar_wait(hop::smem_addr(&bars[st]), (c / stages) & 1);

    // scores: thread kk sums q . k[kk] along hd for every row
    float s[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) s[r] = 0.f;
    if (tid < n) {
      const T* krow = Ks + tid * hd;
#pragma unroll 4
      for (int p = 0; p < CH; ++p) {
        const int e = ((p + tid) % CH) * E;
        float kf[E];
        hop::Vec16<T>::load(krow + e, kf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int x = 0; x < E; x += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + r * hd + e + x);
            s[r] = fmaf(qv.x, kf[x], s[r]);
            s[r] = fmaf(qv.y, kf[x + 1], s[r]);
            s[r] = fmaf(qv.z, kf[x + 2], s[r]);
            s[r] = fmaf(qv.w, kf[x + 3], s[r]);
          }
        }
      }
    }
    // softmax, one block reduction per chunk: the rows' max over the
    // block, then P = exp(s - max) and the rows' sums
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      s[r] = tid < n ? s[r] * scale : kNeg;
      const float mx = hop::warp_max(s[r]);
      if (lane == 0) warp_m[warp][r] = mx;
    }
    __syncthreads();
    float alpha[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int w = 0; w < NW; ++w) m_new = fmaxf(m_new, warp_m[w][r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      const float p = tid < n ? expf(s[r] - m_new) : 0.f;
      if (tid < n) sc[r * chunk + tid] = p;
      const float ps = hop::warp_sum(p);
      if (lane == 0) warp_s[warp][r] = ps;
    }
    __syncthreads();

    // PV
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += warp_s[w][r];
      l[r] = l[r] * alpha[r] + sum;
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[r][y] *= alpha[r];
    }
    if constexpr (WIDE) {
      // each thread's 4-column slices in turn, all keys, sums in accs
      for (int d = tid * 4; d < hd; d += kThreads * 4) {
        float x[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(accs + r * hd + d);
          x[r][0] = a.x * alpha[r];
          x[r][1] = a.y * alpha[r];
          x[r][2] = a.z * alpha[r];
          x[r][3] = a.w * alpha[r];
        }
        for (int kk = 0; kk < n; ++kk) {
          float vf[4];
          rt::VecLoad<T, 4>::run(Vs + kk * hd + d, vf);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float p = sc[r * chunk + kk];
#pragma unroll
            for (int y = 0; y < 4; ++y) x[r][y] = fmaf(p, vf[y], x[r][y]);
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
          *reinterpret_cast<float4*>(accs + r * hd + d) =
              make_float4(x[r][0], x[r][1], x[r][2], x[r][3]);
      }
    } else {
#pragma unroll 2
      for (int kk = pv_item ? ks : n; kk < n; kk += KS) {
        float vf[4];
        rt::VecLoad<T, 4>::run(Vs + kk * hd + dq, vf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float p = sc[r * chunk + kk];
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[r][y] = fmaf(p, vf[y], acc[r][y]);
        }
      }
    }
    __syncthreads();  // every reader of this stage, of P and of the sums
    if (tid == 0 && c + stages < nc) {
      hop::fence_async_smem();
      fetch(c + stages);
    }
  }

  // The key splits' partials through the (now idle) ring, summed in a
  // fixed order and stored, with the rows' (max, sum), into slot `split`
  // of rank 0's shared memory (WIDE: the one split's sums, in accs).
  float* red = WIDE ? accs : reinterpret_cast<float*>(smem);  // [KS][RT][hd]
  if (pv_item) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      *reinterpret_cast<float4*>(red + (ks * RT + r) * hd + dq) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  hop::cluster_wait();  // rank 0 has started
  for (int i = tid; i < RT * hd; i += kThreads) {
    float x = 0.f;
    for (int j = 0; j < KS; ++j) x += red[j * RT * hd + i];
    hop::st_cluster(hop::map_rank(&gacc[split * RT * hd + i], 0), x);
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      hop::st_cluster(hop::map_rank(&gm[split][r], 0), m[r]);
      hop::st_cluster(hop::map_rank(&gl[split][r], 0), l[r]);
    }
  }
  hop::cluster_sync();  // every split's partials are in rank 0
  if (split != 0) return;  // nothing reads this block's shared memory

  // Rank 0 merges the splits in rank order.
  for (int i = tid; i < nr * hd; i += kThreads) {
    const int r = i / hd;
    float mx = kNeg;
    for (int j = 0; j < splits; ++j) mx = fmaxf(mx, gm[j][r]);
    float lsum = 0.f, x = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float f = expf(gm[j][r] - mx);
      lsum += gl[j][r] * f;
      x += gacc[j * RT * hd + i] * f;
    }
    out[((size_t)b * h + head0) * hd + i] =
        rt::from_float<T>(lsum > 0.f ? x / lsum : 0.f);
  }
}

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

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* tables;
  void* out;
  int B, hkv, G, rows, hd, num_pages, page, P, split_len, splits, chunk,
      stages;
  float scale;
};

template <typename T, int HD, int RT, bool WIDE>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes =
      smem_bytes<T, RT>(a.hd, a.chunk, a.stages, a.splits, WIDE);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;
  auto kernel = paged_decode_kernel<T, HD, RT, WIDE>;
  if (int e = allow_smem(kernel, (int)bytes, &allowed)) return e;
  const int groups = (a.G + a.rows - 1) / a.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.hkv * groups, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_pages), static_cast<const T*>(a.v_pages),
      a.lengths, a.tables, static_cast<T*>(a.out), a.G, a.rows, a.hd,
      a.num_pages, a.page, a.P, a.split_len, a.chunk, a.stages, a.scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, bool WIDE = false>
int dispatch_rows(const Args& a, cudaStream_t s) {
  if (a.rows <= 1) return launch<T, HD, 1, WIDE>(a, s);
  if (a.rows <= 2) return launch<T, HD, 2, WIDE>(a, s);
  if (a.rows <= 4) return launch<T, HD, 4, WIDE>(a, s);
  return launch<T, HD, 8, WIDE>(a, s);
}

template <typename T>
int dispatch_hd(const Args& a, cudaStream_t s) {
  if (a.hd == 64) return dispatch_rows<T, 64>(a, s);
  if (a.hd == 128) return dispatch_rows<T, 128>(a, s);
  if (a.hd > kWideHd) return dispatch_rows<T, 0, true>(a, s);
  return dispatch_rows<T, 0>(a, s);
}

}  // namespace

// q [B, hkv*G, hd]; k_pages/v_pages [hkv, num_pages, page, hd] (16-byte
// aligned: the bulk copies; else cudaErrorMisalignedAddress); lengths [B]
// int32; tables [B, P] int32; out [B, hkv*G, hd]; hd a multiple of 8.
// The plan (decode_plan in paged_attention.py): `rows`
// (1-8) query heads a block, `splits` (1-8) blocks a cluster, each over
// `split_len` positions in chunks of `chunk` tokens (a chunk never
// crosses a page: page % chunk == 0) through `stages` (1-2) stages.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int rt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const int* lengths,
                               const int* tables, void* out, int B, int hkv,
                               int G, int hd, int num_pages, int page, int P,
                               int rows, int split_len, int splits,
                               int chunk, int stages, float scale, int dtype,
                               void* stream) {
  if (B < 1 || hkv < 1 || G < 1 || P < 1 || rows < 1 || rows > 8 ||
      hd < 8 || hd % 8 ||
      splits < 1 || splits > kMaxSplits ||
      (splits - 1) * split_len >= P * page || splits * split_len < P * page ||
      chunk < 1 || chunk > kMaxChunk ||
      page % chunk || split_len % chunk || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the bulk copies take 16-byte-aligned sources (a page's rows are
  // multiples of 16 bytes from its pool's start)
  if ((reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q,    k_pages, v_pages,   lengths, tables, out,   B,
               hkv,  G,       rows,      hd,      num_pages, page, P,
               split_len,     splits,    chunk,   stages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(a, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
