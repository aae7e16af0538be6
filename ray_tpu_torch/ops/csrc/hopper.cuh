// Hopper (sm_90a) building blocks for the hand-written kernel bodies:
// asynchronous tile copies into 128-byte-swizzled shared memory, bulk
// copies completing on mbarriers, thread-block clusters (rank, barrier,
// distributed shared memory), 16-byte row reads from shared memory and
// warp reductions, the wgmma shared-memory descriptor, the
// wgmma fence / commit / wait, the bf16 m64nNk16 wgmma with fp32
// accumulators (A from shared memory or from registers), and the
// accumulator's register layout.
//
// Tile layout. A [rows][D] bf16 tile sits in shared memory as D / 64
// column blocks of [rows][64], one after the other (one block for D = 64,
// two for D = 128). A 64-element row is 128 bytes; in each group of 8
// rows (a 1024-byte swizzle atom) the 16-byte chunk c of row r is stored
// at chunk c ^ (r % 8). This is the layout wgmma reads in its 128-byte
// swizzle mode, both as a K-major operand (rows = M or N, columns = K)
// and as an MN-major one (rows = K, columns = N), so one copy of a tile
// serves both roles. Every tile starts on a 1024-byte boundary.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies: cp.async, zero-filled when !ok ----

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all of this thread's copy groups.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes (cp.async's included) visible
// to the async proxy wgmma reads through. A barrier follows, so that every
// thread's writes are.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- bulk copies (the TMA's untiled form) under mbarriers ----
//
// One thread arms a barrier with the bytes it expects (mbar_expect_tx,
// which is also that barrier's one arrival of the phase) and starts
// bulk_copy_g2s copies that count those bytes down as they land; every
// thread waits for the phase to complete with mbar_wait. Sizes and both
// addresses must be multiples of 16 bytes.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// Make mbar_init visible to the async proxy; a block barrier follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity (0, 1, 0, ...) is
// complete. A phase that has not completed after ~2^32 clocks (a copy that
// never lands) traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// Copy `bytes` contiguous bytes from global `src` to shared `dst`; the
// landing bytes complete on barrier `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- thread-block clusters ----
//
// A kernel launched with a cluster dimension (cudaLaunchKernelEx with
// cudaLaunchAttributeClusterDimension) runs its blocks in clusters that
// are scheduled together and can read and write each other's shared memory
// (distributed shared memory). cluster_sync is a barrier over every
// thread of every block of the cluster (release on arrive, acquire on
// wait): shared-memory writes before it, a peer's stores included, are
// visible to reads after it. Every thread of every block takes part in
// each barrier. A block's shared memory may be accessed by a peer only
// after a barrier that block has arrived at (it has started) and only
// until it exits: a block whose shared memory peers read or write must
// not exit before a barrier that follows their last access.

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The two halves of a cluster barrier: an arrive that orders no memory
// (to mark that this block has started) and the wait that completes it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of `p` (a variable in this block's shared memory) in the
// shared memory of the cluster's block of rank `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// A float to distributed shared memory (an address from map_rank).
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// ---- rows in shared memory and warp reductions (the paged kernels) ----

// 16 bytes of T from shared memory, as floats.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Byte offset of 16-byte chunk c (0-7) of row r in a swizzled column block.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Copy rows [r0, r0 + ROWS) of a [S, stride] bf16 tensor, D columns from
// `src`, into the swizzled tile at `dst` with NT threads; rows at or
// beyond S are zero.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % NT == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = it * NT + threadIdx.x;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* p = src + (size_t)(ok ? r0 + r : 0) * stride + c * 8;
    cp_async16(dst + (c / 8) * (ROWS * 128) + swz(r, c % 8), p, ok);
  }
}

// ---- wgmma operands ----

// Shared-memory matrix descriptor in the 128-byte swizzle mode: start
// address, leading byte offset (between swizzle atoms along N of an
// MN-major operand: its next 64 columns; unused for K-major) and stride
// byte offset (between groups of 8 rows: 1024 in this layout), each in
// 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// A [ROWS][D] tile read K-major (rows = M or N): k-step kk takes columns
// 16 kk .. 16 kk + 15, 32 bytes into a row of column block kk / 4.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16);
}

// A [ROWS][N] tile read MN-major (rows = K): k-step kk takes rows
// 16 kk .. 16 kk + 15; N > 64 reaches the next column block.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, ROWS * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for all of this warpgroup's committed wgmma groups.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin an accumulator after a wait: no read of it moves above this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the accumulator's register layout ----
//
// An m64nN fp32 accumulator takes N / 2 registers a thread. Register i of
// thread t (0-127) of the warpgroup holds
//   row    16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
//   column 8 (i / 4) + 2 (t % 4) + i % 2.
// A thread holds two rows; the four threads of a quad (equal t / 4) hold
// one row between them, so a row reduction is two xor-shuffles (1, 2).
// wgmma's register A operand (m64k16, four bf16 pairs) has the same
// layout, so the accumulator columns 16 kk .. 16 kk + 15 are the A
// operand of k-step kk of a product that sums over those columns.

__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the SFU's approximation (ex2.approx.ftz: relative error ~2^-22,
// 0 for very negative x), without exp2f's subnormal handling.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Register A operand of k-step kk from accumulator-shaped fp32 values,
// rounded to bf16.
template <int R>
__device__ __forceinline__ void to_a(const float (&x)[R], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h =
        __floats2bfloat162_rn(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
    a[j] = *reinterpret_cast<uint32_t*>(&h);
  }
}

// ---- wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators ----
//
// Mma<N>::ss: d (+)= A B with A [64 x 16] and B [16 x N] both K-major in
// shared memory. Mma<N>::rs: A from registers (to_a), B MN-major in
// shared memory (the transpose bit set). `acc` = 0 overwrites d. Only
// the shapes the kernels use are written out: ss at N = 32 and 64 (score
// products), rs at N = 64 and 128 (products into O, dK and dV).

template <int N>
struct Mma;

template <>
struct Mma<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

}  // namespace hop
