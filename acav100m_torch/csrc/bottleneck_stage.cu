// One ResNet bottleneck block with BN folded, on folded frames (NHWC), in
// float32: the float32 form of kernel K2, written for Hopper (sm_90a).
//
// Replaces the TPU kernel acav100m_tpu/ops/pallas/bottleneck_kernel.py:
// fused_stage (body _make_kernel, _conv3x3). A kt=1 bottleneck stage is a
// chain of these blocks; the wrapper launches this kernel once per block.
// Each block computes, per frame:
//   a = relu(x . aw + ab)                       1x1, Cin -> Ci
//   b = relu(conv3x3_same(a, stride s) + bb)    3x3, Ci -> Ci
//   y = relu(b . cw + cb + shortcut)            1x1, Ci -> Cout
//   shortcut = x[::s, ::s] . pw + pb  (projection)  or  x  (identity)
//
// Design. Persistent CTAs, one an SM, each walking over output tiles of
// TH x TW pixels (16 x 16 at stride 1, 8 x 8 at stride 2) of one frame, all
// Cout channels. Three warpgroups:
//   * a producer (one elected thread) that keeps a ring of NS stages of 32
//     KB full, in the order the consumers use them, each completed on an
//     mbarrier (full) and handed back on another (empty): no per-step
//     __syncthreads. A tile takes, in order,
//       - product a: per chunk of 16 input channels, the tile's input
//         region (its pixels plus a 1-pixel halo) by TMA, zeros outside the
//         frame and past Cin, and the chunk's rows of aw;
//       - product b: one tap of bw a stage;
//       - product c, a pass of 128 output columns a warpgroup at a time:
//         cw in chunks of KC rows, then the projection's x (the region
//         again, 8 channels a stage) with its rows of pw where the block
//         has one, then four stages for the epilogue's 32-column slices,
//         which hold the identity shortcut (x at the tile's pixels, by
//         TMA) where the block has no projection.
//     Weights come as the host packed them (pack_block_f32) by bulk copies.
//   * two consumer warpgroups that run the three products on wgmma
//     (m64nNk8 TF32, f32 sums; A from registers, B from the ring by
//     descriptor), every sum starting from its bias:
//       1. a on the region's rows (the region padded to whole m64 tiles),
//          the m64 tiles shared between the warpgroups; zero outside the
//          frame, which is the 3x3's 'same' padding;
//       2. b on the tile as an implicit GEMM over the 9 taps of bw: tap
//          (dy, dx) reads a at each pixel's region row shifted by the tap;
//       3. y = b . cw (+ x[::s, ::s] . pw) + cb (+ pb | x), then ReLU,
//          written 32 columns at a time into an epilogue stage and stored
//          from there by TMA, each warpgroup's leader its own 8 tile rows,
//          so that the stores drain while the next products run.
//     At stride 1 the warpgroups split b and c by the tile's m64 row tiles
//     (two each), at stride 2 (one row tile) by columns. a and b live in
//     shared memory in fp32 (b over a); four named barriers of the two
//     consumer warpgroups a tile order them.
//
// 3xTF32. Each fp32 operand v is split into big = tf32(v) and small =
// tf32(v - big), rounded as cvt.rna rounds (to nearest, ties away from
// zero; see tf32_rna), and each product A.B is issued as three wgmma
// products, small.big, big.small and then big.big, into one fp32
// accumulator: the small terms first, so their rounding stays below the
// large term. The dropped small.small term is about 2^-22 of the product.
// A (the activations) is split in registers as it is loaded; B (the
// weights) never changes, so the host splits it once and the ring carries
// both parts. ACCUMULATION: the tensor cores round their fp32 sums toward
// zero, so each wgmma into a large accumulator drops up to an ulp of it,
// always the same way; each tap of product b sums into its own accumulator
// (scale-d 0 on its first wgmma), added to the total with an fp32 add.
// PIPELINE. Within a stage a k8 step's A fragments go to one of two
// register sets, the step two back waited for first (wgmma.wait_group 1),
// so a step's loads and splits overlap the step before it; a stage is
// handed back once its last step is done. (Running the steps of
// consecutive stages back to back keeps two stages' fragments live, more
// than the 168 registers a thread that three warpgroups leave ptxas: it
// then serializes every wgmma, and the kernel took 0.7555 ms.)
//
// Layouts. The weights (B) and a and b are K-major without swizzle, in
// planes of 4 channels: element (row r, channel k) at (k / 4) * plane +
// r * 16 + (k % 4) * 4 bytes, so a wgmma core matrix (8 rows x 16 bytes) is
// 8 consecutive rows of a plane, and a lane's A fragment loads (rows g and
// g + 8, channels t and t + 4; wgmma's register layout of A is
// mma.m16n8k8's) fall on 32 different banks. Weights are packed in this
// order with their output channels as rows, big then small, cw and pw in
// passes of 128 columns. x lands in the ring in pixel rows of 16 channels
// (product a) or 8 (the projection) with TMA's 64- or 32-byte swizzle, the
// identity and the outputs in rows of 32 channels with its 128-byte
// swizzle: a TMA box row is then whole 32-byte sectors (boxes of 4
// channels, 16 bytes a row, took 0.7654 ms against 0.6602), and the
// swizzle keeps the fragment loads and the epilogue's accesses on
// different banks. The region is stored row by row with a pitch of AWS
// pixels; at stride 2 each region row is split into its even and odd
// columns, so the pixels a tap reads for consecutive output pixels of a
// tile row are consecutive region rows.
//
// Bytes a tile. The block's weights do not fit beside the ring: at Cin 256,
// aw, bw and cw are 272 KB in fp32, 544 KB as big and small parts, against
// the 227 KB a CTA may use. So they stream through the ring with the
// activations, and a larger tile reads them fewer times. At 16 x 16 pixels
// a tile at Cin 256 takes 324 x 1 KB of x region (1.27x its pixels), 544 KB
// of weights (2.1 KB a pixel; a 16 x 8 tile would take 4.3 KB a pixel) and
// 256 KB of identity shortcut into shared memory, about 1.15 MB, and writes
// 256 KB: 0.59 GB a block through the L2 at the main path's 512 tiles.
// Shared memory at stride 1: a (324 rows x 64 channels) 83 KB, four stages
// of 32 KB.
//
// Bound on an H100 SXM at the main path's shape (SlowFast s2_slow at 256^2
// input: 32 frames of 64x64, Cin 80 -> 256, inner 64, 3 blocks): 57.15
// GFLOP, issued three times in 3xTF32, is 0.347 ms at the 495 TFLOP/s of
// dense TF32; one launch a block moves about 0.71 GB through device memory
// (x, three block outputs written, two read back), 0.21 ms at 3.35 TB/s.
// So it is bound by operations. This design issues 186.4 GFLOP of TF32
// products (the halo, and product a padded to whole m64 tiles of the
// region, 1.5x its pixels), 0.377 ms at the 494 TFLOP/s that wgmma TF32
// reaches alone on an H100 80GB HBM3 at 700 W (ablate_k2.py); the kernel
// takes 0.646 ms there. Its stages each drain their wgmma (PIPELINE), and
// x, the weights and the stores compete for the L2 (ablate_k2.py: the
// products alone 0.56 ms, the ring and epilogues alone 0.39).
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NCONS 256          // consumer threads: two warpgroups
#define NT 384             // and one producer warpgroup
#define PASS 128           // output columns of product c a warpgroup accumulates
#define STAGE 32768        // bytes a stage of the ring
#define MAXNS 8            // stages at most
#define KA 16              // input channels a stage of product a
#define KP 8               // input channels a stage of the projection

extern __shared__ __align__(128) unsigned char smem[];

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// contiguous bytes global -> shared, completed on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// a box of a tensor shared -> global, as one bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(map), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wait until the shared memory of all but this thread's last N bulk stores
// has been read
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// wait until this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory stores made visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups' barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
}

// one consumer warpgroup's own barrier (2 and 3)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmma are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// matrix descriptor of a K-major, unswizzled operand whose 8-row core
// matrices start at shared address addr: lbo bytes from one 4-channel
// plane to the next (along K), sbo bytes from 8 rows to the next 8
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x N, f32) += A (64 x 8, TF32, from registers) . B (8 x N, TF32, from
// shared memory by descriptor); scale_d 0 replaces D by the product
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (N == 16) wgmma_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, a, db, scale_d);
  else wgmma_n128(d, a, db, scale_d);
}

// ---- 3xTF32 -----------------------------------------------------------------

// cvt.rna.tf32.f32 for any finite v, in two integer instructions: add half
// a TF32 ulp to the magnitude bits and clear the 13 bits TF32 drops. (The
// cvt itself compiles to a longer sequence that also sorts out NaN and Inf.)
// pack_block_f32 splits the weights on the host in the same way.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// A's fragment of one k8 step, split: rows r0 (the lane's g) and r1 (g + 8),
// channels t and t + 4 of the step, read as at(row, 0) and at(row, 1)
template <class At>
__device__ __forceinline__ void load_split(At at, int r0, int r1, uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split(at(r0, 0), big[0], small[0]);
  split(at(r1, 0), big[1], small[1]);
  split(at(r0, 1), big[2], small[2]);
  split(at(r1, 1), big[3], small[3]);
}

// a and b: channel (4 * plane + t) of row r, planes pl bytes apart from p
struct Planes {
  const unsigned char* p;
  int pl, t;
  __device__ __forceinline__ float operator()(int r, int h) const {
    return reinterpret_cast<const float*>(p + h * pl)[4 * r + t];
  }
};

// Word t of 16-byte chunk c of row r, in rows of ROWB bytes that TMA wrote
// with its ROWB-byte swizzle (chunk c of a row lands at c ^ (the row's
// 128-byte line mod 128 / ROWB lines)), from a base aligned to 1024 bytes
template <int ROWB, class T>
__device__ __forceinline__ T* swz(T* p, int r, int c) {
  constexpr int SH = ROWB == 128 ? 0 : ROWB == 64 ? 1 : 2;
  return p + r * ROWB + ((c ^ ((r >> SH) & (ROWB / 16 - 1))) << 4);
}

// x in the ring: channel (4 * (c + h) + t) of row r
template <int ROWB>
struct Swizzled {
  const unsigned char* p;
  int c, t;
  __device__ __forceinline__ float operator()(int r, int h) const {
    return reinterpret_cast<const float*>(swz<ROWB>(p, r, c + h))[t];
  }
};

// One k8 step of D (R m64 tiles x N columns) += A . B in 3xTF32: A's
// parts in registers, B's (big, small) in shared memory by descriptor;
// small.big, then big.small, then big.big. scale 0 starts D from the first
// product. Committed as one group. No wgmma sits under a branch: ptxas
// serializes the ones it finds there.
template <int N, int R>
__device__ __forceinline__ void mma3(float (&d)[R][N / 2], const uint32_t (&ab)[R][4],
                                     const uint32_t (&as)[R][4], uint64_t db_big,
                                     uint64_t db_small, int scale) {
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < R; ++m) wgmma<N>(d[m], as[m], db_big, scale);
#pragma unroll
  for (int m = 0; m < R; ++m) wgmma<N>(d[m], ab[m], db_small, 1);
#pragma unroll
  for (int m = 0; m < R; ++m) wgmma<N>(d[m], ab[m], db_big, 1);
  wgmma_commit();
}

// every row of R m64 tiles x N columns from the bias b (wgmma's layout:
// d[4k + 2h + e] is column 8k + 2t + e)
template <int N, int R>
__device__ __forceinline__ void from_bias(float (&d)[R][N / 2], const float* b, int t) {
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(b + 8 * k + 2 * t));
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        d[m][4 * k + 2 * h] = v.x;
        d[m][4 * k + 2 * h + 1] = v.y;
      }
  }
}

// ---- the kernel -------------------------------------------------------------

// Tile geometry at stride S: TH x TW output pixels, their input region of
// AH rows x AWS stored pixels (at stride 2 a row is its AWP even columns,
// then its AWP odd ones), NA region pixels padded to NAM (an even number of
// m64 tiles, as many for each consumer warpgroup).
template <int S>
struct Geom {
  static constexpr int TH = S == 1 ? 16 : 8, TW = TH, NQ = TH * TW, MQ = NQ / 64;
  static constexpr int AH = S * (TH - 1) + 3, AWP = S == 1 ? TW + 2 : TW + 1;
  static constexpr int AWS = S * AWP, NA = AH * AWS, NAM = (NA + 127) / 128 * 128, MA = NAM / 64;
};

struct Params {
  const float* x;
  int N, H, W, Cin, Kp;                // Kp: Cin rounded up to KA
  const float* aw; const float* ab;    // packed (2, Kp/4, Ci, 4): big, then small
  const float* bw; const float* bb;    // packed (2, 9, Ci/4, Ci, 4)
  const float* cw; const float* cb;    // packed (2, P, Ci/4, 128, 4); cb (P * 128), + pb
  const float* pw;                     // packed (2, P, Kp/4, 128, 4), or null
  int Cout, P;                         // P passes of 128 output columns
  float* out;
  int Ho, Wo, tiles_x, tiles_y, tiles;
  int NS;                              // stages of the ring
  uint32_t off_ring;                   // the ring's offset in shared memory
};

template <int S, int CI>
__global__ void __launch_bounds__(NT, 1) bottleneck_block_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap pmap,
    const __grid_constant__ CUtensorMap imap, const __grid_constant__ CUtensorMap omap,
    const Params p) {
  using G = Geom<S>;
  // products b and c: at stride 1 the two warpgroups split the tile's m64
  // row tiles; at stride 2 (one row tile) they split the columns
  constexpr bool SPLIT_M = G::MQ >= 2;
  constexpr int RA = G::MA / 2;                  // a's m64 tiles a warpgroup
  constexpr int RB = SPLIT_M ? G::MQ / 2 : 1;    // b's and c's m64 tiles a warpgroup
  constexpr int NB = SPLIT_M ? CI : CI / 2;      // b's columns a warpgroup
  constexpr int KC = SPLIT_M ? 32 : 16;          // rows of cw a stage
  constexpr int PPS = SPLIT_M ? 1 : 2;           // passes of 128 columns a stage of c
  constexpr int PLA = G::NA * 16, PLB = G::NQ * 16;  // a's and b's plane strides
  // x in the ring: the region in rows of KA channels (64 bytes) for product
  // a, of KP (32 bytes) for the projection; the weights after its NAM rows
  constexpr int XA = G::NAM * KA * 4, XP = G::NAM * KP * 4;
  // bytes of one part (big or small) of a stage's weights
  constexpr uint32_t AWB = KA * CI * 4, BWB = CI * CI * 4, CWB = KC * PASS * 4,
                     PWB = KP * PASS * 4;
  static_assert(XA + 2 * AWB <= STAGE && 2 * BWB <= STAGE && PPS * 2 * CWB <= STAGE &&
                XP + PPS * 2 * PWB <= STAGE && PPS * G::NQ * 128 <= STAGE, "a stage holds 32 KB");
  static_assert(G::MQ == 1 || G::MQ == 4, "one or four m64 row tiles");
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t base = saddr(smem);
  const uint32_t full0 = base, empty0 = base + 8 * MAXNS;  // mbarriers
  const int tiles_frame = p.tiles_y * p.tiles_x;
  const int np = SPLIT_M ? p.P : (p.P + 1) / 2;  // passes of product c
  if (tid == 0) {
    for (int s = 0; s < p.NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread --------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != NCONS) return;
    int st = 0;
    uint32_t ph = 0;
    // the next stage once the consumers have handed it back, expecting
    // bytes on its full barrier bar
    auto open = [&](uint32_t bytes, uint32_t& bar) -> uint32_t {
      mbar_wait(empty0 + 8 * st, ph ^ 1);
      bar = full0 + 8 * st;
      mbar_expect_tx(bar, bytes);
      return base + p.off_ring + st * STAGE;
    };
    auto next = [&]() {
      if (++st == p.NS) { st = 0; ph ^= 1; }
    };
    // the region at output origin (oy0, ox0) of frame, from channel c, in
    // boxes of map (xmap: KA channels, pmap: KP)
    auto region = [&](uint32_t dst, const CUtensorMap* map, int c, int frame, int oy0, int ox0,
                      uint32_t bar) {
      if constexpr (S == 1)
        tma_4d(dst, map, c, ox0 - 1, oy0 - 1, frame, bar);
      else
        tma_5d(dst, map, c, ox0 - 1, 0, 2 * oy0 - 1, frame, bar);
    };
    // bytes from float offset off of a packed weight's big part and of its
    // small part (part floats later), to dst and dst + bytes
    auto weights = [&](uint32_t dst, const float* w, size_t part, size_t off, uint32_t bytes,
                       uint32_t bar) {
      bulk_copy(dst, w + off, bytes, bar);
      bulk_copy(dst + bytes, w + part + off, bytes, bar);
    };
    const size_t aw_part = (size_t)p.Kp * CI, bw_part = (size_t)9 * CI * CI;
    const size_t cw_part = (size_t)p.P * CI * PASS, pw_part = (size_t)p.P * p.Kp * PASS;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int frame = t / tiles_frame, r = t % tiles_frame;
      const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;
      uint32_t bar;
      for (int k0 = 0; k0 < p.Kp; k0 += KA) {  // product a
        const uint32_t dst = open(G::NA * KA * 4 + 2 * AWB, bar);
        region(dst, &xmap, k0, frame, oy0, ox0, bar);
        weights(dst + XA, p.aw, aw_part, (size_t)k0 * CI, AWB, bar);
        next();
      }
      for (int tap = 0; tap < 9; ++tap) {  // product b
        const uint32_t dst = open(2 * BWB, bar);
        weights(dst, p.bw, bw_part, (size_t)tap * CI * CI, BWB, bar);
        next();
      }
      for (int q = 0; q < np; ++q) {  // product c
        const int pps = min(PPS, p.P - q * PPS);
        for (int k0 = 0; k0 < CI; k0 += KC) {
          const uint32_t dst = open(pps * 2 * CWB, bar);
          for (int j = 0; j < pps; ++j)
            weights(dst + j * 2 * CWB, p.cw, cw_part,
                    (size_t)(q * PPS + j) * CI * PASS + (size_t)k0 * PASS, CWB, bar);
          next();
        }
        if (p.pw != nullptr) {
          for (int k0 = 0; k0 < p.Kp; k0 += KP) {
            const uint32_t dst = open(G::NA * KP * 4 + pps * 2 * PWB, bar);
            region(dst, &pmap, k0, frame, oy0, ox0, bar);
            for (int j = 0; j < pps; ++j)
              weights(dst + XP + j * 2 * PWB, p.pw, pw_part,
                      (size_t)(q * PPS + j) * p.Kp * PASS + (size_t)k0 * PASS, PWB, bar);
            next();
          }
        }
        for (int i = 0; i < 4; ++i) {  // the epilogue, 32 columns a stage
          if (p.pw == nullptr) {  // with the identity in it
            const uint32_t dst = open(G::NQ * 128, bar);
            tma_4d(dst, &imap, q * PASS + 32 * i, ox0, oy0, frame, bar);
          } else {
            open(0, bar);
          }
          next();
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int r16 = warp * 16 + g;  // this thread's first row of an m64 tile
  unsigned char* const abuf = smem + 128;  // a, and b over it
  const int ma0 = wg * RA;                              // a's m64 tiles
  const int mb0 = SPLIT_M ? wg * RB : 0;                // b's and c's
  const int nb0 = SPLIT_M ? 0 : wg * NB, wsub = SPLIT_M ? 0 : wg;
  const bool leader = tid % 128 == 0;  // stores its warpgroup's outputs by TMA
  int st = 0;
  uint32_t ph = 0;
  // the next stage, once full: its offset in shared memory
  auto acquire = [&]() -> uint32_t {
    mbar_wait(full0 + 8 * st, ph);
    return p.off_ring + st * STAGE;
  };
  // done reading the stage acquired last: returns it, to be handed back
  // by arrive() once nothing reads it any more (its wgmma, its TMA store)
  auto advance = [&]() -> int {
    const int s = st;
    if (++st == p.NS) { st = 0; ph ^= 1; }
    return s;
  };
  auto arrive = [&](int s) { mbar_arrive(empty0 + 8 * s); };
  auto release = [&]() { arrive(advance()); };
  // each b/c fragment row's pixel in the tile, and its region row at tap
  // (0, 0) and under the projection
  int qrow[RB][2], brow[RB][2], prow[RB][2];
#pragma unroll
  for (int m = 0; m < RB; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (mb0 + m) * 64 + r16 + 8 * h;
      qrow[m][h] = q;
      brow[m][h] = S * (q / G::TW) * G::AWS + q % G::TW;
      prow[m][h] = (S * (q / G::TW) + 1) * G::AWS + q % G::TW + 1;
    }

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int frame = t / tiles_frame, r = t % tiles_frame;
    const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;

    // 1. a = relu(x . aw + ab) on the region's rows, this warpgroup's m64
    // tiles of them. Every product's sums start from its bias.
    float acc_a[RA][CI / 2];
    from_bias<CI, RA>(acc_a, p.ab, t4);
    for (int k0 = 0; k0 < p.Kp; k0 += KA) {
      const uint32_t off = acquire();
      uint32_t fb[KA / 8][RA][4], fs[KA / 8][RA][4];
#pragma unroll
      for (int ks = 0; ks < KA / 8; ++ks) {
#pragma unroll
        for (int m = 0; m < RA; ++m) {
          const int row = (ma0 + m) * 64 + r16;
          load_split(Swizzled<KA * 4>{smem + off, 2 * ks, t4}, row, row + 8, fb[ks][m],
                     fs[ks][m]);
        }
        const uint32_t w = base + off + XA + 2 * ks * CI * 16;
        mma3<CI, RA>(acc_a, fb[ks], fs[ks], make_desc(w, CI * 16, 128),
                     make_desc(w + AWB, CI * 16, 128), 1);
      }
      wgmma_wait<0>();
      release();
    }
    consumers_sync();  // the last tile's product c is done with b, which lies over a
#pragma unroll
    for (int m = 0; m < RA; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = (ma0 + m) * 64 + r16 + 8 * h;
        if (pix >= G::NA) continue;
        const int rr = pix / G::AWS, jj = pix % G::AWS;
        const int cc = S == 1 ? jj : 2 * (jj % G::AWP) + jj / G::AWP;
        const int yy = S * oy0 - 1 + rr, xx = S == 1 ? ox0 - 1 + cc : 2 * ox0 - 2 + cc;
        const bool inside = yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
#pragma unroll
        for (int k = 0; k < CI / 8; ++k) {
          const int n = 8 * k + 2 * t4;
          float2 v = make_float2(0.f, 0.f);
          if (inside) {
            v.x = fmaxf(acc_a[m][4 * k + 2 * h], 0.f);
            v.y = fmaxf(acc_a[m][4 * k + 2 * h + 1], 0.f);
          }
          *reinterpret_cast<float2*>(abuf + (n / 4) * PLA + pix * 16 + (n % 4) * 4) = v;
        }
      }
    consumers_sync();  // a is whole

    // 2. b = relu(conv3x3(a, stride S) + bb) on the tile, an implicit GEMM
    // over the 9 taps: tap (dy, dx) reads a at each pixel's region row
    // shifted by the tap. Each tap sums into part (see ACCUMULATION).
    float acc_b[RB][NB / 2], part[RB][NB / 2];
    from_bias<NB, RB>(acc_b, p.bb + nb0, t4);
#pragma unroll
    for (int m = 0; m < RB; ++m)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) part[m][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t off = acquire();
      const int dy = tap / 3, dx = tap % 3;
      const int shift = dy * G::AWS + (S == 1 ? dx : ((dx + 1) & 1) * G::AWP + (dx + 1) / 2);
      uint32_t fb[2][RB][4], fs[2][RB][4];
#pragma unroll
      for (int ks = 0; ks < CI / 8; ++ks) {
        if (ks >= 2) wgmma_wait<1>();  // step ks - 2 is done with fb, fs[ks & 1]
#pragma unroll
        for (int m = 0; m < RB; ++m)
          load_split(Planes{abuf + 2 * ks * PLA, PLA, t4}, brow[m][0] + shift,
                     brow[m][1] + shift, fb[ks & 1][m], fs[ks & 1][m]);
        const uint32_t w = base + off + 2 * ks * CI * 16 + nb0 * 16;
        mma3<NB, RB>(part, fb[ks & 1], fs[ks & 1], make_desc(w, CI * 16, 128),
                     make_desc(w + BWB, CI * 16, 128), ks > 0);
      }
      wgmma_wait<0>();
      release();
#pragma unroll
      for (int m = 0; m < RB; ++m)
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) acc_b[m][i] += part[m][i];
    }
    consumers_sync();  // every warpgroup is done with a
#pragma unroll
    for (int m = 0; m < RB; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qrow[m][h];
#pragma unroll
        for (int k = 0; k < NB / 8; ++k) {
          const int n = nb0 + 8 * k + 2 * t4;
          *reinterpret_cast<float2*>(abuf + (n / 4) * PLB + q * 16 + (n % 4) * 4) =
              make_float2(fmaxf(acc_b[m][4 * k + 2 * h], 0.f),
                          fmaxf(acc_b[m][4 * k + 2 * h + 1], 0.f));
        }
      }
    consumers_sync();  // b is whole

    // 3. y = relu(b . cw (+ x[::s, ::s] . pw) + cb (+ pb | x)), a pass of
    // 128 columns a warpgroup at a time (pb is folded into cb by the wrapper).
    // At stride 2 with an odd number of passes the second warpgroup's last
    // pass has no columns: it computes on what its half of the stage holds
    // and stores nothing.
    for (int q = 0; q < np; ++q) {
      const int pp = q * PPS + wsub;  // this warpgroup's pass of 128 columns
      const bool live = pp < p.P;
      float acc_c[RB][PASS / 2];
      from_bias<PASS, RB>(acc_c, p.cb + (live ? pp : 0) * PASS, t4);
      for (int k0 = 0; k0 < CI; k0 += KC) {
        const uint32_t off = acquire();
        uint32_t fb[2][RB][4], fs[2][RB][4];
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          if (ks >= 2) wgmma_wait<1>();
#pragma unroll
          for (int m = 0; m < RB; ++m)
            load_split(Planes{abuf + ((k0 + 8 * ks) / 4) * PLB, PLB, t4}, qrow[m][0],
                       qrow[m][1], fb[ks & 1][m], fs[ks & 1][m]);
          const uint32_t w = base + off + wsub * 2 * CWB + 2 * ks * PASS * 16;
          mma3<PASS, RB>(acc_c, fb[ks & 1], fs[ks & 1], make_desc(w, PASS * 16, 128),
                         make_desc(w + CWB, PASS * 16, 128), 1);
        }
        wgmma_wait<0>();
        release();
      }
      if (p.pw != nullptr) {
        for (int k0 = 0; k0 < p.Kp; k0 += KP) {
          const uint32_t off = acquire();
          uint32_t fb[RB][4], fs[RB][4];
#pragma unroll
          for (int m = 0; m < RB; ++m)
            load_split(Swizzled<KP * 4>{smem + off, 0, t4}, prow[m][0], prow[m][1], fb[m],
                       fs[m]);
          const uint32_t w = base + off + XP + wsub * 2 * PWB;
          mma3<PASS, RB>(acc_c, fb, fs, make_desc(w, PASS * 16, 128),
                         make_desc(w + PWB, PASS * 16, 128), 1);
          wgmma_wait<0>();
          release();
        }
      }
      // the epilogue, 32 columns a stage: relu(acc (+ the identity the stage
      // holds)) into the stage, in rows of 128 bytes as TMA's 128-byte
      // swizzle lays them, this warpgroup's 64 RB pixels as a box of 8 tile
      // rows; then the warpgroup's leader stores the box by TMA, which clips
      // what lies past the frame or past Cout. The stores drain while the
      // next products run; the leader hands a stage back once TMA has read
      // it, at the latest at the pass's end.
      int held = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t box = acquire() + wg * RB * 64 * 128;
        unsigned char* ep = smem + box;
#pragma unroll
        for (int m = 0; m < RB; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * i + jj, c = 8 * jj + 2 * t4;
              float2* e = reinterpret_cast<float2*>(
                  swz<128>(ep, qrow[m][h] - mb0 * 64, c / 4) + (c % 4) * 4);
              float2 v = make_float2(acc_c[m][4 * j + 2 * h], acc_c[m][4 * j + 2 * h + 1]);
              if (p.pw == nullptr) {
                const float2 sc = *e;
                v.x += sc.x;
                v.y += sc.y;
              }
              *e = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
            }
        fence_async_smem();
        warpgroup_sync(wg);  // the box holds the warpgroup's outputs
        const int s = advance();
        if (leader) {
          tma_store_4d(&omap, base + box, pp * PASS + 32 * i, ox0,
                       oy0 + (SPLIT_M ? 8 * wg : 0), frame);
          bulk_wait_read<1>();
          if (held >= 0) arrive(held);
          held = s;
        } else {
          arrive(s);
        }
      }
      if (leader) {
        bulk_wait_read<0>();
        arrive(held);
      }
    }
  }
  if (leader) bulk_wait();
}

// ---- the launcher -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up by cudaGetDriverEntryPoint, so the
// library needs no -lcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a float32 tensor map of x, zeros outside it, whose boxes land in rows of
// box[0] * 4 bytes with the swizzle of that width
static int encode(CUtensorMap* map, const void* x, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box[0] == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box[0] == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(x), dims,
                        strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// x as TMA sees it. The tile's region in boxes of `chans` channels: at
// stride 1 dims (C, W, H, N), box (chans, AWS, AH, 1); at stride 2 dims (C,
// W/2, 2, H, N), the column split into its half and its parity, box (chans,
// AWP, 2, AH, 1), which lands each region row as its even columns, then its
// odd ones.
template <int S>
static int encode_region(CUtensorMap* map, const void* x, int N, int H, int W, int Cin,
                         cuuint32_t chans) {
  using G = Geom<S>;
  const cuuint64_t c = (cuuint64_t)Cin * 4;  // bytes a pixel
  if (S == 1) {
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {c, c * W, c * W * H};
    const cuuint32_t box[4] = {chans, G::AWS, G::AH, 1};
    return encode(map, x, 4, dims, strides, box);
  }
  const cuuint64_t dims[5] = {(cuuint64_t)Cin, (cuuint64_t)W / 2, 2, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[4] = {2 * c, c, c * W, c * W * H};
  const cuuint32_t box[5] = {chans, G::AWP, 2, G::AH, 1};
  return encode(map, x, 5, dims, strides, box);
}

// A tensor of (N, H, W, C) pixels in boxes of 32 channels of rows tile
// rows of the tile's width
template <int S>
static int encode_tile(CUtensorMap* map, const void* t, int N, int H, int W, int C,
                       cuuint32_t rows) {
  using G = Geom<S>;
  const cuuint64_t c = (cuuint64_t)C * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {c, c * W, c * W * H};
  const cuuint32_t box[4] = {32, G::TW, rows, 1};
  return encode(map, t, 4, dims, strides, box);
}

// xmap: x's region, KA channels a box (product a); pmap: KP channels (the
// projection); imap: x at the tile's pixels (the identity, stride 1 only);
// omap: the output at a consumer warpgroup's 8 rows of the tile
template <int S>
static int encode_maps(CUtensorMap* xmap, CUtensorMap* pmap, CUtensorMap* imap,
                       CUtensorMap* omap, const Params& p) {
  int e = encode_region<S>(xmap, p.x, p.N, p.H, p.W, p.Cin, KA);
  if (e == 0) e = encode_region<S>(pmap, p.x, p.N, p.H, p.W, p.Cin, KP);
  if (e == 0) e = encode_tile<S>(imap, p.x, p.N, p.H, p.W, p.Cin, Geom<S>::TH);
  if (e == 0) e = encode_tile<S>(omap, p.out, p.N, p.Ho, p.Wo, p.Cout, 8);
  return e;
}

template <int S, int CI>
static int launch(Params p, cudaStream_t stream) {
  using G = Geom<S>;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // shared memory: the mbarriers, a (and b over it), then the ring
  p.off_ring = (128 + (CI / 4) * G::NA * 16 + 1023) / 1024 * 1024;  // TMA's swizzle atoms
  p.NS = min(MAXNS, (optin - (int)p.off_ring) / STAGE);
  if (p.NS < 2) return (int)cudaErrorInvalidValue;
  const size_t smem_bytes = p.off_ring + (size_t)p.NS * STAGE;
  CUtensorMap xmap, pmap, imap, omap;
  const int e = encode_maps<S>(&xmap, &pmap, &imap, &omap, p);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_block_kernel<S, CI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  p.tiles_x = (p.Wo + G::TW - 1) / G::TW;
  p.tiles_y = (p.Ho + G::TH - 1) / G::TH;
  p.tiles = p.N * p.tiles_x * p.tiles_y;
  const int grid = p.tiles < sms ? p.tiles : sms;
  if (grid == 0) return 0;
  bottleneck_block_kernel<S, CI><<<grid, NT, smem_bytes, stream>>>(xmap, pmap, imap, omap, p);
  return (int)cudaGetLastError();
}

// Weights come packed (see the layout note above and the wrapper's
// pack_block_f32): each matrix's big part, then its small part; cb with the
// projection's pb added, padded to whole passes of 128; pw null for the
// identity shortcut.
extern "C" int bottleneck_block(
    const void* x, int N, int H, int W, int Cin, const void* aw, const void* ab,
    const void* bw, const void* bb, const void* cw, const void* cb, const void* pw,
    int Ci, int Cout, int s, void* out, void* stream) {
  if (Cin % 4 || Cout % 32 || (Ci != 32 && Ci != 64) || (s != 1 && s != 2) || H % s || W % s)
    return (int)cudaErrorInvalidValue;
  if (pw == nullptr && (Cin != Cout || s != 1)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const float*)x;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Kp = (Cin + KA - 1) / KA * KA;
  p.aw = (const float*)aw; p.ab = (const float*)ab;
  p.bw = (const float*)bw; p.bb = (const float*)bb;
  p.cw = (const float*)cw; p.cb = (const float*)cb;
  p.pw = (const float*)pw;
  p.Cout = Cout; p.P = (Cout + PASS - 1) / PASS;
  p.out = (float*)out; p.Ho = H / s; p.Wo = W / s;
  cudaStream_t st = (cudaStream_t)stream;
  if (s == 1) return Ci == 64 ? launch<1, 64>(p, st) : launch<1, 32>(p, st);
  return Ci == 64 ? launch<2, 64>(p, st) : launch<2, 32>(p, st);
}
