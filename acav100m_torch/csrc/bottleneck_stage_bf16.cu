// One ResNet bottleneck block with BN folded, on folded frames (NHWC), in
// bfloat16: the bf16 form of kernel K2, written for Hopper (sm_90a).
//
// Replaces the bfloat16 form of the TPU kernel
// acav100m_tpu/ops/pallas/bottleneck_kernel.py:fused_stage (body
// _make_kernel, _conv3x3, with x and out in bf16). A kt=1 bottleneck stage
// is a chain of these blocks; the wrapper launches this kernel once per
// block. Per frame, with bf16 operands, f32 sums and f32 biases:
//   a  = bf16(relu(x . aw + ab))                    1x1, Cin -> Ci
//   b  = bf16(relu(conv3x3_same(a, stride s) + bb)) 3x3, Ci -> Ci
//   sc = x[::s, ::s] . pw + pb  (projection, f32)   or  f32(x)  (identity)
//   y  = bf16(relu(b . cw + cb + sc))               1x1, Ci -> Cout
// which rounds to bf16 exactly where the TPU kernel does (its lines 91-101).
//
// Design. Persistent CTAs, one an SM, each walking over output tiles of
// TH x 8 pixels (16 x 8 at stride 1, 8 x 8 at stride 2) of one frame, all
// Cout channels. Three warpgroups:
//   * a producer (one elected thread) that loads, at the start, the
//     block's weight matrices into shared memory once for the CTA by 1-D
//     bulk copies, and then keeps x in flight through a ring of stages,
//     each one chunk of KX input channels of the tile's input region (the
//     tile's pixels plus a 1-pixel halo) by TMA, with zeros outside the
//     frame and past Cin. Every stage is completed on an mbarrier (full)
//     and handed back on another (empty): no per-step __syncthreads. Where
//     a tile has more chunks than the ring has stages, a's buffer (idle
//     from product c's end to product a's) takes the first one past the
//     ring, on its own pair of mbarriers.
//   * two consumer warpgroups that run the three products on wgmma
//     (m64nNk16, bf16 in, f32 sums, A and B from shared memory by
//     descriptor), every sum starting from its bias:
//       1. a on the region's rows (M = the region padded to 64), K = Cin
//          chunk by chunk from the ring, half of a's columns each; zero
//          outside the frame, which is the 3x3's 'same' padding;
//       2. b on the tile as an implicit GEMM over the 9 taps of bw: tap
//          (dy, dx) reads a at each pixel's region row shifted by the tap;
//       3. y = b . cw (+ x[::s, ::s] . pw, whose x comes through the ring
//          again, read at the tile's pixels) in passes of 256 columns, then
//          the shortcut and ReLU in f32, rounded to bf16. The identity
//          shortcut is read from the ring's stages during product a.
//     At stride 1 the warpgroups split b and c by the tile's two 64-pixel
//     row tiles (wgmma n64 and n256), at stride 2 by columns. a and b live
//     in shared memory in bf16 (b over a); four named barriers of the two
//     consumer warpgroups a tile order them. Product c's epilogue swaps
//     accumulator pairs within each quad of lanes, so every lane stores 16
//     bytes of 8 consecutive channels.
// Weights that do not fit beside the ring (pw when Cin is large, aw when it
// is larger still) stream through the ring's stages with x instead.
//
// Layouts. Every shared-memory matrix is K-major without swizzle, in
// planes of 8 channels: element (row r, channel k) at
// (k / 8) * plane + r * 16 + (k % 8) * 2 bytes, so a wgmma core matrix (8
// rows x 16 bytes) is 8 consecutive rows of a plane, and any 8 consecutive
// rows are one. The wrapper packs the weights once in this order (their
// rows are the output channels), cw and pw in passes of 256 columns. The
// region is stored row by row with a pitch of AWS pixels; at stride 2 each
// region row is split into its even and odd columns, so the pixels a tap
// reads for 8 consecutive output pixels of a tile row are 8 consecutive
// region rows, and the tile's rows are a uniform AWS * s apart: product
// b's and the projection's A operands are then plain descriptors (8-row
// groups SBO apart), with no ldmatrix.
//
// Bound on an H100 SXM at the main path's shape (SlowFast s2_slow at 256^2
// input: 32 frames of 64x64, Cin 80 -> 256, inner 64, 3 blocks): 57.15
// GFLOP is 0.058 ms at the 989 TFLOP/s of dense bf16; x in and y out are
// 21 + 67 = 88 MB, 0.026 ms at 3.35 TB/s. One launch per block moves the
// two block outputs between blocks through device memory, another 0.27 GB
// (0.08 ms), and product a recomputes the halo (180 region pixels for
// 128 output pixels at stride 1). With the products on wgmma the kernel is
// held back by memory: x's loads in product a and the output's stores in
// product c's epilogue are not overlapped with the products.
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef uint16_t bf16_t;   // bf16 bits; arithmetic is in f32

#define NCONS 256          // consumer threads: two warpgroups
#define NT 384             // and one producer warpgroup
#define PASS 256           // output columns of product c a pass

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

// the two consumer warpgroups' barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
}

// this thread's shared-memory stores made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// matrix descriptor of a K-major, unswizzled operand whose 8-row core
// matrices start at shared address addr: lbo bytes from one 8-channel
// plane to the next (along K), sbo bytes from 8 rows to the next 8
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x N, f32) += A (64 x 16) . B (16 x N), bf16, both from shared memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_n16(d, da, db);
  else if constexpr (N == 32) wgmma_n32(d, da, db);
  else if constexpr (N == 64) wgmma_n64(d, da, db);
  else if constexpr (N == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // round to nearest even, as torch's .to(torch.bfloat16) and XLA's convert
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// The four lanes of a quad (q = lane % 4) hold a row's accumulator pairs
// for columns 8k + 2q, +1 (the wgmma layout); v[2s], v[2s+1] is the pair of
// k = 4j + s. Afterwards lane q holds the 8 columns 8(4j + q) .. +7, in
// order: a 4 x 4 transpose of pairs in two butterfly stages, so the
// epilogue reads and writes 16 bytes a lane.
__device__ __forceinline__ void quad_transpose(float (&v)[8], int q) {
  const bool b1 = q & 2, b0 = q & 1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // slots s and s + 2 across lanes q, q ^ 2
    const int lo = 2 * (e >> 1) + (e & 1), hi = lo + 4;
    const float r = __shfl_xor_sync(0xffffffffu, b1 ? v[lo] : v[hi], 2);
    if (b1) v[lo] = r; else v[hi] = r;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // slots s and s + 1 across lanes q, q ^ 1
    const int lo = 4 * (e >> 1) + (e & 1), hi = lo + 2;
    const float r = __shfl_xor_sync(0xffffffffu, b0 ? v[lo] : v[hi], 1);
    if (b0) v[lo] = r; else v[hi] = r;
  }
}

// ---- the kernel -------------------------------------------------------------

// Tile geometry at stride S: TH x TW output pixels, their input region of
// AH rows x AWS stored pixels (at stride 2 a row is its AWP even columns,
// then its AWP odd ones), NA region pixels padded to NAM (whole m64 tiles).
template <int S>
struct Geom {
  static constexpr int TH = S == 1 ? 16 : 8, TW = 8, NQ = TH * TW, MQ = NQ / 64;
  static constexpr int AH = S * (TH - 1) + 3, AWP = S == 1 ? TW + 2 : TW + 1;
  static constexpr int AWS = S * AWP, NA = AH * AWS, NAM = (NA + 63) / 64 * 64, MA = NAM / 64;
};

// The launcher's plan of shared memory (byte offsets) and of the ring.
struct Params {
  const bf16_t* x;
  int N, H, W, Cin, Kp;                // Kp: Cin rounded up to 16
  const bf16_t* aw; const float* ab;   // packed (Kp/8, Ci, 8)
  const bf16_t* bw; const float* bb;   // packed (9, Ci/8, Ci, 8)
  const bf16_t* cw; const float* cb;   // packed (P, Ci/8, 256, 8); cb (+ pb)
  const bf16_t* pw;                    // packed (P, Kp/8, 256, 8), or null
  int Cout, P;                         // P passes of 256 output columns
  bf16_t* out;
  int Ho, Wo, tiles_x, tiles_y, tiles;
  int KX, NS, aw_res, pw_res;          // ring: KX channels a stage, NS stages
  int a_chunk;                         // product a's chunk that lands in a's buffer, or -1
  uint32_t off_bw, off_cw, off_aw, off_pw, off_a, off_stage, stage_bytes, stage_w;
};

template <int S, int CI>
__global__ void __launch_bounds__(NT, 1) bottleneck_block_bf16_kernel(
    const __grid_constant__ CUtensorMap xmap, const Params p) {
  using G = Geom<S>;
  constexpr int NW = CI / 2;  // a's columns a consumer warpgroup owns
  // products b and c: at stride 1 the two warpgroups split the tile's two
  // m64 row tiles; at stride 2 (one row tile) they split the columns
  constexpr bool SPLIT_M = G::MQ == 2;
  constexpr int NB = SPLIT_M ? CI : CI / 2;          // b's columns a warpgroup
  constexpr int NC = SPLIT_M ? PASS : PASS / 2;      // c's columns a warpgroup, a pass
  static_assert(G::MQ == 1 || G::MQ == 2, "one or two row tiles");
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t base = saddr(smem);
  const uint32_t full0 = base, empty0 = base + 16, wbar = base + 32;  // mbarriers
  // a's buffer, idle from product c to product a's end, as one more stage
  const uint32_t afull = base + 40, aempty = base + 48;
  const int tiles_frame = p.tiles_y * p.tiles_x;
  if (tid == 0) {
    for (int s = 0; s < p.NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS);
    }
    mbar_init(wbar, 1);
    mbar_init(afull, 1);
    mbar_init(aempty, NCONS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread --------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 2 * 128) return;
    const uint32_t bw_b = 9 * CI * CI * 2, cw_b = p.P * CI * PASS * 2;
    const uint32_t aw_b = p.Kp * CI * 2, pw_b = p.P * p.Kp * PASS * 2;
    mbar_expect_tx(wbar, bw_b + cw_b + (p.aw_res ? aw_b : 0) +
                             (p.pw != nullptr && p.pw_res ? pw_b : 0));
    bulk_copy(base + p.off_bw, p.bw, bw_b, wbar);
    bulk_copy(base + p.off_cw, p.cw, cw_b, wbar);
    if (p.aw_res) bulk_copy(base + p.off_aw, p.aw, aw_b, wbar);
    if (p.pw != nullptr && p.pw_res) bulk_copy(base + p.off_pw, p.pw, pw_b, wbar);
    int st = 0;
    uint32_t ph = 0;
    // one stage: channels [k0, k0 + rows) of the region at output origin
    // (oy0, ox0) of frame, and a weight chunk that streams with it
    // (or, with in_a, into a's buffer once product c of the tile before is
    // done with it: i counts this CTA's tiles)
    auto chunk = [&](int frame, int oy0, int ox0, int k0, const bf16_t* w, uint32_t wrow,
                     bool in_a = false, int i = 0) {
      if (in_a)
        mbar_wait(aempty, (i & 1) ^ 1);
      else
        mbar_wait(empty0 + 8 * st, ph ^ 1);
      const int rows = min(p.KX, p.Kp - k0);
      const uint32_t bar = in_a ? afull : full0 + 8 * st;
      const uint32_t dst = in_a ? base + p.off_a : base + p.off_stage + st * p.stage_bytes;
      const uint32_t wbytes = w != nullptr ? rows * wrow * 2 : 0;
      mbar_expect_tx(bar, (rows / 8) * G::NA * 16 + wbytes);
      for (int j = 0; j < rows / 8; ++j) {
        if constexpr (S == 1)
          tma_4d(dst + j * G::NAM * 16, &xmap, k0 + 8 * j, ox0 - 1, oy0 - 1, frame, bar);
        else
          tma_5d(dst + j * G::NAM * 16, &xmap, k0 + 8 * j, ox0 - 1, 0, 2 * oy0 - 1, frame, bar);
      }
      if (w != nullptr) bulk_copy(dst + p.stage_w, w + (size_t)k0 * wrow, wbytes, bar);
      if (!in_a && ++st == p.NS) { st = 0; ph ^= 1; }
    };
    for (int t = blockIdx.x, i = 0; t < p.tiles; t += gridDim.x, ++i) {
      const int frame = t / tiles_frame, r = t % tiles_frame;
      const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;
      for (int k0 = 0, c = 0; k0 < p.Kp; k0 += p.KX, ++c)
        chunk(frame, oy0, ox0, k0, p.aw_res ? nullptr : p.aw, CI, c == p.a_chunk, i);
      if (p.pw != nullptr)
        for (int q = 0; q < p.P; ++q)
          for (int k0 = 0; k0 < p.Kp; k0 += p.KX)
            chunk(frame, oy0, ox0, k0, p.pw_res ? nullptr : p.pw + (size_t)q * p.Kp * PASS, PASS);
    }
    return;
  }

  // ---- consumers: two warpgroups ----------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int half = wg, warp = (tid % 128) / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int mrow = SPLIT_M ? half : 0;                // b's and c's row tile
  const int nb0 = SPLIT_M ? 0 : half * NB, nc0 = SPLIT_M ? 0 : half * NC;
  const uint32_t abuf = base + p.off_a;
  unsigned char* const abuf_p = smem + p.off_a;
  const bf16_t* const xn0 = p.x;
  int st = 0;
  uint32_t ph = 0;
  auto next_stage = [&]() { if (++st == p.NS) { st = 0; ph ^= 1; } };
  mbar_wait(wbar, 0);

  for (int t = blockIdx.x, i = 0; t < p.tiles; t += gridDim.x, ++i) {
    const int frame = t / tiles_frame, r = t % tiles_frame;
    const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;
    const bf16_t* xn = xn0 + (size_t)frame * p.H * p.W * p.Cin;

    // 1. a = bf16(relu(x . aw + ab)) on the region's NAM rows, this
    // warpgroup's NW columns. Every product's sums start from its bias, so
    // no epilogue loads one.
    // the identity shortcut of product c's first pass, for each of this
    // thread's rows 8 channels a quad slot (see quad_transpose): read from
    // the stages as they pass, where the tile's pixels are region pixels
    uint4 xs[2][NC / 32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NC / 32; ++j) xs[h][j] = make_uint4(0u, 0u, 0u, 0u);
    float acc_a[G::MA][NW / 2];
#pragma unroll
    for (int k = 0; k < NW / 8; ++k) {
      const float2 bias = __ldg(reinterpret_cast<const float2*>(p.ab + half * NW + 8 * k + 2 * t4));
#pragma unroll
      for (int m = 0; m < G::MA; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc_a[m][4 * k + 2 * h] = bias.x;
          acc_a[m][4 * k + 2 * h + 1] = bias.y;
        }
    }
    for (int k0 = 0, c = 0; k0 < p.Kp; k0 += p.KX, ++c) {
      const int rows = min(p.KX, p.Kp - k0);
      const bool in_a = c == p.a_chunk;
      const uint32_t off = in_a ? p.off_a : p.off_stage + st * p.stage_bytes, stage = base + off;
      mbar_wait(in_a ? afull : full0 + 8 * st, in_a ? i & 1 : ph);
      wgmma_fence();
      for (int ks = 0; ks < rows / 16; ++ks) {
        const uint64_t db = p.aw_res
            ? make_desc(base + p.off_aw + (k0 / 8 + 2 * ks) * CI * 16 + half * NW * 16, CI * 16, 128)
            : make_desc(stage + p.stage_w + 2 * ks * CI * 16 + half * NW * 16, CI * 16, 128);
#pragma unroll
        for (int m = 0; m < G::MA; ++m)
          wgmma<NW>(acc_a[m], make_desc(stage + 2 * ks * G::NAM * 16 + m * 64 * 16,
                                        G::NAM * 16, 128), db);
      }
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (S == 1) {
        if (p.pw == nullptr) {
          const unsigned char* stage_p = smem + off;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = mrow * 64 + warp * 16 + 8 * h + g;
            const int row = (q / G::TW + 1) * G::AWS + q % G::TW + 1;
#pragma unroll
            for (int j = 0; j < NC / 32; ++j) {
              const int plane = nc0 / 8 + 4 * j + t4 - k0 / 8;
              if (plane >= 0 && plane < rows / 8)
                xs[h][j] = *reinterpret_cast<const uint4*>(stage_p + plane * G::NAM * 16 +
                                                           row * 16);
            }
          }
        }
      }
      if (!in_a) {
        mbar_arrive(empty0 + 8 * st);
        next_stage();
      }
    }
    consumers_sync();  // the last tile's product c is done with b, which lies over a
#pragma unroll
    for (int m = 0; m < G::MA; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = m * 64 + warp * 16 + 8 * h + g;
        const int rr = pix / G::AWS, jj = pix % G::AWS;
        const int cc = S == 1 ? jj : 2 * (jj % G::AWP) + jj / G::AWP;
        const int yy = S * oy0 - 1 + rr, xx = S == 1 ? ox0 - 1 + cc : 2 * ox0 - 2 + cc;
        const bool inside = pix < G::NA && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W;
#pragma unroll
        for (int k = 0; k < NW / 8; ++k) {
          const int n = half * NW + 8 * k + 2 * t4;
          const uint32_t v = inside ? pack_bf16(fmaxf(acc_a[m][4 * k + 2 * h], 0.f),
                                                fmaxf(acc_a[m][4 * k + 2 * h + 1], 0.f))
                                    : 0u;
          *reinterpret_cast<uint32_t*>(abuf_p + (n / 8) * G::NAM * 16 + pix * 16 + (n % 8) * 2) = v;
        }
      }
    fence_async_smem();
    consumers_sync();  // a is whole

    // the identity shortcut of the passes after the first, from x
    auto load_identity = [&](int pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mrow * 64 + warp * 16 + 8 * h + g;
        const int oy = oy0 + q / G::TW, ox = ox0 + q % G::TW;
        const bf16_t* xq = xn + ((size_t)(S * oy) * p.W + S * ox) * p.Cin;
#pragma unroll
        for (int j = 0; j < NC / 32; ++j) {
          const int n = pass * PASS + nc0 + 8 * (4 * j + t4);
          xs[h][j] = oy < p.Ho && ox < p.Wo && n < p.Cout
                         ? __ldg(reinterpret_cast<const uint4*>(xq + n))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };

    // 2. b = bf16(relu(conv3x3(a, stride S) + bb)) on the tile, an implicit
    // GEMM over the 9 taps: tap (dy, dx) reads a at each pixel's region row
    // shifted by the tap
    float acc_b[NB / 2];
#pragma unroll
    for (int k = 0; k < NB / 8; ++k) {
      const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bb + nb0 + 8 * k + 2 * t4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc_b[4 * k + 2 * h] = bias.x;
        acc_b[4 * k + 2 * h + 1] = bias.y;
      }
    }
    wgmma_fence();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int shift = dy * G::AWS + (S == 1 ? dx : ((dx + 1) & 1) * G::AWP + (dx + 1) / 2);
#pragma unroll
      for (int ks = 0; ks < CI / 16; ++ks)
        wgmma<NB>(acc_b,
                  make_desc(abuf + 2 * ks * G::NAM * 16 + (S * 8 * mrow * G::AWS + shift) * 16,
                            G::NAM * 16, S * G::AWS * 16),
                  make_desc(base + p.off_bw + (tap * (CI / 8) + 2 * ks) * CI * 16 + nb0 * 16,
                            CI * 16, 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    consumers_sync();  // every warpgroup is done with a
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = mrow * 64 + warp * 16 + 8 * h + g;
#pragma unroll
      for (int k = 0; k < NB / 8; ++k) {
        const int n = nb0 + 8 * k + 2 * t4;
        *reinterpret_cast<uint32_t*>(abuf_p + (n / 8) * G::NQ * 16 + q * 16 + (n % 8) * 2) =
            pack_bf16(fmaxf(acc_b[4 * k + 2 * h], 0.f), fmaxf(acc_b[4 * k + 2 * h + 1], 0.f));
      }
    }
    fence_async_smem();
    consumers_sync();  // b is whole

    // 3. y = bf16(relu(b . cw (+ x[::s, ::s] . pw) + cb (+ pb | f32(x)))),
    // a pass of 256 columns at a time (pb is folded into cb by the wrapper)
    for (int pass = 0; pass < p.P; ++pass) {
      if (pass > 0 && p.pw == nullptr) load_identity(pass);
      float acc_c[NC / 2];
#pragma unroll
      for (int k = 0; k < NC / 8; ++k) {
        const int n = min(pass * PASS + nc0 + 8 * k + 2 * t4, p.Cout - 2);
        const float2 bias = __ldg(reinterpret_cast<const float2*>(p.cb + n));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc_c[4 * k + 2 * h] = bias.x;
          acc_c[4 * k + 2 * h + 1] = bias.y;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < CI / 16; ++ks)
        wgmma<NC>(acc_c, make_desc(abuf + 2 * ks * G::NQ * 16 + mrow * 64 * 16, G::NQ * 16, 128),
                  make_desc(base + p.off_cw + (pass * (CI / 8) + 2 * ks) * PASS * 16 + nc0 * 16,
                            PASS * 16, 128));
      wgmma_commit();
      if (p.pw != nullptr) {
        for (int k0 = 0; k0 < p.Kp; k0 += p.KX) {
          const int rows = min(p.KX, p.Kp - k0);
          const uint32_t stage = base + p.off_stage + st * p.stage_bytes;
          mbar_wait(full0 + 8 * st, ph);
          wgmma_fence();
          for (int ks = 0; ks < rows / 16; ++ks) {
            const uint64_t db = p.pw_res
                ? make_desc(base + p.off_pw + (pass * (p.Kp / 8) + k0 / 8 + 2 * ks) * PASS * 16 +
                                nc0 * 16, PASS * 16, 128)
                : make_desc(stage + p.stage_w + 2 * ks * PASS * 16 + nc0 * 16, PASS * 16, 128);
            wgmma<NC>(acc_c, make_desc(stage + 2 * ks * G::NAM * 16 +
                                           ((S * 8 * mrow + 1) * G::AWS + 1) * 16,
                                       G::NAM * 16, S * G::AWS * 16), db);
          }
          wgmma_commit();
          wgmma_wait_all();
          mbar_arrive(empty0 + 8 * st);
          next_stage();
        }
      }
      wgmma_wait_all();
      // product c is done with b: a's buffer may take the next tile's x
      if (pass == p.P - 1 && p.a_chunk >= 0) mbar_arrive(aempty);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mrow * 64 + warp * 16 + 8 * h + g;
        const int oy = oy0 + q / G::TW, ox = ox0 + q % G::TW;
        bf16_t* dst = p.out + (((size_t)frame * p.Ho + oy) * p.Wo + ox) * p.Cout;
#pragma unroll
        for (int j = 0; j < NC / 32; ++j) {
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = acc_c[4 * (4 * j + e / 2) + 2 * h + e % 2];
          quad_transpose(v, t4);
          const int n = pass * PASS + nc0 + 8 * (4 * j + t4);
          if (oy >= p.Ho || ox >= p.Wo || n >= p.Cout) continue;
          if (p.pw == nullptr) {
            const uint32_t u[4] = {xs[h][j].x, xs[h][j].y, xs[h][j].z, xs[h][j].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(u[e]);
              v[2 * e] += f.x;
              v[2 * e + 1] += f.y;
            }
          }
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = pack_bf16(fmaxf(v[2 * e], 0.f), fmaxf(v[2 * e + 1], 0.f));
          *reinterpret_cast<uint4*>(dst + n) = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
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

// x as TMA sees it: a box of 8 channels of the tile's region, zeros outside
// the frame and past Cin. Stride 1: dims (C, W, H, N), box (8, AWS, AH, 1).
// Stride 2: dims (C, W/2, 2, H, N), the column split into its half and its
// parity, box (8, AWP, 2, AH, 1), which lands each region row as its even
// columns, then its odd ones.
template <int S>
static int encode_x(CUtensorMap* map, const void* x, int N, int H, int W, int Cin) {
  using G = Geom<S>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t c = (cuuint64_t)Cin * 2;  // bytes a pixel
  CUresult r;
  if (S == 1) {
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {c, c * W, c * W * H};
    const cuuint32_t box[4] = {8, G::AWS, G::AH, 1}, es[4] = {1, 1, 1, 1};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
           es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[5] = {(cuuint64_t)Cin, (cuuint64_t)W / 2, 2, (cuuint64_t)H,
                                (cuuint64_t)N};
    const cuuint64_t strides[4] = {2 * c, c, c * W, c * W * H};
    const cuuint32_t box[5] = {8, G::AWP, 2, G::AH, 1}, es[5] = {1, 1, 1, 1, 1};
    r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, box,
           es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Shared memory: the mbarriers, bw and cw resident, aw and pw resident if
// they fit, a (and b over it), then the ring. Prefers resident weights,
// then 64 channels a stage and two stages. Returns the bytes, 0 if nothing fits.
template <int S, int CI>
static size_t plan_smem(Params* p, bool proj, size_t limit) {
  using G = Geom<S>;
  const size_t fixed = 128 + 9 * CI * CI * 2 + (size_t)p->P * CI * PASS * 2 + G::NAM * CI * 2;
  const size_t aw_b = (size_t)p->Kp * CI * 2, pw_b = proj ? (size_t)p->P * p->Kp * PASS * 2 : 0;
  static const int rings[6][2] = {{64, 2}, {32, 2}, {64, 1}, {32, 1}, {16, 2}, {16, 1}};
  for (int res = 0; res < 3; ++res) {
    const int aw_res = res < 2, pw_res = res < 1;
    if (!proj && res == 1) continue;
    const int wrow = (proj && !pw_res) ? PASS : (!aw_res ? CI : 0);
    for (const auto& ring : rings) {
      const size_t stage = (size_t)(ring[0] / 8) * 16 * (G::NAM + wrow);
      const size_t total = fixed + (aw_res ? aw_b : 0) + (pw_res ? pw_b : 0) + ring[1] * stage;
      if (total > limit) continue;
      p->KX = ring[0];
      p->NS = ring[1];
      p->aw_res = aw_res;
      p->pw_res = pw_res;
      p->off_bw = 128;
      p->off_cw = p->off_bw + 9 * CI * CI * 2;
      p->off_a = p->off_cw + p->P * CI * PASS * 2;
      p->off_aw = p->off_a + G::NAM * CI * 2;
      p->off_pw = p->off_aw + (aw_res ? aw_b : 0);
      p->off_stage = p->off_pw + (pw_res ? pw_b : 0);
      p->stage_bytes = stage;
      p->stage_w = (ring[0] / 8) * 16 * G::NAM;
      // a's buffer takes the first chunk past the ring where it holds one
      const int chunks = (p->Kp + ring[0] - 1) / ring[0];
      p->a_chunk = aw_res && CI >= ring[0] && chunks > ring[1] ? ring[1] : -1;
      return total;
    }
  }
  return 0;
}

template <int S, int CI>
static int launch(Params p, bool proj, cudaStream_t stream) {
  using G = Geom<S>;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem_bytes = plan_smem<S, CI>(&p, proj, (size_t)optin);
  if (smem_bytes == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int e = encode_x<S>(&map, p.x, p.N, p.H, p.W, p.Cin);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_block_bf16_kernel<S, CI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  p.tiles_x = (p.Wo + G::TW - 1) / G::TW;
  p.tiles_y = (p.Ho + G::TH - 1) / G::TH;
  p.tiles = p.N * p.tiles_x * p.tiles_y;
  const int grid = p.tiles < sms ? p.tiles : sms;
  if (grid == 0) return 0;
  bottleneck_block_bf16_kernel<S, CI><<<grid, NT, smem_bytes, stream>>>(map, p);
  return (int)cudaGetLastError();
}

// Weights come packed (see the layout note above and the wrapper's
// pack_block_bf16); biases are float32, with the projection's pb already
// added to cb; pw null for the identity shortcut.
extern "C" int bottleneck_block_bf16(
    const void* x, int N, int H, int W, int Cin, const void* aw, const void* ab,
    const void* bw, const void* bb, const void* cw, const void* cb, const void* pw,
    int Ci, int Cout, int s, void* out, void* stream) {
  if (Cin % 8 || Cout % 32 || (Ci != 32 && Ci != 64) || (s != 1 && s != 2) || H % s || W % s)
    return (int)cudaErrorInvalidValue;
  if (pw == nullptr && (Cin != Cout || s != 1)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = (const bf16_t*)x;
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Kp = (Cin + 15) / 16 * 16;
  p.aw = (const bf16_t*)aw; p.ab = (const float*)ab;
  p.bw = (const bf16_t*)bw; p.bb = (const float*)bb;
  p.cw = (const bf16_t*)cw; p.cb = (const float*)cb;
  p.pw = (const bf16_t*)pw;
  p.Cout = Cout; p.P = (Cout + PASS - 1) / PASS;
  p.out = (bf16_t*)out; p.Ho = H / s; p.Wo = W / s;
  const bool proj = pw != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (s == 1) return Ci == 64 ? launch<1, 64>(p, proj, st) : launch<1, 32>(p, proj, st);
  return Ci == 64 ? launch<2, 64>(p, proj, st) : launch<2, 32>(p, proj, st);
}
