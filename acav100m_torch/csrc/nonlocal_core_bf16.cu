// The core of PySlowFast's non-local block, dot_product instantiation, in
// bfloat16 (slowfast/models/nonlocal_helper.py, Wang et al. 2018):
//
//   y[n] = g[n] (theta[n]^T phi[n] / Nk)^T      theta (Ci, Nq), phi, g (Ci, Nk)
//
// computed as y[n] = At[n] theta[n] with At[n] = g[n] phi[n]^T / Nk (Ci, Ci),
// the same function in the cheaper order: nothing of size Nq x Nk exists.
//
// It replaces no TPU kernel: the JAX package has no non-local block. It is
// the port's own kernel of the block: one launch, the cheaper order and its
// two bf16 roundings fixed in the code, nothing of size Nq x Nk.
//
// It is slower than two cuBLAS bf16 bmm calls in the same order (H100 80GB
// HBM3, 700 W, batch 32: 0.166 / 0.141 ms against 0.136 / 0.100 ms at res3 /
// res4): its 128 x 128 tiles of y re-read At's rows and theta's columns from
// the L2 for every tile, and the At tiles of the launch's first wave run
// their long Nk loops on half the CTAs while the y tiles behind them wait.
// Larger wgmma tiles fed by TMA are the way under the library's time.
//
// Bound on an H100 SXM at the main path's shapes (batch 32, bf16): theta,
// phi and g read once and y written once are 0.335 GB at res3 (Ci 256,
// Nq 8192, Nk 2048), 100 us at 3.35 TB/s, and 0.168 GB at res4 (Ci 512, Nq
// 2048, Nk 512), 50 us; the products of this order are 43 us at 989 TFLOP/s
// in either. So the kernel is bound by its bytes and its design is to read
// theta once and write y once, with At (at most 16 MB at res4) from the L2.
//
// Design. One persistent launch; CTAs take 128 x 128 output tiles in order
// from a ticket in device memory:
//   * first every tile of At (phase 1): a product of g's and phi's rows over
//     Nk, both K-major; the float32 sums are scaled by 1/Nk in float32 and
//     rounded to bf16 into the workspace, then the CTA adds one to its
//     clip's count;
//   * then every tile of y (phase 2), in the order (clip, column tile of Nq,
//     row tile of Ci), so that the row tiles that read one tile of theta run
//     together and the second finds it in the L2: it waits until its clip's
//     count holds all of the clip's At tiles, then takes the product of At's
//     rows and theta over Ci.
// A tile of y waits only on tiles earlier in the ticket order, which running
// CTAs hold and finish without waiting, so the grid cannot deadlock. The
// launcher sets the counts and the ticket to zero before the launch.
// Each tile runs 8 warps (2 x 4, 64 x 32 each) of mma.sync m16n8k16 bf16 with
// float32 sums, operands in 64-deep stages by cp.async (global to shared,
// through the L2 alone, where At is written) through a ring of 3 stages,
// rows of 128 bytes with their 16-byte chunks swizzled by the row; fragments
// by ldmatrix (theta, K x N with N contiguous, by ldmatrix.trans). Each tile
// is rounded to bf16 into shared memory and written out in rows of 16 bytes.
//
// Tails. Nk and Nq need only be multiples of 8 (rows of 16-byte chunks): the
// last stage of an At tile zero-fills the chunks of g and phi past Nk, and
// the last column tile of y zero-fills theta's chunks past Nq and stores only
// the chunks before it. Ci is a multiple of 128 (the model's widths are).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;    // output tile, rows and columns
constexpr int KS = 64;       // depth of a stage
constexpr int STAGES = 3;
constexpr int NT = 256;      // 8 warps
constexpr int STAGE_BYTES = 2 * TILE * KS * 2;  // A and B, bf16
constexpr int SMEM = STAGES * STAGE_BYTES;      // 96 KB; the epilogue reuses stage 0
constexpr int CTAS_PER_SM = 2;

struct Args {
  const __nv_bfloat16* theta;  // (n, ci, nq)
  const __nv_bfloat16* phi;    // (n, ci, nk)
  const __nv_bfloat16* g;      // (n, ci, nk)
  __nv_bfloat16* at;           // (n, ci, ci) workspace
  int* count;                  // n clips' finished At tiles, then the ticket
  __nv_bfloat16* y;            // (n, ci, nq)
  int n, ci, nq, nk;
  float inv_nk;
  int ct;      // row (and column) tiles of Ci
  int qt;      // column tiles of Nq, the last one partial where 128 does not divide Nq
  int p1;      // At tiles: n * ct * ct
  int total;   // p1 + n * ct * qt
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// 16 bytes from src where ok, else 16 zero bytes (src is not read)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// One stage: A's 128 rows (K-major, row stride lda elements) from column k0,
// and B: phase 1 128 K-major rows like A; phase 2 64 rows of K (stride
// ldb) of 128 columns from col0, as two 64-column halves. Phase 1 zero-fills
// the chunks at K and past it; phase 2 those of B at ncol columns from col0
// and past them.
template <bool P2>
__device__ __forceinline__ void load_stage(uint8_t* st, const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* b, int ldb, int k0, int col0,
                                           int K, int ncol) {
  const uint32_t sa = smem_u32(st), sb = sa + TILE * KS * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * NT, r = idx >> 3, c = idx & 7;
    const bool ok = P2 || k0 + c * 8 < K;
    cp_async16_or_zero(sa + swz(r, c), ok ? a + (size_t)r * lda + k0 + c * 8 : a, ok);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (!P2) {
      const int r = idx >> 3, c = idx & 7;
      const bool ok = k0 + c * 8 < K;
      cp_async16_or_zero(sb + swz(r, c), ok ? b + (size_t)r * ldb + k0 + c * 8 : b, ok);
    } else {
      const int k = idx >> 4, cc = idx & 15;
      const bool ok = cc * 8 < ncol;
      cp_async16_or_zero(sb + (cc >> 3) * (KS * KS * 2) + swz(k, cc & 7),
                         ok ? b + (size_t)(k0 + k) * ldb + col0 + cc * 8 : b, ok);
    }
  }
}

// One 128 x 128 tile: acc = A[rows] . B over K, then out[rows][cols] =
// bf16(acc * scale) for the first ncol columns, written through shared
// memory. K is a multiple of 8, ncol of 8 (128 in phase 1).
template <bool P2>
__device__ void tile(uint8_t* smem, const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                     int ldb, int col0, int K, int ncol, float scale, __nv_bfloat16* out,
                     int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<P2>(smem + s * STAGE_BYTES, a, lda, b, ldb, s * KS, col0, K, ncol);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = kt + STAGES - 1;
    if (nx < KT)
      load_stage<P2>(smem + (nx % STAGES) * STAGE_BYTES, a, lda, b, ldb, nx * KS, col0, K, ncol);
    cp_commit();
    const uint32_t sa = smem_u32(smem + (kt % STAGES) * STAGE_BYTES), sb = sa + TILE * KS * 2;
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldsm_x4(sa + swz(r, ks * 2 + (lane >> 4)), af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        if (!P2) {
          const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(sb + swz(r, ks * 2 + ((lane >> 3) & 1)), bf[2 * nj][0], bf[2 * nj][1],
                  bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
        } else {
          const int k = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = wn * 32 + nj * 16 + ((lane >> 4) << 3);
          ldsm_x4_t(sb + (col >> 6) * (KS * KS * 2) + swz(k, (col & 63) >> 3), bf[2 * nj][0],
                    bf[2 * nj][1], bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue: the tile in bf16 into stage 0 (128 rows of 256 bytes, chunks
  // swizzled by the row), then out in rows of 16 bytes
  uint8_t* so = smem;
  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + mi * 16 + gr + h * 8, c = wn * 32 + ni * 8 + tc;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[mi][ni][2 * h] * scale, acc[mi][ni][2 * h + 1] * scale);
        *(__nv_bfloat162*)(so + r * 256 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) = v;
      }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = threadIdx.x + i * NT, r = idx >> 4, cc = idx & 15;
    if (cc * 8 < ncol) {
      const uint4 v = *(const uint4*)(so + r * 256 + ((cc ^ (r & 7)) << 4));
      *(uint4*)(out + (size_t)r * ldo + cc * 8) = v;
    }
  }
  __syncthreads();  // stage 0 is the next tile's
}

__global__ void __launch_bounds__(NT, CTAS_PER_SM) nonlocal_core_bf16_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int item_s;
  const int ticket = a.n;  // a.count[n] is the ticket
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(a.count + ticket, 1);
    __syncthreads();
    const int item = item_s;
    __syncthreads();
    if (item >= a.total) break;
    if (item < a.p1) {  // At[b][r0:, c0:] = g[b][r0:] . phi[b][c0:]^T / nk
      const int b = item / (a.ct * a.ct), rc = item % (a.ct * a.ct);
      const int r0 = (rc / a.ct) * TILE, c0 = (rc % a.ct) * TILE;
      const size_t base = (size_t)b * a.ci * a.nk;
      tile<false>(smem, a.g + base + (size_t)r0 * a.nk, a.nk, a.phi + base + (size_t)c0 * a.nk,
                  a.nk, 0, a.nk, TILE, a.inv_nk, a.at + (size_t)b * a.ci * a.ci + (size_t)r0 * a.ci + c0,
                  a.ci);
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(a.count + b, 1);
      }
    } else {  // y[b][r0:, q0:] = At[b][r0:] . theta[b][:, q0:]
      const int j = item - a.p1, per = a.ct * a.qt;
      const int b = j / per, rest = j % per;
      const int q0 = (rest / a.ct) * TILE, r0 = (rest % a.ct) * TILE;
      if (threadIdx.x == 0) {
        const int want = a.ct * a.ct;
        while (*(volatile const int*)(a.count + b) < want) __nanosleep(64);
        __threadfence();
      }
      __syncthreads();
      tile<true>(smem, a.at + (size_t)b * a.ci * a.ci + (size_t)r0 * a.ci, a.ci,
                 a.theta + (size_t)b * a.ci * a.nq, a.nq, q0, a.ci, a.nq - q0, 1.f,
                 a.y + (size_t)b * a.ci * a.nq + (size_t)r0 * a.nq + q0, a.nq);
    }
  }
}

}  // namespace

// Bytes of the workspace: At (n, ci, ci) bf16, then n + 1 ints.
extern "C" size_t nonlocal_core_bf16_workspace(int n, int ci) {
  return (size_t)n * ci * ci * 2 + sizeof(int) * ((size_t)n + 1);
}

// theta (n, ci, nq), phi and g (n, ci, nk), y (n, ci, nq): contiguous bf16,
// 16-byte aligned; ci a multiple of 128, nq and nk of 8. At is scaled by
// 1 / nk_div (the keys' count before any zero columns the caller added).
// work: the workspace's bytes (16-byte aligned). Returns a cudaError_t.
extern "C" int nonlocal_core_bf16(const void* theta, const void* phi, const void* g, void* work,
                                  int n, int ci, int nq, int nk, int nk_div, void* y,
                                  void* stream) {
  if (n < 1 || ci < TILE || ci % TILE || nq < 8 || nq % 8 || nk < 8 || nk % 8 || nk_div < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.theta = (const __nv_bfloat16*)theta;
  a.phi = (const __nv_bfloat16*)phi;
  a.g = (const __nv_bfloat16*)g;
  a.at = (__nv_bfloat16*)work;
  a.count = (int*)((uint8_t*)work + (size_t)n * ci * ci * 2);
  a.y = (__nv_bfloat16*)y;
  a.n = n;
  a.ci = ci;
  a.nq = nq;
  a.nk = nk;
  a.inv_nk = 1.f / (float)nk_div;
  a.ct = ci / TILE;
  a.qt = (nq + TILE - 1) / TILE;
  a.p1 = n * a.ct * a.ct;
  a.total = a.p1 + n * a.ct * a.qt;
  cudaError_t err = cudaFuncSetAttribute(nonlocal_core_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nonlocal_core_bf16_kernel, NT,
                                                           SMEM)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.total < per_sm * sms ? a.total : per_sm * sms;
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(a.count, 0, sizeof(int) * ((size_t)n + 1), s)) != cudaSuccess)
    return (int)err;
  nonlocal_core_bf16_kernel<<<grid, NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}
