// Fused mini-batch k-means assign + accumulate for M stacked clusterings.
//
// Replaces the TPU kernel acav100m_tpu/ops/pallas/kmeans_kernel.py:
// fused_assign_update (body _kernel). Same four results:
//   best (M,B) i32        first-index argmin over centers of
//                         dist = -2 x.c + |x|^2 + |c|^2, divided by 5 where
//                         counts < threshold (the underuse discount);
//   counts_add (M,K) f32  one-hot counts of best;
//   deltas (M,K,D) f32    sum of the rows assigned to each center;
//   min_mean (M,) f32     mean over rows of the minimum distance.
//
// Design. The TPU version walks a sequential grid and accumulates counts
// and deltas in place across batch tiles. Hopper runs blocks in parallel
// and in no order, and no float atomics are used here, so every sum has a
// fixed order and the results repeat bit for bit:
//   * assign_kernel: one CTA per (tile of TB rows, clustering m). It
//     streams the tile and the K centers through shared memory in chunks of
//     DC features, the next chunk's loads in flight in registers while the
//     current one is used. Each thread owns a 2-row x 4-center register
//     tile of the (TB,K) distance product in fp32 FMA. Then the
//     first-index argmin, and per-tile partial counts and min-sums (tiny).
//     The ragged tail tile is masked (no pad-and-subtract).
//   * accumulate_kernel: one CTA per (128 feature columns, clustering m).
//     Each thread owns one column and walks all B rows in order, adding
//     each row's value into its center's accumulator in shared memory.
//     That is the deltas without any per-tile partials. The first column
//     block also sums the tiles' partial counts and min-sums in tile order.
//
// Bound on an H100 SXM at the main path's shape (M=10, K=32, D=2304,
// B=1024): the kernel must move 100 MB (batch 94.4 MB, centers and deltas
// 5.9 MB), about 30 us at 3.35 TB/s. The operations it needs are 1.6 GFLOP
// (the distance product 1.51, norms and the delta sums of each row once),
// about 24 us at the 67 TFLOP/s of fp32 FMA; written as a one-hot product,
// as on the TPU, the delta sums would double that to 3.0 GFLOP (45 us). So
// bytes and operations are close, bytes slightly ahead. This version reads
// the batch twice (once per kernel, 189 MB), which puts its own floor near
// 56 us; keeping the tile on chip between the two uses is later work, and
// so are TF32 tensor cores, which would change the argmin numerics.
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#define NT 256     // threads per assign CTA
#define DC 32      // feature chunk staged per step
#define TBMAX 64   // rows per assign tile at most
#define XREGS (TBMAX * DC / NT)
#define RR 2       // rows per thread tile
#define RK 4       // centers per thread tile
#define KMAX 256   // centers supported
#define NC 128     // columns (threads) per accumulate CTA
#define RB 2048    // assignments staged per accumulate pass
#define UNROLL 32  // rows in flight per accumulate thread

template <int CREGS>
__global__ void __launch_bounds__(NT) assign_kernel(
    const float* __restrict__ centers,  // (M,K,D)
    const float* __restrict__ counts,   // (M,K)
    const float* __restrict__ batch,    // (M,B,D)
    float threshold, int K, int B, int D, int TB,
    int* __restrict__ best,             // (M,B)
    float* __restrict__ part_counts,    // (T,M,K)
    float* __restrict__ part_minsum) {  // (T,M)
  const int tile = blockIdx.x, m = blockIdx.y, M = gridDim.y;
  const int tid = threadIdx.x;
  const int row0 = tile * TB;
  const int rows = min(TB, B - row0);
  const int KG = (K + RK - 1) / RK, KP = KG * RK;

  extern __shared__ float smem[];
  float* xs = smem;                  // TB x (DC+1)
  float* cs = xs + TB * (DC + 1);    // KP x (DC+1)
  float* x2 = cs + KP * (DC + 1);    // TB
  float* c2 = x2 + TB;               // KP
  float* dist = c2 + KP;             // TB x K
  float* mind = dist + TB * K;       // TB
  int* bst = (int*)(mind + TB);      // TB

  const float* xm = batch + (size_t)m * B * D;
  const float* cm = centers + (size_t)m * K * D;
  const int nx = TB * DC, nc = KP * DC;

  float xr[XREGS], cr[CREGS];
#define LOAD_CHUNK(d0)                                                        \
  _Pragma("unroll") for (int j = 0; j < XREGS; ++j) {                         \
    const int i = tid + j * NT, r = i / DC, d = (d0) + i % DC;                \
    xr[j] = (i < nx && r < rows && d < D) ? __ldg(xm + (size_t)(row0 + r) * D + d) : 0.f; \
  }                                                                           \
  _Pragma("unroll") for (int j = 0; j < CREGS; ++j) {                         \
    const int i = tid + j * NT, k = i / DC, d = (d0) + i % DC;                \
    cr[j] = (i < nc && k < K && d < D) ? __ldg(cm + (size_t)k * D + d) : 0.f; \
  }

  const bool worker = tid < (TB / RR) * KG;
  const int rg = tid / KG, cg = tid % KG;
  float acc[RR][RK] = {};
  for (int i = tid; i < TB + KP; i += NT) {
    if (i < TB) x2[i] = 0.f; else c2[i - TB] = 0.f;
  }
  LOAD_CHUNK(0)
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < XREGS; ++j) {
      const int i = tid + j * NT;
      if (i < nx) xs[(i / DC) * (DC + 1) + i % DC] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < CREGS; ++j) {
      const int i = tid + j * NT;
      if (i < nc) cs[(i / DC) * (DC + 1) + i % DC] = cr[j];
    }
    __syncthreads();
    if (d0 + DC < D) { LOAD_CHUNK(d0 + DC) }  // in flight during the products
    // squared norms: element i is always owned by the same thread
    for (int i = tid; i < TB + KP; i += NT) {
      const float* v = i < TB ? xs + i * (DC + 1) : cs + (i - TB) * (DC + 1);
      float sq = 0.f;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) sq = fmaf(v[dd], v[dd], sq);
      if (i < TB) x2[i] += sq; else c2[i - TB] += sq;
    }
    if (worker) {
      const float* xa = xs + rg * RR * (DC + 1);
      const float* ca = cs + cg * RK * (DC + 1);
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        float xv[RR], cv[RK];
#pragma unroll
        for (int a = 0; a < RR; ++a) xv[a] = xa[a * (DC + 1) + dd];
#pragma unroll
        for (int b = 0; b < RK; ++b) cv[b] = ca[b * (DC + 1) + dd];
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b < RK; ++b) acc[a][b] = fmaf(xv[a], cv[b], acc[a][b]);
      }
    }
  }
#undef LOAD_CHUNK
  __syncthreads();

  if (worker) {
#pragma unroll
    for (int a = 0; a < RR; ++a)
#pragma unroll
      for (int b = 0; b < RK; ++b) {
        const int r = rg * RR + a, k = cg * RK + b;
        if (k < K) {
          float dv = -2.f * acc[a][b] + x2[r] + c2[k];
          if (counts[m * K + k] < threshold) dv = dv / 5.f;
          dist[r * K + k] = dv;
        }
      }
  }
  __syncthreads();

  for (int r = tid; r < rows; r += NT) {
    float bd = dist[r * K];
    int bk = 0;
    for (int k = 1; k < K; ++k) {
      const float v = dist[r * K + k];
      if (v < bd) { bd = v; bk = k; }  // strict: ties keep the first index
    }
    bst[r] = bk;
    mind[r] = bd;
    best[(size_t)m * B + row0 + r] = bk;
  }
  __syncthreads();

  for (int k = tid; k < K; k += NT) {
    int c = 0;
    for (int r = 0; r < rows; ++r) c += bst[r] == k;
    part_counts[((size_t)tile * M + m) * K + k] = (float)c;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += mind[r];
    part_minsum[(size_t)tile * M + m] = s;
  }
}

__global__ void __launch_bounds__(NC) accumulate_kernel(
    const float* __restrict__ batch, const int* __restrict__ best,
    const float* __restrict__ part_counts, const float* __restrict__ part_minsum,
    int K, int B, int D, int T, float* __restrict__ deltas,
    float* __restrict__ counts_add, float* __restrict__ min_mean) {
  const int m = blockIdx.y, M = gridDim.y, tid = threadIdx.x;
  const int d = blockIdx.x * NC + tid;
  extern __shared__ float smem[];
  float* acc = smem;                  // K x NC: column tid owned by thread tid
  int* sbest = (int*)(acc + K * NC);  // RB
  for (int k = 0; k < K; ++k) acc[k * NC + tid] = 0.f;
  const float* xm = batch + (size_t)m * B * D + d;
  for (int r0 = 0; r0 < B; r0 += RB) {
    const int n = min(RB, B - r0);
    __syncthreads();
    for (int i = tid; i < n; i += NC) sbest[i] = best[(size_t)m * B + r0 + i];
    __syncthreads();
    if (d < D) {
      // software pipeline: the next UNROLL rows load while this group adds
      float v[UNROLL], w[UNROLL];
      int r = 0;
      const int full = n / UNROLL * UNROLL;
      if (full) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(xm + (size_t)(r0 + u) * D);
      }
      for (; r < full; r += UNROLL) {
        const bool more = r + UNROLL < full;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          w[u] = more ? __ldg(xm + (size_t)(r0 + r + UNROLL + u) * D) : 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[sbest[r + u] * NC + tid] += v[u];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = w[u];
      }
      for (; r < n; ++r) acc[sbest[r] * NC + tid] += __ldg(xm + (size_t)(r0 + r) * D);
    }
  }
  if (d < D)
    for (int k = 0; k < K; ++k) deltas[((size_t)m * K + k) * D + d] = acc[k * NC + tid];
  if (blockIdx.x == 0) {
    for (int k = tid; k < K; k += NC) {
      float s = 0.f;
      for (int t = 0; t < T; ++t) s += part_counts[((size_t)t * M + m) * K + k];
      counts_add[m * K + k] = s;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < T; ++t) s += part_minsum[(size_t)t * M + m];
      min_mean[m] = s / (float)B;
    }
  }
}

// rows per assign tile for K centers: TB/RR row groups x ceil(K/RK) center
// groups of threads, at most NT
extern "C" int kmeans_assign_update_tile(int K) {
  const int kg = (K + RK - 1) / RK;
  return RR * min(TBMAX / RR, NT / kg);
}

template <int CREGS>
static cudaError_t launch_assign(dim3 grid, size_t smem, cudaStream_t s,
                                 const float* c, const float* n, const float* x,
                                 float thr, int K, int B, int D, int TB, int* best,
                                 float* pc, float* pm) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_kernel<CREGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  assign_kernel<CREGS><<<grid, NT, smem, s>>>(c, n, x, thr, K, B, D, TB, best, pc, pm);
  return cudaGetLastError();
}

extern "C" int kmeans_assign_update(
    const void* centers, const void* counts, const void* batch, float threshold,
    int M, int K, int B, int D, void* best, void* part_counts, void* part_minsum,
    void* counts_add, void* deltas, void* min_mean, void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int TB = kmeans_assign_update_tile(K);
  const int T = (B + TB - 1) / TB;
  const int KP = (K + RK - 1) / RK * RK;
  const size_t smem = sizeof(float) * ((size_t)(TB + KP) * (DC + 1) + TB + KP +
                                       (size_t)TB * K + TB) + sizeof(int) * TB;
  const dim3 grid(T, M);
  const int cregs = (KP * DC + NT - 1) / NT;
  const float* c = (const float*)centers;
  const float* n = (const float*)counts;
  const float* x = (const float*)batch;
  cudaError_t err;
  if (cregs <= 4)
    err = launch_assign<4>(grid, smem, s, c, n, x, threshold, K, B, D, TB, (int*)best,
                           (float*)part_counts, (float*)part_minsum);
  else if (cregs <= 8)
    err = launch_assign<8>(grid, smem, s, c, n, x, threshold, K, B, D, TB, (int*)best,
                           (float*)part_counts, (float*)part_minsum);
  else
    err = launch_assign<KMAX * DC / NT>(grid, smem, s, c, n, x, threshold, K, B, D, TB,
                                        (int*)best, (float*)part_counts,
                                        (float*)part_minsum);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = sizeof(float) * (size_t)K * NC + sizeof(int) * RB;
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(accumulate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  accumulate_kernel<<<dim3((D + NC - 1) / NC, M), NC, smem2, s>>>(
      x, (const int*)best, (const float*)part_counts, (const float*)part_minsum, K, B,
      D, T, (float*)deltas, (float*)counts_add, (float*)min_mean);
  return (int)cudaGetLastError();
}
