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
// dims (optional, M ints): clustering m's rows and centers are zero at and
// past column dims[m]. The kernel then neither reads nor multiplies those
// columns, and writes zeros to deltas there; the results are those of the
// zero-padded input, bit for bit.
//
// Design. The TPU version walks a sequential grid and accumulates counts
// and deltas in place across batch tiles. Hopper runs blocks in parallel
// and in no order, and no float atomics are used here, so every sum has a
// fixed order and two launches on the same inputs give the same bytes.
// One persistent launch takes work items from one queue index: first every
// assign item, the widest clustering's first, then the accumulate blocks,
// the narrowest clustering's first (its rows are sorted first):
//   * assign item (TB rows of m, one split of SW columns): rows and centers
//     are staged chunk by chunk (DC features) through a cp.async ring; the
//     distance product runs on the tensor cores (mma.sync m16n8k8 TF32,
//     3xTF32 below), the norms from the same staged chunks in fp32. The
//     split's partial products and norms go to the workspace; the tile's
//     last split to finish (a completion counter) adds the splits' partials
//     in split order, applies the discount, takes the first-index argmin,
//     and writes the tile's count of each center, each row's rank among
//     the tile's rows of its center, and its min-sum. Splitting the columns
//     keeps the widest clustering's tiles from being the critical path.
//     The last tile of m to finish sums the tiles' counts and min-sums in
//     tile order, sorts m's rows by center (row order kept within a
//     center: the tiles' counts and ranks give each row its place) and
//     then releases m;
//   * accumulate block (NCOL columns of m): waits for m's release, then
//     takes m's rows in sorted order RS at a time: all warps stage them
//     into shared memory (the next RS in flight while these are summed),
//     and each warp sums the rows of its run of centers from there in row
//     order, 2 columns a lane. Those are the deltas with the same
//     additions in the same order as a walk over the rows, whatever the
//     centers' sizes. With the real columns of all clusterings (28 MB at
//     the main path's shape) the L2 still holds m's rows from its assign.
// An item waits only on items earlier in the queue, which running CTAs
// hold and finish without waiting, so the grid cannot deadlock.
//
// 3xTF32. Each fp32 operand v is split in registers into big = tf32(v) and
// small = tf32(v - big), rounded as cvt.rna rounds, and each product is
// issued as three MMAs (small.big, big.small, big.big) into an fp32
// accumulator: close to an fp32 product (one TF32 product keeps about
// 2^-11). The tensor cores round their fp32 sums toward zero, so each
// chunk's products sum into a fresh accumulator that is then added to the
// running total with an fp32 add. Centers are padded to the MMA width of 8
// with zeros in shared memory and kept out of the argmin.
//
// Bound on an H100 SXM at the main path's shape (M=10, K=32, D=2304,
// B=1024; the taps' real widths sum to 5944 of the 23040 padded columns):
// over the real columns the function must move 4 B x (1024 x 5944 rows +
// 32 x 5944 centers + 10 x 32 x 2304 deltas) = 28 MB, 8.4 us at 3.35 TB/s
// (100 MB and 30 us padded). Its operations, 3 x 0.39 GFLOP of TF32 MMAs,
// take 2.4 us at 495 TFLOP/s. So it is bound by bytes.
//
// Plain C interface for ctypes; the launcher allocates nothing (the caller
// passes a workspace of kmeans_assign_update_workspace() bytes) and
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256          // threads per CTA: 8 warps
#define NWARP (NT / 32)
#define TB 64           // rows per assign tile: 16 a row group of warps
#define DC 32           // features a staged chunk holds
#define LDS (DC + 4)    // row stride of a staged chunk in floats: 4 (mod 32)
#define STAGES 4        // chunks in the cp.async ring
#define CG 32           // centers a pass covers: 4 n-tiles of 8
#define SW 512          // columns an assign item covers (a multiple of DC)
#define KMAX 256        // centers supported
#define MMAX 64         // clusterings supported
#define NCOL 64         // columns an accumulate block covers: 2 a lane
#define RS 256          // sorted rows an accumulate block stages at a time
#define EPT 8           // tile-epilogue elements in flight per thread
#define CTAS_PER_SM 2   // persistent grid, at most what can be resident
#define MINB 2          // CTAs an SM must hold: caps registers at 128 a thread

extern __shared__ float smem[];

// The queue, planned on the host.
struct Plan {
  int grp[MMAX];  // clustering of queue group g: widest first
  int dm[MMAX];   // real width of clustering m
  int a0[MMAX];   // queue index where A(g) starts
  int c0[MMAX];   // queue index where C(g) starts
  int total;      // items in the queue
};

// The workspace: counters, zero when a launch starts, then scratch.
struct Work {
  int* queue;          // next work item
  int* done;           // (M) tiles finished, per clustering
  int* ready;          // (M) 1 once the clustering's rows are sorted
  int* splits_done;    // (M,T) splits finished, per tile
  float* pdot;         // (M,T,SMAX,TB,K) each split's partial x.c
  float* px2;          // (M,T,SMAX,TB) and |x|^2
  float* pc2;          // (M,T,SMAX,K) and |c|^2
  int* part_cnt;       // (T,M,K) rows of each center in each tile
  float* part_minsum;  // (T,M)
  int* rank;           // (M,B) a row's rank among its tile's rows of its center
  int* order;          // (M,B) rows sorted by center, row order within one
  int* seg;            // (M,K+1) where each center's rows start in order
};

struct Args {
  const float* centers;  // (M,K,D)
  const float* counts;   // (M,K)
  const float* batch;    // (M,B,D)
  float threshold;
  int M, K, B, D, T, NB, SMAX;
  int* best;             // (M,B)
  float* counts_add;     // (M,K)
  float* deltas;         // (M,K,D)
  float* min_mean;       // (M)
};

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  // 16 bytes global -> shared: the first `bytes` from src, zeros after them
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// cvt.rna.tf32.f32 for any finite v, in two integer instructions: add half
// a TF32 ulp to the magnitude bits and clear the 13 bits TF32 drops.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Issue the cp.async copies of features [d0, d0+DC) of the tile's rows and
// of kn centers into one ring slot; rows and centers past the ends, and
// features at or past dhi, land as zeros without being read. Rows are D
// floats apart.
__device__ __forceinline__ void stage_chunk(float* slot, const float* xm, const float* cm,
                                            int row0, int rows, int kn, int D, int dhi,
                                            int d0) {
  for (int i = threadIdx.x; i < (TB + CG) * (DC / 4); i += NT) {
    const int r = i / (DC / 4), q = (i % (DC / 4)) * 4, d = d0 + q;
    const bool is_x = r < TB;
    const int rr = is_x ? r : r - TB;
    const bool ok = (is_x ? rr < rows : rr < kn) && d < dhi;
    const float* src = is_x ? xm + (size_t)(row0 + rr) * D + d : cm + (size_t)rr * D + d;
    cp16(slot + r * LDS + q, ok ? src : xm, ok ? 4 * min(4, dhi - d) : 0);
  }
}

// Columns [dlo, dhi) of the tile's x.c against NT8 n-tiles of centers into
// tot, and this thread's shares of the rows' and centers' squared norms.
template <int NT8>
__device__ __forceinline__ void product(const float* xm, const float* cm, int row0,
                                        int rows, int kn, int D, int dlo, int dhi,
                                        float (&tot)[4][4], float& xq0, float& xq1,
                                        float (&cq)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, kh = warp >> 2;
  const int nchunks = (dhi - dlo + DC - 1) / DC;
  float* ring = smem;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks)
      stage_chunk(ring + s * (TB + CG) * LDS, xm, cm, row0, rows, kn, D, dhi, dlo + s * DC);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < nchunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk c landed; every warp is done with chunk c-1
    if (c + STAGES - 1 < nchunks)
      stage_chunk(ring + ((c + STAGES - 1) % STAGES) * (TB + CG) * LDS, xm, cm, row0, rows,
                  kn, D, dhi, dlo + (c + STAGES - 1) * DC);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* xa = ring + (c % STAGES) * (TB + CG) * LDS + (16 * rg + g) * LDS;
    const float* cb = ring + (c % STAGES) * (TB + CG) * LDS + (TB + g) * LDS;
    // each chunk sums into a fresh accumulator, added to the total in
    // fp32: the tensor cores' own sums round toward zero
    float part[NT8][4] = {};
#pragma unroll
    for (int kk = kh * (DC / 2); kk < (kh + 1) * (DC / 2); kk += 8) {
      const float a0 = xa[kk + t], a1 = xa[8 * LDS + kk + t];
      const float a2 = xa[kk + t + 4], a3 = xa[8 * LDS + kk + t + 4];
      xq0 = fmaf(a0, a0, xq0); xq0 = fmaf(a2, a2, xq0);
      xq1 = fmaf(a1, a1, xq1); xq1 = fmaf(a3, a3, xq1);
      uint32_t ab[4], as[4];
      split(a0, ab[0], as[0]); split(a1, ab[1], as[1]);
      split(a2, ab[2], as[2]); split(a3, ab[3], as[3]);
      uint32_t bb[NT8][2], bs[NT8][2];
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const float b0 = cb[8 * j * LDS + kk + t], b1 = cb[8 * j * LDS + kk + t + 4];
        cq[j] = fmaf(b0, b0, cq[j]); cq[j] = fmaf(b1, b1, cq[j]);
        split(b0, bb[j][0], bs[j][0]); split(b1, bb[j][1], bs[j][1]);
      }
      // small.big, big.small, then big.big, each for every n-tile in a
      // row, so that an MMA seldom waits on the one before it
#pragma unroll
      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], as, bb[j]);
#pragma unroll
      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], ab, bb[j]);
    }
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[j][e] += part[j][e];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The last assign tile of m: counts and min-sum summed in tile order, m's
// rows sorted by center, then m released to its accumulate blocks.
__device__ void finish(const Args& a, const Work& w, int m) {
  const int tid = threadIdx.x, K = a.K, M = a.M, T = a.T;
  int* base = (int*)smem;     // T x K: tile counts, then where the rows start
  int* segs = base + T * K;   // K+1
  float* msum = (float*)(segs + K + 1);  // T
  for (int i = tid; i < T * K; i += NT)
    base[i] = __ldcg(w.part_cnt + ((size_t)(i / K) * M + m) * K + i % K);
  for (int t = tid; t < T; t += NT) msum[t] = __ldcg(w.part_minsum + (size_t)t * M + m);
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += msum[t];
    a.min_mean[m] = s / (float)a.B;
  }
  for (int k = tid; k < K; k += NT) {
    int s = 0;
    for (int t = 0; t < T; ++t) s += base[t * K + k];
    segs[k + 1] = s;
    a.counts_add[m * K + k] = (float)s;
  }
  __syncthreads();
  if (tid == 0) {
    segs[0] = 0;
    for (int k = 0; k < K; ++k) segs[k + 1] += segs[k];
  }
  __syncthreads();
  for (int k = tid; k <= K; k += NT) w.seg[m * (K + 1) + k] = segs[k];
  for (int k = tid; k < K; k += NT) {
    int run = segs[k];
    for (int t = 0; t < T; ++t) {
      const int c = base[t * K + k];
      base[t * K + k] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int r0 = 0; r0 < a.B; r0 += 4 * NT) {  // 4 rows' loads in flight a thread
    int kv[4], rv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = min(r0 + j * NT + tid, a.B - 1);
      kv[j] = __ldcg(a.best + (size_t)m * a.B + r);
      rv[j] = __ldcg(w.rank + (size_t)m * a.B + r);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + j * NT + tid;
      if (r < a.B) w.order[(size_t)m * a.B + base[(r / TB) * K + kv[j]] + rv[j]] = r;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(w.ready + m, 1);
}

// The last split of a tile: the splits' partials added in split order,
// the discount, the first-index argmin, the tile's counts, ranks and
// min-sum; then the clustering's completion count.
__device__ void tile_epilogue(const Args& a, const Work& w, int m, int tile, int S) {
  const int K = a.K, B = a.B, tid = threadIdx.x;
  const int row0 = tile * TB, rows = min(TB, B - row0);
  float* dist = smem;           // TB x K
  float* mind = dist + TB * K;  // TB
  int* bst = (int*)(mind + TB); // TB
  const size_t p0 = ((size_t)m * a.T + tile) * a.SMAX;
  for (int i0 = 0; i0 < rows * K; i0 += NT * EPT) {
    float dot[EPT], x2[EPT], c2[EPT], cnt[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = min(i0 + e * NT + tid, rows * K - 1), r = i / K, k = i % K;
      cnt[e] = __ldg(a.counts + m * K + k);
      dot[e] = __ldcg(w.pdot + (p0 * TB + r) * K + k);
      x2[e] = __ldcg(w.px2 + p0 * TB + r);
      c2[e] = __ldcg(w.pc2 + p0 * K + k);
    }
    for (int s = 1; s < S; ++s) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = min(i0 + e * NT + tid, rows * K - 1), r = i / K, k = i % K;
        dot[e] += __ldcg(w.pdot + ((p0 + s) * TB + r) * K + k);
        x2[e] += __ldcg(w.px2 + (p0 + s) * TB + r);
        c2[e] += __ldcg(w.pc2 + (p0 + s) * K + k);
      }
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = i0 + e * NT + tid;
      if (i < rows * K) {
        float dv = -2.f * dot[e] + x2[e] + c2[e];
        if (cnt[e] < a.threshold) dv = dv / 5.f;
        dist[i] = dv;
      }
    }
  }
  __syncthreads();
  {  // first-index argmin: 4 threads a row, each over every 4th center
    const int r = tid >> 2, q = tid & 3;
    float bd = q < K && r < rows ? dist[r * K + q] : INFINITY;
    int bk = q < K ? q : K;
    if (r < rows)
      for (int k = q + 4; k < K; k += 4) {
        const float v = dist[r * K + k];
        if (v < bd) { bd = v; bk = k; }  // strict: ties keep the first index
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // the smaller value, on ties the smaller index
      const float ov = __shfl_xor_sync(0xffffffffu, bd, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      if (ov < bd || (ov == bd && ok < bk)) { bd = ov; bk = ok; }
    }
    if (q == 0 && r < rows) {
      bst[r] = bk;
      mind[r] = bd;
      a.best[(size_t)m * B + row0 + r] = bk;
    }
  }
  int* cnt = bst + TB;  // 2 x K: each center's rows among rows 0-31 and 32-63
  for (int i = tid; i < 2 * K; i += NT) cnt[i] = 0;
  __syncthreads();
  // a row's rank among the tile's rows of its center, from the rows of
  // its own warp (match_any) and, for rows 32-63, the count in rows 0-31
  int k = 0, rk = 0;
  if (tid < TB) {
    const bool has = tid < rows;
    const unsigned act = __ballot_sync(0xffffffffu, has);
    if (has) {
      k = bst[tid];
      const unsigned peers = __match_any_sync(act, k);
      rk = __popc(peers & ((1u << (tid & 31)) - 1));
      if (rk == 0) cnt[(tid >> 5) * K + k] = __popc(peers);
    }
  }
  __syncthreads();
  if (tid < rows) w.rank[(size_t)m * B + row0 + tid] = rk + (tid >= 32 ? cnt[k] : 0);
  for (int c = tid; c < K; c += NT) w.part_cnt[((size_t)tile * a.M + m) * K + c] = cnt[c] + cnt[K + c];
  if (tid < 32) {  // the min-sum, in a fixed order
    float v = (tid < rows ? mind[tid] : 0.f) + (tid + 32 < rows ? mind[tid + 32] : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid == 0) w.part_minsum[(size_t)tile * a.M + m] = v;
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.done + m, 1) == a.T - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    finish(a, w, m);
  }
}

// Split s (columns [s SW, (s+1) SW) below dm) of the tile of TB rows of
// clustering m: partial products and norms into the workspace. Warp w owns
// rows 16 (w & 3) .. +15 against the CG centers of a pass, and half
// kh = w >> 2 of each chunk's features; the two halves' sums are added in a
// fixed order at the end of the pass.
__device__ void assign_split(const Args& a, const Work& w, int m, int tile, int s, int dm) {
  const int K = a.K, B = a.B, D = a.D, S = (dm + SW - 1) / SW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, kh = warp >> 2;
  const int row0 = tile * TB, rows = min(TB, B - row0);
  const int dlo = s * SW, dhi = min(dm, dlo + SW);
  const size_t p = ((size_t)m * a.T + tile) * a.SMAX + s;
  float* xh = smem + STAGES * (TB + CG) * LDS;  // TB, half 1's share of |x|^2
  float* ch = xh + TB;                           // CG, half 1's share of |c|^2
  const float* xm = a.batch + (size_t)m * B * D;
  for (int k0 = 0; k0 < K; k0 += CG) {
    const int kn = min(CG, K - k0);
    const float* cm = a.centers + ((size_t)m * K + k0) * D;
    float tot[4][4] = {}, cq[4] = {}, xq0 = 0.f, xq1 = 0.f;
    switch ((kn + 7) / 8) {
      case 1: product<1>(xm, cm, row0, rows, kn, D, dlo, dhi, tot, xq0, xq1, cq); break;
      case 2: product<2>(xm, cm, row0, rows, kn, D, dlo, dhi, tot, xq0, xq1, cq); break;
      case 3: product<3>(xm, cm, row0, rows, kn, D, dlo, dhi, tot, xq0, xq1, cq); break;
      default: product<4>(xm, cm, row0, rows, kn, D, dlo, dhi, tot, xq0, xq1, cq); break;
    }
    // the quad's four shares of each norm, in a fixed order
    xq0 += __shfl_xor_sync(0xffffffffu, xq0, 1); xq0 += __shfl_xor_sync(0xffffffffu, xq0, 2);
    xq1 += __shfl_xor_sync(0xffffffffu, xq1, 1); xq1 += __shfl_xor_sync(0xffffffffu, xq1, 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cq[j] += __shfl_xor_sync(0xffffffffu, cq[j], 1);
      cq[j] += __shfl_xor_sync(0xffffffffu, cq[j], 2);
    }
    __syncthreads();  // every warp is done with the ring
    // half 1 hands its sums to half 0 through shared memory
    float* th = smem + (rg * 32 + lane) * 16;
    if (kh == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) th[4 * j + e] = tot[j][e];
      if (t == 0) { xh[16 * rg + g] = xq0; xh[16 * rg + g + 8] = xq1; }
      if (t == 0 && rg == 0)
        for (int j = 0; j < 4; ++j) ch[8 * j + g] = cq[j];
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * rg + g + 8 * (e >> 1), kl = 8 * j + 2 * t + (e & 1);
          if (kl < kn) w.pdot[(p * TB + r) * K + k0 + kl] = tot[j][e] + th[4 * j + e];
        }
      if (t == 0 && k0 == 0) {
        w.px2[p * TB + 16 * rg + g] = xq0 + xh[16 * rg + g];
        w.px2[p * TB + 16 * rg + g + 8] = xq1 + xh[16 * rg + g + 8];
      }
      if (t == 0 && rg == 0)
        for (int j = 0; j < 4; ++j)
          if (8 * j + g < kn) w.pc2[p * K + k0 + 8 * j + g] = cq[j] + ch[8 * j + g];
    }
    __syncthreads();  // shared memory is free for the next pass
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.splits_done + m * a.T + tile, 1) == S - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    tile_epilogue(a, w, m, tile, S);
  }
}

// 2 floats of a row from p on, of which the first n are real
__device__ __forceinline__ float2 load2(const float* p, int n) {
  return make_float2(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f);
}

// The rows whose indices lanes 0..RS/NWARP-1 hold in idx: 2 columns a lane
// from xm on, of which nreal are real (all of them where full).
__device__ __forceinline__ void load_rows(float2 (&v)[RS / NWARP], const float* xm, int idx,
                                          int D, bool full, int nreal) {
  if (full) {
#pragma unroll
    for (int u = 0; u < RS / NWARP; ++u) {
      const int r = __shfl_sync(0xffffffffu, idx, u);
      v[u] = __ldg(reinterpret_cast<const float2*>(xm + (size_t)r * D));
    }
  } else {
#pragma unroll
    for (int u = 0; u < RS / NWARP; ++u) {
      const int r = __shfl_sync(0xffffffffu, idx, u);
      v[u] = load2(xm + (size_t)r * D, nreal);
    }
  }
}

// Columns [blk NCOL, (blk+1) NCOL) of m's deltas, one of the nb blocks
// that hold real columns. Rows are taken in their sorted order RS at a
// time: the 8 warps stage them into shared memory together (every warp
// loads RS / NWARP rows, whatever the centers' sizes), then each warp sums
// the rows of its run of centers from there, in row order, 2 columns a
// lane. While m is not yet released, the block writes the zeros of every
// nb-th block past the real ones.
__device__ void accumulate_block(const Args& a, const Work& w, int m, int blk, int nb,
                                 int dm) {
  const int K = a.K, B = a.B, D = a.D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float2 zero = make_float2(0.f, 0.f);
  for (int z = nb + blk; z < a.NB; z += nb) {
    const int c = z * NCOL + 2 * lane;
    if (c < D)
      for (int k = warp; k < K; k += NWARP)
        *reinterpret_cast<float2*>(a.deltas + ((size_t)m * K + k) * D + c) = zero;
  }
  const int col = blk * NCOL + 2 * lane;
  float* out = a.deltas + (size_t)m * K * D + col;
  if (tid == 0) {
    while (*(volatile int*)(w.ready + m) == 0) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  int* segs = (int*)smem;                                  // K+1
  float2* staged = (float2*)(smem + (K + 4) / 4 * 4);      // RS x 32
  for (int k = tid; k <= K; k += NT) segs[k] = __ldcg(w.seg + m * (K + 1) + k);
  __syncthreads();
  // warp v owns the centers whose rows start in [v B / NWARP, (v+1) B / NWARP):
  // [klo, khi), counted over the centers 32 at a time
  int klo = 0, khi = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int own = k0 + lane < K ? min(NWARP - 1, segs[k0 + lane] * NWARP / B) : NWARP;
    klo += __popc(__ballot_sync(0xffffffffu, own < warp));
    khi += __popc(__ballot_sync(0xffffffffu, own <= warp));
  }
  const int lo = segs[klo], hi = segs[khi];
  const int* ord = w.order + (size_t)m * B;
  const float* xm = a.batch + (size_t)m * B * D + col;
  const int nreal = max(0, min(2, dm - col));
  const bool full = (blk + 1) * NCOL <= dm;  // every lane's 2 columns are real
  int k = klo;
  int kend = k < khi ? segs[k + 1] : hi;
  float2 acc = zero;
  // the chunk's rows are loaded into registers while the chunk before is
  // summed; a clamped index reads a real row whose value goes unused (a
  // select on a load's result would wait for it)
  const int q = warp * (RS / NWARP);
  int idx = __ldcg(ord + min(q + lane, B - 1));
  float2 v[RS / NWARP];
  load_rows(v, xm, idx, D, full, nreal);
  idx = __ldcg(ord + min(RS + q + lane, B - 1));
  for (int p0 = 0; p0 < B; p0 += RS) {
    __syncthreads();  // every warp is done with the previous chunk
#pragma unroll
    for (int u = 0; u < RS / NWARP; ++u) staged[(q + u) * 32 + lane] = v[u];
    __syncthreads();
    if (p0 + RS < B) {
      load_rows(v, xm, idx, D, full, nreal);
      idx = __ldcg(ord + min(p0 + 2 * RS + q + lane, B - 1));
    }
    const int s1 = min(hi, p0 + RS);
    for (int p = max(lo, p0); p < s1;) {
      while (p >= kend) {  // center k's rows are done
        if (col < D) *reinterpret_cast<float2*>(out + (size_t)k * D) = acc;
        acc = zero;
        ++k;
        kend = segs[k + 1];
      }
      const int e = min(kend, s1);  // center k's rows in this chunk, in order
#pragma unroll 8
      for (; p < e; ++p) {
        const float2 x = staged[(p - p0) * 32 + lane];
        acc.x += x.x;
        acc.y += x.y;
      }
    }
  }
  for (; k < khi; ++k) {
    if (col < D) *reinterpret_cast<float2*>(out + (size_t)k * D) = acc;
    acc = zero;
  }
}

__device__ void run_item(const Args& a, const Work& w, const Plan& plan, int item) {
  for (int g = 0; g < a.M; ++g) {
    const int m = plan.grp[g], dm = plan.dm[m], S = (dm + SW - 1) / SW;
    if (item >= plan.a0[g] && item < plan.a0[g] + a.T * S) {
      const int i = item - plan.a0[g];
      assign_split(a, w, m, i / S, i % S, dm);
      return;
    }
    const int nb = (dm + NCOL - 1) / NCOL;
    if (item >= plan.c0[g] && item < plan.c0[g] + nb) {
      accumulate_block(a, w, m, item - plan.c0[g], nb, dm);
      return;
    }
  }
}

__global__ void __launch_bounds__(NT, MINB) k1_kernel(Args a, Work w, Plan plan) {
  __shared__ int item_s;
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(w.queue, 1);
    __syncthreads();
    const int item = item_s;
    __syncthreads();  // everyone has read item_s before it is written again
    if (item >= plan.total) return;
    run_item(a, w, plan, item);
  }
}

// The workspace's layout; with base null, only its size in bytes.
static size_t layout(int M, int K, int B, int D, char* base, Work* w, size_t* counter_bytes) {
  const int T = (B + TB - 1) / TB, SMAX = (D + SW - 1) / SW;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  int* counters = (int*)take(sizeof(int) * (1 + 2 * (size_t)M + (size_t)M * T));
  if (counter_bytes) *counter_bytes = off;
  const size_t parts = (size_t)M * T * SMAX;
  float* pdot = (float*)take(sizeof(float) * parts * TB * K);
  float* px2 = (float*)take(sizeof(float) * parts * TB);
  float* pc2 = (float*)take(sizeof(float) * parts * K);
  int* part_cnt = (int*)take(sizeof(int) * (size_t)T * M * K);
  float* part_minsum = (float*)take(sizeof(float) * (size_t)T * M);
  int* rank = (int*)take(sizeof(int) * (size_t)M * B);
  int* order = (int*)take(sizeof(int) * (size_t)M * B);
  int* seg = (int*)take(sizeof(int) * (size_t)M * (K + 1));
  if (w)
    *w = Work{counters, counters + 1, counters + 1 + M, counters + 1 + 2 * M, pdot, px2,
              pc2, part_cnt, part_minsum, rank, order, seg};
  return off;
}

extern "C" size_t kmeans_assign_update_workspace(int M, int K, int B, int D) {
  return layout(M, K, B, D, nullptr, nullptr, nullptr);
}

// dims: host array of M widths, or null for D everywhere.
extern "C" int kmeans_assign_update(
    const void* centers, const void* counts, const void* batch, float threshold,
    int M, int K, int B, int D, const int* dims, void* work, void* best,
    void* counts_add, void* deltas, void* min_mean, void* stream) {
  const int T = (B + TB - 1) / TB;
  // shared memory: an assign item's ring and tile, or an accumulate
  // block's centers' starts and staged rows, whichever is more
  const size_t smem_assign = sizeof(float) * ((size_t)STAGES * (TB + CG) * LDS + TB + CG) +
                             sizeof(float) * ((size_t)TB * K + TB) + sizeof(int) * (TB + 2 * K);
  const size_t smem_acc = sizeof(int) * (((size_t)K + 4) / 4 * 4) + sizeof(float2) * RS * 32;
  const size_t smem = smem_assign > smem_acc ? smem_assign : smem_acc;
  // the last tile's sort keeps every tile's counts in shared memory
  if (K < 1 || K > KMAX || M < 1 || M > MMAX || B < 1 || D < 4 || D % 4 ||
      sizeof(int) * ((size_t)T * K + K + 1 + T) > smem)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  for (int m = 0; m < M; ++m) {
    plan.dm[m] = dims ? dims[m] : D;
    if (plan.dm[m] < 1 || plan.dm[m] > D) return (int)cudaErrorInvalidValue;
    plan.grp[m] = m;
  }
  for (int g = 1; g < M; ++g)  // widest first; ties keep the clusterings' order
    for (int h = g; h > 0 && plan.dm[plan.grp[h]] > plan.dm[plan.grp[h - 1]]; --h) {
      const int x = plan.grp[h];
      plan.grp[h] = plan.grp[h - 1];
      plan.grp[h - 1] = x;
    }
  const int NB = (D + NCOL - 1) / NCOL;
  // every assign item, widest clustering first, then the accumulate
  // blocks, narrowest first: those are released first
  int pos = 0;
  for (int g = 0; g < M; ++g) {
    plan.a0[g] = pos;
    pos += T * ((plan.dm[plan.grp[g]] + SW - 1) / SW);
  }
  for (int g = M - 1; g >= 0; --g) {
    plan.c0[g] = pos;
    pos += (plan.dm[plan.grp[g]] + NCOL - 1) / NCOL;
  }
  plan.total = pos;
  Args a{(const float*)centers, (const float*)counts, (const float*)batch, threshold,
         M, K, B, D, T, NB, (D + SW - 1) / SW,
         (int*)best, (float*)counts_add, (float*)deltas, (float*)min_mean};
  Work w;
  size_t counter_bytes;
  layout(M, K, B, D, (char*)work, &w, &counter_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_kernel, NT, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(plan.total, min(per_sm, CTAS_PER_SM) * sms);
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(work, 0, counter_bytes, s)) != cudaSuccess) return (int)err;
  k1_kernel<<<grid, NT, smem, s>>>(a, w, plan);
  return (int)cudaGetLastError();
}
