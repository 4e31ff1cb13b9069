// One step of stage 6's batched greedy MI selection (batch_mi, the
// incremental "mem" score) in one launch:
//
//   gather   the B candidates' (P, 2) cluster pairs by their ids
//   score    each as if added alone to the contingency cache, in float32:
//              new_nlogn = NlogN - nlogn(N[p,i1,i2]) + nlogn(N[p,i1,i2] + 1)
//              (aloga with a[p,i2], blogb with b[p,i1]: the margins cross)
//              s[p] = new_nlogn/n' - new_aloga/n' - new_blogb/n' + log(n'),
//              n' = n[p] + 1, then the mean over pairs (weighted if given);
//              candidates at index >= valid (a tail batch's pads) score -inf
//   top-k    the k best in descending order, ties to the lowest index
//            (torch.sort(stable=True), lax.top_k)
//   fold     the valid winners into N, a, b and n: each cell's exact integer
//            count of winners first, then one add of it (pads weigh 0)
//   stats    NlogN, aloga and blogb recomputed over the whole updated cache
//   output   the k indices, then the k scores' bits, for one host read.
//
// It replaces no Pallas kernel: the JAX package runs this step as one jitted
// executable (acav100m_tpu/ops/mi.py, BatchGreedySelector), which the port
// had run as some 90 eager PyTorch ops, each a launch of a microsecond or two
// and each enqueued by the host at a few microseconds.
//
// Bound. At stage 6's shapes (B 20, k 4, P 45, C 32) a step moves about
// 0.21 MB: the (P, C, C) cache and its margins read once for the
// statistics, the winners' k x P cells written, 0.06 us at 3.35 TB/s; its
// 46,080 cells' logarithms are some 1.2 MFLOP. Neither bounds it: it is bound by latency, a launch and a chain of
// dependent phases. The design keeps every phase in one CTA of 1024 threads,
// the phases separated by __syncthreads() alone: the candidates' ids travel
// in the launch's parameters (no copy before it), a warp scores one
// candidate with its lanes over the pairs, every thread ranks one score
// against all of them in shared memory, a thread folds one (winner, pair),
// and a warp recomputes one pair's statistics; the output is copied back in
// the same call. Nothing uses atomics, so two launches on the same inputs
// give the same bytes.
//
// Order of operations. Every float operation is an explicit round-to-
// nearest intrinsic, so nvcc fuses none into an FMA and the elementwise
// arithmetic is the eager chain's, operation for operation, with logf as
// PyTorch's log. Sums are taken in a fixed order of their own (a lane's
// pairs or cells in order, then a butterfly over the warp's lanes), which
// differs from PyTorch's reductions only in rounding. The folded counts are
// exact integers, so N, a, b and n come out bit for bit as the eager chain's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int WARPS = NT / 32;
constexpr int MAX_B = 512;  // candidates a step: their ids fill 2 KB of the parameters
constexpr float EPS = 2.220446049250313e-16f;  // float64's eps, the weights' clamp

struct Ids {
  int v[MAX_B];
};

struct Args {
  const int2* pairs;  // (V, P): each candidate's two cluster ids a pair
  float* N;           // (P, C, C), folded in place
  float* a;           // (P, C): N summed over its first cluster axis
  float* b;           // (P, C): N summed over its second
  float* n;           // (P,)
  float* nlogn;       // (P,) statistics, recomputed in place
  float* aloga;
  float* blogb;
  const float* w;     // (P,) pair weights, or null for the plain mean
  int* out;           // k indices, then the k scores' bits
  int B, valid, k, P, C;
};

__device__ __forceinline__ float xlogx(float x) { return __fmul_rn(x, logf(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Candidate i (score x) comes before candidate j (score y): the larger
// score, NaN largest (torch.sort's descending order), then the lower index.
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool xn = isnan(x), yn = isnan(y);
  if (xn != yn) return xn;
  if (!xn && x != y) return x > y;
  return i < j;
}

// One pair's change of an x log x sum when its entry x grows by one.
__device__ __forceinline__ float bumped(float sum, float x) {
  return __fadd_rn(__fsub_rn(sum, xlogx(x)), xlogx(__fadd_rn(x, 1.f)));
}

__global__ void __launch_bounds__(NT, 1) batch_mi_step_kernel(const Args g, const Ids ids) {
  __shared__ float score[MAX_B];
  __shared__ int top[MAX_B];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = g.C, P = g.P;

  // 1. score: a warp a candidate, its lanes over the pairs
  float denom = (float)P;
  if (g.w) {  // every warp sums the weights in the same order
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s = __fadd_rn(s, g.w[p]);
    denom = fmaxf(warp_sum(s), EPS);
  }
  for (int j = warp; j < g.B; j += WARPS) {
    float acc = 0.f;
    if (j < g.valid) {
      const size_t row = (size_t)ids.v[j] * P;
      for (int p = lane; p < P; p += 32) {
        const int2 c = g.pairs[row + p];
        const float n_new = __fadd_rn(g.n[p], 1.f);
        const float s_n = bumped(g.nlogn[p], g.N[((size_t)p * C + c.x) * C + c.y]);
        const float s_a = bumped(g.aloga[p], g.a[p * C + c.y]);
        const float s_b = bumped(g.blogb[p], g.b[p * C + c.x]);
        const float s = __fadd_rn(
            __fsub_rn(__fsub_rn(__fdiv_rn(s_n, n_new), __fdiv_rn(s_a, n_new)),
                      __fdiv_rn(s_b, n_new)),
            logf(n_new));
        acc = __fadd_rn(acc, g.w ? __fmul_rn(s, g.w[p]) : s);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) score[j] = j < g.valid ? __fdiv_rn(acc, denom) : -INFINITY;
  }
  __syncthreads();

  // 2. top-k: each score's rank among all of them
  for (int j = threadIdx.x; j < g.B; j += NT) {
    const float s = score[j];
    int rank = 0;
    for (int i = 0; i < g.B; ++i) rank += before(score[i], i, s, j);
    if (rank < g.k) top[rank] = j;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < g.k; r += NT) {
    g.out[r] = top[r];
    g.out[g.k + r] = __float_as_int(score[top[r]]);
  }

  // 3. fold: thread (winner r, pair p) adds the count of the valid winners
  // that share its cell, where r is the first of them
  int folded = 0;
  for (int r = 0; r < g.k; ++r) folded += top[r] < g.valid;
  for (int p = threadIdx.x; p < P; p += NT) g.n[p] = __fadd_rn(g.n[p], (float)folded);
  for (int t = threadIdx.x; t < g.k * P; t += NT) {
    const int r = t / P, p = t - r * P;
    if (top[r] >= g.valid) continue;
    const int2 c = g.pairs[(size_t)ids.v[top[r]] * P + p];
    bool first_n = true, first_a = true, first_b = true;
    int dn = 0, da = 0, db = 0;
    for (int q = 0; q < g.k; ++q) {
      if (top[q] >= g.valid) continue;
      const int2 o = g.pairs[(size_t)ids.v[top[q]] * P + p];
      const bool sn = o.x == c.x && o.y == c.y, sa = o.y == c.y, sb = o.x == c.x;
      if (q < r) {
        first_n &= !sn;
        first_a &= !sa;
        first_b &= !sb;
      } else {
        dn += sn;
        da += sa;
        db += sb;
      }
    }
    if (first_n) {
      float* cell = g.N + ((size_t)p * C + c.x) * C + c.y;
      *cell = __fadd_rn(*cell, (float)dn);
    }
    if (first_a) g.a[p * C + c.y] = __fadd_rn(g.a[p * C + c.y], (float)da);
    if (first_b) g.b[p * C + c.x] = __fadd_rn(g.b[p * C + c.x], (float)db);
  }
  __syncthreads();

  // 4. statistics over the updated cache: a warp a pair
  const int cells = C * C;
  for (int p = warp; p < P; p += WARPS) {
    const float* np_ = g.N + (size_t)p * cells;
    float sn = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll 4
    for (int i = lane; i < cells; i += 32) sn = __fadd_rn(sn, xlogx(np_[i]));
    for (int i = lane; i < C; i += 32) {
      sa = __fadd_rn(sa, xlogx(g.a[p * C + i]));
      sb = __fadd_rn(sb, xlogx(g.b[p * C + i]));
    }
    sn = warp_sum(sn);
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      g.nlogn[p] = sn;
      g.aloga[p] = sa;
      g.blogb[p] = sb;
    }
  }
}

}  // namespace

// pairs (V, P, 2) int32; ids: host array of B int64 in [0, V), the first
// `valid` of them real; N, a, b, n, nlogn, aloga, blogb: the float32 cache
// and statistics, updated in place; w: (P,) float32 or null; out: 2k int32
// on the device; out_host: pinned host memory for a copy of out, or null.
// All contiguous on the current device. Returns a cudaError_t.
extern "C" int batch_mi_step(const void* pairs, const int64_t* ids, long long V, int B, int valid,
                             int k, int P, int C, void* N, void* a, void* b, void* n, void* nlogn,
                             void* aloga, void* blogb, const void* w, void* out, void* out_host,
                             void* stream) {
  if (B < 1 || B > MAX_B || valid < 1 || valid > B || k < 1 || k > B || P < 1 || C < 1 ||
      V < 1 || V > INT32_MAX || (long long)P * C * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Ids h;
  for (int j = 0; j < B; ++j) {
    if (ids[j] < 0 || ids[j] >= V) return (int)cudaErrorInvalidValue;
    h.v[j] = (int)ids[j];
  }
  const Args g{(const int2*)pairs, (float*)N,     (float*)a,     (float*)b,
               (float*)n,          (float*)nlogn, (float*)aloga, (float*)blogb,
               (const float*)w,    (int*)out,     B,             valid,
               k,                  P,             C};
  const cudaStream_t s = (cudaStream_t)stream;
  batch_mi_step_kernel<<<1, NT, 0, s>>>(g, h);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && out_host)
    err = cudaMemcpyAsync(out_host, out, sizeof(int) * 2 * k, cudaMemcpyDeviceToHost, s);
  return (int)err;
}
