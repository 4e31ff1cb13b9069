// One ResNet bottleneck block with BN folded, on folded frames (NHWC).
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
// Design. The Pallas kernel holds a whole frame in VMEM (up to 100 MB
// scoped); a 64x64 frame is 1.3 MB at Cin 80 and 4.2 MB at 256 channels in
// fp32, far above the 227 KB of shared memory a Hopper block can use. So
// each CTA (8 warps) owns one spatial output tile (TH x TW pixels, all Cout
// channels; 8 x 16 at stride 1) of one frame and runs the block's products
// as GEMMs on the tensor cores. Each product stages x and its weights in
// shared memory by cp.async, step by step (16 input channels for a, one tap
// for b, 32 channels for c), into two buffers, so the next step's copy is in
// flight while this step's products run:
//   1. a on the tile's input region plus a 1-pixel halo (10 x 18 for an
//      8 x 16 tile; the halo that neighbouring tiles also compute is
//      recomputed, 1.41x the tile's work): M = region pixels (rounded up
//      to 48), N = Ci, K = Cin (zero-padded to a multiple of KA). a is
//      zero outside the frame, which is the 3x3 conv's 'same' padding;
//   2. b on the tile as an implicit GEMM over the 9 taps: M = tile pixels,
//      N = Ci, K = 9 Ci, the A fragment read from a at each pixel's region
//      row shifted by the tap;
//   3. y = b . cw (+ x[::s, ::s] . pw for the projection): M = tile pixels,
//      N = Cout, K = Ci (+ Cin), then the shortcut, biases and ReLU, written
//      out. Pixels past a ragged frame edge are computed and not stored.
// a and b stay in shared memory between products, pixel-major; b
// overwrites a once every warp is done with it.
//
// 3xTF32. Each fp32 operand v is split in registers into
// big = tf32(v) and small = tf32(v - big), rounded as cvt.rna rounds
// (to nearest, ties away from zero; see tf32_rna), and each product
// A.B is issued as three mma.sync.m16n8k8 TF32 products, small.big,
// big.small and then big.big, into one fp32 accumulator: the small terms
// first, so their rounding stays below the large term. The dropped
// small.small term is about 2^-22 of the product, which keeps the result
// near fp32 (one TF32 product alone keeps about 2^-11).
// Fragment layout of m16n8k8 (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// Here k slot t carries input channel 2t and slot t+4 channel 2t+1, in A
// and B alike, which leaves the product as it is and makes (a0, a2) and
// (a1, a3) one 8-byte load each.
// ACCUMULATION. The tensor cores round their fp32 sums toward zero, so
// each MMA into a large accumulator drops up to an ulp of it, always the
// same way. Over product b's 216 MMAs into one total that bias reached
// 3e-6 of the output's max, so each tap of b sums into its own
// accumulator, added to the total with an fp32 add.
// A rows are pixels with a row stride of 8 (mod 16) words, so a half
// warp's 8-byte A loads cover the 32 banks once; B rows are input channels
// with a row stride of 4 (mod 16) words, so the b0 loads (rows 2t) and the
// b1 loads (rows 2t+1) each fall on 32 different banks.
//
// Bound on an H100 SXM at the main path's shape (SlowFast s2_slow at 256^2
// input: 32 frames of 64x64, Cin 80 -> 256, inner 64, 3 blocks): 57.15
// GFLOP, issued three times in 3xTF32, is 0.347 ms at the 495 TFLOP/s of
// dense TF32; the one launch a block design moves about 0.71 GB through
// device memory (x, three block outputs written, two read back), 0.21 ms
// at 3.35 TB/s. So it is bound by operations. mma.sync TF32 itself runs at
// 323 TFLOP/s on an H100 80GB HBM3 at 700 W (ablate_k2.py), which puts
// this design's floor for its 189.7 GFLOP of MMAs (halo and padding
// included) at 0.59 ms. Later work: one launch for the whole stage
// (3-pixel halo), which drops the 0.54 GB that goes between blocks; wgmma
// in place of mma.sync; TMA-fed staging.
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256             // threads per CTA
#define NWARP (NT / 32)
#define KA 16              // input channels a step of product a stages
#define KC 32              // input channels a step of product c stages
#define MAXR 4             // staged x rows a thread owns: NAM, NQ <= 256

extern __shared__ float smem[];

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  // 16 bytes global -> shared; with ok false nothing is read and zeros land
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// rows [k0, k0+rows) and columns [c0, c0+ncols) of a row-major (K, N) weight
// matrix into smem[wo + kk * (ncols + 4) + c], zero past K
__device__ __forceinline__ void stage_w(int wo, const float* w, int N, int k0, int K,
                                        int c0, int ncols, int rows) {
  const int n4 = ncols / 4, ldw = ncols + 4;
  for (int i = threadIdx.x; i < rows * n4; i += NT) {
    const int kk = i / n4, c = (i % n4) * 4;
    const bool ok = k0 + kk < K;
    cp16(smem + wo + kk * ldw + c, ok ? w + (size_t)(k0 + kk) * N + c0 + c : w, ok);
  }
}

// Runs steps 0..n-1 of a product: stage(k, buf) issues the cp.async copies
// of step k into buffer buf, compute(k, buf) uses them. Step k+1 is in
// flight while step k is computed. Ends on a barrier, so the buffers and
// anything the product read are free afterwards.
template <class Stage, class Compute>
__device__ __forceinline__ void pipeline(int n, Stage stage, Compute compute) {
  stage(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      stage(k + 1, (k + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();
  }
}

// cvt.rna.tf32.f32 for any finite v, in two integer instructions: add half
// a TF32 ulp to the magnitude bits and clear the 13 bits TF32 drops. (The
// cvt itself compiles to a longer sequence that also sorts out NaN and Inf.)
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

// One k8 step of a warp's (16 MT) x (8 NT8) output tile in 3xTF32.
// ao[i][h]: smem offset of A row g + 8h of m-tile i, at this step's first
// column; wo: smem offset of B row 0 (input channel k) at the tile's first
// output column, rows ldw apart.
template <int MT, int NT8>
__device__ __forceinline__ void mma_k8(float (&acc)[MT][NT8][4], const int (&ao)[MT][2],
                                       int wo, int ldw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ab[MT][4], as[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float2 lo = *reinterpret_cast<const float2*>(smem + ao[i][0] + 2 * t);
    const float2 hi = *reinterpret_cast<const float2*>(smem + ao[i][1] + 2 * t);
    split(lo.x, ab[i][0], as[i][0]);
    split(hi.x, ab[i][1], as[i][1]);
    split(lo.y, ab[i][2], as[i][2]);
    split(hi.y, ab[i][3], as[i][3]);
  }
  // each of the three products for two n-tiles in a row, so that an MMA
  // seldom waits on the one before it for its accumulator
  static_assert(NT8 % 2 == 0, "n-tiles go in pairs");
#pragma unroll
  for (int j0 = 0; j0 < NT8; j0 += 2) {
    uint32_t bb[2][2], bs[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      split(smem[wo + 2 * t * ldw + 8 * (j0 + jj) + g], bb[jj][0], bs[jj][0]);
      split(smem[wo + (2 * t + 1) * ldw + 8 * (j0 + jj) + g], bb[jj][1], bs[jj][1]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j0 + jj], as[i], bb[jj]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j0 + jj], ab[i], bs[jj]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j0 + jj], ab[i], bb[jj]);
  }
}

// KD columns of the (16 MT)-row A block whose row offsets are ao, from
// column ka, against KD staged weight rows at wo (row stride ldw)
template <int MT, int NT8, int KD>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT8][4], const int (&ao)[MT][2],
                                          int ka, int wo, int ldw, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; kk += 8) {
    int a[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i][0] = ao[i][0] + ka + kk;
      a[i][1] = ao[i][1] + ka + kk;
    }
    mma_k8<MT, NT8>(acc, a, wo + kk * ldw, ldw, lane);
  }
}

__global__ void __launch_bounds__(NT, 2) bottleneck_block_kernel(
    const float* __restrict__ x, int H, int W, int Cin,
    const float* __restrict__ aw, const float* __restrict__ ab,
    const float* __restrict__ bw, const float* __restrict__ bb,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ pw, const float* __restrict__ pb,
    int Ci, int Cout, int s, int TH, int TW,
    float* __restrict__ out, int Ho, int Wo) {
  const int frame = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int AH = (TH - 1) * s + 3, AW = (TW - 1) * s + 3;  // region + halo
  const int ry0 = oy0 * s - 1, rx0 = ox0 * s - 1;          // region origin
  const int NA = AH * AW, NAM = (NA + 47) / 48 * 48, NQ = TH * TW;
  const int SA = Ci + 8;                    // a and b row stride, 8 mod 16
  constexpr int SXA = KA + 8, SX = KC + 8;  // staged x row strides, 8 mod 16
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* xn = x + (size_t)frame * H * W * Cin;

  // shared memory, by phase (offsets in floats); each product stages its
  // steps into two buffers, one filling while the other is computed on:
  //   a: aS (NAM x SA) at 0; 2 x [x (NAM x SXA), aw rows (KA x Ci+4)] after
  //   b: aS; 2 x [one tap of bw (Ci x Ci+4)] after it; then bS (NQ x SA) over aS
  //   c: bS; 2 x [x (NQ x SX), cw or pw rows (KC x ncols+4)] after it
  const int A_END = NAM * SA;
  float* aS = smem;
  float* bS = smem;

  // 1. a = relu(x . aw + ab) on the region's NAM rows, on the tensor cores.
  // A warp owns 48 region pixels x 32 channels.
  {
    const int mg = NAM / 48, items = mg * (Ci / 32), ldw = Ci + 4;
    const int stage_sz = NAM * SXA + KA * ldw, steps = (Cin + KA - 1) / KA;
    int xoff[MAXR];  // x offset of each staged row this thread copies, or -1
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int p = (tid + r * NT) / (KA / 4);
      const int yy = ry0 + p / AW, xx = rx0 + p % AW;
      xoff[r] = (p < NA && yy >= 0 && yy < H && xx >= 0 && xx < W)
                    ? (yy * W + xx) * Cin : -1;
    }
    for (int r0 = 0; r0 < items; r0 += NWARP) {
      const int item = r0 + warp;
      const bool live = item < items;
      const int m0 = (item % mg) * 48, n0 = (item / mg) * 32;
      float acc[3][4][4] = {};
      auto stage = [&](int k, int buf) {
        const int so = A_END + buf * stage_sz, k0 = k * KA;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const int i = tid + r * NT, p = i / (KA / 4), c = (i % (KA / 4)) * 4;
          if (p >= NAM) break;
          const bool ok = xoff[r] >= 0 && k0 + c < Cin;
          cp16(smem + so + p * SXA + c, ok ? xn + xoff[r] + k0 + c : xn, ok);
        }
        stage_w(so + NAM * SXA, aw, Ci, k0, Cin, 0, Ci, KA);
      };
      auto compute = [&](int k, int buf) {
        if (!live) return;
        const int so = A_END + buf * stage_sz;
        int ao[3][2];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) ao[i][h] = so + (m0 + 16 * i + 8 * h + g) * SXA;
        mma_chunk<3, 4, KA>(acc, ao, 0, so + NAM * SXA + n0, ldw, lane);
      };
      pipeline(steps, stage, compute);
      if (live) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m0 + 16 * i + 8 * h + g;
            const int yy = ry0 + p / AW, xx = rx0 + p % AW;
            const bool inside = p < NA && yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = n0 + 8 * j + 2 * t;
              const float2 bias = __ldg(reinterpret_cast<const float2*>(ab + n));
              float2 v = make_float2(0.f, 0.f);
              if (inside) {
                v.x = fmaxf(acc[i][j][2 * h] + bias.x, 0.f);
                v.y = fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f);
              }
              *reinterpret_cast<float2*>(aS + p * SA + n) = v;
            }
          }
      }
    }
  }

  // 2. b = relu(conv3x3(a, stride s) + bb) on the tile, on the tensor cores,
  // as an implicit GEMM over the 9 taps (K = 9 Ci): tap (dy, dx) reads the
  // A fragment from a at the region row of each output pixel plus
  // dy * AW + dx. A warp owns 32 output pixels x 32 channels; the launcher
  // admits at most one item a warp, so b can overwrite a when all are done.
  {
    const int mg = NQ / 32, items = mg * (Ci / 32), ldw = Ci + 4, stage_sz = Ci * ldw;
    const bool live = warp < items;
    const int m0 = (warp % mg) * 32, n0 = (warp / mg) * 32;
    float acc[2][4][4] = {};
    int base[2][2];  // smem offset of each A row's tap (0, 0) in a
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m0 + 16 * i + 8 * h + g;
        base[i][h] = ((s * (q / TW)) * AW + s * (q % TW)) * SA;
      }
    auto stage = [&](int tap, int buf) {
      stage_w(A_END + buf * stage_sz, bw + (size_t)tap * Ci * Ci, Ci, 0, Ci, 0, Ci, Ci);
    };
    auto compute = [&](int tap, int buf) {
      if (!live) return;
      const int off = ((tap / 3) * AW + tap % 3) * SA, wo = A_END + buf * stage_sz + n0;
      int ao[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) ao[i][h] = base[i][h] + off;
      float part[2][4][4] = {};  // this tap's sum, see ACCUMULATION
      for (int k0 = 0; k0 < Ci; k0 += KC)
        mma_chunk<2, 4, KC>(part, ao, k0, wo + k0 * ldw, ldw, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    };
    pipeline(9, stage, compute);  // its last barrier: every warp is done with a
    if (live) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = m0 + 16 * i + 8 * h + g;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 8 * j + 2 * t;
            const float2 bias = __ldg(reinterpret_cast<const float2*>(bb + n));
            float2 v;
            v.x = fmaxf(acc[i][j][2 * h] + bias.x, 0.f);
            v.y = fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f);
            *reinterpret_cast<float2*>(bS + q * SA + n) = v;
          }
        }
    }
  }

  // 3. y = relu(b . cw (+ x[::s, ::s] . pw) + cb (+ pb | x)) on the tensor
  // cores. A warp owns 32 pixels x 32 channels. A round takes as many whole
  // 32-channel groups as there are warps for, stages only their weight
  // columns, and runs the steps of b . cw and then those of the projection.
  {
    const int mg = NQ / 32, groups = Cout / 32, gpr = NWARP / mg > 1 ? NWARP / mg : 1;
    const int csteps = Ci / KC, steps = csteps + (pw != nullptr ? (Cin + KC - 1) / KC : 0);
    int xoff[MAXR];  // x offset of each staged tile pixel this thread copies, or -1
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int q = (tid + r * NT) / (KC / 4);
      const int yy = s * (oy0 + q / TW), xx = s * (ox0 + q % TW);
      xoff[r] = (q < NQ && yy < H && xx < W) ? (yy * W + xx) * Cin : -1;
    }
    for (int g0 = 0; g0 < groups; g0 += gpr) {
      const int ng = groups - g0 < gpr ? groups - g0 : gpr;
      const int c0 = g0 * 32, ncols = ng * 32, ldw = ncols + 4;
      const int stage_sz = NQ * SX + KC * ldw;
      const bool live = warp < mg * ng;
      const int m0 = (warp % mg) * 32, n0 = (warp / mg) * 32;  // n0 from c0
      float acc[2][4][4] = {};
      auto stage = [&](int k, int buf) {
        const int so = NQ * SA + buf * stage_sz;
        if (k < csteps) {
          stage_w(so + NQ * SX, cw, Cout, k * KC, Ci, c0, ncols, KC);
          return;
        }
        const int k0 = (k - csteps) * KC;
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const int i = tid + r * NT, q = i / (KC / 4), c = (i % (KC / 4)) * 4;
          if (q >= NQ) break;
          const bool ok = xoff[r] >= 0 && k0 + c < Cin;
          cp16(smem + so + q * SX + c, ok ? xn + xoff[r] + k0 + c : xn, ok);
        }
        stage_w(so + NQ * SX, pw, Cout, k0, Cin, c0, ncols, KC);
      };
      auto compute = [&](int k, int buf) {
        if (!live) return;
        const int so = NQ * SA + buf * stage_sz, wo = so + NQ * SX + n0;
        const bool on_b = k < csteps;
        int ao[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = m0 + 16 * i + 8 * h + g;
            ao[i][h] = on_b ? q * SA + k * KC : so + q * SX;
          }
        mma_chunk<2, 4, KC>(acc, ao, 0, wo, ldw, lane);
      };
      pipeline(steps, stage, compute);
      if (live) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = m0 + 16 * i + 8 * h + g, oy = oy0 + q / TW, ox = ox0 + q % TW;
            if (oy >= Ho || ox >= Wo) continue;
            const float* xq = xn + ((size_t)(s * oy) * W + s * ox) * Cin;  // identity
            float* dst = out + (((size_t)frame * Ho + oy) * Wo + ox) * Cout;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = c0 + n0 + 8 * j + 2 * t;
              const float2 bias = __ldg(reinterpret_cast<const float2*>(cb + n));
              const float2 sc = __ldg(reinterpret_cast<const float2*>(
                  pw != nullptr ? pb + n : xq + n));
              float2 v;
              v.x = fmaxf(acc[i][j][2 * h] + bias.x + sc.x, 0.f);
              v.y = fmaxf(acc[i][j][2 * h + 1] + bias.y + sc.y, 0.f);
              *reinterpret_cast<float2*>(dst + n) = v;
            }
          }
      }
    }
  }
}

static size_t bottleneck_block_smem(int Ci, int Cout, int s, int TH, int TW) {
  const int na = ((TH - 1) * s + 3) * ((TW - 1) * s + 3);
  const int nam = (na + 47) / 48 * 48, nq = TH * TW, mg = nq / 32;
  const int gpr = NWARP / mg > 1 ? NWARP / mg : 1;
  const int ncols = 32 * (Cout / 32 < gpr ? Cout / 32 : gpr);
  const int a_end = nam * (Ci + 8);
  const int phase_a = a_end + 2 * (nam * (KA + 8) + KA * (Ci + 4));
  const int phase_b = a_end + 2 * Ci * (Ci + 4);
  const int phase_c = nq * (Ci + 8) + 2 * (nq * (KC + 8) + KC * (ncols + 4));
  int most = phase_a > phase_b ? phase_a : phase_b;
  most = most > phase_c ? most : phase_c;
  return sizeof(float) * (size_t)most;
}

extern "C" int bottleneck_block(
    const void* x, int N, int H, int W, int Cin, const void* aw, const void* ab,
    const void* bw, const void* bb, const void* cw, const void* cb,
    const void* pw, const void* pb, int Ci, int Cout, int s, int TH, int TW,
    void* out, void* stream) {
  const int nam = (((TH - 1) * s + 3) * ((TW - 1) * s + 3) + 47) / 48 * 48;
  if (Cin % 4 || Ci % KC || Cout % 32 || H % s || W % s || (TH * TW) % 32 ||
      (TH * TW / 32) * (Ci / 32) > NWARP || nam * (KA / 4) > MAXR * NT ||
      TH * TW * (KC / 4) > MAXR * NT)
    return (int)cudaErrorInvalidValue;
  if (pw == nullptr && (Cin != Cout || s != 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = bottleneck_block_smem(Ci, Cout, s, TH, TW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bottleneck_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int Ho = H / s, Wo = W / s;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, N);
  bottleneck_block_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, H, W, Cin, (const float*)aw, (const float*)ab,
      (const float*)bw, (const float*)bb, (const float*)cw, (const float*)cb,
      (const float*)pw, (const float*)pb, Ci, Cout, s, TH, TW, (float*)out, Ho, Wo);
  return (int)cudaGetLastError();
}
