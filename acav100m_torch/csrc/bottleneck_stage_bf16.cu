// One ResNet bottleneck block with BN folded, on folded frames (NHWC), in
// bfloat16: the bf16 form of kernel K2.
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
// Design. The tiling is the float32 form's (bottleneck_stage.cu): each CTA
// (8 warps) owns one spatial output tile (TH x TW pixels, all Cout
// channels; 8 x 16 at stride 1, 4 x 8 at stride 2) of one frame and runs the
// block's three products as GEMMs on the tensor cores, staging x and the
// weights in shared memory by cp.async, step by step, into two buffers:
//   1. a on the tile's input region plus a 1-pixel halo (rounded up to 48
//      rows), K = Cin in steps of KA; zero outside the frame, which is the
//      3x3 conv's 'same' padding;
//   2. b on the tile as an implicit GEMM over the 9 taps, one tap of bw a
//      step, the A rows read from a at each pixel's region row shifted by
//      the tap;
//   3. y = b . cw (+ x[::s, ::s] . pw) in steps of KC channels, then the
//      biases, the shortcut and ReLU in f32, rounded to bf16 and stored.
// a and b stay in shared memory, in bf16, as the TPU kernel keeps them in
// the compute dtype; b overwrites a once every warp is done with it.
//
// Products. Each k16 step of a warp tile is one
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 x 8 output
// tile, accumulating in f32: the operands are bf16 already, so nothing is
// split (the float32 form issues three TF32 products for each). Fragments
// come from shared memory by ldmatrix: A (16 x 16, rows pixels, columns
// input channels) by .x4, each lane giving the address of one 16-byte row
// piece; B from the row-major (K, N) weights by .x4.trans, which hands each
// lane the (k, k+1) pairs of one column that the B fragment holds, for two
// 8-column tiles at once. ldmatrix reads 8 rows of 16 bytes a phase, so
// every shared-memory row stride here is an odd number of 16-byte units
// (Ci + 8 = 72, KA + 8 = 24, KC + 8 = 40, ncols + 8 = 72 bf16 values),
// which puts the 8 rows on 8 different groups of 4 banks. Stride 2 reads
// every other region row in product b, which costs 2-way conflicts there.
//
// Bound on an H100 SXM at the main path's shape (SlowFast s2_slow at 256^2
// input: 32 frames of 64x64, Cin 80 -> 256, inner 64, 3 blocks): 57.15
// GFLOP is 0.058 ms at the 989 TFLOP/s of dense bf16; x in and y out are
// 21 + 67 = 88 MB, 0.026 ms at 3.35 TB/s. So the stage is bound by
// operations. This design also moves the two block outputs between blocks
// through device memory (another 0.27 GB) and recomputes the halo of a.
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256             // threads per CTA
#define NWARP (NT / 32)
#define KA 16              // input channels a step of product a stages
#define KC 32              // input channels a step of product c stages
#define MAXR 4             // staged 16-byte x pieces a thread owns: NAM, NQ <= 512

typedef uint16_t bf16_t;   // bf16 bits; arithmetic is in f32

extern __shared__ __align__(16) bf16_t smem[];

__device__ __forceinline__ void cp16(bf16_t* dst, const bf16_t* src, bool ok) {
  // 16 bytes global -> shared; with ok false nothing is read and zeros land
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// rows [k0, k0+rows) and columns [c0, c0+ncols) of a row-major (K, N) bf16
// weight matrix into smem[wo + kk * (ncols + 8) + c], zero past K
__device__ __forceinline__ void stage_w(int wo, const bf16_t* w, int N, int k0, int K,
                                        int c0, int ncols, int rows) {
  const int n8 = ncols / 8, ldw = ncols + 8;
  for (int i = threadIdx.x; i < rows * n8; i += NT) {
    const int kk = i / n8, c = (i % n8) * 8;
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KD columns of a warp's (16 MT) x (8 NT8) output tile, k16 step by step.
// arow[i]: smem offset of the row this lane addresses for m-tile i's A
// fragments (row lr of the m-tile, see below), at the first column plus lc;
// brow: smem offset of B row lr (input channel k) at the tile's first output
// column plus lc, rows ldw apart.
template <int MT, int NT8, int KD>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT8][4], const int (&arow)[MT],
                                          int brow, int ldw) {
  static_assert(NT8 % 2 == 0, "B fragments load two n-tiles at a time");
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(a[i], smem + arow[i] + kk);
#pragma unroll
    for (int j = 0; j < NT8; j += 2) {
      uint32_t b[4];  // b[0], b[1]: n-tile j; b[2], b[3]: n-tile j + 1
      ldsm_x4_trans(b, smem + brow + kk * ldw + 8 * j);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // round to nearest even, as torch's .to(torch.bfloat16) and XLA's convert
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__global__ void __launch_bounds__(NT, 2) bottleneck_block_bf16_kernel(
    const bf16_t* __restrict__ x, int H, int W, int Cin,
    const bf16_t* __restrict__ aw, const float* __restrict__ ab,
    const bf16_t* __restrict__ bw, const float* __restrict__ bb,
    const bf16_t* __restrict__ cw, const float* __restrict__ cb,
    const bf16_t* __restrict__ pw, const float* __restrict__ pb,
    int Ci, int Cout, int s, int TH, int TW,
    bf16_t* __restrict__ out, int Ho, int Wo) {
  const int frame = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int AH = (TH - 1) * s + 3, AW = (TW - 1) * s + 3;  // region + halo
  const int ry0 = oy0 * s - 1, rx0 = ox0 * s - 1;          // region origin
  const int NA = AH * AW, NAM = (NA + 47) / 48 * 48, NQ = TH * TW;
  const int SA = Ci + 8;                    // a and b row stride
  constexpr int SXA = KA + 8, SX = KC + 8;  // staged x row strides
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // the row (lr) and 8-column half (lc) of a 16 x 16 fragment block whose
  // address this lane gives ldmatrix .x4: lanes 0-7 rows 0-7, 8-15 rows
  // 8-15, each at column 0; lanes 16-31 the same rows at column 8
  const int lr = (lane & 7) + (lane & 8), lc = (lane >> 4) * 8;
  const bf16_t* xn = x + (size_t)frame * H * W * Cin;

  // shared memory, by phase (offsets in bf16 values); each product stages
  // its steps into two buffers, one filling while the other is computed on:
  //   a: aS (NAM x SA) at 0; 2 x [x (NAM x SXA), aw rows (KA x Ci+8)] after
  //   b: aS; 2 x [one tap of bw (Ci x Ci+8)] after it; then bS (NQ x SA) over aS
  //   c: bS; 2 x [x (NQ x SX), cw or pw rows (KC x ncols+8)] after it
  const int A_END = NAM * SA;
  bf16_t* aS = smem;
  bf16_t* bS = smem;

  // 1. a = bf16(relu(x . aw + ab)) on the region's NAM rows. A warp owns 48
  // region pixels x 32 channels.
  {
    const int mg = NAM / 48, items = mg * (Ci / 32), ldw = Ci + 8;
    const int stage_sz = NAM * SXA + KA * ldw, steps = (Cin + KA - 1) / KA;
    int xoff[MAXR];  // x offset of each staged row this thread copies, or -1
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int p = (tid + r * NT) / (KA / 8);
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
          const int i = tid + r * NT, p = i / (KA / 8), c = (i % (KA / 8)) * 8;
          if (p >= NAM) break;
          const bool ok = xoff[r] >= 0 && k0 + c < Cin;
          cp16(smem + so + p * SXA + c, ok ? xn + xoff[r] + k0 + c : xn, ok);
        }
        stage_w(so + NAM * SXA, aw, Ci, k0, Cin, 0, Ci, KA);
      };
      auto compute = [&](int k, int buf) {
        if (!live) return;
        const int so = A_END + buf * stage_sz;
        int arow[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) arow[i] = so + (m0 + 16 * i + lr) * SXA + lc;
        mma_chunk<3, 4, KA>(acc, arow, so + NAM * SXA + lr * ldw + n0 + lc, ldw);
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
              uint32_t v = 0u;
              if (inside)
                v = pack_bf16(fmaxf(acc[i][j][2 * h] + bias.x, 0.f),
                              fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f));
              *reinterpret_cast<uint32_t*>(aS + p * SA + n) = v;
            }
          }
      }
    }
  }

  // 2. b = bf16(relu(conv3x3(a, stride s) + bb)) on the tile, as an implicit
  // GEMM over the 9 taps (K = 9 Ci): tap (dy, dx) reads the A rows from a at
  // the region row of each output pixel plus dy * AW + dx. A warp owns 32
  // output pixels x 32 channels; the launcher admits at most one item a
  // warp, so b can overwrite a when all are done.
  {
    const int mg = NQ / 32, items = mg * (Ci / 32), ldw = Ci + 8, stage_sz = Ci * ldw;
    const bool live = warp < items;
    const int m0 = (warp % mg) * 32, n0 = (warp / mg) * 32;
    float acc[2][4][4] = {};
    int base[2];  // smem offset of this lane's A row at tap (0, 0), plus lc
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = m0 + 16 * i + lr;
      base[i] = ((s * (q / TW)) * AW + s * (q % TW)) * SA + lc;
    }
    auto stage = [&](int tap, int buf) {
      stage_w(A_END + buf * stage_sz, bw + (size_t)tap * Ci * Ci, Ci, 0, Ci, 0, Ci, Ci);
    };
    auto compute = [&](int tap, int buf) {
      if (!live) return;
      const int off = ((tap / 3) * AW + tap % 3) * SA;
      const int brow = A_END + buf * stage_sz + lr * ldw + n0 + lc;
      int arow[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) arow[i] = base[i] + off;
      for (int k0 = 0; k0 < Ci; k0 += KC) {
        int ak[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) ak[i] = arow[i] + k0;
        mma_chunk<2, 4, KC>(acc, ak, brow + k0 * ldw, ldw);
      }
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
            *reinterpret_cast<uint32_t*>(bS + q * SA + n) =
                pack_bf16(fmaxf(acc[i][j][2 * h] + bias.x, 0.f),
                          fmaxf(acc[i][j][2 * h + 1] + bias.y, 0.f));
          }
        }
    }
  }

  // 3. y = bf16(relu(b . cw (+ x[::s, ::s] . pw) + cb (+ pb | f32(x)))). A
  // warp owns 32 pixels x 32 channels. A round takes as many whole
  // 32-channel groups as there are warps for, stages only their weight
  // columns, and runs the steps of b . cw and then those of the projection
  // into the same f32 sums.
  {
    const int mg = NQ / 32, groups = Cout / 32, gpr = NWARP / mg > 1 ? NWARP / mg : 1;
    const int csteps = Ci / KC, steps = csteps + (pw != nullptr ? (Cin + KC - 1) / KC : 0);
    int xoff[MAXR];  // x offset of each staged tile pixel this thread copies, or -1
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int q = (tid + r * NT) / (KC / 8);
      const int yy = s * (oy0 + q / TW), xx = s * (ox0 + q % TW);
      xoff[r] = (q < NQ && yy < H && xx < W) ? (yy * W + xx) * Cin : -1;
    }
    for (int g0 = 0; g0 < groups; g0 += gpr) {
      const int ng = groups - g0 < gpr ? groups - g0 : gpr;
      const int c0 = g0 * 32, ncols = ng * 32, ldw = ncols + 8;
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
          const int i = tid + r * NT, q = i / (KC / 8), c = (i % (KC / 8)) * 8;
          if (q >= NQ) break;
          const bool ok = xoff[r] >= 0 && k0 + c < Cin;
          cp16(smem + so + q * SX + c, ok ? xn + xoff[r] + k0 + c : xn, ok);
        }
        stage_w(so + NQ * SX, pw, Cout, k0, Cin, c0, ncols, KC);
      };
      auto compute = [&](int k, int buf) {
        if (!live) return;
        const int so = NQ * SA + buf * stage_sz;
        const bool on_b = k < csteps;
        int arow[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = m0 + 16 * i + lr;
          arow[i] = (on_b ? q * SA + k * KC : so + q * SX) + lc;
        }
        mma_chunk<2, 4, KC>(acc, arow, so + NQ * SX + lr * ldw + n0 + lc, ldw);
      };
      pipeline(steps, stage, compute);
      if (live) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = m0 + 16 * i + 8 * h + g, oy = oy0 + q / TW, ox = ox0 + q % TW;
            if (oy >= Ho || ox >= Wo) continue;
            const bf16_t* xq = xn + ((size_t)(s * oy) * W + s * ox) * Cin;  // identity
            bf16_t* dst = out + (((size_t)frame * Ho + oy) * Wo + ox) * Cout;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = c0 + n0 + 8 * j + 2 * t;
              const float2 bias = __ldg(reinterpret_cast<const float2*>(cb + n));
              const float2 sc =
                  pw != nullptr
                      ? __ldg(reinterpret_cast<const float2*>(pb + n))
                      : unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(xq + n)));
              *reinterpret_cast<uint32_t*>(dst + n) =
                  pack_bf16(fmaxf(acc[i][j][2 * h] + bias.x + sc.x, 0.f),
                            fmaxf(acc[i][j][2 * h + 1] + bias.y + sc.y, 0.f));
            }
          }
      }
    }
  }
}

static size_t bottleneck_block_bf16_smem(int Ci, int Cout, int s, int TH, int TW) {
  const int na = ((TH - 1) * s + 3) * ((TW - 1) * s + 3);
  const int nam = (na + 47) / 48 * 48, nq = TH * TW, mg = nq / 32;
  const int gpr = NWARP / mg > 1 ? NWARP / mg : 1;
  const int ncols = 32 * (Cout / 32 < gpr ? Cout / 32 : gpr);
  const int a_end = nam * (Ci + 8);
  const int phase_a = a_end + 2 * (nam * (KA + 8) + KA * (Ci + 8));
  const int phase_b = a_end + 2 * Ci * (Ci + 8);
  const int phase_c = nq * (Ci + 8) + 2 * (nq * (KC + 8) + KC * (ncols + 8));
  int most = phase_a > phase_b ? phase_a : phase_b;
  most = most > phase_c ? most : phase_c;
  return sizeof(bf16_t) * (size_t)most;
}

extern "C" int bottleneck_block_bf16(
    const void* x, int N, int H, int W, int Cin, const void* aw, const void* ab,
    const void* bw, const void* bb, const void* cw, const void* cb,
    const void* pw, const void* pb, int Ci, int Cout, int s, int TH, int TW,
    void* out, void* stream) {
  const int nam = (((TH - 1) * s + 3) * ((TW - 1) * s + 3) + 47) / 48 * 48;
  if (Cin % 8 || Ci % KC || Cout % 32 || H % s || W % s || (TH * TW) % 32 ||
      (TH * TW / 32) * (Ci / 32) > NWARP || nam * (KA / 8) > MAXR * NT ||
      TH * TW * (KC / 8) > MAXR * NT)
    return (int)cudaErrorInvalidValue;
  if (pw == nullptr && (Cin != Cout || s != 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = bottleneck_block_bf16_smem(Ci, Cout, s, TH, TW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bottleneck_block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int Ho = H / s, Wo = W / s;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, N);
  bottleneck_block_bf16_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16_t*)x, H, W, Cin, (const bf16_t*)aw, (const float*)ab,
      (const bf16_t*)bw, (const float*)bb, (const bf16_t*)cw, (const float*)cb,
      (const bf16_t*)pw, (const float*)pb, Ci, Cout, s, TH, TW, (bf16_t*)out, Ho, Wo);
  return (int)cudaGetLastError();
}
