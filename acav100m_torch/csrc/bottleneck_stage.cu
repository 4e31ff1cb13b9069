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
// each CTA owns one spatial output tile (TH x TW pixels, all Cout channels)
// of one frame, and runs the block's three products as small GEMMs whose
// operands are staged in shared memory chunk by chunk (KC input channels
// at a time, weights included):
//   1. a on the tile's input region plus a 1-pixel halo (recomputing the
//      halo that neighbouring tiles also compute); a is zero outside the
//      frame, which is the 3x3 conv's 'same' zero padding;
//   2. b on the tile, as 9 shifted products over a;
//   3. y = b . cw (+ x . pw for the projection) with the shortcut, written
//      out.
// a and b stay in shared memory, channel-major, so a thread's 4 pixels are
// one 16-byte load. Each thread owns a 4-pixel x (8, 4 or 16)-channel
// register tile and accumulates in fp32 FMA. Tiles cut by the frame edge
// are masked, so any H, W (divisible by the stride) works.
//
// Bound on an H100 SXM at the main path's shape (SlowFast s2_slow at 256^2
// input: 64x64 frames, Cin 80 -> 256, inner 64, 3 blocks, 8 slow frames a
// clip): 1.79 GFLOP a frame, 14.3 GFLOP a clip, about 213 us a clip at the
// 67 TFLOP/s of fp32 FMA, against about 13 us of device-memory traffic
// (44 MB). It is bound by operations. Fusing the whole stage into one
// launch (3-pixel halo) and moving the products to wgmma tensor cores with
// TMA-fed tiles is later work; TF32 would also change the numerics.
//
// Plain C interface for ctypes; the launcher allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#define NT 256  // threads per CTA
#define KC 32   // input channels staged per step

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float* acc, float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// rows [k0, k0+KC) of a row-major (K, N) weight matrix into wc (KC x N),
// zero past K
__device__ __forceinline__ void stage_weights(float* wc, const float* w, int k0,
                                              int K, int N) {
  const int n4 = N / 4;
  for (int i = threadIdx.x; i < KC * n4; i += NT) {
    const int kk = i / n4, c = (i % n4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + kk < K) v = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k0 + kk) * N + c));
    *reinterpret_cast<float4*>(wc + kk * N + c) = v;
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
  const int NA = AH * AW, NAP = (NA + 3) / 4 * 4, NQ = TH * TW;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* aT = smem;                          // Ci x NAP
  float* bT = aT + Ci * NAP;                 // Ci x NQ
  float* xc = bT + Ci * NQ;                  // KC x max(NAP, NQ)
  float* wc = xc + KC * max(NAP, NQ);        // KC x max(Ci, Cout)
  const float* xn = x + (size_t)frame * H * W * Cin;

  // 1. a = relu(x . aw + ab) on the region; 4 pixels x 8 channels a thread
  {
    const int ng = Ci / 8, items = (NAP / 4) * ng;
    for (int item0 = 0; item0 < items; item0 += NT) {
      const int item = item0 + tid;
      const bool live = item < items;
      const int g = item % ng, p0 = (item / ng) * 4;
      float acc[4][8] = {};
      for (int k0 = 0; k0 < Cin; k0 += KC) {
        __syncthreads();
        for (int i = tid; i < NAP * KC; i += NT) {
          const int p = i / KC, kk = i % KC;
          const int yy = ry0 + p / AW, xx = rx0 + p % AW;
          xc[kk * NAP + p] = (p < NA && k0 + kk < Cin && yy >= 0 && yy < H &&
                              xx >= 0 && xx < W)
                                 ? __ldg(xn + ((size_t)yy * W + xx) * Cin + k0 + kk)
                                 : 0.f;
        }
        stage_weights(wc, aw, k0, Cin, Ci);
        __syncthreads();
        if (live) {
#pragma unroll 4
          for (int kk = 0; kk < KC; ++kk) {
            const float4 a4 = lds4(xc + kk * NAP + p0);
            const float4 w0 = lds4(wc + kk * Ci + g * 4);
            const float4 w1 = lds4(wc + kk * Ci + g * 4 + Ci / 2);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              fma4(acc[r], av[r], w0);
              fma4(acc[r] + 4, av[r], w1);
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + r;
          const int yy = ry0 + p / AW, xx = rx0 + p % AW;
          const bool inside = p < NA && yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int n = g * 4 + (c / 4) * (Ci / 2) + c % 4;
            aT[n * NAP + p] = inside ? fmaxf(acc[r][c] + __ldg(ab + n), 0.f) : 0.f;
          }
        }
      }
    }
  }

  // 2. b = relu(conv3x3(a, stride s) + bb) on the tile; 4 pixels x 4 channels
  {
    const int ng = Ci / 4, items = (NQ / 4) * ng;
    for (int item0 = 0; item0 < items; item0 += NT) {
      const int item = item0 + tid;
      const bool live = item < items;
      const int g = item % ng, q0 = (item / ng) * 4;
      int base[4];  // region index of tap (0,0) for each pixel
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = min(q0 + r, NQ - 1);
        base[r] = (s * (q / TW)) * AW + s * (q % TW);
      }
      float acc[4][4] = {};
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * AW + tap % 3;
        for (int k0 = 0; k0 < Ci; k0 += KC) {
          __syncthreads();
          stage_weights(wc, bw + (size_t)tap * Ci * Ci, k0, Ci, Ci);
          __syncthreads();
          if (live) {
#pragma unroll 4
            for (int kk = 0; kk < KC && k0 + kk < Ci; ++kk) {
              const float* arow = aT + (k0 + kk) * NAP + off;
              const float4 w = lds4(wc + kk * Ci + g * 4);
#pragma unroll
              for (int r = 0; r < 4; ++r) fma4(acc[r], arow[base[r]], w);
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = g * 4 + c;
            bT[n * NQ + q0 + r] = fmaxf(acc[r][c] + __ldg(bb + n), 0.f);
          }
      }
    }
  }

  // 3. y = relu(b . cw (+ x . pw) + biases (+ x)); 4 pixels x 16 channels
  {
    const int ng = Cout / 16, items = (NQ / 4) * ng;
    for (int item0 = 0; item0 < items; item0 += NT) {
      const int item = item0 + tid;
      const bool live = item < items;
      const int g = item % ng, q0 = (item / ng) * 4;
      float acc[4][16] = {};
      for (int k0 = 0; k0 < Ci; k0 += KC) {
        __syncthreads();
        stage_weights(wc, cw, k0, Ci, Cout);
        __syncthreads();
        if (live) {
#pragma unroll 2
          for (int kk = 0; kk < KC && k0 + kk < Ci; ++kk) {
            const float4 b4 = lds4(bT + (k0 + kk) * NQ + q0);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 w = lds4(wc + kk * Cout + g * 4 + j * (Cout / 4));
#pragma unroll
              for (int r = 0; r < 4; ++r) fma4(acc[r] + 4 * j, bv[r], w);
            }
          }
        }
      }
      if (pw != nullptr) {  // projection: x at the tile's pixels (stride s)
        for (int k0 = 0; k0 < Cin; k0 += KC) {
          __syncthreads();
          for (int i = tid; i < NQ * KC; i += NT) {
            const int q = i / KC, kk = i % KC;
            const int yy = s * (oy0 + q / TW), xx = s * (ox0 + q % TW);
            xc[kk * NQ + q] = (k0 + kk < Cin && yy < H && xx < W)
                                  ? __ldg(xn + ((size_t)yy * W + xx) * Cin + k0 + kk)
                                  : 0.f;
          }
          stage_weights(wc, pw, k0, Cin, Cout);
          __syncthreads();
          if (live) {
#pragma unroll 2
            for (int kk = 0; kk < KC; ++kk) {
              const float4 x4 = lds4(xc + kk * NQ + q0);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float4 w = lds4(wc + kk * Cout + g * 4 + j * (Cout / 4));
#pragma unroll
                for (int r = 0; r < 4; ++r) fma4(acc[r] + 4 * j, xv[r], w);
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = q0 + r, oy = oy0 + q / TW, ox = ox0 + q % TW;
          if (q >= NQ || oy >= Ho || ox >= Wo) continue;
          const float* xq = xn + ((size_t)(s * oy) * W + s * ox) * Cin;  // identity
          float* dst = out + (((size_t)frame * Ho + oy) * Wo + ox) * Cout;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = g * 4 + j * (Cout / 4);
            const float4 bias = __ldg(reinterpret_cast<const float4*>(cb + n));
            float4 sc;
            if (pw != nullptr) {
              sc = __ldg(reinterpret_cast<const float4*>(pb + n));
            } else {
              sc = __ldg(reinterpret_cast<const float4*>(xq + n));
            }
            float4 v;
            v.x = fmaxf(acc[r][4 * j + 0] + bias.x + sc.x, 0.f);
            v.y = fmaxf(acc[r][4 * j + 1] + bias.y + sc.y, 0.f);
            v.z = fmaxf(acc[r][4 * j + 2] + bias.z + sc.z, 0.f);
            v.w = fmaxf(acc[r][4 * j + 3] + bias.w + sc.w, 0.f);
            *reinterpret_cast<float4*>(dst + n) = v;
          }
        }
      }
    }
  }
}

static size_t bottleneck_block_smem(int Cin, int Ci, int Cout, int s, int TH, int TW) {
  const int na = ((TH - 1) * s + 3) * ((TW - 1) * s + 3);
  const int nap = (na + 3) / 4 * 4, nq = TH * TW;
  return sizeof(float) * ((size_t)Ci * nap + (size_t)Ci * nq +
                          (size_t)KC * (nap > nq ? nap : nq) +
                          (size_t)KC * (Ci > Cout ? Ci : Cout));
}

extern "C" int bottleneck_block(
    const void* x, int N, int H, int W, int Cin, const void* aw, const void* ab,
    const void* bw, const void* bb, const void* cw, const void* cb,
    const void* pw, const void* pb, int Ci, int Cout, int s, int TH, int TW,
    void* out, void* stream) {
  if (Ci % 8 || Cout % 16 || H % s || W % s || (TH * TW) % 4)
    return (int)cudaErrorInvalidValue;
  if (pw == nullptr && (Cin != Cout || s != 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = bottleneck_block_smem(Cin, Ci, Cout, s, TH, TW);
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
