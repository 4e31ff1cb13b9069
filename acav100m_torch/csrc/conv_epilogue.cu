// The epilogue of a convolution whose inference batch norm was folded into
// its weights, in place on the convolution's channels-last output:
//
//   y = relu?((y + bias[c]) + r)      (r, the residual, where given)
//
// y and r are rows x C in memory (NDHWC: C innermost), float32 or bf16; bias
// is C float32 values, the folded BN's shift. The arithmetic is float32, in
// that order, each add rounded to nearest (no FMA), and the result is
// rounded once to y's dtype (round to nearest even), so the plain twin
// (ops/conv_epilogue.py, conv_epilogue_ref) gives the same bits. ReLU keeps
// a NaN (v < 0 ? 0 : v), as torch.relu does.
//
// It replaces no Pallas kernel: on the TPU, XLA fuses each convolution with
// its BN, ReLU and residual add for the JAX package. The port had run them
// as cuDNN's BN kernel, a ReLU and an add, each a pass over the tensor in
// NCDHW, with cuDNN transposing to and from NHWC around every convolution.
//
// Bound: bytes. A pass reads y (and r) and writes y once: 8 (12) bytes an
// element in float32, 4 (6) in bf16, against one add or two and a max. At
// 3.35 TB/s a 100 MB tensor is 60 us; nothing here is worth the tensor
// cores. The design keeps every thread's memory traffic in 16-byte vectors
// (4 float32 or 8 bf16 values of one row, hence C a multiple of 8), each
// thread with 4 vectors of y (and r) in flight before it computes, and the
// bias read through the read-only cache, where its C values stay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads a block
constexpr int UNROLL = 4;           // 16-byte vectors a thread
constexpr int CHUNK = NT * UNROLL;  // vectors a block

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// y: nvec 16-byte vectors, cvec of them a row; r likewise or unused.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(NT)
    conv_epilogue_kernel(T* __restrict__ y, const float* __restrict__ bias,
                         const T* __restrict__ r, long long nvec, int cvec) {
  constexpr int N = Vec<T>::N;
  const long long base = (long long)blockIdx.x * CHUNK;
  const int c0 = (int)(base % cvec);
  float v[UNROLL][N], rv[UNROLL][N];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + threadIdx.x + u * NT;
    if (i < nvec) {
      Vec<T>::load(y + i * N, v[u]);
      if (RES) Vec<T>::load(r + i * N, rv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + threadIdx.x + u * NT;
    if (i >= nvec) break;
    const int c = ((c0 + (int)threadIdx.x + u * NT) % cvec) * N;
    float b[N];
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(bias + c + j));
      b[j] = q.x, b[j + 1] = q.y, b[j + 2] = q.z, b[j + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = __fadd_rn(v[u][j], b[j]);
      if (RES) s = __fadd_rn(s, rv[u][j]);
      if (RELU) s = s < 0.f ? 0.f : s;
      v[u][j] = s;
    }
    Vec<T>::store(y + i * N, v[u]);
  }
}

template <typename T, bool RES, bool RELU>
cudaError_t launch(void* y, const void* bias, const void* r, long long nvec, int cvec,
                   unsigned blocks, cudaStream_t s) {
  conv_epilogue_kernel<T, RES, RELU>
      <<<blocks, NT, 0, s>>>((T*)y, (const float*)bias, (const T*)r, nvec, cvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(void* y, const void* bias, const void* r, int relu, long long nvec,
                         int cvec, unsigned blocks, cudaStream_t s) {
  if (r) return (relu ? launch<T, true, true> : launch<T, true, false>)(y, bias, r, nvec, cvec,
                                                                         blocks, s);
  return (relu ? launch<T, false, true> : launch<T, false, false>)(y, bias, r, nvec, cvec,
                                                                    blocks, s);
}

}  // namespace

// y (rows, c) float32 (bf16 = 0) or bf16 (bf16 = 1), contiguous, 16-byte
// aligned, updated in place; bias (c,) float32, 16-byte aligned; r like y,
// or null for no residual; relu 0 or 1; c a multiple of 8. Enqueues one
// launch on stream (none for rows = 0) and returns cudaGetLastError() after
// it, as a cudaError_t.
extern "C" int conv_epilogue(void* y, const void* bias, const void* r, long long rows, int c,
                             int bf16, int relu, void* stream) {
  if (rows < 0 || c < 8 || c % 8 || !y || !bias) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int cvec = c / (bf16 ? 8 : 4);
  const long long nvec = rows * cvec;
  const long long blocks = (nvec + CHUNK - 1) / CHUNK;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_dtype<__nv_bfloat16>(y, bias, r, relu, nvec, cvec, (unsigned)blocks, s)
                    : launch_dtype<float>(y, bias, r, relu, nvec, cvec, (unsigned)blocks, s));
}
