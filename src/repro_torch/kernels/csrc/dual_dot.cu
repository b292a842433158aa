// dual_dot.cu — the fused dual dot product (K2) for Hopper.
//
// Replaces repro/kernels/dotprod.py::dual_dot_2d (its pl.pallas_call over
// (rb, 128) tiles of four (rows, cols) operands).  What it computes: the
// pair (a.b, c.d) in ONE sweep over the four operands, as per-block partial
// pairs that the wrapper (repro_torch/kernels/ops.py::dual_dot) sums.
// Preconditioned CG and pipelined CG call it once per iteration for their
// two reductions; pipelined CG passes (r, r, w, r), so operands may alias
// (the kernel only reads them).
//
// Accumulation type: promote(dtype, float32) — float for float input,
// double for double input.  (The TPU kernel always accumulated in float32;
// the port widens with the operands so a float64 solve keeps float64 dots.)
//
// Determinism: no atomics.  Each block owns a fixed contiguous chunk of
// kThreads * kItems elements; every thread sums its kItems strided elements
// in order, the block reduces by warp shuffles and one shared-memory pass in
// a fixed tree, and writes its pair to partials[2*block].  The block count
// depends on n only, so two runs on the same inputs give the same bits.
//
// Bound: bytes.  Each distinct operand is read once (2 mul + 2 add per
// element, far below the card's float rate); the partials are one pair per
// 8192 elements.  Design for that bound: the chunk loop is unrolled 8 deep,
// so a thread keeps up to 32 loads in flight, neighbouring threads on
// neighbouring addresses.
// No vector (16-byte) loads yet: speed is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libdual_dot.so
// The C entry returns cudaGetLastError() after the launch; 0 is success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;   // elements per thread; a block covers 8192
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, const T* __restrict__ d,
                long long n, T* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * (kThreads * kItems);
  T ab = T(0);
  T cd = T(0);
#pragma unroll 8
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    if (i < n) {
      ab += a[i] * b[i];
      cd += c[i] * d[i];
    }
  }
  __shared__ T s_ab[kWarps];
  __shared__ T s_cd[kWarps];
  ab = warp_sum(ab);
  cd = warp_sum(cd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_ab[warp] = ab;
    s_cd[warp] = cd;
  }
  __syncthreads();
  if (warp == 0) {
    ab = lane < kWarps ? s_ab[lane] : T(0);
    cd = lane < kWarps ? s_cd[lane] : T(0);
    ab = warp_sum(ab);
    cd = warp_sum(cd);
    if (lane == 0) {
      partials[2 * (long long)blockIdx.x] = ab;
      partials[2 * (long long)blockIdx.x + 1] = cd;
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, const void* d,
           long long n, void* partials, int blocks, int device,
           cudaStream_t stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  // launch on the tensors' card, and give the calling thread back its own
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  dual_dot_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d), n,
      static_cast<T*>(partials));
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

int dual_dot_f32(const void* a, const void* b, const void* c, const void* d,
                 long long n, void* partials, int blocks, int device,
                 void* stream) {
  return launch<float>(a, b, c, d, n, partials, blocks, device,
                       static_cast<cudaStream_t>(stream));
}

int dual_dot_f64(const void* a, const void* b, const void* c, const void* d,
                 long long n, void* partials, int blocks, int device,
                 void* stream) {
  return launch<double>(a, b, c, d, n, partials, blocks, device,
                        static_cast<cudaStream_t>(stream));
}

int dual_dot_items_per_block() { return kThreads * kItems; }

const char* dual_dot_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
