// stencil7.cu — the legacy 7-point stencil kernels for Hopper: K6 (affine
// stencil on a halo-padded brick), K5 (the same stencil fused with a
// partial dot product) and K7 (one FTCS step from an unpadded brick and its
// four received halo planes).
//
// K6 replaces repro/kernels/stencil7.py::affine_stencil and K5
// repro/kernels/spmv.py::spmv_dot (their pl.pallas_calls over (8, 128)
// windows of a (bx+2, by+2, Z) padded brick).  For every output cell
// (i, j, z) of the (bx, by, Z) brick, with c = P[i+1, j+1, z]:
//
//   out = c_diag*c + c_off*(((((x- + x+) + y-) + y+) + z+) + z-)
//
// where the z neighbours are edge-replicated (z+ = c on the top face, z- = c
// on the bottom face), as the reference's concatenations make them.  FTCS
// passes (1 - 6w, w), the BTCS operator (1, -w*psi).  One templated body,
// affine_stencil_kernel<T, kDot>, serves both: with kDot it also reduces
// c*out over the block and writes one partial per block.
//
// K5's dot runs over the UNMASKED out, Moat and z faces included, exactly as
// the reference's kernel does before make_sharded_iteration masks Ap.  It
// accumulates in promote(type, float32) — the brick's own type here, float
// or double (the TPU kernel always used float32 partials; the port widens
// with the operands, as K2 does).  No atomics: a block reduces its cells'
// products by warp shuffles and one shared-memory pass in a fixed tree, and
// the block count depends on the extents only, so two runs give the same
// bits.  The wrapper (repro_torch/kernels/ops.py::spmv_hex_dot) sums the
// partials with one torch.sum.
//
// K7 replaces repro/kernels/stencil7.py::stencil_planes.  It takes the
// UNPADDED (bx, by, Z) brick T and the planes xlo, xhi (1, by, Z) and ylo,
// yhi (bx, 1, Z) that the neighbours sent.  On a brick-edge row or column
// the plane's cell replaces the missing neighbour; nothing outside the
// brick or the planes is ever read (the Pallas version read undefined
// window cells and discarded them with where).  The Dirichlet Moat — the
// global domain's x and y faces, from the brick's global offset, and the
// z faces — keeps its old value, so no masking pass follows the kernel.
//
// All three sum the neighbours in the order above, and --fmad=false keeps
// every multiply and add rounded on its own, so they equal their plain
// versions (repro_torch/kernels/stencil7.py, spmv.py) and the plain brick
// steps bit for bit.  The coefficients arrive already rounded to the
// field's type.
//
// Tiling: one thread per output cell, z the contiguous axis.  A block is
// min(128, Z rounded up to 32) threads along z by 256/that rows along y; the
// grid is (z blocks, y blocks, bx).  Offsets come from the extents, and the
// ragged z and y edges are guarded.
//
// Bound: bytes.  K6 and K5 read the padded brick once and write the brick
// (about 2*bx*by*Z values; K5 adds one partial per block); K7 reads the
// brick and four planes and writes the brick.  8 to 10 operations per cell
// are far below the card's float rate.  The design does nothing more about
// the bound yet: each thread loads its six neighbours straight from device
// memory and leans on L1/L2 for the reuse.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libstencil7.so
// The C entries return cudaGetLastError() after the launch; 0 is success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z limit

struct Shape {
  dim3 block;
  dim3 grid;
  bool ok;
};

Shape shape_for(int bx, int by, int nz) {
  Shape s;
  int bdx = ((nz + 31) / 32) * 32;
  if (bdx > 128) bdx = 128;
  const int bdy = kThreads / bdx;
  const int gy = (by + bdy - 1) / bdy;
  s.block = dim3(bdx, bdy, 1);
  s.grid = dim3((nz + bdx - 1) / bdx, gy, bx);
  s.ok = bx >= 1 && by >= 1 && nz >= 1 && gy <= kMaxGrid && bx <= kMaxGrid;
  return s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// K6 (kDot false) and K5 (kDot true, one partial of sum c*out per block)
template <typename T, bool kDot>
__global__ void __launch_bounds__(kThreads)
affine_stencil_kernel(const T* __restrict__ P, T* __restrict__ out,
                      T* __restrict__ partials, int bx, int by, int nz,
                      T c_diag, T c_off) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  T prod = T(0);
  if (z < nz && j < by) {
    const long long sy = nz;                        // padded strides
    const long long sx = (long long)(by + 2) * nz;
    const T* p = P + (long long)(i + 1) * sx + (long long)(j + 1) * sy + z;
    const T c = p[0];
    T s = p[-sx] + p[sx];
    s = s + p[-sy];
    s = s + p[sy];
    s = s + (z + 1 < nz ? p[1] : c);
    s = s + (z > 0 ? p[-1] : c);
    const T v = c_diag * c + c_off * s;
    out[((long long)i * by + j) * nz + z] = v;
    prod = c * v;
  }
  if constexpr (kDot) {
    // every thread of the block takes part in the fixed reduction tree
    __shared__ T s_part[kWarps];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = (blockDim.x * blockDim.y) >> 5;
    prod = warp_sum(prod);
    if (lane == 0) s_part[warp] = prod;
    __syncthreads();
    if (warp == 0) {
      T v = lane < nwarps ? s_part[lane] : T(0);
      v = warp_sum(v);
      if (lane == 0) {
        const long long bid =
            ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x;
        partials[bid] = v;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_planes_kernel(const T* __restrict__ t, const T* __restrict__ xlo,
                      const T* __restrict__ xhi, const T* __restrict__ ylo,
                      const T* __restrict__ yhi, T* __restrict__ out, int bx,
                      int by, int nz, int gx0, int gy0, int nx, int ny,
                      T c_diag, T c_off) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (z >= nz || j >= by) return;
  const long long sy = nz;
  const long long sx = (long long)by * nz;
  const long long q = (long long)i * sx + (long long)j * sy + z;
  const T c = t[q];
  const int gx = gx0 + i;
  const int gy = gy0 + j;
  const bool interior = gx > 0 && gx < nx - 1 && gy > 0 && gy < ny - 1 &&
                        z > 0 && z < nz - 1;
  if (!interior) {  // the Moat keeps its value
    out[q] = c;
    return;
  }
  const T xm = i > 0 ? t[q - sx] : xlo[(long long)j * nz + z];
  const T xp = i + 1 < bx ? t[q + sx] : xhi[(long long)j * nz + z];
  const T ym = j > 0 ? t[q - sy] : ylo[(long long)i * nz + z];
  const T yp = j + 1 < by ? t[q + sy] : yhi[(long long)i * nz + z];
  T s = xm + xp;
  s = s + ym;
  s = s + yp;
  s = s + t[q + 1];  // interior: 0 < z < nz - 1
  s = s + t[q - 1];
  out[q] = c_diag * c + c_off * s;
}

// Launch on the tensors' card, and give the calling thread back its own.
struct DeviceGuard {
  int prev = -1;
  int device;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) : device(dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
};

template <typename T, bool kDot>
int launch_stencil7(const void* P, void* out, void* partials, int bx, int by,
                    int nz, T c_diag, T c_off, int device,
                    cudaStream_t stream) {
  const Shape s = shape_for(bx, by, nz);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  affine_stencil_kernel<T, kDot><<<s.grid, s.block, 0, stream>>>(
      static_cast<const T*>(P), static_cast<T*>(out),
      static_cast<T*>(partials), bx, by, nz, c_diag, c_off);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_planes(const void* t, const void* xlo, const void* xhi,
                  const void* ylo, const void* yhi, void* out, int bx, int by,
                  int nz, int gx0, int gy0, int nx, int ny, T c_diag, T c_off,
                  int device, cudaStream_t stream) {
  const Shape s = shape_for(bx, by, nz);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  stencil_planes_kernel<T><<<s.grid, s.block, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(xlo),
      static_cast<const T*>(xhi), static_cast<const T*>(ylo),
      static_cast<const T*>(yhi), static_cast<T*>(out), bx, by, nz, gx0, gy0,
      nx, ny, c_diag, c_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil7_f32(const void* P, void* out, int bx, int by, int nz,
                 float c_diag, float c_off, int device, void* stream) {
  return launch_stencil7<float, false>(P, out, nullptr, bx, by, nz, c_diag,
                                       c_off, device,
                                       static_cast<cudaStream_t>(stream));
}

int stencil7_f64(const void* P, void* out, int bx, int by, int nz,
                 double c_diag, double c_off, int device, void* stream) {
  return launch_stencil7<double, false>(P, out, nullptr, bx, by, nz, c_diag,
                                        c_off, device,
                                        static_cast<cudaStream_t>(stream));
}

// Number of partials (blocks) one K5 launch on a (bx, by, nz) brick writes;
// -1 if the brick is empty or too large for the grid.
long long spmv_dot_blocks(int bx, int by, int nz) {
  const Shape s = shape_for(bx, by, nz);
  if (!s.ok) return -1;
  return (long long)s.grid.x * s.grid.y * s.grid.z;
}

int spmv_dot_f32(const void* P, void* out, void* partials, int bx, int by,
                 int nz, float c_diag, float c_off, int device, void* stream) {
  return launch_stencil7<float, true>(P, out, partials, bx, by, nz, c_diag,
                                      c_off, device,
                                      static_cast<cudaStream_t>(stream));
}

int spmv_dot_f64(const void* P, void* out, void* partials, int bx, int by,
                 int nz, double c_diag, double c_off, int device,
                 void* stream) {
  return launch_stencil7<double, true>(P, out, partials, bx, by, nz, c_diag,
                                       c_off, device,
                                       static_cast<cudaStream_t>(stream));
}

int stencil_planes_f32(const void* t, const void* xlo, const void* xhi,
                       const void* ylo, const void* yhi, void* out, int bx,
                       int by, int nz, int gx0, int gy0, int nx, int ny,
                       float c_diag, float c_off, int device, void* stream) {
  return launch_planes<float>(t, xlo, xhi, ylo, yhi, out, bx, by, nz, gx0,
                              gy0, nx, ny, c_diag, c_off, device,
                              static_cast<cudaStream_t>(stream));
}

int stencil_planes_f64(const void* t, const void* xlo, const void* xhi,
                       const void* ylo, const void* yhi, void* out, int bx,
                       int by, int nz, int gx0, int gy0, int nx, int ny,
                       double c_diag, double c_off, int device, void* stream) {
  return launch_planes<double>(t, xlo, xhi, ylo, yhi, out, bx, by, nz, gx0,
                               gy0, nx, ny, c_diag, c_off, device,
                               static_cast<cudaStream_t>(stream));
}

const char* stencil7_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
