// transfer.cu — the multigrid transfer kernels K3 (restriction) and K4
// (prolongation) for Hopper.
//
// Replace repro/kernels/transfer.py::build_restrict_call and
// ::build_prolong_call (both one pl.pallas_call over the whole level,
// _whole_array_call).  Alignment is even vertex-centred: coarse cell I sits
// on fine cell 2I, so a fine extent n has a coarse extent n/2 + 1 (integer
// division) with interior cells 1 .. m, m = n/2 - 1.
//
// K3, restriction (fine -> coarse): separable 27-point full weighting.  Per
// axis, w(lo, mid, hi) = 0.5*mid + 0.25*(lo + hi) over fine cells 2I-1, 2I,
// 2I+1; the x pass first, then y, then z, each pass rounded — the order of
// the plain version (repro_torch/kernels/transfer.py::restrict_ref, itself
// the reference's _restrict_axis).  Coarse Moat cells are written as zero.
//
// K4, prolongation (coarse -> fine): separable trilinear interpolation.  Per
// axis, an even fine cell f copies coarse cell f/2 and an odd one takes
// 0.5*(c[(f-1)/2] + c[(f+1)/2]); again x, then y, then z.  Fine Moat cells
// are written as zero (the plain version zero-pads each axis after its pass,
// so any Moat coordinate yields +0).
//
// Tiling: the TPU kernel ran the whole level as one grid cell; here one
// thread owns one output cell, z the contiguous axis, and a grid-stride loop
// covers the level.  Each thread recomputes the separable passes it needs
// (K3: 9 x-pass, 3 y-pass, 1 z-pass values from 27 fine reads; K4: up to 4,
// 2, 1 values from up to 8 coarse reads).  Neighbouring threads share most
// of their reads, which L1/L2 serve.  With --fmad=false every multiply and
// add rounds on its own, so both kernels equal their plain versions bit for
// bit at float and double.
//
// Bound: bytes.  K3 reads the fine level once and writes the coarse level
// (about 1/8 of it); K4 reads the coarse level and writes the fine one.  The
// operations (4 per axis-pass output) are far below the float rate.  The
// design does nothing more about the bound yet: no shared-memory staging of
// the fine planes, and the stride-2 fine reads of K3 use half of each sector.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libtransfer.so
// The C entries return cudaGetLastError() after the launch; 0 is success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T weigh(T lo, T mid, T hi) {
  return T(0.5) * mid + T(0.25) * (lo + hi);
}

template <typename T>
__device__ __forceinline__ T interp(T lo, T hi) {
  return T(0.5) * (lo + hi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(const T* __restrict__ fine, T* __restrict__ coarse, int ny,
                int nz, int cx, int cy, int cz) {
  const long long total = (long long)cx * cy * cz;
  const long long sx = (long long)ny * nz;  // fine x stride
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += (long long)gridDim.x * blockDim.x) {
    const int K = (int)(q % cz);
    const long long r = q / cz;
    const int J = (int)(r % cy);
    const int I = (int)(r / cy);
    if (I == 0 || I == cx - 1 || J == 0 || J == cy - 1 || K == 0 ||
        K == cz - 1) {
      coarse[q] = T(0);
      continue;
    }
    T zs[3];
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
      const int k = 2 * K - 1 + dk;
      T ys[3];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int j = 2 * J - 1 + dj;
        const T* p = fine + (long long)(2 * I - 1) * sx + (long long)j * nz + k;
        ys[dj] = weigh(p[0], p[sx], p[2 * sx]);                  // x pass
      }
      zs[dk] = weigh(ys[0], ys[1], ys[2]);                       // y pass
    }
    coarse[q] = weigh(zs[0], zs[1], zs[2]);                      // z pass
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(const T* __restrict__ coarse, T* __restrict__ fine, int nx,
               int ny, int nz, int cy, int cz) {
  const long long total = (long long)nx * ny * nz;
  const long long sx = (long long)cy * cz;  // coarse x stride
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += (long long)gridDim.x * blockDim.x) {
    const int fz = (int)(q % nz);
    const long long r = q / nz;
    const int fy = (int)(r % ny);
    const int fx = (int)(r / ny);
    if (fx == 0 || fx == nx - 1 || fy == 0 || fy == ny - 1 || fz == 0 ||
        fz == nz - 1) {
      fine[q] = T(0);
      continue;
    }
    const bool ox = fx & 1, oy = fy & 1, oz = fz & 1;
    const int ix = fx >> 1, iy = fy >> 1, iz = fz >> 1;   // even: f/2; odd: (f-1)/2
    // x pass at coarse (j, k)
    auto px = [&](int j, int k) -> T {
      const T* p = coarse + (long long)ix * sx + (long long)j * cz + k;
      return ox ? interp(p[0], p[sx]) : p[0];
    };
    // y pass at coarse k
    auto py = [&](int k) -> T {
      return oy ? interp(px(iy, k), px(iy + 1, k)) : px(iy, k);
    };
    fine[q] = oz ? interp(py(iz), py(iz + 1)) : py(iz);          // z pass
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // SMs x resident-block budget
  return (int)(blocks < cap ? blocks : cap);
}

template <typename T, bool kRestrict>
int launch(const void* src, void* dst, const int* shape, int device,
           cudaStream_t stream) {
  // shape: fine (nx, ny, nz), coarse (cx, cy, cz)
  const int nx = shape[0], ny = shape[1], nz = shape[2];
  const int cx = shape[3], cy = shape[4], cz = shape[5];
  if (nx < 1 || ny < 1 || nz < 1 || cx < 1 || cy < 1 || cz < 1)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  if (kRestrict) {
    restrict_kernel<T><<<grid_for((long long)cx * cy * cz), kThreads, 0,
                         stream>>>(static_cast<const T*>(src),
                                   static_cast<T*>(dst), ny, nz, cx, cy, cz);
  } else {
    prolong_kernel<T><<<grid_for((long long)nx * ny * nz), kThreads, 0,
                        stream>>>(static_cast<const T*>(src),
                                  static_cast<T*>(dst), nx, ny, nz, cy, cz);
  }
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

int restrict_f32(const void* fine, void* coarse, const int* shape, int device,
                 void* stream) {
  return launch<float, true>(fine, coarse, shape, device,
                             static_cast<cudaStream_t>(stream));
}

int restrict_f64(const void* fine, void* coarse, const int* shape, int device,
                 void* stream) {
  return launch<double, true>(fine, coarse, shape, device,
                              static_cast<cudaStream_t>(stream));
}

int prolong_f32(const void* coarse, void* fine, const int* shape, int device,
                void* stream) {
  return launch<float, false>(coarse, fine, shape, device,
                              static_cast<cudaStream_t>(stream));
}

int prolong_f64(const void* coarse, void* fine, const int* shape, int device,
                void* stream) {
  return launch<double, false>(coarse, fine, shape, device,
                               static_cast<cudaStream_t>(stream));
}

const char* transfer_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
