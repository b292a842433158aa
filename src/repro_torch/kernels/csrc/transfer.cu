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
// so any Moat coordinate yields +0); coarse Moat cells are read as stored.
//
// K3's tiling: the TPU kernel ran the whole level as one grid cell; here one
// thread owns one coarse cell, z the contiguous axis, and a grid-stride loop
// covers the level.  Each thread recomputes the separable passes it needs (9
// x-pass, 3 y-pass, 1 z-pass values from 27 fine reads); neighbouring
// threads share most of their reads, which L1/L2 serve.
//
// K4's tiling (prolong_march_kernel): a block of 32 x 8 threads owns a tile
// of 16 fine y rows x 128 fine z (a z chunk) x 2*xc fine x planes and
// marches along x over coarse planes I, writing fine planes 2I and 2I+1 at
// each step.  Coarse plane I+1's tile, 9 rows x 65 z (a one-cell y/z halo),
// is staged in shared memory once (double-buffered: one barrier a step, the
// loads of plane I+2 in flight meanwhile); each thread keeps its 2 x 3
// values of plane I in registers and forms the odd x-pass values
// 0.5*(P_I + P_{I+1}) there, so every coarse value is read from device
// memory once per tile (xc + 1 planes for xc steps).  Thread (lane, ty) owns
// fine rows 2J and 2J+1 (J = the tile's coarse row ty) and the four fine z
// cells 4*lane .. 4*lane+3 of its chunk (coarse z pairs 2*lane and
// 2*lane+1): coordinates come from blockIdx/threadIdx and the march counter,
// with no division per cell, and every fine cell keeps the plain version's
// expression tree (x pass, then y, then z).  The Moat is a select on each
// store.  Rows of nz % 4 == 0 cells (the finest level pair) are stored four
// at a time (16 bytes a float4, two double2 at float64); other rows four
// scalar stores.  The launch shape has one owner,
// repro_torch/kernels/transfer.py::k4_launch_shape; the launcher refuses a
// shape that does not cover the fine level once with no empty tile.
//
// With --fmad=false every multiply and add rounds on its own, so both
// kernels equal their plain versions bit for bit at float and double.
//
// Bound: bytes.  K3 reads the fine level once and writes the coarse level
// (about 1/8 of it); K4 reads the coarse level and writes the fine one.  The
// operations (4 per axis-pass output) are far below the float rate.  K3 does
// nothing more about the bound yet: no shared-memory staging of the fine
// planes, and its stride-2 fine reads use half of each sector.  K4 streams
// its stores as whole sectors and re-reads only the tile halos (one coarse
// row in 9, one plane in xc + 1).  The launch shape's xc is 1, measured
// fastest at five of six level pairs: the second read of a plane is served
// by L2, which holds the whole coarse level, while each further step of a
// march costs a barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libtransfer.so
// The C entries return cudaGetLastError() after the launch; 0 is success.

#include <climits>
#include <cstdint>

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

// K4: the x-marching prolongation (see the note at the top)
constexpr int kProlongTY = 8;                       // coarse rows per block
constexpr int kProlongZC = 128;                     // fine z per block
constexpr int kProlongCW = kProlongZC / 2 + 1;      // staged coarse z: 65
constexpr int kProlongStage = (kProlongTY + 1) * kProlongCW;  // 9 rows
constexpr int kProlongThreads = 32 * kProlongTY;
// stage slots a thread loads: tid, tid + 256, tid + 512
constexpr int kProlongLoads =
    (kProlongStage + kProlongThreads - 1) / kProlongThreads;
constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z limit

// Four consecutive fine z cells of one row: one 16-byte store (two at
// double), or four scalar stores of the cells in the row (bit c of `live`).
template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       unsigned live) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (live >> c & 1u) p[c] = v[c];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(double* p, const double (&v)[4],
                                       unsigned live) {
  if (kVec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (live >> c & 1u) p[c] = v[c];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kProlongThreads)
prolong_march_kernel(const T* __restrict__ coarse, T* __restrict__ fine,
                     int nx, int ny, int nz, int cx, int cy, int cz, int xc) {
  // stage[b][r * kProlongCW + w]: coarse row J0 + r, coarse z K0 + w
  __shared__ T stage[2][kProlongStage];
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + lane;
  const int J0 = blockIdx.x * kProlongTY;          // first coarse row
  const int I0 = blockIdx.y * xc;                  // first coarse step
  const int I1 = min(I0 + xc, (nx + 1) >> 1);      // one past its last
  const int K0 = blockIdx.z * (kProlongZC / 2);    // first coarse z
  const long long csx = (long long)cy * cz;        // coarse x stride
  const long long fsx = (long long)ny * nz;        // fine x stride

  // this thread's stage slots: slot q = tid + h * 256 is coarse row J0 + r,
  // z K0 + w (r, w of the constant row width); a slot off the level is
  // staged as zero (only Moat and unstored cells ever read one)
  int h_off[kProlongLoads];
  unsigned h_ok = 0;
#pragma unroll
  for (int h = 0; h < kProlongLoads; ++h) {
    const int q = tid + h * kProlongThreads;
    const int r = q / kProlongCW;
    const int w = q - r * kProlongCW;
    const bool ok = q < kProlongStage && J0 + r < cy && K0 + w < cz;
    h_ok |= (unsigned)ok << h;
    h_off[h] = ok ? (J0 + r) * cz + K0 + w : 0;
  }
  T ld[kProlongLoads];
  auto load = [&](int p) {
    const T* src = coarse + (long long)p * csx;
#pragma unroll
    for (int h = 0; h < kProlongLoads; ++h)
      ld[h] = p < cx && (h_ok >> h & 1u) ? src[h_off[h]] : T(0);
  };
  auto put = [&](int b) {
#pragma unroll
    for (int h = 0; h < kProlongLoads; ++h) {
      const int q = tid + h * kProlongThreads;
      if (q < kProlongStage) stage[b][q] = ld[h];
    }
  };
  // the thread's coarse values of a staged plane: rows J, J + 1 and z
  // 2*lane .. 2*lane + 2 of the chunk
  const int base = ty * kProlongCW + 2 * lane;
  auto get = [&](int b, T(&v)[2][3]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[r][c] = stage[b][base + r * kProlongCW + c];
  };

  // the thread's fine cells: rows 2J + r, z fz0 + c.  `live`: stored
  // (inside the level); `inner`: off the y and z Moat faces
  const int fy = 2 * (J0 + ty);
  const int fz0 = 2 * K0 + 4 * lane;
  unsigned z_live = 0, z_in = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int fz = fz0 + c;
    z_live |= (unsigned)(fz < nz) << c;
    z_in |= (unsigned)(fz > 0 && fz < nz - 1) << c;
  }
  const bool active = fy < ny && fz0 < nz;
  unsigned row_live = 0, row_in = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_live |= (unsigned)(fy + r < ny) << r;
    row_in |= (unsigned)(fy + r > 0 && fy + r < ny - 1) << r;
  }
  // the launcher keeps a fine plane's offsets inside an int
  const int col = active ? fy * nz + fz0 : 0;

  // fine plane fx from its x-pass values X: the y pass (row 2J copies, row
  // 2J + 1 averages rows J and J + 1), then the z pass (z 2k copies, 2k + 1
  // averages k and k + 1), then the Moat select
  auto emit = [&](int fx, const T(&X)[2][3]) {
    const bool x_in = fx > 0 && fx < nx - 1;
    T* o = fine + (long long)fx * fsx + col;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(row_live >> r & 1u)) continue;
      T Y[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Y[c] = r ? interp(X[0][c], X[1][c]) : X[0][c];
      T v[4] = {Y[0], interp(Y[0], Y[1]), Y[1], interp(Y[1], Y[2])};
      const unsigned inner = x_in && (row_in >> r & 1u) ? z_in : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = inner >> c & 1u ? v[c] : T(0);
      store4<kVec>(o + r * nz, v, z_live);
    }
  };

  // plane I in registers (cur), plane I + 1 staged, plane I + 2 in flight
  T cur[2][3], nxt[2][3], odd[2][3];
  load(I0);
  put(0);
  load(I0 + 1);
  __syncthreads();
  get(0, cur);
  int b = 1;
  for (int I = I0; I < I1; ++I) {
    put(b);  // plane I + 1; stage b was last read two steps ago
    if (I + 1 < I1) load(I + 2);
    __syncthreads();
    get(b, nxt);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) odd[r][c] = interp(cur[r][c], nxt[r][c]);
    if (active) {
      emit(2 * I, cur);
      if (2 * I + 1 < nx) emit(2 * I + 1, odd);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) cur[r][c] = nxt[r][c];
    b ^= 1;
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // SMs x resident-block budget
  return (int)(blocks < cap ? blocks : cap);
}

template <typename T>
int launch_restrict(const void* src, void* dst, const int* shape, int device,
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
  restrict_kernel<T><<<grid_for((long long)cx * cy * cz), kThreads, 0,
                       stream>>>(static_cast<const T*>(src),
                                 static_cast<T*>(dst), ny, nz, cx, cy, cz);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// True if `tiles` tiles of `size` cover [0, extent) with none empty.
bool covers(long long tiles, long long size, long long extent) {
  return tiles >= 1 && tiles * size >= extent && (tiles - 1) * size < extent;
}

// K4 with the launch shape transfer.py::k4_launch_shape computed: grid
// (y tiles of 16 fine rows, x tiles of 2*xc fine planes, z chunks of 128),
// block (32, 8).  Refuses a shape that does not cover the fine level once,
// or a coarse level that is not its coarsening.
template <typename T>
int launch_prolong(const void* src, void* dst, const int* shape, int grid_x,
                   int grid_y, int grid_z, int block_x, int block_y, int xc,
                   int device, cudaStream_t stream) {
  const int nx = shape[0], ny = shape[1], nz = shape[2];
  const int cx = shape[3], cy = shape[4], cz = shape[5];
  if (nx < 1 || ny < 1 || nz < 1 || cx != nx / 2 + 1 || cy != ny / 2 + 1 ||
      cz != nz / 2 + 1 || (long long)ny * nz + kProlongZC > INT_MAX ||
      block_x != 32 || block_y != kProlongTY || xc < 1 ||
      grid_y > kMaxGrid || grid_z > kMaxGrid ||
      !covers(grid_x, 2 * kProlongTY, ny) || !covers(grid_y, 2LL * xc, nx) ||
      !covers(grid_z, kProlongZC, nz))
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const dim3 grid(grid_x, grid_y, grid_z), block(block_x, block_y);
  const T* c = static_cast<const T*>(src);
  T* f = static_cast<T*>(dst);
  // whole 16-byte stores where every row starts on 16 bytes
  if (nz % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0)
    prolong_march_kernel<T, true><<<grid, block, 0, stream>>>(
        c, f, nx, ny, nz, cx, cy, cz, xc);
  else
    prolong_march_kernel<T, false><<<grid, block, 0, stream>>>(
        c, f, nx, ny, nz, cx, cy, cz, xc);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

int restrict_f32(const void* fine, void* coarse, const int* shape, int device,
                 void* stream) {
  return launch_restrict<float>(fine, coarse, shape, device,
                                static_cast<cudaStream_t>(stream));
}

int restrict_f64(const void* fine, void* coarse, const int* shape, int device,
                 void* stream) {
  return launch_restrict<double>(fine, coarse, shape, device,
                                 static_cast<cudaStream_t>(stream));
}

int prolong_f32(const void* coarse, void* fine, const int* shape, int grid_x,
                int grid_y, int grid_z, int block_x, int block_y, int xc,
                int device, void* stream) {
  return launch_prolong<float>(coarse, fine, shape, grid_x, grid_y, grid_z,
                               block_x, block_y, xc, device,
                               static_cast<cudaStream_t>(stream));
}

int prolong_f64(const void* coarse, void* fine, const int* shape, int grid_x,
                int grid_y, int grid_z, int block_x, int block_y, int xc,
                int device, void* stream) {
  return launch_prolong<double>(coarse, fine, shape, grid_x, grid_y, grid_z,
                                block_x, block_y, xc, device,
                                static_cast<cudaStream_t>(stream));
}

const char* transfer_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
