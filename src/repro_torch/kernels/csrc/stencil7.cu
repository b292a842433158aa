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
// passes (1 - 6w, w), the BTCS operator (1, -w*psi).  K5 also sums c*out
// over each block's tile and writes one partial per block.
//
// K5's dot runs over the UNMASKED out, Moat and z faces included, exactly as
// the reference's kernel does before make_sharded_iteration masks Ap.  It
// accumulates in promote(type, float32) — the brick's own type here, float
// or double (the TPU kernel always used float32 partials; the port widens
// with the operands, as K2 does).  The wrapper
// (repro_torch/kernels/ops.py::spmv_hex_dot) sums the partials with one
// torch.sum.
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
// K6 tiling: one thread per output cell, z the contiguous axis.  A block
// is min(128, Z rounded up to 32) threads along z by 256/that rows along y;
// the grid is (z blocks, y blocks, bx).  Offsets come from the extents,
// and the ragged z and y edges are guarded.  Each thread loads its six
// neighbours straight from device memory and leans on L1/L2 for the reuse.
//
// K5 (spmv_dot_march_kernel) has its own mapping, which marches along x:
// - a block is 32 z lanes x kSpmvTY = 8 y rows; each thread owns
//   kSpmvCells = 4 z cells, 32 apart, so a block covers kSpmvZC = 128 z
//   (larger Z takes more blocks along grid z) and a warp reads and writes
//   consecutive z;
// - a block owns a tile of 8 rows x 128 z and xc consecutive x planes and
//   walks them in order.  Each thread keeps its cells' x-1, x and x+1
//   values in registers (and the x+2 plane in flight), so every centre
//   value is read from device memory once per block;
// - the y and z neighbours come from a shared-memory stage of the current
//   plane, (8+2) rows x (128+2) z with the halo rows and z columns,
//   double-buffered: the threads write their x+1 values and the halo cells
//   of the next plane into the other buffer, so one __syncthreads() per
//   plane separates the writes from the reads (10.4 KB at float);
// - each thread adds its products c*out to one register in a fixed order
//   (plane by plane, cell by cell): at most xc * 4 <= 128 products, so the
//   float32 chain stays far inside K5_REL = 1e-5 of sum |c*out|.  The block
//   then reduces once, by warp shuffles and one shared-memory pass in a
//   fixed tree, and writes one partial per block.  No atomics; the grid
//   depends on the extents only, so two runs give the same bits;
// - the launch shape (grid, block, xc) has one owner,
//   repro_torch/kernels/spmv.py::spmv_launch_shape; the launcher checks it
//   covers every output cell once with no empty tile, and refuses it
//   otherwise.  The partial of block (y tile, x tile, z chunk) is at
//   (z chunk * x tiles + x tile) * y tiles + y tile.
//
// K7 (stencil_planes_march_kernel) marches on K5's tile and pipeline, with
// the planes in place of the pad:
// - a thread's x-1 value at the brick's first plane is xlo's cell, its x+1
//   value at the last plane xhi's; the stage's halo row above the brick's
//   first row is ylo's row of the plane, and the first thread past the
//   brick's last row stages yhi's row (the halo row below it).  In-plane
//   offsets are j*Z + z in the x planes and i*Z + z in the y planes;
//   nothing outside the brick or the planes is read (no corner, no row past
//   yhi's, no z outside [0, Z));
// - the Moat is kept out of the loads' way: a Moat cell stores its
//   register c and skips the sum.  The y test is made once a thread, the z
//   test falls on fixed cells (lane 0 of the first z chunk, the lane of
//   Z - 1), the x test once a plane, so only the z faces split a warp;
// - K7 writes no partials, so nothing ties its xc to K5's 32: the launch
//   shape has one owner, repro_torch/kernels/stencil7.py::k7_launch_shape,
//   and the launcher refuses a shape that does not cover every cell once
//   with no empty tile.
//
// Bound: bytes.  K6 and K5 read the padded brick once and write the brick
// (about 2*bx*by*Z values; K5 adds one partial per block); K7 reads the
// brick and four planes and writes the brick.  K5 and K7 read each centre
// value once per tile and the two planes around it (xc + 2 planes for a
// tile of xc).  8 to 10 operations per cell are far below the card's float
// rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libstencil7.so
// The C entries return cudaGetLastError() after the launch; 0 is success.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

// K6
template <typename T>
__global__ void __launch_bounds__(kThreads)
affine_stencil_kernel(const T* __restrict__ P, T* __restrict__ out, int bx,
                      int by, int nz, T c_diag, T c_off) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
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
    out[((long long)i * by + j) * nz + z] = c_diag * c + c_off * s;
  }
}

// K5: the x-marching SpMV + dot (see the note at the top)
constexpr int kSpmvTY = 8;                     // y rows per block
constexpr int kSpmvCells = 4;                  // z cells per thread
constexpr int kSpmvZC = 32 * kSpmvCells;       // z per block
constexpr int kSpmvXCMax = 32;                 // x planes per block
constexpr int kSpmvThreads = 32 * kSpmvTY;
constexpr int kSpmvW = kSpmvZC + 2;            // stage row width
// halo cells of a plane's stage: two y rows of 128 z, two z columns of 8
// rows; thread tid stages halo cells tid and tid + 256
constexpr int kSpmvHalo = 2 * kSpmvZC + 2 * kSpmvTY;
constexpr int kSpmvHaloPer = (kSpmvHalo + kSpmvThreads - 1) / kSpmvThreads;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kSpmvThreads)
spmv_dot_march_kernel(const T* __restrict__ P, T* __restrict__ out,
                      T* __restrict__ partials, int bx, int by, int nz,
                      int xc, T c_diag, T c_off) {
  // stage[b][r][w]: padded row y0 + r (r = 0 .. 9), z = z0 - 1 + w
  __shared__ T stage[2][kSpmvTY + 2][kSpmvW];
  __shared__ T s_part[kSpmvTY];
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + lane;
  const int y0 = blockIdx.x * kSpmvTY;  // padded row of stage row 0
  const int x0 = blockIdx.y * xc;       // first output plane of the tile
  const int x1 = min(x0 + xc, bx);      // one past its last
  const int z0 = blockIdx.z * kSpmvZC;
  const int j = y0 + ty;                // output row; padded row j + 1
  // padded strides; the launcher keeps a plane's offsets inside an int
  const int sy = nz;
  const long long sx = (long long)(by + 2) * nz;
  // padded row j + 1 exists for j <= by: the last one is the y+ halo of
  // row by - 1, staged by the first thread past the brick's y edge
  const bool row_in = j <= by;
  const bool live = j < by;
  const int col = (j + 1) * sy + z0 + lane;  // first cell, in a plane

  // this thread's halo cells of a stage: offset in a plane and stage slot,
  // slot -1 for none.  A halo cell outside the padded brick (a row past
  // by + 1, z outside [0, nz)) is never read, so it is not staged
  int h_off[kSpmvHaloPer], h_slot[kSpmvHaloPer];
#pragma unroll
  for (int h = 0; h < kSpmvHaloPer; ++h) {
    const int q = tid + h * kSpmvThreads;
    int r = 0, w = 0;
    if (q < 2 * kSpmvZC) {
      r = q < kSpmvZC ? 0 : kSpmvTY + 1;
      w = 1 + q % kSpmvZC;
    } else if (q < kSpmvHalo) {
      r = 1 + (q - 2 * kSpmvZC) / 2;
      w = (q & 1) ? kSpmvW - 1 : 0;
    }
    const int z = z0 - 1 + w;
    const bool ok = q < kSpmvHalo && y0 + r <= by + 1 && z >= 0 && z < nz;
    h_slot[h] = ok ? r * kSpmvW + w : -1;
    h_off[h] = ok ? (y0 + r) * sy + z : 0;
  }
  auto load_cells = [&](int plane, T(&v)[kSpmvCells]) {
    const T* p = P + (long long)plane * sx + col;
#pragma unroll
    for (int c = 0; c < kSpmvCells; ++c)
      v[c] = row_in && z0 + lane + 32 * c < nz ? p[32 * c] : T(0);
  };
  auto load_halo = [&](int plane, T(&v)[kSpmvHaloPer]) {
    const T* p = P + (long long)plane * sx;
#pragma unroll
    for (int h = 0; h < kSpmvHaloPer; ++h)
      v[h] = h_slot[h] >= 0 ? p[h_off[h]] : T(0);
  };
  auto put = [&](int b, const T(&v)[kSpmvCells], const T(&hv)[kSpmvHaloPer]) {
    T* st = &stage[b][0][0];
#pragma unroll
    for (int c = 0; c < kSpmvCells; ++c)
      st[(ty + 1) * kSpmvW + 1 + lane + 32 * c] = v[c];
#pragma unroll
    for (int h = 0; h < kSpmvHaloPer; ++h)
      if (h_slot[h] >= 0) st[h_slot[h]] = hv[h];
  };

  // padded planes i (prev), i + 1 (cur, staged), i + 2 (nxt) and i + 3
  // (far, in flight) for output plane i
  T prev[kSpmvCells], cur[kSpmvCells], nxt[kSpmvCells], far[kSpmvCells];
  T h_nxt[kSpmvHaloPer], h_far[kSpmvHaloPer];
  load_cells(x0, prev);
  load_cells(x0 + 1, cur);
  load_halo(x0 + 1, h_far);
  put(0, cur, h_far);
  load_cells(x0 + 2, nxt);
  load_halo(x0 + 2, h_nxt);
  T acc = T(0);
  int b = 0;
  for (int i = x0; i < x1; ++i) {
    __syncthreads();  // stage b holds plane i + 1; stage b ^ 1 is free
    if (i + 1 < x1) {
      put(b ^ 1, nxt, h_nxt);
      load_cells(i + 3, far);
      load_halo(i + 3, h_far);
    }
    if (live) {
      const T* st = &stage[b][0][0];
      T* o = out + ((long long)i * by + j) * nz + (z0 + lane);
#pragma unroll
      for (int c = 0; c < kSpmvCells; ++c) {
        const int z = z0 + lane + 32 * c;
        if (z < nz) {
          const int w = 1 + lane + 32 * c;
          const T ctr = cur[c];
          T s = prev[c] + nxt[c];
          s = s + st[ty * kSpmvW + w];
          s = s + st[(ty + 2) * kSpmvW + w];
          s = s + (z + 1 < nz ? st[(ty + 1) * kSpmvW + w + 1] : ctr);
          s = s + (z > 0 ? st[(ty + 1) * kSpmvW + w - 1] : ctr);
          const T v = c_diag * ctr + c_off * s;
          o[32 * c] = v;
          acc = acc + ctr * v;
        }
      }
    }
    if (i + 1 < x1) {
#pragma unroll
      for (int c = 0; c < kSpmvCells; ++c) {
        prev[c] = cur[c];
        cur[c] = nxt[c];
        nxt[c] = far[c];
      }
#pragma unroll
      for (int h = 0; h < kSpmvHaloPer; ++h) h_nxt[h] = h_far[h];
    }
    b ^= 1;
  }
  // one fixed tree over the block: each warp by shuffles, then warp 0
  acc = warp_sum(acc);
  if (lane == 0) s_part[ty] = acc;
  __syncthreads();
  if (ty == 0) {
    T v = lane < kSpmvTY ? s_part[lane] : T(0);
    v = warp_sum(v);
    if (lane == 0)
      partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x] = v;
  }
}

// K7: the x-marching FTCS step from a brick and its halo planes (see the
// note at the top)
template <typename T>
__global__ void __launch_bounds__(kSpmvThreads)
stencil_planes_march_kernel(const T* __restrict__ t, const T* __restrict__ xlo,
                            const T* __restrict__ xhi,
                            const T* __restrict__ ylo,
                            const T* __restrict__ yhi, T* __restrict__ out,
                            int bx, int by, int nz, int xc, int gx0, int gy0,
                            int nx, int ny, T c_diag, T c_off) {
  // stage[b][r][w]: brick row y0 - 1 + r (r = 0 .. 9), z = z0 - 1 + w
  __shared__ T stage[2][kSpmvTY + 2][kSpmvW];
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + lane;
  const int y0 = blockIdx.x * kSpmvTY;  // brick row of stage row 1
  const int x0 = blockIdx.y * xc;       // first plane of the tile
  const int x1 = min(x0 + xc, bx);      // one past its last
  const int z0 = blockIdx.z * kSpmvZC;
  const int j = y0 + ty;
  // in-plane strides; the launcher keeps a plane's offsets inside an int
  const int sy = nz;
  const long long sx = (long long)by * nz;
  const bool live = j < by;
  // the Moat: the y test once a thread, the z test on fixed cells (bit c of
  // `inner`: cell c is off the z faces and its row off the y faces), the x
  // test once a plane
  const int gy = gy0 + j;
  const bool y_in = live && gy > 0 && gy < ny - 1;
  unsigned in_z = 0, inner = 0;
#pragma unroll
  for (int c = 0; c < kSpmvCells; ++c) {
    const int z = z0 + lane + 32 * c;
    in_z |= (unsigned)(z < nz) << c;
    inner |= (unsigned)(y_in && z > 0 && z < nz - 1) << c;
  }

  // this thread's halo cells of a stage: source at plane 0, its step from
  // plane to plane and its stage slot (-1: none).  Row y0 - 1 is ylo's at
  // the brick's first row, the row past the brick's last is yhi's; a row
  // beyond that, and z outside [0, nz), is never read and not staged; the
  // z columns are staged on live rows only
  const T* h_src[kSpmvHaloPer];
  int h_step[kSpmvHaloPer], h_slot[kSpmvHaloPer];
#pragma unroll
  for (int h = 0; h < kSpmvHaloPer; ++h) {
    const int q = tid + h * kSpmvThreads;
    int r = 0, w = 0;
    if (q < 2 * kSpmvZC) {
      r = q < kSpmvZC ? 0 : kSpmvTY + 1;
      w = 1 + q % kSpmvZC;
    } else if (q < kSpmvHalo) {
      r = 1 + (q - 2 * kSpmvZC) / 2;
      w = (q & 1) ? kSpmvW - 1 : 0;
    }
    const int z = z0 - 1 + w;
    const int row = y0 - 1 + r;
    const T* src = nullptr;
    int step = 0;
    if (q < kSpmvHalo && z >= 0 && z < nz) {
      if (row < 0) {
        src = ylo + z;
        step = nz;
      } else if (row < by) {
        src = t + row * sy + z;
        step = (int)sx;
      } else if (row == by && q < 2 * kSpmvZC) {
        src = yhi + z;
        step = nz;
      }
    }
    h_src[h] = src;
    h_step[h] = step;
    h_slot[h] = src ? r * kSpmvW + w : -1;
  }
  // this thread's cells of brick plane p, p = -1 and bx being the x
  // planes: its row while live; yhi's cells on the first row past the
  // brick (the stage's y halo of row by - 1); nothing otherwise
  const int col = live ? j * sy + z0 + lane : 0;
  auto load_cells = [&](int p, T(&v)[kSpmvCells]) {
    const T* src = nullptr;
    if (live)
      src = p < 0 ? xlo + col : p < bx ? t + p * sx + col : xhi + col;
    else if (j == by && p >= 0 && p < bx)
      src = yhi + (long long)p * nz + z0 + lane;
#pragma unroll
    for (int c = 0; c < kSpmvCells; ++c)
      v[c] = src && (in_z >> c & 1u) ? src[32 * c] : T(0);
  };
  auto load_halo = [&](int p, T(&v)[kSpmvHaloPer]) {
#pragma unroll
    for (int h = 0; h < kSpmvHaloPer; ++h)
      v[h] = h_slot[h] >= 0 ? h_src[h][(long long)p * h_step[h]] : T(0);
  };
  auto put = [&](int b, const T(&v)[kSpmvCells], const T(&hv)[kSpmvHaloPer]) {
    T* st = &stage[b][0][0];
#pragma unroll
    for (int c = 0; c < kSpmvCells; ++c)
      st[(ty + 1) * kSpmvW + 1 + lane + 32 * c] = v[c];
#pragma unroll
    for (int h = 0; h < kSpmvHaloPer; ++h)
      if (h_slot[h] >= 0) st[h_slot[h]] = hv[h];
  };

  // planes i - 1 (prev), i (cur, staged), i + 1 (nxt) and i + 2 (far, in
  // flight) for plane i
  T prev[kSpmvCells], cur[kSpmvCells], nxt[kSpmvCells], far[kSpmvCells];
  T h_nxt[kSpmvHaloPer], h_far[kSpmvHaloPer];
  load_cells(x0 - 1, prev);
  load_cells(x0, cur);
  load_halo(x0, h_far);
  put(0, cur, h_far);
  load_cells(x0 + 1, nxt);
  if (x0 + 1 < x1) load_halo(x0 + 1, h_nxt);
  int b = 0;
  for (int i = x0; i < x1; ++i) {
    __syncthreads();  // stage b holds plane i; stage b ^ 1 is free
    if (i + 1 < x1) {
      put(b ^ 1, nxt, h_nxt);
      load_cells(i + 2, far);
      if (i + 2 < x1) load_halo(i + 2, h_far);
    }
    if (live) {
      const int gx = gx0 + i;
      const unsigned mid = gx > 0 && gx < nx - 1 ? inner : 0u;
      const T* st = &stage[b][0][0];
      T* o = out + (long long)i * sx + col;
#pragma unroll
      for (int c = 0; c < kSpmvCells; ++c) {
        if (in_z >> c & 1u) {
          T v = cur[c];  // the Moat keeps its value
          if (mid >> c & 1u) {
            const int w = 1 + lane + 32 * c;
            T s = prev[c] + nxt[c];
            s = s + st[ty * kSpmvW + w];
            s = s + st[(ty + 2) * kSpmvW + w];
            s = s + st[(ty + 1) * kSpmvW + w + 1];
            s = s + st[(ty + 1) * kSpmvW + w - 1];
            v = c_diag * v + c_off * s;
          }
          o[32 * c] = v;
        }
      }
    }
    if (i + 1 < x1) {
#pragma unroll
      for (int c = 0; c < kSpmvCells; ++c) {
        prev[c] = cur[c];
        cur[c] = nxt[c];
        nxt[c] = far[c];
      }
#pragma unroll
      for (int h = 0; h < kSpmvHaloPer; ++h) h_nxt[h] = h_far[h];
    }
    b ^= 1;
  }
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

template <typename T>
int launch_stencil7(const void* P, void* out, int bx, int by, int nz,
                    T c_diag, T c_off, int device, cudaStream_t stream) {
  const Shape s = shape_for(bx, by, nz);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  affine_stencil_kernel<T><<<s.grid, s.block, 0, stream>>>(
      static_cast<const T*>(P), static_cast<T*>(out), bx, by, nz, c_diag,
      c_off);
  return (int)cudaGetLastError();
}

// True if `tiles` tiles of `size` cover [0, extent) with none empty.
bool covers(long long tiles, long long size, long long extent) {
  return tiles >= 1 && tiles * size >= extent && (tiles - 1) * size < extent;
}

// K5 with the launch shape spmv.py::spmv_launch_shape computed: grid
// (y tiles, x tiles, z chunks), block (32, 8), xc x planes per tile and
// n_partials = the grid's blocks, the length of `partials`.
template <typename T>
int launch_spmv(const void* P, void* out, void* partials, int bx, int by,
                int nz, int grid_x, int grid_y, int grid_z, int block_x,
                int block_y, int xc, long long n_partials, T c_diag, T c_off,
                int device, cudaStream_t stream) {
  if (bx < 1 || by < 1 || nz < 1 || (long long)(by + 2) * nz > INT_MAX ||
      block_x != 32 || block_y != kSpmvTY ||
      xc < 1 || xc > kSpmvXCMax || grid_y > kMaxGrid || grid_z > kMaxGrid ||
      !covers(grid_x, kSpmvTY, by) || !covers(grid_y, xc, bx) ||
      !covers(grid_z, kSpmvZC, nz) ||
      n_partials != (long long)grid_x * grid_y * grid_z)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  spmv_dot_march_kernel<T><<<dim3(grid_x, grid_y, grid_z),
                             dim3(block_x, block_y), 0, stream>>>(
      static_cast<const T*>(P), static_cast<T*>(out),
      static_cast<T*>(partials), bx, by, nz, xc, c_diag, c_off);
  return (int)cudaGetLastError();
}

// K7 with the launch shape stencil7.py::k7_launch_shape computed: grid
// (y tiles, x tiles, z chunks), block (32, 8) and xc x planes per tile.
template <typename T>
int launch_planes(const void* t, const void* xlo, const void* xhi,
                  const void* ylo, const void* yhi, void* out, int bx, int by,
                  int nz, int gx0, int gy0, int nx, int ny, int grid_x,
                  int grid_y, int grid_z, int block_x, int block_y, int xc,
                  T c_diag, T c_off, int device, cudaStream_t stream) {
  if (bx < 1 || by < 1 || nz < 1 ||
      (long long)by * nz + kSpmvZC > INT_MAX || block_x != 32 ||
      block_y != kSpmvTY || xc < 1 || grid_y > kMaxGrid ||
      grid_z > kMaxGrid || !covers(grid_x, kSpmvTY, by) ||
      !covers(grid_y, xc, bx) || !covers(grid_z, kSpmvZC, nz))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  stencil_planes_march_kernel<T><<<dim3(grid_x, grid_y, grid_z),
                                   dim3(block_x, block_y), 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(xlo),
      static_cast<const T*>(xhi), static_cast<const T*>(ylo),
      static_cast<const T*>(yhi), static_cast<T*>(out), bx, by, nz, xc, gx0,
      gy0, nx, ny, c_diag, c_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stencil7_f32(const void* P, void* out, int bx, int by, int nz,
                 float c_diag, float c_off, int device, void* stream) {
  return launch_stencil7<float>(P, out, bx, by, nz, c_diag, c_off, device,
                                static_cast<cudaStream_t>(stream));
}

int stencil7_f64(const void* P, void* out, int bx, int by, int nz,
                 double c_diag, double c_off, int device, void* stream) {
  return launch_stencil7<double>(P, out, bx, by, nz, c_diag, c_off, device,
                                 static_cast<cudaStream_t>(stream));
}

int spmv_dot_f32(const void* P, void* out, void* partials, int bx, int by,
                 int nz, int grid_x, int grid_y, int grid_z, int block_x,
                 int block_y, int xc, long long n_partials, float c_diag,
                 float c_off, int device, void* stream) {
  return launch_spmv<float>(P, out, partials, bx, by, nz, grid_x, grid_y,
                            grid_z, block_x, block_y, xc, n_partials, c_diag,
                            c_off, device, static_cast<cudaStream_t>(stream));
}

int spmv_dot_f64(const void* P, void* out, void* partials, int bx, int by,
                 int nz, int grid_x, int grid_y, int grid_z, int block_x,
                 int block_y, int xc, long long n_partials, double c_diag,
                 double c_off, int device, void* stream) {
  return launch_spmv<double>(P, out, partials, bx, by, nz, grid_x, grid_y,
                             grid_z, block_x, block_y, xc, n_partials, c_diag,
                             c_off, device, static_cast<cudaStream_t>(stream));
}

int stencil_planes_f32(const void* t, const void* xlo, const void* xhi,
                       const void* ylo, const void* yhi, void* out, int bx,
                       int by, int nz, int gx0, int gy0, int nx, int ny,
                       int grid_x, int grid_y, int grid_z, int block_x,
                       int block_y, int xc, float c_diag, float c_off,
                       int device, void* stream) {
  return launch_planes<float>(t, xlo, xhi, ylo, yhi, out, bx, by, nz, gx0,
                              gy0, nx, ny, grid_x, grid_y, grid_z, block_x,
                              block_y, xc, c_diag, c_off, device,
                              static_cast<cudaStream_t>(stream));
}

int stencil_planes_f64(const void* t, const void* xlo, const void* xhi,
                       const void* ylo, const void* yhi, void* out, int bx,
                       int by, int nz, int gx0, int gy0, int nx, int ny,
                       int grid_x, int grid_y, int grid_z, int block_x,
                       int block_y, int xc, double c_diag, double c_off,
                       int device, void* stream) {
  return launch_planes<double>(t, xlo, xhi, ylo, yhi, out, bx, by, nz, gx0,
                               gy0, nx, ny, grid_x, grid_y, grid_z, block_x,
                               block_y, xc, c_diag, c_off, device,
                               static_cast<cudaStream_t>(stream));
}

const char* stencil7_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
