// fused_stencil.cu — the fused loop-body stencil kernel (K1) for Hopper.
//
// Replaces repro/kernels/fused.py::build_fused_call (the Pallas kernel built
// around its pl.pallas_call) in two modes:
// - padded: inputs are the (bx+2kh, by+2kh, nz) wrap-padded window, outputs
//   fresh (bx, by, nz) tensors;
// - margin (the halo-resident layout): inputs are resident buffers of extent
//   (bx+2M, by+2M, nz), M >= k*h, whose window starts at M - k*h; the final
//   sub-step writes cell (x, y) to (M+x, M+y) of a caller-supplied output
//   buffer of the same extent that is never an input (ping-pong).  The
//   reference writes in place through input_output_aliases, which is valid
//   only while blocks run one at a time.
// The two modes differ only in the origins and row strides of Geom.  The
// overlap's interior launch (region mode) is a margin-mode launch over one
// rectangle of the brick: the host moves the Geoms' window and destination
// offsets by its origin (x0 == y0; fused.py::sweep_geoms) and passes the
// region's global origin as cx, cy, so it needs no code here.  Instead
// of a source generated per program, the kernel reads the body's canonical
// tap form from a small descriptor that the host flattens from the
// LoweredGroup (repro_torch/kernels/fused.py, _encode), and is templated on
// float / double.
//
// One kernel, fused_column_kernel (the column entry): one launch evaluates
// ONE sub-step over a rectangular region of the window.  At k = 1 one launch
// covers the brick (the make step at time_tile=1 in margin mode, every
// solver operator application in padded mode); at k > 1 the sweep, k
// launches enqueued by one C call (fused_sweep_*), sub-step s over the
// trapezoid's region s.  A body with a hazard (below) takes the kernel's
// kHazard instantiation, on the same routes.
//
// What it computes, per launch: for each AffineUpdate, in program order,
//     field[z0:z0+zlen] = const + sum_g c_g * (sum_p prod_t tap_{g,p,t})
// on the interior (x, y) cells, with at most 2 taps per product, k times
// (the valid region shrinking by h per sub-step, trapezoid).  The Dirichlet
// Moat mask comes from global coordinates.  Later updates read earlier
// updates' centre values.  z planes outside [z0, z0+zlen) are copied
// through unchanged.
//
// Association: taps that share a coefficient are summed first, in recorded
// order, and multiplied once; the groups are then added in order of first
// appearance, then `const` — the association of the Pallas body.  One
// __device__ function, eval_update, holds it, so the instantiations agree
// with each other and with fused_step_ref by construction.
//
// Bound: bytes.  At k = 1 a launch reads each input window once and writes
// each output once: for the heat3d body at 512 x 512 x 128 float, about
// 2 x 134 MB per step, against about 9 flops per cell.
//
// Column entry (fused_column_kernel), K6's thread mapping (stencil7.cu):
// - a block is (BZ, BY) threads, BZ = min(128, ceil(max nz / kK1Cells)
//   rounded up to 32), BY = 256 / BZ (rounded down, as K6); x comes from
//   blockIdx.y, y from blockIdx.x * BY + threadIdx.y, and each thread walks
//   z = threadIdx.x, +BZ, ..., kK1Cells cells at once.  So a warp reads and
//   writes consecutive z (coalesced), and a block owns whole z columns: a
//   later update's from_center tap at dz != 0 (always dx = dy = 0 by
//   lowering) reads a value that this block wrote, and the __syncthreads()
//   between updates is enough.  Threads past the region's y edge skip the
//   work and still reach every barrier.
// - kK1Cells = 4 cells per thread: with one, each tap's load waited on the
//   previous tap's add, so a cell paid the load latency once per tap, and
//   the per-block descriptor copy was spread over one cell per thread; four
//   cells issue four independent loads per tap (measured 0.81 -> 0.31 ms
//   per heat3d launch on an H100; more cells cost registers and occupancy).
// - no division or modulo per cell: each thread computes its cell's (x, y)
//   row in the inputs and outputs once, in 64 bits; a tap's offset is that
//   row times its field's nz plus dx*sx + dy*nz + dz, with the field's x
//   stride sx = in_py * nz kept in shared memory per block.
// - the Moat mask once per column: the column's global (gx, gy), wrapped
//   mod (nx, ny) with a non-negative remainder when `wrap` and the column
//   lies off the grid (a sweep's regions reach (k-1)*h past the brick,
//   below 0 for a brick at the grid's low edge).  Without wrap a cell
//   outside [0, nx) x [0, ny) is not interior.  At k = 1 the host also
//   keeps the brick inside the grid.
// - coefficients rounded to T once per block, into shared memory beside the
//   descriptor; the `!= 1.0` and `!= 0.0` tests stay on the double values,
//   so the same operations happen in the same order.
// - outputs written in place: no block-private scratch, no temporary, no
//   block-stride tile loop.
// Neighbour reuse (each input cell is read by up to 7 taps) is left to
// L1/L2.  Left for a later K1 change: staging the (x, y) neighbourhood in
// shared memory.
//
// The sweep (k > 1).  Sub-step s (0 <= s < k) evaluates
// region s of the trapezoid, extent (bx + 2(k-s-1)h, by + 2(k-s-1)h) at
// global origin (cx, cy) - (k-s-1)h, over the whole region in one launch:
// - a written field is read from the input at s = 0 and from scratch
//   (s-1) & 1 after; an unwritten field always from the input; sub-step s
//   writes scratch s & 1, and the outputs at s = k - 1.  The first write of
//   a field copies its Moat cells and unwritten z planes from that same
//   source, and from_center taps read the sub-step's own destination.
// - scratch buffers have the inputs' extent, row stride and members, and
//   a region cell sits at the same (x, y) in the input, in both scratch
//   buffers and in the window, so only the origins move per sub-step
//   (Geom, one per sub-step, computed by fused.py::sweep_geoms).
// - each cell's arithmetic is the trapezoid's, so the sweep equals
//   fused_step_ref bit for bit.
// - bytes: k launches, each reading its region's window and writing its
//   region: about k x the k = 1 launch's bytes (0.66 ms of HBM at heat3d
//   512 x 512 x 128 float, k = 8), against the TPU kernel's one read and
//   one write of the window (0.083 ms).
// Why the trapezoid is not held on chip: a block must own whole z columns
// (a later update reads an earlier one's new value at dz != 0), a heat3d
// column is 128 x 4 B, and each written field needs two copies, so 227 KB
// of shared memory holds about 220 columns, a 14 x 14 window: at k = 8,
// h = 1 no output tile is left, and at k = 2 a 10 x 10 tile recomputes
// about 1.6x the cells to save half the bytes.  The k = 1 launch is bound
// by issue and latency, not bytes, so that would be slower per step.
//
// Hazards.  An update that re-writes a field already written in this
// sub-step while reading that field's new value at dz != 0 would read cells
// that other threads of its column are writing (the host flags it:
// hd[5]).  All of its new values must be computed before any is stored, so
// the kHazard instantiation evaluates such an update with the same walk,
// parks each interior cell's value in a shared-memory stage of BY x zlen
// elements (row threadIdx.y, index z - z0), reaches a barrier that every
// thread of the block reaches, and then copies the stage to the
// destination.  A hazard update is never a field's first write, so only
// interior cells of [z0, z0 + zlen) move.  The stage sits after the
// descriptor, 16-byte aligned, and holds the largest zlen of the body's
// hazard updates (fused.py::hazard_stage_bytes; launch_sweep checks it
// against the descriptor); every other update, in a hazard body too, runs
// as in the hazard-free instantiation, whose code is unchanged by it.
//
// Members (an ensemble's batch axis).  A launch over a (B, X, Y, Z) stack
// of every field runs grid z = B: block (.., .., m) evaluates member m, and
// thread 0 moves each field's base pointer by m whole members (in_px x in_py
// x nz elements of an input or scratch buffer, out_px x out_py x nz of a
// destination) where it fills s_in / s_out.  Nothing else depends on the
// member: the per-cell code, the descriptor and the hazard stage are those
// of one member, so a batched launch equals B single launches bit for bit.
// The reference vmaps its pallas_call over the members
// (repro/compiler/codegen.py, compile_group); here the axis is the grid's.
// The offset lives in the kMembers instantiations, which serve B > 1: with
// it in every launch, the prologue's 16 unrolled 64-bit offsets grew the
// code from 936 to 1424 instructions at float and the single-member
// launches by 0.4-1.0 % on an H100, so B = 1 keeps the code it had.
//
// FMA contraction: build with --fmad=false.  Every multiply and add then
// rounds on its own, as the plain PyTorch version's separate elementwise
// kernels do, so every instantiation is held *bitwise* against
// fused_step_ref on the card at float and double.  Turning contraction on is a decision for a
// later performance change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libfused_stencil.so
// The C entries return cudaGetLastError() after the launch; 0 is success.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxFields = 16;
// update header: field, z0, zlen, nz, first_write, hazard, n_groups,
//                coef_base, next_update_offset
constexpr int kUpdHeader = 9;
// one tap: field, dz, dx, dy, from_center
constexpr int kTapInts = 5;
// z cells one thread of the column entry evaluates at once
constexpr int kK1Cells = 4;
// ints of one Geom (read_geom), and sub-steps of one sweep call
constexpr int kGeomInts = 20;
constexpr int kMaxSweep = 64;

// buf0, buf1 and written are unused (a removed kernel's); they stay so that
// the kernel's parameter layout, and with it its code, does not move.
template <typename T>
struct Fields {
  const T* in[kMaxFields];   // inputs, padded or resident (see Geom)
  T* out[kMaxFields];        // outputs of the written fields (see Geom)
  T* buf0[kMaxFields];       // unused
  T* buf1[kMaxFields];       // unused
  int nz[kMaxFields];
  int written[kMaxFields];   // unused
};

// One launch's geometry: one sub-step over a region.  bx, by, cx, cy are
// the region's extent and global origin, in_off the origin of its h-deep
// read window in the inputs, and out_off, out_py where it lands in its
// destination; in_px and out_px are the x extents of the input and
// destination buffers, which with the row strides give one member's extent.
// k, max_nz and the two tile fields are unused (a removed kernel's); they
// keep their places so that the parameter layout, and with it the kernel's
// code, does not move.
struct Geom {
  int bx, by;            // region extent
  int nx, ny;            // global extent (Moat)
  int cx, cy;            // global origin of the region
  int k, h, wrap;
  int in_px, out_px;     // x extent of the inputs and of the destination
  int tiles_x, tiles_y;  // unused
  int n_ints, n_coefs;
  int max_nz;
  int in_off, in_py;     // window origin (x and y) and row stride of inputs
  int out_off, out_py;   // region origin (x and y) and row stride of outputs
};

// Bytes of dynamic shared memory before the hazard stage: the coefficients
// (as double and as T) and the descriptor, rounded up to 16 bytes.
template <typename T>
__host__ __device__ inline size_t stage_offset(int n_coefs, int n_ints) {
  return ((size_t)n_coefs * (sizeof(double) + sizeof(T)) +
          (size_t)n_ints * sizeof(int) + 15) & ~(size_t)15;
}

// N cells of one thread, evaluated side by side: every operation acts on
// each cell alone, rounded as the scalar one is, so a cell's value does not
// depend on N.  The N loads of one tap are issued together.
template <typename T, int N>
struct Cells {
  T v[N];
  __device__ Cells() {}
  __device__ explicit Cells(T s) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = s;
  }
};

template <typename T, int N>
__device__ __forceinline__ Cells<T, N> operator+(const Cells<T, N>& a,
                                                 const Cells<T, N>& b) {
  Cells<T, N> r;
#pragma unroll
  for (int c = 0; c < N; ++c) r.v[c] = a.v[c] + b.v[c];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Cells<T, N> operator*(const Cells<T, N>& a,
                                                 const Cells<T, N>& b) {
  Cells<T, N> r;
#pragma unroll
  for (int c = 0; c < N; ++c) r.v[c] = a.v[c] * b.v[c];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Cells<T, N> operator*(T s, const Cells<T, N>& b) {
  Cells<T, N> r;
#pragma unroll
  for (int c = 0; c < N; ++c) r.v[c] = s * b.v[c];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Cells<T, N> operator+(const Cells<T, N>& a, T s) {
  Cells<T, N> r;
#pragma unroll
  for (int c = 0; c < N; ++c) r.v[c] = a.v[c] + s;
  return r;
}

// One update's body at one cell (V = T) or at N cells (V = Cells<T, N>):
// the group sums, the coefficient products, `const`, in the association of
// the note above.  `q` indexes the update's first group in `desc`; `cf`
// holds the update's doubles (const, then one coefficient per group) and
// `coef(c)` the same value rounded to T; `tap(t)` reads the tap whose five
// ints start at t.
template <typename V, typename Coef, typename Tap>
__device__ __forceinline__ V eval_update(const int* desc, int q, int n_groups,
                                         const double* cf, Coef coef,
                                         Tap tap) {
  V acc = V();
  bool have = false;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int n_prod = desc[q++];
    V gsum = V();
    for (int p = 0; p < n_prod; ++p) {
      const int n_taps = desc[q++];
      V t = tap(desc + q);
      q += kTapInts;
      for (int tt = 1; tt < n_taps; ++tt) {
        t = t * tap(desc + q);
        q += kTapInts;
      }
      gsum = (p == 0) ? t : gsum + t;
    }
    const V tg = (cf[1 + gi] != 1.0) ? coef(1 + gi) * gsum : gsum;
    acc = have ? acc + tg : tg;
    have = true;
  }
  if (!have)
    acc = V(coef(0));
  else if (cf[0] != 0.0)
    acc = acc + coef(0);
  return acc;
}

// kHazard: the instantiation for a body with a hazard update (the note on
// hazards above); false: every other body, whose code does not depend on it.
// kMembers: a launch over B > 1 members (the note on members above); false:
// one member, whose code does not depend on it.
template <typename T, bool kHazard, bool kMembers>
__global__ void __launch_bounds__(256)
fused_column_kernel(Fields<T> f, Geom g, const int* __restrict__ desc_g,
                    const double* __restrict__ coef_g) {
  extern __shared__ double smem[];
  double* coefs = smem;                                   // n_coefs
  T* coefs_t = reinterpret_cast<T*>(smem + g.n_coefs);    // n_coefs, as T
  int* desc = reinterpret_cast<int*>(coefs_t + g.n_coefs);
  T* const stage = kHazard ? reinterpret_cast<T*>(
                                 reinterpret_cast<char*>(smem) +
                                 stage_offset<T>(g.n_coefs, g.n_ints))
                           : nullptr;     // BY x (largest hazard zlen)
  __shared__ const T* s_in[kMaxFields];
  __shared__ T* s_out[kMaxFields];
  __shared__ long long s_sx[kMaxFields];   // input x stride, in_py * nz
  __shared__ int s_nz[kMaxFields];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < kMaxFields; ++q) {
      s_in[q] = f.in[q];
      s_out[q] = f.out[q];
      s_nz[q] = f.nz[q];
      s_sx[q] = (long long)g.in_py * f.nz[q];
    }
    if constexpr (kMembers) {
      // member blockIdx.z of the stacks: whole members further on
      const long long m = blockIdx.z;
      for (int q = 0; q < kMaxFields; ++q) {
        if (s_in[q]) s_in[q] += m * g.in_px * s_sx[q];
        if (s_out[q]) s_out[q] += m * g.out_px * g.out_py * (long long)f.nz[q];
      }
    }
  }
  for (int q = tid; q < g.n_coefs; q += nthreads) {
    const double c = coef_g[q];
    coefs[q] = c;
    coefs_t[q] = static_cast<T>(c);
  }
  for (int q = tid; q < g.n_ints; q += nthreads) desc[q] = desc_g[q];
  __syncthreads();

  // this thread's column: region cell (i, j), z = threadIdx.x, +BZ, ...
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = j < g.by;
  // the column's (x, y) row in the inputs (window centre, h deep) and in
  // the destination; a field's offset is the row times its nz
  const long long r_in = (long long)(g.in_off + g.h + i) * g.in_py +
                         (g.in_off + g.h + j);
  const long long r_out = (long long)(g.out_off + i) * g.out_py +
                          (g.out_off + j);
  // wrap only a column past the grid (none at k = 1, the edge columns of a
  // sweep's regions): a runtime modulo costs tens of instructions
  int gx = g.cx + i, gy = g.cy + j;
  if (g.wrap && (gx < 0 || gx >= g.nx)) gx = ((gx % g.nx) + g.nx) % g.nx;
  if (g.wrap && (gy < 0 || gy >= g.ny)) gy = ((gy % g.ny) + g.ny) % g.ny;
  const bool interior = gx > 0 && gx < g.nx - 1 && gy > 0 && gy < g.ny - 1;

  const int n_updates = desc[0];
  int pos = 1;
  for (int u = 0; u < n_updates; ++u) {
    const int* hd = desc + pos;
    const int fl = hd[0], z0 = hd[1], zlen = hd[2], nz = hd[3];
    const int first = hd[4], n_groups = hd[6], cb = hd[7];
    const int body = pos + kUpdHeader;
    // the first write of a field also carries the unwritten z planes and
    // the Moat cells through from its source (input or previous sub-step);
    // a later one touches only its window
    const int zb = first ? 0 : z0;
    const int ze = first ? nz : z0 + zlen;
    if (live && (first || interior)) {
      const T* own = s_in[fl] + r_in * nz;
      T* dst = s_out[fl] + r_out * nz;
      // kK1Cells cells of the column at once, blockDim.x apart
      for (int zc = zb + (int)threadIdx.x; zc < ze;
           zc += kK1Cells * blockDim.x) {
        int zs[kK1Cells];     // where each cell's taps are read
        bool win[kK1Cells];   // the cell is updated (else copied through)
        bool any = false;
#pragma unroll
        for (int c = 0; c < kK1Cells; ++c) {
          const int z = zc + c * blockDim.x;
          win[c] = interior && z < ze && z >= z0 && z < z0 + zlen;
          any = any || win[c];
          zs[c] = win[c] ? z : z0;   // other cells read z0's taps, unused
        }
        Cells<T, kK1Cells> val;
        if (any)
          val = eval_update<Cells<T, kK1Cells>>(
              desc, body, n_groups, coefs + cb,
              [&](int c) { return coefs_t[cb + c]; },
              [&](const int* t) {
                // t: field, dz, dx, dy, from_center
                const long long tnz = s_nz[t[0]];
                const T* src =
                    t[4] ? s_out[t[0]] + r_out * tnz + t[1]
                         : s_in[t[0]] + r_in * tnz + t[2] * s_sx[t[0]] +
                               t[3] * tnz + t[1];
                Cells<T, kK1Cells> r;
#pragma unroll
                for (int c = 0; c < kK1Cells; ++c) r.v[c] = src[zs[c]];
                return r;
              });
#pragma unroll
        for (int c = 0; c < kK1Cells; ++c) {
          const int z = zc + c * blockDim.x;
          if constexpr (kHazard) {
            if (hd[5]) {   // interior, inside the window: park the value
              if (z < ze) stage[threadIdx.y * zlen + (z - z0)] = val.v[c];
              continue;
            }
          }
          if (z < ze) dst[z] = win[c] ? val.v[c] : own[z];
        }
      }
    }
    if constexpr (kHazard) {
      if (hd[5]) {
        // every new value of the window is in the stage: store them
        __syncthreads();
        if (live && interior) {
          T* dst = s_out[fl] + r_out * nz;
          const T* row = stage + threadIdx.y * zlen;
          for (int z = (int)threadIdx.x; z < zlen; z += blockDim.x)
            dst[z0 + z] = row[z];
        }
      }
    }
    __syncthreads();
    pos = hd[8];
  }
}

// Sets `device` current for the launch and gives the calling thread its
// own device back.
struct DeviceScope {
  int prev = -1;
  int device;
  cudaError_t err;
  explicit DeviceScope(int dev) : device(dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
};

Geom read_geom(const int* geom) {
  Geom g;
  g.bx = geom[0];
  g.by = geom[1];
  g.nx = geom[2];
  g.ny = geom[3];
  g.cx = geom[4];
  g.cy = geom[5];
  g.k = geom[6];
  g.h = geom[7];
  g.wrap = geom[8];
  g.in_px = geom[9];
  g.out_px = geom[10];
  g.tiles_x = geom[11];
  g.tiles_y = geom[12];
  g.n_ints = geom[13];
  g.n_coefs = geom[14];
  g.max_nz = geom[15];
  g.in_off = geom[16];
  g.in_py = geom[17];
  g.out_off = geom[18];
  g.out_py = geom[19];
  return g;
}

// The largest zlen of the hazard updates in the host copy `desc` of a
// descriptor of n_ints ints, 0 if none is flagged, or -1 if the update
// headers' chain leaves the descriptor.
int hazard_zlen(const int* desc, int n_ints) {
  if (n_ints < 1) return -1;
  int zmax = 0, pos = 1;
  for (int u = 0; u < desc[0]; ++u) {
    if (pos < 1 || pos > n_ints - kUpdHeader) return -1;
    const int* hd = desc + pos;
    if (hd[5]) zmax = hd[2] > zmax ? hd[2] : zmax;
    if (hd[8] <= pos) return -1;
    pos = hd[8];
  }
  return zmax;
}

// The column entry over k sub-steps (k = 1: one launch over the brick):
// launch s gets geoms[s * kGeomInts ...], grid (grids[2s], grids[2s + 1])
// and block (block_z, block_y) of at most 256 threads, as
// fused.py::k1_launch_shape computes them; each grid is checked to cover
// its region (grid y = bx_s, grid x * block_y >= by_s), and grid z is
// `batch`, the members of every field's stack (1 <= batch <= 65535; B > 1
// picks the kMembers instantiation).  A written field (outs[q] != null) is
// read from ins[q] at s = 0, else from scratch
// (s-1) & 1, and written to scratch s & 1, or to outs[q] at s = k - 1;
// scratch0 must be set for k > 1, scratch1 for k > 2.  `hazard` picks the
// kHazard instantiation, with a stage of `stage_bytes`: both are checked
// against host_desc, the host's copy of the descriptor `desc` (a hazard
// update flagged, and block_y x its largest zlen elements of T; 0 bytes
// without a hazard).  Returns the first error; launches after it are not
// enqueued.
template <typename T>
int launch_sweep(const void* const* ins, void* const* outs,
                 void* const* scratch0, void* const* scratch1, const int* nz,
                 int n_fields, const int* desc, const double* coefs,
                 const int* geoms, const int* grids, int k, int block_z,
                 int block_y, const int* host_desc, int hazard,
                 long long stage_bytes, int batch, int device,
                 cudaStream_t stream) {
  if (n_fields < 1 || n_fields > kMaxFields || k < 1 || k > kMaxSweep ||
      block_z < 32 || block_z % 32 != 0 || block_y < 1 ||
      block_z * block_y > 256 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Geom g0 = read_geom(geoms);
  for (int s = 0; s < k; ++s) {
    const Geom g = read_geom(geoms + s * kGeomInts);
    const int grid_x = grids[2 * s], grid_y = grids[2 * s + 1];
    if (g.bx < 1 || g.by < 1 || grid_x < 1 || grid_y != g.bx ||
        grid_y > 65535 || (long long)grid_x * block_y < g.by || g.h < 0 ||
        g.nx < 1 || g.ny < 1 || g.in_off < 0 || g.out_off < 0 ||
        g.in_off + 2 * g.h + g.by > g.in_py || g.out_off + g.by > g.out_py ||
        g.in_off + 2 * g.h + g.bx > g.in_px || g.out_off + g.bx > g.out_px ||
        g.n_ints != g0.n_ints || g.n_coefs != g0.n_coefs)
      return (int)cudaErrorInvalidValue;
  }
  // k = 1 keeps the brick inside the grid, as the k = 1 entry always has
  if (k == 1 && (g0.cx < 0 || g0.cy < 0 || g0.cx + g0.bx > g0.nx ||
                 g0.cy + g0.by > g0.ny))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_fields; ++q)
    if (outs[q] && ((k > 1 && !scratch0[q]) || (k > 2 && !scratch1[q])))
      return (int)cudaErrorInvalidValue;
  const int zmax = host_desc ? hazard_zlen(host_desc, g0.n_ints) : -1;
  if (zmax < 0 || hazard != (zmax > 0 ? 1 : 0) ||
      stage_bytes != (long long)block_y * zmax * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const auto kernel =
      batch > 1 ? (hazard ? fused_column_kernel<T, true, true>
                          : fused_column_kernel<T, false, true>)
                : (hazard ? fused_column_kernel<T, true, false>
                          : fused_column_kernel<T, false, false>);
  const size_t smem =
      hazard ? stage_offset<T>(g0.n_coefs, g0.n_ints) + (size_t)stage_bytes
             : (size_t)g0.n_coefs * (sizeof(double) + sizeof(T)) +
                   (size_t)g0.n_ints * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* const* scratch[2] = {scratch0, scratch1};
  for (int s = 0; s < k; ++s) {
    const Geom g = read_geom(geoms + s * kGeomInts);
    Fields<T> f = {};
    for (int q = 0; q < n_fields; ++q) {
      const bool wr = outs[q] != nullptr;
      f.in[q] = static_cast<const T*>(wr && s > 0 ? scratch[(s - 1) & 1][q]
                                                  : ins[q]);
      f.out[q] = static_cast<T*>(
          !wr ? nullptr : s == k - 1 ? outs[q] : scratch[s & 1][q]);
      f.nz[q] = nz[q];
    }
    kernel<<<dim3(grids[2 * s], grids[2 * s + 1], batch),
             dim3(block_z, block_y), smem, stream>>>(f, g, desc, coefs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int fused_sweep_f32(const void* const* ins, void* const* outs,
                    void* const* scratch0, void* const* scratch1,
                    const int* nz, int n_fields, const int* desc,
                    const double* coefs, const int* geoms, const int* grids,
                    int k, int block_z, int block_y, const int* host_desc,
                    int hazard, long long stage_bytes, int batch,
                    int device, void* stream) {
  return launch_sweep<float>(ins, outs, scratch0, scratch1, nz, n_fields,
                             desc, coefs, geoms, grids, k, block_z, block_y,
                             host_desc, hazard, stage_bytes, batch, device,
                             static_cast<cudaStream_t>(stream));
}

int fused_sweep_f64(const void* const* ins, void* const* outs,
                    void* const* scratch0, void* const* scratch1,
                    const int* nz, int n_fields, const int* desc,
                    const double* coefs, const int* geoms, const int* grids,
                    int k, int block_z, int block_y, const int* host_desc,
                    int hazard, long long stage_bytes, int batch,
                    int device, void* stream) {
  return launch_sweep<double>(ins, outs, scratch0, scratch1, nz, n_fields,
                              desc, coefs, geoms, grids, k, block_z, block_y,
                              host_desc, hazard, stage_bytes, batch, device,
                              static_cast<cudaStream_t>(stream));
}

const char* fused_stencil_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
