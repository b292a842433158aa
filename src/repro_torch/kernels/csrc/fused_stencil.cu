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
// The two modes differ only in the origins and row strides of Geom.  One generic
// kernel serves every loop body: instead of a source generated per program,
// it reads the body's canonical tap form from a small descriptor that the
// host flattens from the LoweredGroup (repro_torch/kernels/fused.py,
// _encode), and it is templated on float / double.
//
// What it computes, per launch: for each AffineUpdate, in program order,
//     field[z0:z0+zlen] = const + sum_g c_g * (sum_p prod_t tap_{g,p,t})
// on the interior (x, y) cells, with at most 2 taps per product.  Each block
// owns an output tile and loads the tile's window k*h cells deeper on each
// side from the wrap-padded inputs; it applies the body k times, the valid
// region shrinking by h per sub-step (trapezoid).  The Dirichlet Moat mask
// comes from global coordinates (coords + tile origin), taken mod (nx, ny)
// when `wrap`.  Later updates read earlier updates' centre values.  z planes
// outside [z0, z0+zlen) are copied through unchanged.
//
// Association: taps that share a coefficient are summed first, in recorded
// order, and multiplied once; the groups are then added in order of first
// appearance, then `const` — the association of the Pallas body, which is
// what keeps the kernel within 1 ulp of the roll interpreter.
//
// Design (right first; speed is later work):
// - One thread per (x, y, z) cell of the tile's current region, z the
//   contiguous axis, block-stride over the region.  Layout stays (X, Y, Z).
// - k > 1: sub-steps run on block-private scratch windows in global memory
//   (two per written field, ping-pong), with __syncthreads() between them.
//   No block reads another block's output inside a launch.
// - __syncthreads() separates the updates of one sub-step, because a later
//   update may read an earlier one's result at another z.  An update that
//   re-writes a field while reading that field's new value at dz != 0 first
//   writes to a block-private temporary (the host flags it as a hazard).
// - The descriptor is copied into shared memory once per block.
//
// FMA contraction: build with --fmad=false.  Every multiply and add then
// rounds on its own, as the plain PyTorch version's separate elementwise
// kernels do, so the kernel is held *bitwise* against fused_step_ref on the
// card at float and double.  Turning contraction on is a decision for a
// later performance change.
//
// Bound: bytes.  At k = 1 a launch reads each padded input once and writes
// each output once: for the heat3d body at 512 x 512 x 128 float, about
// 2 x 134 MB per step, against about 9 flops per cell.  The design does
// nothing about that bound yet: no shared-memory staging, TMA or z chunking;
// the k > 1 scratch windows go through device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libfused_stencil.so
// The C entry returns cudaGetLastError() after the launch; 0 is success.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxFields = 16;
// update header: field, z0, zlen, nz, first_write, hazard, n_groups,
//                coef_base, next_update_offset
constexpr int kUpdHeader = 9;
// one tap: field, dz, dx, dy, from_center
constexpr int kTapInts = 5;

template <typename T>
struct Fields {
  const T* in[kMaxFields];   // inputs, padded or resident (see Geom)
  T* out[kMaxFields];        // outputs of the written fields (see Geom)
  T* buf0[kMaxFields];       // scratch windows (k > 1), written fields
  T* buf1[kMaxFields];
  int nz[kMaxFields];
  int written[kMaxFields];
};

struct Geom {
  int bx, by;            // brick extent of the outputs
  int nx, ny;            // global extent (Moat)
  int cx, cy;            // global origin of the brick
  int k, h, wrap;
  int tile_x, tile_y;    // output tile of one block
  int tiles_x, tiles_y;
  int n_ints, n_coefs;
  int max_nz;
  int in_off, in_py;     // window origin (x and y) and row stride of inputs
  int out_off, out_py;   // brick origin (x and y) and row stride of outputs
};

template <typename T>
__global__ void __launch_bounds__(256)
fused_stencil_kernel(Fields<T> f, Geom g, T* tmp,
                     const int* __restrict__ desc_g,
                     const double* __restrict__ coef_g) {
  extern __shared__ double smem[];
  double* coefs = smem;
  int* desc = reinterpret_cast<int*>(smem + g.n_coefs);
  __shared__ const T* s_in[kMaxFields];
  __shared__ T* s_out[kMaxFields];
  __shared__ T* s_buf[2][kMaxFields];
  __shared__ int s_nz[kMaxFields];
  __shared__ int s_wr[kMaxFields];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kMaxFields; ++q) {
      s_in[q] = f.in[q];
      s_out[q] = f.out[q];
      s_buf[0][q] = f.buf0[q];
      s_buf[1][q] = f.buf1[q];
      s_nz[q] = f.nz[q];
      s_wr[q] = f.written[q];
    }
  }
  for (int q = threadIdx.x; q < g.n_coefs; q += blockDim.x) coefs[q] = coef_g[q];
  for (int q = threadIdx.x; q < g.n_ints; q += blockDim.x) desc[q] = desc_g[q];
  __syncthreads();

  const int kh = g.k * g.h;
  const int WX = g.tile_x + 2 * kh;     // scratch window extent (max)
  const int WY = g.tile_y + 2 * kh;
  const int n_tiles = g.tiles_x * g.tiles_y;
  const int n_updates = desc[0];
  const size_t win = (size_t)WX * WY;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // tile origin in brick coordinates; window cell (0, 0) sits k*h below
    const int x0 = (tile / g.tiles_y) * g.tile_x;
    const int y0 = (tile % g.tiles_y) * g.tile_y;
    const int wx = min(g.tile_x, g.bx - x0) + 2 * kh;
    const int wy = min(g.tile_y, g.by - y0) + 2 * kh;
    const int gx_w = g.cx + x0 - kh;
    const int gy_w = g.cy + y0 - kh;

    // value of field `fl` as sub-step s found it, at window cell (i, j, z)
    auto src = [&](int fl, int s, int i, int j, int z) -> T {
      const int nz = s_nz[fl];
      if (s == 0 || !s_wr[fl])
        return s_in[fl][((size_t)(g.in_off + x0 + i) * g.in_py +
                         (g.in_off + y0 + j)) * nz + z];
      return s_buf[(s - 1) & 1][fl][(size_t)blockIdx.x * win * nz +
                                    ((size_t)i * WY + j) * nz + z];
    };
    // where sub-step s writes field `fl` at window cell (i, j, z)
    auto dst = [&](int fl, int s, int i, int j, int z) -> T* {
      const int nz = s_nz[fl];
      if (s == g.k - 1)
        return s_out[fl] + ((size_t)(g.out_off + x0 + i - kh) * g.out_py +
                            (g.out_off + y0 + j - kh)) * nz + z;
      return s_buf[s & 1][fl] + (size_t)blockIdx.x * win * nz +
             ((size_t)i * WY + j) * nz + z;
    };
    auto tap = [&](const int* t, int s, int i, int j, int z) -> T {
      // t: field, dz, dx, dy, from_center
      if (t[4]) return *dst(t[0], s, i, j, z + t[1]);
      return src(t[0], s, i + t[2], j + t[3], z + t[1]);
    };
    auto interior = [&](int i, int j) -> bool {
      int gx = gx_w + i, gy = gy_w + j;
      if (g.wrap) {
        gx = ((gx % g.nx) + g.nx) % g.nx;
        gy = ((gy % g.ny) + g.ny) % g.ny;
      }
      return gx > 0 && gx < g.nx - 1 && gy > 0 && gy < g.ny - 1;
    };

    for (int s = 0; s < g.k; ++s) {
      const int lo = (s + 1) * g.h;     // output region [lo, w - lo)
      const int ox = wx - 2 * lo;
      const int oy = wy - 2 * lo;
      int pos = 1;
      for (int u = 0; u < n_updates; ++u) {
        const int* hd = desc + pos;
        const int fl = hd[0], z0 = hd[1], zlen = hd[2], nz = hd[3];
        const int first = hd[4], hazard = hd[5], n_groups = hd[6], cb = hd[7];
        const int body = pos + kUpdHeader;
        // the first write of a field in a sub-step also carries the
        // unwritten z planes and the Moat cells through
        const int zb = first ? 0 : z0;
        const int zn = first ? nz : zlen;
        const long long ncell = (long long)ox * oy * zn;
        for (long long c = threadIdx.x; c < ncell; c += blockDim.x) {
          const int z = zb + (int)(c % zn);
          const long long r = c / zn;
          const int j = lo + (int)(r % oy);
          const int i = lo + (int)(r / oy);
          T val;
          if (z >= z0 && z < z0 + zlen && interior(i, j)) {
            int q = body;
            T acc = T(0);
            bool have = false;
            for (int gi = 0; gi < n_groups; ++gi) {
              const int n_prod = desc[q++];
              T gsum = T(0);
              for (int p = 0; p < n_prod; ++p) {
                const int n_taps = desc[q++];
                T t = tap(desc + q, s, i, j, z);
                q += kTapInts;
                for (int tt = 1; tt < n_taps; ++tt) {
                  t = t * tap(desc + q, s, i, j, z);
                  q += kTapInts;
                }
                gsum = (p == 0) ? t : gsum + t;
              }
              const double cf = coefs[cb + 1 + gi];
              const T tg = (cf != 1.0) ? static_cast<T>(cf) * gsum : gsum;
              acc = have ? acc + tg : tg;
              have = true;
            }
            const double cst = coefs[cb];
            if (!have)
              acc = static_cast<T>(cst);
            else if (cst != 0.0)
              acc = acc + static_cast<T>(cst);
            val = acc;
          } else if (first) {
            val = src(fl, s, i, j, z);
          } else {
            continue;  // earlier update's value already in place
          }
          if (hazard)
            tmp[(size_t)blockIdx.x * win * g.max_nz +
                ((size_t)i * WY + j) * g.max_nz + z] = val;
          else
            *dst(fl, s, i, j, z) = val;
        }
        if (hazard) {
          __syncthreads();
          const long long nwin = (long long)ox * oy * zlen;
          for (long long c = threadIdx.x; c < nwin; c += blockDim.x) {
            const int z = z0 + (int)(c % zlen);
            const long long r = c / zlen;
            const int j = lo + (int)(r % oy);
            const int i = lo + (int)(r / oy);
            if (interior(i, j))
              *dst(fl, s, i, j, z) =
                  tmp[(size_t)blockIdx.x * win * g.max_nz +
                      ((size_t)i * WY + j) * g.max_nz + z];
          }
        }
        __syncthreads();
        pos = hd[8];
      }
    }
  }
}

template <typename T>
int launch(const void* const* ins, void* const* outs, void* const* buf0,
           void* const* buf1, void* tmp, const int* nz, const int* written,
           int n_fields, const int* desc, const double* coefs,
           const int* geom, int grid, int threads, int device,
           cudaStream_t stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
  // launch on the tensors' card, and give the calling thread back its own
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  Fields<T> f = {};
  for (int q = 0; q < n_fields; ++q) {
    f.in[q] = static_cast<const T*>(ins[q]);
    f.out[q] = static_cast<T*>(outs[q]);
    f.buf0[q] = static_cast<T*>(buf0[q]);
    f.buf1[q] = static_cast<T*>(buf1[q]);
    f.nz[q] = nz[q];
    f.written[q] = written[q];
  }
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
  g.tile_x = geom[9];
  g.tile_y = geom[10];
  g.tiles_x = geom[11];
  g.tiles_y = geom[12];
  g.n_ints = geom[13];
  g.n_coefs = geom[14];
  g.max_nz = geom[15];
  g.in_off = geom[16];
  g.in_py = geom[17];
  g.out_off = geom[18];
  g.out_py = geom[19];
  const size_t smem = (size_t)g.n_coefs * sizeof(double) +
                      (size_t)g.n_ints * sizeof(int);
  fused_stencil_kernel<T><<<grid, threads, smem, stream>>>(
      f, g, static_cast<T*>(tmp), desc, coefs);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

extern "C" {

int fused_stencil_f32(const void* const* ins, void* const* outs,
                      void* const* buf0, void* const* buf1, void* tmp,
                      const int* nz, const int* written, int n_fields,
                      const int* desc, const double* coefs, const int* geom,
                      int grid, int threads, int device, void* stream) {
  return launch<float>(ins, outs, buf0, buf1, tmp, nz, written, n_fields, desc,
                       coefs, geom, grid, threads, device,
                       static_cast<cudaStream_t>(stream));
}

int fused_stencil_f64(const void* const* ins, void* const* outs,
                      void* const* buf0, void* const* buf1, void* tmp,
                      const int* nz, const int* written, int n_fields,
                      const int* desc, const double* coefs, const int* geom,
                      int grid, int threads, int device, void* stream) {
  return launch<double>(ins, outs, buf0, buf1, tmp, nz, written, n_fields,
                        desc, coefs, geom, grid, threads, device,
                        static_cast<cudaStream_t>(stream));
}

const char* fused_stencil_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
