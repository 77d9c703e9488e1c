// Hopper (sm_90a) kernels for the 3D stencils of the Navier-Stokes step,
// bound to PyTorch through a plain C interface (ctypes); see
// sopht_mpi_tpu_torch/ops/cuda_stencils_3d.py for the wrappers and the plain
// PyTorch versions they are held against.
//
// Layout: vector fields are (3, nz, ny, nx) contiguous, components (x, y, z),
// x the fastest array axis. "Ring" is any cell with index 0 or n-1 on any
// axis. Scalar prefactors are read from device memory (0-d tensors), so the
// host never has to know dt.
//
// Launch shape of the single-device kernels (every one but the filters'
// z-marching kernels and conv_filter_line_kernel): one thread per output
// cell, blocks of 32 x 8 threads over (x, y), one grid row of blocks per
// z-plane, so a warp reads 32 neighbouring x cells (coalesced) and no
// thread divides an index by a cell count.
//
// The sharded kernels: curl_zmarch_kernel, rotational_zmarch_kernel and
// diffusion_zmarch_kernel (after the single-device kernels). A sharded
// field is (S, 3, nz, ny, nx), S = pz * py shards of a (pz, py) mesh over
// (z, y), each shard a contiguous block of its own; one launch covers all
// shards. Three-point stencils need no corner halos. Wall masks, clamps and
// ramps take the cell's GLOBAL (z, y) from the shard's offsets (coords[2
// s], coords[2 s + 1]) and the grid's (NZ, NY), so a shard seam is
// interior; the wraparound halo of a shard on a physical wall is only ever
// next to ring cells, which read no neighbour. The TPU kernels' y tiles,
// 8-row seam strips and plane selects are VMEM bookkeeping with no
// counterpart here.
//   Replace _curl_sharded_kernel (launched in _curl_sharded_impl),
//   _rotational_sharded_kernel (_rotational_sharded_impl),
//   _diffusion_sharded_kernel (_diffusion_sharded_impl) and
//   _diffpen_sharded_kernel (_diffpen_sharded_impl): the curl, the
//   rotational transport, the diffusion step and the diffusion step with
//   the wall sponge below on a sharded field, reading the shard's own
//   block and the four halo buffers the exchange made for it, never a
//   ghosted copy: zlo / zhi (S, 3, 1, ny, nx), the planes below each
//   shard's first and above its last, and ylo / yhi (S, 3, nz, 1, nx), the
//   rows below its first and above its last.
//   A block owns a TX x TY tile of (x, y) cells of one shard and marches
//   along z through a chunk of zchunk of its planes (grid: tiles, chunks,
//   shards); a thread owns one cell of each plane. The chunk's planes and
//   the two beyond it arrive, with a one-cell x and y halo, in a ring of
//   `stages` shared-memory tiles by cp.async (16-byte copies of the rows
//   where nx and the pointers allow, an element a copy at the halo columns
//   and otherwise), plane k + stages - 2 issued as plane k arrives, so the
//   centre plane k - 1 stays in the ring. A thread works out where each of
//   its copies lands and starts once; for a plane it only steps the
//   source. Only the loader knows where a row comes from (the block, a z
//   plane buffer, a y row buffer); the arithmetic reads the tile. The z
//   neighbours at a thread's cell stay in registers as the march rolls on;
//   the centre plane's in-plane neighbours come from its tile. The
//   launch bound caps a thread at 64 registers. The rotational
//   transport forms q = u x w once per cell of a plane's tile, halo cells
//   included, into one of two q tiles (the single-device kernel forms each
//   cell's seven times). The curl's l1 max is folded a block into its
//   shard's slot. A launch plan (tile, chunk, stages, shared bytes, blocks,
//   16-byte copies; sharded_stencil_plan) is checked by the launcher.
//   The diffusion pair's walk keeps the plane below the centre too, so the
//   sponge forms each cell's diffusion at its in-plane clamp source's place
//   in the tiles, and the z band's source plane writes the band's planes:
//   no thread takes another path than its neighbours. Where a source lies
//   in another tile, the scattering instance takes over.
//   Bound: HBM bytes, each input field and its halo buffers read once and
//   the output written once (24 B a cell for the curl and the diffusion
//   pair, 36 for the transport, at f32). The tile's halo over-read, (TX +
//   2)(TY + 2) / (TX TY), and the two extra planes a chunk mostly hit L2.
//
// rotational_curl_add_3d
//   Replaces sopht_mpi_tpu/ops/pallas_stencils_3d.py
//   rotational_curl_add_3d_pallas (kernel _rotational_kernel).
//   out = w + pref * curl(u x w), the cross product taken at each of the six
//   neighbours; ring cells keep w.
//   Bound: HBM bytes, 2 fields read + 1 written = 36 B/cell at f32. The TPU
//   kernel streamed z-planes through VMEM; here each thread owns one cell
//   and re-reads its neighbours through L1/L2 (a block's x/y neighbours sit
//   in L1, the z-neighbour planes of all blocks in flight fit the 50 MB L2),
//   so device memory sees each input about once.
//
// diffusion_penalise_vector_3d
//   Replaces diffusion_penalise_vector_3d_pallas (kernel
//   _diffusion_penalise_kernel).
//   out = r(z) r(y) r(x) * D[clamp(z), clamp(y), clamp(x)], clamp to
//   [w-1, n-w], r the sine ramp of the wall sponge, D = f + p * lap7(f) on
//   the interior and f on the ring.
//   Bound: 1 field read + 1 written = 24 B/cell at f32. Same one-cell-per-
//   thread design; the clamp makes sponge cells read their source's stencil
//   straight away instead of a second pass over the diffused field.
//
// curl_3d
//   Replaces curl_3d_pallas (kernel _curl_kernel).
//   out = pref * curl(psi) (0 on the ring) + add[c]; optionally
//   l1 = max over cells of |u_x| + |u_y| + |u_z|.
//   Bound: 24 B/cell at f32. The TPU carried a per-plane max through its
//   sequential grid; blocks here run in no order, so each block reduces its
//   cells (warp shuffles, then shared memory) and folds the result into a
//   zeroed device scalar with atomicMax on the bit pattern, which orders
//   non-negative IEEE floats like the values.
//
// The filtered transport (filter on, or no sponge) runs the next three
// kernels in turn: diffusion, the Laplacian filter, the wall sponge.
//
// diffusion_vector_3d
//   Replaces diffusion_timestep_vector_3d_pallas (kernel _diffusion_kernel).
//   out = f + p * lap7(f) on the interior, f on the ring. Bound: 24 B/cell
//   at f32; the same one-cell-per-thread design as the fused kernel.
//
// mult_filter_3d_zmarch (mult_filter_zmarch_kernel)
//   Replaces laplacian_filter_vector_3d_pallas, multiplicative type (kernel
//   _mult_filter_kernel, launched in _mult_filter_pass), one launch per
//   filter application.
//   res = clear . H_z . clear . H_y . clear . H_x (buf), H = 0.25 (2f - f+ -
//   f-) along one axis, "clear" zeroing the ring (the z-wall planes
//   included); with orig given, out = orig - res (the last application).
//   The output cell needs the 27-point neighbourhood. A single-device
//   launch of the sharded kernels' z-march (below): a block marches its
//   tile's planes, each read from HBM once into the ring (no halo buffers:
//   the rows and planes beyond the field are never loaded, and only ring
//   cells sit next to them). As a plane arrives the block forms clear . H_x
//   of its tile rows and the two halo rows once, into a shared tile (the
//   halo rows need the tile's corners, so its x halo columns are copied on
//   rows 0 ... TY + 1); after a barrier each thread forms clear . H_y at its
//   cell and keeps it in a register, and from the last three writes the
//   output of the plane below (the TPU kernel read each plane three times).
//   With orig = buf (order 1) the centre value comes from the ring: 24
//   B/cell at f32, 32 with another orig, the bound.
//
// conv_filter_3d_zmarch (conv_filter_zmarch_kernel)
//   Replaces the same function's convolution type (_conv_filter_stage,
//   kernels _conv_inplane_kernel, _conv_z_kernel, _conv_z_single_kernel:
//   one pallas_call a stage, or k for a z stage that does not fit VMEM) at
//   orders k = 1 ... 5, one launch for the whole filter: per axis x, y, z
//   in turn, g - (clear . H_a)^k g. Plane z's in-plane stages need a k-cell
//   halo, its z stage planes z - k ... z + k, so a single-device launch of
//   the z-march walks k planes beyond each end of its chunk with a k-cell
//   tile halo, forms the x stage's k levels of each tile row in registers
//   (runs of cells from 16-byte shared loads; the redundant halo levels
//   buy the 2k - 2 barriers a plane of levels ping-ponged in shared memory,
//   a design 1.8 times slower at k = 5: tools/conv_filter_pingpong.cu), the y
//   stage's likewise down the columns, and rolls the z stage one level a
//   plane through registers (k high-passes a cell, not k^2). Bound: 24
//   B/cell at f32, one read and one write; the in-plane halo's (TY + 2k) /
//   TY rows and the levels' high-passes (about 115 a thread a plane at k =
//   5) are what hold it back.
//
// conv_filter_line_3d, conv_filter_z_pass_3d (conv_filter_line_kernel,
// conv_filter_z_pass_kernel)
//   The convolution type above order 5, where conv_filter_zmarch_kernel
//   has no instance: the in-plane stages are one launch each, a thread
//   sweeping one x-line (or y-line) k times in place in the output; the z
//   stage is k launches of a 3-plane pass, the last fused with the
//   subtraction.
//
// penalise_vector_3d
//   Replaces penalise_field_boundary_vector_3d_pallas (kernel
//   _penalise_kernel). out = r(z) r(y) r(x) * f[clamp(z), clamp(y),
//   clamp(x)], the clamp and ramp of the fused kernel above, with the ramp
//   values sin(pi k / 2w) read from device memory (computed in double on
//   the host). Bound: 24 B/cell at f32, one pass.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

__device__ __forceinline__ float sin_t(float v) { return sinf(v); }
__device__ __forceinline__ double sin_t(double v) { return sin(v); }
__device__ __forceinline__ float abs_t(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_t(double v) { return fabs(v); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// The extent of a sharded launch: a shard's (nz, ny, nx) and the grid's
// extent along the sharded axes (NZ, NY).
struct Geom {
  int nz, ny, nx;
  int NZ, NY;
};

// The cell this thread owns on a single-device launch: (z, y, x) and its
// index i in an (nz, ny, nx) component. False for the ragged edge of the
// launch.
struct Cell {
  int x, y, z;
  long long i;
};

__device__ __forceinline__ bool this_cell(int nz, int ny, int nx, Cell& c) {
  c.x = blockIdx.x * kBlockX + threadIdx.x;
  c.y = blockIdx.y * kBlockY + threadIdx.y;
  c.z = blockIdx.z;
  c.i = ((long long)c.z * ny + c.y) * nx + c.x;
  return c.x < nx && c.y < ny;
}

__device__ __forceinline__ bool on_ring(int z, int y, int x, int nz, int ny,
                                        int nx) {
  return z == 0 || y == 0 || x == 0 || z == nz - 1 || y == ny - 1 ||
         x == nx - 1;
}

template <typename T>
__device__ __forceinline__ void cross_at(const T* __restrict__ u,
                                         const T* __restrict__ w,
                                         long long i, long long n, T q[3]) {
  const T u0 = __ldg(u + i), u1 = __ldg(u + n + i), u2 = __ldg(u + 2 * n + i);
  const T w0 = __ldg(w + i), w1 = __ldg(w + n + i), w2 = __ldg(w + 2 * n + i);
  q[0] = u1 * w2 - u2 * w1;
  q[1] = u2 * w0 - u0 * w2;
  q[2] = u0 * w1 - u1 * w0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rotational_curl_add_kernel(const T* __restrict__ w,
                               const T* __restrict__ u,
                               const T* __restrict__ pref,
                               T* __restrict__ out, int nz, int ny, int nx) {
  Cell c;
  if (!this_cell(nz, ny, nx, c)) return;
  const long long sy = nx;
  const long long sz = (long long)ny * nx;
  const long long n = sz * nz;
  const long long i = c.i;
  const T w0 = __ldg(w + i), w1 = __ldg(w + n + i), w2 = __ldg(w + 2 * n + i);
  if (on_ring(c.z, c.y, c.x, nz, ny, nx)) {
    out[i] = w0;
    out[n + i] = w1;
    out[2 * n + i] = w2;
    return;
  }
  T qxp[3], qxm[3], qyp[3], qym[3], qzp[3], qzm[3];
  cross_at(u, w, i + 1, n, qxp);
  cross_at(u, w, i - 1, n, qxm);
  cross_at(u, w, i + sy, n, qyp);
  cross_at(u, w, i - sy, n, qym);
  cross_at(u, w, i + sz, n, qzp);
  cross_at(u, w, i - sz, n, qzm);
  const T p = *pref;
  // component order of _curl_planes: curl_x = d_y q_z - d_z q_y, ...
  out[i] = w0 + p * ((qyp[2] - qym[2]) - (qzp[1] - qzm[1]));
  out[n + i] = w1 + p * ((qzp[0] - qzm[0]) - (qxp[2] - qxm[2]));
  out[2 * n + i] = w2 + p * ((qxp[1] - qxm[1]) - (qyp[0] - qym[0]));
}

// Sponge ramp: sin(pi/2 k / w) at distance k < w from a wall, 1 inside.
template <typename T>
__device__ __forceinline__ T ramp(int i, int n, int w) {
  const int k = i < w ? i : (i > n - 1 - w ? n - 1 - i : -1);
  if (k < 0) return T(1);
  return sin_t(T(0.5 * 3.14159265358979323846) * T(k) / T(w));
}

// Sponge source: cells within w of a wall take the value of cell w-1
// (n-w at the high wall).
__device__ __forceinline__ int clamp_src(int i, int n, int w) {
  return i < w - 1 ? w - 1 : (i > n - w ? n - w : i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diffusion_penalise_kernel(const T* __restrict__ f,
                              const T* __restrict__ pref,
                              T* __restrict__ out, int nz, int ny, int nx,
                              int width) {
  Cell c;
  if (!this_cell(nz, ny, nx, c)) return;
  const long long sz = (long long)ny * nx;
  const long long n = sz * nz;
  // the clamp source: at most width - 1 cells away
  const int xs = clamp_src(c.x, nx, width);
  const int ys = clamp_src(c.y, ny, width);
  const int zs = clamp_src(c.z, nz, width);
  const long long s = ((long long)zs * ny + ys) * nx + xs;
  const bool interior = !on_ring(zs, ys, xs, nz, ny, nx);
  const T rx = ramp<T>(c.x, nx, width);
  const T ry = ramp<T>(c.y, ny, width);
  const T rz = ramp<T>(c.z, nz, width);
  const T p = *pref;
  // every component's seven values first, then the sums: 21 loads in flight
  // (read after each sum, the loads ran 5% slower on an H100)
  T val[3][7];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T* fc = f + k * n;
    val[k][0] = __ldg(fc + s);
    if (interior) {
      val[k][1] = __ldg(fc + s + sz);
      val[k][2] = __ldg(fc + s - sz);
      val[k][3] = __ldg(fc + s + nx);
      val[k][4] = __ldg(fc + s - nx);
      val[k][5] = __ldg(fc + s + 1);
      val[k][6] = __ldg(fc + s - 1);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T center = val[k][0];
    T v = center;
    if (interior) {
      // summation order of the plain version: -6 f, then the z, y and x
      // neighbour pairs
      T lap = T(-6) * center;
      lap = (lap + val[k][1]) + val[k][2];
      lap = (lap + val[k][3]) + val[k][4];
      lap = (lap + val[k][5]) + val[k][6];
      v = center + p * lap;
    }
    // the plain version ramps along x, then y, then z
    out[k * n + c.i] = ((v * rx) * ry) * rz;
  }
}

__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_nonneg(double* addr, double v) {
  atomicMax(reinterpret_cast<unsigned long long*>(addr),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    curl_kernel(const T* __restrict__ psi, const T* __restrict__ pref,
                const T* __restrict__ add, T* __restrict__ out,
                T* __restrict__ l1_max, int nz, int ny, int nx) {
  Cell c;
  const bool valid = this_cell(nz, ny, nx, c);
  T l1 = T(0);
  if (valid) {
    const long long sz = (long long)ny * nx;
    const long long n = sz * nz;
    const long long i = c.i;
    T c0 = T(0), c1 = T(0), c2 = T(0);
    if (!on_ring(c.z, c.y, c.x, nz, ny, nx)) {
      const T* p0 = psi;
      const T* p1 = psi + n;
      const T* p2 = psi + 2 * n;
      const T p = *pref;
      c0 = p * ((__ldg(p2 + i + nx) - __ldg(p2 + i - nx)) -
                (__ldg(p1 + i + sz) - __ldg(p1 + i - sz)));
      c1 = p * ((__ldg(p0 + i + sz) - __ldg(p0 + i - sz)) -
                (__ldg(p2 + i + 1) - __ldg(p2 + i - 1)));
      c2 = p * ((__ldg(p1 + i + 1) - __ldg(p1 + i - 1)) -
                (__ldg(p0 + i + nx) - __ldg(p0 + i - nx)));
    }
    if (add != nullptr) {
      c0 = c0 + add[0];
      c1 = c1 + add[1];
      c2 = c2 + add[2];
    }
    out[i] = c0;
    out[n + i] = c1;
    out[2 * n + i] = c2;
    l1 = (abs_t(c0) + abs_t(c1)) + abs_t(c2);
  }
  if (l1_max == nullptr) return;  // uniform across the launch
  // block max: warp shuffles, then one value per warp through shared memory
  for (int off = 16; off > 0; off >>= 1)
    l1 = max_t(l1, __shfl_down_sync(0xffffffffu, l1, off));
  __shared__ T warp_max[kThreads / 32];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) warp_max[warp] = l1;
  __syncthreads();
  if (warp == 0) {
    l1 = lane < kThreads / 32 ? warp_max[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1)
      l1 = max_t(l1, __shfl_down_sync(0xffffffffu, l1, off));
    if (lane == 0) atomic_max_nonneg(l1_max, l1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diffusion_kernel(const T* __restrict__ f, const T* __restrict__ pref,
                     T* __restrict__ out, int nz, int ny, int nx) {
  Cell c;
  if (!this_cell(nz, ny, nx, c)) return;
  const long long sz = (long long)ny * nx;
  const long long n = sz * nz;
  const long long i = c.i;
  const bool interior = !on_ring(c.z, c.y, c.x, nz, ny, nx);
  const T p = *pref;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T* fc = f + k * n;
    const T center = __ldg(fc + i);
    T v = center;
    if (interior) {
      // summation order of the plain version (see diffusion_penalise_kernel)
      T lap = T(-6) * center;
      lap = (lap + __ldg(fc + i + sz)) + __ldg(fc + i - sz);
      lap = (lap + __ldg(fc + i + nx)) + __ldg(fc + i - nx);
      lap = (lap + __ldg(fc + i + 1)) + __ldg(fc + i - 1);
      v = center + p * lap;
    }
    out[k * n + i] = v;
  }
}

// One directional high-pass, in the plain version's order.
template <typename T>
__device__ __forceinline__ T highpass(T center, T plus, T minus) {
  return T(0.25) * ((T(2) * center - plus) - minus);
}

// A thread owns one line of the in-plane stage: an x-line (axis 0) indexed
// by (component, z, y), or a y-line (axis 1) indexed by (component, z, x).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_filter_line_kernel(const T* __restrict__ f, T* __restrict__ out,
                            int nz, int ny, int nx, int axis, int k) {
  const long long line = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int across = axis == 0 ? ny : nx;  // the other in-plane axis
  const long long n_lines = 3LL * nz * across;
  if (line >= n_lines) return;
  const int a = (int)(line % across);
  const int z = (int)((line / across) % nz);
  const long long comp = line / ((long long)across * nz);
  const int len = axis == 0 ? nx : ny;
  const long long stride = axis == 0 ? 1 : nx;
  const long long base = comp * nz * ny * nx + (long long)z * ny * nx +
                         (axis == 0 ? (long long)a * nx : (long long)a);
  const T* src = f + base;
  T* dst = out + base;
  for (int i = 0; i < len; ++i) dst[i * stride] = src[i * stride];
  // H^k is zero on a line on a z wall or on the other in-plane axis' ring,
  // and on a line with no interior cell: out = f there
  if (z == 0 || z == nz - 1 || a == 0 || a == across - 1 || len < 3) return;
  for (int it = 0; it < k; ++it) {
    T prev = dst[0];  // the old left neighbour
    dst[0] = T(0);
    for (int i = 1; i < len - 1; ++i) {
      const T cur = dst[i * stride];
      dst[i * stride] = highpass(cur, dst[(i + 1) * stride], prev);
      prev = cur;
    }
    dst[(len - 1) * stride] = T(0);
  }
  for (int i = 0; i < len; ++i) dst[i * stride] = src[i * stride] - dst[i * stride];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_filter_z_pass_kernel(const T* __restrict__ buf,
                              const T* __restrict__ orig,
                              T* __restrict__ out, int nz, int ny, int nx) {
  Cell c;
  if (!this_cell(nz, ny, nx, c)) return;
  const long long sz = (long long)ny * nx;
  const long long n = sz * nz;
  const bool interior = !on_ring(c.z, c.y, c.x, nz, ny, nx);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T* fc = buf + k * n;
    const T res = interior ? highpass(__ldg(fc + c.i), __ldg(fc + c.i + sz),
                                      __ldg(fc + c.i - sz))
                           : T(0);
    out[k * n + c.i] = orig != nullptr ? __ldg(orig + k * n + c.i) - res : res;
  }
}

// Sponge weight at index i of an n-cell axis: ramp[k] at distance k < w
// from a wall, 1 inside.
template <typename T>
__device__ __forceinline__ T ramp_at(const T* __restrict__ ramp, int i, int n,
                                     int w) {
  const int k = i < w ? i : (i > n - 1 - w ? n - 1 - i : -1);
  return k < 0 ? T(1) : __ldg(ramp + k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    penalise_kernel(const T* __restrict__ f, const T* __restrict__ ramp,
                    T* __restrict__ out, int nz, int ny, int nx, int width) {
  Cell c;
  if (!this_cell(nz, ny, nx, c)) return;
  const long long n = (long long)nz * ny * nx;
  const long long s =
      ((long long)clamp_src(c.z, nz, width) * ny + clamp_src(c.y, ny, width)) *
          nx +
      clamp_src(c.x, nx, width);
  const T rx = ramp_at(ramp, c.x, nx, width);
  const T ry = ramp_at(ramp, c.y, ny, width);
  const T rz = ramp_at(ramp, c.z, nz, width);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // the plain version ramps along x, then y, then z
    out[k * n + c.i] = ((__ldg(f + k * n + s) * rx) * ry) * rz;
  }
}

inline dim3 grid_of(int nz, int ny, int nx) {
  return dim3((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY, nz);
}

// ---------------------------------------------------------------------------
// The z-marching sharded kernels: curl_zmarch_kernel,
// rotational_zmarch_kernel, diffusion_zmarch_kernel (see the file's head).
// Shared pieces first.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one element (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Wait until at most `pending` (0 ... 3) of this thread's copy groups are
// pending: the walk's ring keeps that many planes in flight behind the one
// it waits for.
__device__ __forceinline__ void cp_async_wait_ring(int pending) {
  if (pending == 0)
    cp_async_wait<0>();
  else if (pending == 1)
    cp_async_wait<1>();
  else if (pending == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// One sharded field as the exchange hands it over, each pointer at component
// 0 of shard 0: the shards' blocks f (S, 3, nz, ny, nx); zlo and zhi (S, 3,
// 1, ny, nx), the planes below each shard's first and above its last; ylo
// and yhi (S, 3, nz, 1, nx), the rows below its first and above its last.
template <typename T>
struct HaloSrc {
  const T* f;
  const T* zlo;
  const T* zhi;
  const T* ylo;
  const T* yhi;
};

// Threads an SM holds at the kernels' launch bound, which caps a thread at
// 64 registers (sharded_stencil_plan counts on it).
constexpr int kZmarchSmThreads = 1024;

// A block's plane tile in shared memory: a component is R = TY + 2 rows of
// W = TX + 2 V values, row r holding grid row y0 - 1 + r and column col
// holding x = x0 - V + col, so the tile's cells start 16 bytes into a row
// and every row starts on 16 bytes; the halo columns are V - 1 and V + TX.
template <typename T, int TX, int TY>
struct ZTile {
  static constexpr int NT = TX * TY;               // threads: a cell each
  static constexpr int V = 16 / (int)sizeof(T);    // values a 16-byte copy
  static constexpr int W = TX + 2 * V;
  static constexpr int R = TY + 2;
  static constexpr int CT = R * W;                 // one component
  static constexpr int NB = 2 * TX + 2 * TY;       // halo cells, no corners
};

// The copies of a plane tile: 3 NF components (field a's, then b's),
// component j at stage + j CT. A copy item is a run of the tile's rows, y
// halo rows included (HALO false: TX / V 16-byte runs a row with VEC, TX
// single values without), or one value of the x halo columns of rows 1 ...
// TY (HALO true; the three-point stencils never read the corners), or of
// rows 0 ... TY + 1 with CORNERS (the filter's H_x of the y halo rows). A
// thread owns items tid, tid + NT, ...: the same for every plane, so it
// works out each item's place once (set) and, for every plane, only where
// the plane's row starts (issue). A row is the block's own, or one of its y
// row buffers (both: body + z stride), or, on the planes z = -1 and nz, the
// z plane buffers' (zoff; a y halo row has none there). A single-device
// launch has no halo buffers (null): rows -1 and ny and planes -1 and nz
// are not copied. Cells outside the grid are not written; only masked
// cells read them.
template <typename T, int TX, int TY, int NF, bool HALO, bool VEC,
          bool CORNERS = false>
struct TileCopies {
  using Z = ZTile<T, TX, TY>;
  static constexpr int NC = 3 * NF;
  static constexpr int RUN = HALO || !VEC ? 1 : Z::V;   // values an item
  static constexpr int PER_ROW = HALO ? 2 : TX / RUN;
  static constexpr int ROWS = HALO && !CORNERS ? TY : Z::R;
  static constexpr int ITEMS = NC * ROWS * PER_ROW;
  static constexpr int N = (ITEMS + Z::NT - 1) / Z::NT;  // items a thread

  const T* body[N];   // the row's value at z = 0 (null: no row on body planes)
  long long zoff[N];  // its offset in a z plane buffer (-1: none)
  int stride[N];
  int dst[N];         // stage offset (-1: no copy)
  bool second[N];     // field b's

  __device__ __forceinline__ void set(const HaloSrc<T>& a, const HaloSrc<T>& b,
                                      int s, int y0, int x0, const Geom& g) {
    const long long plane = (long long)g.ny * g.nx;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int item = i * Z::NT + (int)threadIdx.x;
      body[i] = nullptr;
      zoff[i] = -1;
      stride[i] = 0;
      dst[i] = -1;
      second[i] = false;
      if (ITEMS % Z::NT != 0 && item >= ITEMS) continue;
      const int q = item % PER_ROW, rest = item / PER_ROW;
      const int r = HALO && !CORNERS ? 1 + rest % ROWS : rest % ROWS;
      const int j = rest / ROWS;
      const int x = HALO ? (q ? x0 + TX : x0 - 1) : x0 + q * RUN;
      const int ly = y0 - 1 + r;
      if (x < 0 || x >= g.nx || ly > g.ny) continue;
      const HaloSrc<T>& h = j < 3 ? a : b;
      if ((ly < 0 || ly == g.ny) && h.ylo == nullptr) continue;
      const long long comp = 3LL * s + j % 3;
      dst[i] = j * Z::CT + r * Z::W + Z::V + (x - x0);
      second[i] = j >= 3;
      if (ly < 0) {
        body[i] = h.ylo + comp * g.nz * g.nx + x;
        stride[i] = g.nx;
      } else if (ly == g.ny) {
        body[i] = h.yhi + comp * g.nz * g.nx + x;
        stride[i] = g.nx;
      } else {
        body[i] = h.f + comp * g.nz * plane + (long long)ly * g.nx + x;
        stride[i] = (int)plane;
        if (h.zlo != nullptr)
          zoff[i] = comp * plane + (long long)ly * g.nx + x;
      }
    }
  }

  // Issue plane z (-1 ... nz) into `stage`.
  __device__ __forceinline__ void issue(T* stage, const HaloSrc<T>& a,
                                        const HaloSrc<T>& b, int z,
                                        const Geom& g) const {
    const bool own = z >= 0 && z < g.nz;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (dst[i] < 0) continue;
      const T* src;
      if (own) {
        src = body[i] + (long long)z * stride[i];
      } else {
        if (zoff[i] < 0) continue;
        const HaloSrc<T>& h = second[i] ? b : a;
        src = (z < 0 ? h.zlo : h.zhi) + zoff[i];
      }
      if (RUN == 1)
        cp_async_elem(stage + dst[i], src);
      else
        cp_async16(stage + dst[i], src);
    }
  }
};

// Every copy of a plane tile: the rows, then the x halo columns (with or
// without the corners).
template <typename T, int TX, int TY, int NF, bool VEC, bool CORNERS>
struct PlaneCopies {
  TileCopies<T, TX, TY, NF, false, VEC> rows;
  TileCopies<T, TX, TY, NF, true, VEC, CORNERS> cols;

  __device__ __forceinline__ PlaneCopies(const HaloSrc<T>& a,
                                         const HaloSrc<T>& b, int s, int y0,
                                         int x0, const Geom& g) {
    rows.set(a, b, s, y0, x0, g);
    cols.set(a, b, s, y0, x0, g);
  }
  __device__ __forceinline__ void issue(T* stage, const HaloSrc<T>& a,
                                        const HaloSrc<T>& b, int z,
                                        const Geom& g) const {
    rows.issue(stage, a, b, z, g);
    cols.issue(stage, a, b, z, g);
  }
};

// The block's max of v over its threads into slot *dst (non-negative
// values): warp shuffles, then one value a warp through shared memory.
template <typename T, int NT>
__device__ __forceinline__ void block_max_into(T v, T* dst) {
  for (int off = 16; off > 0; off >>= 1)
    v = max_t(v, __shfl_down_sync(0xffffffffu, v, off));
  __shared__ T warp_max[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? warp_max[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1)
      v = max_t(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) atomic_max_nonneg(dst, v);
  }
}

// Where a block of a z-marching launch works: its shard s, the tile's
// corner (x0, y0), its thread's cell (x, y), the chunk's planes [za, zb).
struct ZWalk {
  int s, x0, y0, x, y, za, zb;
  bool valid;  // (x, y) lies in the shard
};

template <int TX, int TY>
__device__ __forceinline__ ZWalk zwalk(const Geom& g, int zchunk) {
  ZWalk w;
  const int tiles_x = (g.nx + TX - 1) / TX;
  w.s = blockIdx.z;
  w.x0 = (blockIdx.x % tiles_x) * TX;
  w.y0 = (blockIdx.x / tiles_x) * TY;
  w.x = w.x0 + threadIdx.x % TX;
  w.y = w.y0 + threadIdx.x / TX;
  w.za = blockIdx.y * zchunk;
  w.zb = min(w.za + zchunk, g.nz);
  w.valid = w.x < g.nx && w.y < g.ny;
  return w;
}

// The walk the z-marching kernels share. A chunk's planes and REACH planes
// beyond each end: plane k of the walk (z = za - REACH + k, k = 0 ... L -
// 1) sits in ring stage k % stages. The ring keeps the plane k - 1 and,
// with KEEP = 2, plane k - 2 below it readable (none with KEEP = 0), so
// stages - 1 - KEEP planes are in flight ahead. Iteration k waits for plane
// k, issues plane k + stages - 1 - KEEP into the stage plane k - 1 - KEEP
// left (last read in iteration k - 1, before this iteration's barrier)
// through issue(stage, z), and calls step(k, stage of plane k[, stage of
// plane k - 1[, stage of plane k - 2]]).
template <int KEEP, int REACH, typename T, class Issue, class Step>
__device__ __forceinline__ void zmarch_walk(T* ring, int stage_size,
                                            const ZWalk& w, int stages,
                                            Issue issue, Step step) {
  const int L = w.zb - w.za + 2 * REACH;
  const int ahead = stages - 1 - KEEP;
  for (int k = 0; k < ahead; ++k) {
    if (k < L) issue(ring + k * stage_size, w.za - REACH + k);
    cp_async_commit();
  }
  int slot = 0, prev = stages - 1;  // k % stages, (k - 1) % stages
  for (int k = 0; k < L; ++k) {
    cp_async_wait_ring(ahead - 1);
    __syncthreads();
    const int kn = k + ahead;
    if (kn < L) {
      // (k - 1 - KEEP) % stages
      const int back = slot + ahead < stages ? slot + ahead
                                             : slot + ahead - stages;
      issue(ring + back * stage_size, w.za - REACH + kn);
    }
    cp_async_commit();
    if constexpr (KEEP == 0) {
      step(k, ring + slot * stage_size);
    } else if constexpr (KEEP == 1) {
      step(k, ring + slot * stage_size, ring + prev * stage_size);
    } else {
      const int below = prev == 0 ? stages - 1 : prev - 1;  // (k - 2) % stages
      step(k, ring + slot * stage_size, ring + prev * stage_size,
           ring + below * stage_size);
    }
    prev = slot;
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
}

// The walk of the three-point kernels: one plane beyond each end of the
// chunk, each copied as PlaneCopies cut it; plane k - 1 is the centre of
// the cells whose output step k writes. CORNERS copies the tile's corners
// too.
template <typename T, int TX, int TY, int NF, bool VEC, int KEEP,
          bool CORNERS = false, class Step>
__device__ __forceinline__ void zmarch(T* ring, int stage_size,
                                       const HaloSrc<T>& a,
                                       const HaloSrc<T>& b, const ZWalk& w,
                                       const Geom& g, int stages, Step step) {
  const PlaneCopies<T, TX, TY, NF, VEC, CORNERS> copies(a, b, w.s, w.y0,
                                                        w.x0, g);
  zmarch_walk<KEEP, 1>(
      ring, stage_size, w, stages,
      [&](T* stage, int z) { copies.issue(stage, a, b, z, g); }, step);
}

// curl_zmarch_kernel: out = pref * curl(f) (0 on the global ring) + add[c],
// optionally l1_max[s] = max over the shard's cells of |u_x|+|u_y|+|u_z|.
// Step k takes plane k's f_x, f_y at the thread's cell (the z + 1 values of
// plane k - 1's cell) and writes plane k - 1's output from them, the
// registers of plane k - 2 and the centre tile's in-plane neighbours.
template <typename T, int TX, int TY, bool VEC>
__global__ void __launch_bounds__(TX * TY, kZmarchSmThreads / (TX * TY))
    curl_zmarch_kernel(HaloSrc<T> src, const int* __restrict__ coords,
                       const T* __restrict__ pref, const T* __restrict__ add,
                       T* __restrict__ out, T* __restrict__ l1_max, Geom g,
                       int zchunk, int stages) {
  using Z = ZTile<T, TX, TY>;
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int o = (threadIdx.x / TX + 1) * Z::W + Z::V + threadIdx.x % TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  T* dst = out + 3 * n * w.s + (long long)w.y * g.nx + w.x;
  const int gz0 = coords[2 * w.s], gy = coords[2 * w.s + 1] + w.y;
  const T p = *pref;
  // f_x, f_y at the thread's cell on planes k - 2 (m) and k - 1 (c)
  T f0m = T(0), f1m = T(0), f0c = T(0), f1c = T(0);
  T l1 = T(0);
  zmarch<T, TX, TY, 1, VEC, 1>(
      ring, 3 * Z::CT, src, src, w, g, stages,
      [&](int k, const T* t, const T* c) {
        const T f0 = t[o], f1 = t[Z::CT + o];
        if (k >= 2) {
          const int z = w.za + k - 2;
          T c0 = T(0), c1 = T(0), c2 = T(0);
          if (!on_ring(gz0 + z, gy, w.x, g.NZ, g.NY, g.nx)) {
            const T* c0t = c;
            const T* c1t = c + Z::CT;
            const T* c2t = c + 2 * Z::CT;
            // the plain version's order (curl_kernel)
            c0 = p * ((c2t[o + Z::W] - c2t[o - Z::W]) - (f1 - f1m));
            c1 = p * ((f0 - f0m) - (c2t[o + 1] - c2t[o - 1]));
            c2 = p * ((c1t[o + 1] - c1t[o - 1]) -
                      (c0t[o + Z::W] - c0t[o - Z::W]));
          }
          if (add != nullptr) {
            c0 = c0 + __ldg(add);
            c1 = c1 + __ldg(add + 1);
            c2 = c2 + __ldg(add + 2);
          }
          if (w.valid) {
            T* d = dst + z * plane;
            d[0] = c0;
            d[n] = c1;
            d[2 * n] = c2;
            l1 = max_t(l1, (abs_t(c0) + abs_t(c1)) + abs_t(c2));
          }
        }
        f0m = f0c;
        f1m = f1c;
        f0c = f0;
        f1c = f1;
      });
  if (l1_max == nullptr) return;  // uniform across the launch
  block_max_into<T, Z::NT>(l1, l1_max + w.s);
}

// q = u x w at cell i of a plane tile (w's components at t + c CT, u's at
// t + (3 + c) CT), the plain version's order (cross_product_3d).
template <typename T, int CT>
__device__ __forceinline__ void cross_tile(const T* t, int i, T& q0, T& q1,
                                           T& q2) {
  const T w0 = t[i], w1 = t[CT + i], w2 = t[2 * CT + i];
  const T u0 = t[3 * CT + i], u1 = t[4 * CT + i], u2 = t[5 * CT + i];
  q0 = u1 * w2 - u2 * w1;
  q1 = u2 * w0 - u0 * w2;
  q2 = u0 * w1 - u1 * w0;
}

// rotational_zmarch_kernel: out = w + pref * curl(u x w), w on the global
// ring. The curl's walk on a ring of w and u planes; step k forms q = u x w
// of plane k once per cell (the thread's cell into registers and the tile,
// the halo cells into the tile) in q tile k % 2, then writes plane k - 1's
// output from q tile (k - 1) % 2 (formed in step k - 1, before this
// iteration's barrier), w of plane k - 1 (still in the ring) and the
// registers of planes k - 2 and k. q tile k % 2 held plane k - 2, last read
// in step k - 1.
template <typename T, int TX, int TY, bool VEC>
__global__ void __launch_bounds__(TX * TY, kZmarchSmThreads / (TX * TY))
    rotational_zmarch_kernel(HaloSrc<T> wsrc, HaloSrc<T> usrc,
                             const int* __restrict__ coords,
                             const T* __restrict__ pref, T* __restrict__ out,
                             Geom g, int zchunk, int stages) {
  using Z = ZTile<T, TX, TY>;
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  T* qt = ring + stages * 6 * Z::CT;  // two q tiles of 3 CT
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int o = (threadIdx.x / TX + 1) * Z::W + Z::V + threadIdx.x % TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  T* dst = out + 3 * n * w.s + (long long)w.y * g.nx + w.x;
  const int gz0 = coords[2 * w.s], gy = coords[2 * w.s + 1] + w.y;
  const T p = *pref;
  const int L = w.zb - w.za + 2;
  // q_x, q_y at the thread's cell on planes k - 2 (m) and k - 1 (c)
  T q0m = T(0), q1m = T(0), q0c = T(0), q1c = T(0);
  zmarch<T, TX, TY, 2, VEC, 1>(
      ring, 6 * Z::CT, wsrc, usrc, w, g, stages,
      [&](int k, const T* t, const T* c) {
        T* qn = qt + (k & 1) * 3 * Z::CT;
        T q0, q1, q2;
        cross_tile<T, Z::CT>(t, o, q0, q1, q2);
        qn[o] = q0;
        qn[Z::CT + o] = q1;
        qn[2 * Z::CT + o] = q2;
        if (k >= 1 && k <= L - 2) {  // a plane that is some cell's centre
          for (int h = threadIdx.x; h < Z::NB; h += Z::NT) {
            // rows 0 and TY + 1 at the tile's columns, then columns V - 1
            // and V + TX at rows 1 ... TY
            const int i =
                h < 2 * TX
                    ? (h < TX ? 0 : (TY + 1) * Z::W) + Z::V + h % TX
                    : (1 + (h - 2 * TX) % TY) * Z::W +
                          (h - 2 * TX < TY ? Z::V - 1 : Z::V + TX);
            T b0, b1, b2;
            cross_tile<T, Z::CT>(t, i, b0, b1, b2);
            qn[i] = b0;
            qn[Z::CT + i] = b1;
            qn[2 * Z::CT + i] = b2;
          }
        }
        if (k >= 2) {
          const int z = w.za + k - 2;
          const T* qc = qt + ((k - 1) & 1) * 3 * Z::CT;
          T o0 = c[o], o1 = c[Z::CT + o], o2 = c[2 * Z::CT + o];
          if (!on_ring(gz0 + z, gy, w.x, g.NZ, g.NY, g.nx)) {
            // the plain version's order (rotational_curl_add_kernel)
            o0 = o0 + p * ((qc[2 * Z::CT + o + Z::W] -
                            qc[2 * Z::CT + o - Z::W]) -
                           (q1 - q1m));
            o1 = o1 + p * ((q0 - q0m) -
                           (qc[2 * Z::CT + o + 1] - qc[2 * Z::CT + o - 1]));
            o2 = o2 + p * ((qc[Z::CT + o + 1] - qc[Z::CT + o - 1]) -
                           (qc[o + Z::W] - qc[o - Z::W]));
          }
          if (w.valid) {
            T* d = dst + z * plane;
            d[0] = o0;
            d[n] = o1;
            d[2 * n] = o2;
          }
        }
        q0m = q0c;
        q1m = q1c;
        q0c = q0;
        q1c = q1;
      });
}

// Whether cell i of an n-cell axis lies within w of a wall: a sponge cell.
__device__ __forceinline__ bool in_band(int i, int n, int w) {
  return i < w || i > n - 1 - w;
}

// The cells of an n-cell axis whose clamp source (clamp_src) is cell i:
// [*lo, *lo + count), none where i clamps elsewhere (n > 2 w).
__device__ __forceinline__ int clamped_to(int i, int n, int w, int* lo) {
  if (i == w - 1) {
    *lo = 0;
    return w;
  }
  if (i == n - w) {
    *lo = n - w;
    return w;
  }
  *lo = i;
  return i < w - 1 || i > n - w ? 0 : 1;
}

// diffusion_zmarch_kernel: out = f + pref * lap7(f), f on the global ring;
// with SPONGE, the wall sponge of that (the fused kernel's clamp and ramp,
// by global index; the ramp values sin(pi k / 2 width) read from device
// memory, as penalise_kernel reads them). The curl's walk on a ring of f
// planes that keeps plane k - 2 (KEEP = 2): step k writes plane k - 1's
// output from the centre tile (a cell and its in-plane neighbours), the
// newest tile (plane k, the z + 1 values) and the tile below (plane k - 2,
// the z - 1 values).
//   The sponge: a cell takes the diffused value of its clamp source, up to
// width - 1 cells away on each axis, times its own ramps, ((v rx) ry) rz
// (the wall cells' ramp 0 kept as a product, so a NaN in the source shows).
// Every block marches behind a barrier a plane, so a warp whose cells take
// another path than its neighbours' (a quarter of the warps of a 256-cell
// row hold an x-wall cell) sets its block's pace. SPONGE = 1 takes no other
// path: each thread forms the diffusion at its cell's in-plane clamp source,
// read from the same tiles at a fixed offset (the cell itself off the x and
// y walls), and multiplies by its fixed rx and ry; along z the source plane
// writes the wall band's planes (the whole block at once) and the planes
// that clamp to it write nothing. It needs every in-plane source in its
// cells' tile (sponge_gathers); otherwise SPONGE = 2 forms each cell's own
// diffusion and the thread whose cell is a clamp source writes every cell
// that clamps to it (up to width^3 at a corner), and a thread whose cell
// clamps elsewhere writes nothing. Either way every output cell is written
// once.
template <typename T, int TX, int TY, bool VEC, int SPONGE>
__global__ void __launch_bounds__(TX * TY, kZmarchSmThreads / (TX * TY))
    diffusion_zmarch_kernel(HaloSrc<T> src, const int* __restrict__ coords,
                            const T* __restrict__ pref,
                            const T* __restrict__ ramp, T* __restrict__ out,
                            Geom g, int width, int zchunk, int stages) {
  using Z = ZTile<T, TX, TY>;
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int o = (threadIdx.x / TX + 1) * Z::W + Z::V + threadIdx.x % TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  T* shard = out + 3 * n * w.s;
  const int gz0 = coords[2 * w.s], gy0 = coords[2 * w.s + 1];
  const int gy = gy0 + w.y;
  const T p = *pref;
  // the cell whose diffusion the thread forms (its in-plane clamp source
  // with SPONGE = 1, else its own), its place in the tile, whether it lies
  // on the x or y ring, and the thread's fixed x and y ramps
  int xs = w.x, ys = gy;
  T rx = T(1), ry = T(1);
  if (SPONGE == 1) {
    xs = clamp_src(w.x, g.nx, width);
    ys = clamp_src(gy, g.NY, width);
    rx = ramp_at(ramp, w.x, g.nx, width);
    ry = ramp_at(ramp, gy, g.NY, width);
  }
  const int os = o + (ys - gy) * Z::W + (xs - w.x);
  const bool ring_xy = xs == 0 || xs == g.nx - 1 || ys == 0 || ys == g.NY - 1;
  zmarch<T, TX, TY, 1, VEC, 2>(
      ring, 3 * Z::CT, src, src, w, g, stages,
      [&](int k, const T* t, const T* c, const T* m) {
        if (k < 2) return;  // uniform over the block
        const int z = w.za + k - 2, gz = gz0 + z;  // the plane step k writes
        const bool interior = !ring_xy && gz != 0 && gz != g.NZ - 1;
        T v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T* cj = c + j * Z::CT;
          const T centre = cj[os];
          v[j] = centre;
          if (interior) {
            // the plain version's order (diffusion_kernel)
            T lap = T(-6) * centre;
            lap = (lap + t[j * Z::CT + os]) + m[j * Z::CT + os];
            lap = (lap + cj[os + Z::W]) + cj[os - Z::W];
            lap = (lap + cj[os + 1]) + cj[os - 1];
            v[j] = centre + p * lap;
          }
        }
        if (!w.valid) return;
        if (SPONGE == 1) {
          // the plain version ramps along x, then y, then z
          int zl;
          const int zn = clamped_to(gz, g.NZ, width, &zl);  // block-uniform
          for (int a = 0; a < zn; ++a) {
            const T rz = ramp_at(ramp, zl + a, g.NZ, width);
            T* d = shard + (long long)(zl + a - gz0) * plane +
                   (long long)w.y * g.nx + w.x;
            d[0] = ((v[0] * rx) * ry) * rz;
            d[n] = ((v[1] * rx) * ry) * rz;
            d[2 * n] = ((v[2] * rx) * ry) * rz;
          }
          return;
        }
        if (SPONGE == 2 && (in_band(gz, g.NZ, width) ||
                            in_band(gy, g.NY, width) ||
                            in_band(w.x, g.nx, width))) {
          int zl, yl, xl;
          const int zn = clamped_to(gz, g.NZ, width, &zl);
          const int yn = clamped_to(gy, g.NY, width, &yl);
          const int xn = clamped_to(w.x, g.nx, width, &xl);
          for (int a = 0; a < zn; ++a) {
            const T rz = ramp_at(ramp, zl + a, g.NZ, width);
            for (int b = 0; b < yn; ++b) {
              const T rb = ramp_at(ramp, yl + b, g.NY, width);
              T* row = shard + ((long long)(zl + a - gz0) * g.ny +
                                (yl + b - gy0)) * g.nx;
              for (int e = 0; e < xn; ++e) {
                const T ra = ramp_at(ramp, xl + e, g.nx, width);
                row[xl + e] = ((v[0] * ra) * rb) * rz;
                row[n + xl + e] = ((v[1] * ra) * rb) * rz;
                row[2 * n + xl + e] = ((v[2] * ra) * rb) * rz;
              }
            }
          }
          return;
        }
        T* d = shard + z * plane + (long long)w.y * g.nx + w.x;
        d[0] = v[0];
        d[n] = v[1];
        d[2 * n] = v[2];
      });
}

// mult_filter_zmarch_kernel: one multiplicative filter application on one
// device (see the file's head), res = clear . H_z . clear . H_y . clear .
// H_x (buf); out = res (mode 0), buf - res (mode 1: orig is buf, its centre
// value read from the ring) or orig - res (mode 2: orig another field, read
// once, a step ahead of its use, so the load's latency hides behind a
// plane's work). The curl's walk with the tile's corners, on a ring of buf
// planes.
// Step k, when plane k lies inside the z walls (block-uniform): the block
// forms clear . H_x of plane k's R tile rows at the TX columns into the
// shared tile hx (3 R TX values; 0 on the ring and beyond the field, so
// never NaN), a barrier, then each thread forms t_k = clear . H_y at its
// cell (0 off the interior and on the z walls). It then writes plane k -
// 1's output from t_{k-2}, t_{k-1}, t_k. hx is rewritten in step k + 1
// after the walk's barrier, when every thread has read it. No cell reads a
// row or plane beyond the field: only ring cells sit next to them, and
// their result is a select of 0.
template <typename T, int TX, int TY, bool VEC>
__global__ void __launch_bounds__(TX * TY, kZmarchSmThreads / (TX * TY))
    mult_filter_zmarch_kernel(HaloSrc<T> src, const T* __restrict__ orig,
                              T* __restrict__ out, Geom g, int zchunk,
                              int stages, int mode) {
  using Z = ZTile<T, TX, TY>;
  constexpr int HT = Z::R * TX;  // one component of the H_x tile
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  T* hx = ring + stages * 3 * Z::CT;
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int o = (threadIdx.x / TX + 1) * Z::W + Z::V + threadIdx.x % TX;
  const int oh = (threadIdx.x / TX + 1) * TX + threadIdx.x % TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  const long long cell = (long long)w.y * g.nx + w.x;
  // the thread's cell lies in the in-plane interior
  const bool inner = w.x >= 1 && w.x <= g.nx - 2 && w.y >= 1 &&
                     w.y <= g.ny - 2;
  const int L = w.zb - w.za + 2;
  // t at the thread's cell on planes k - 2 (m) and k - 1 (c); orig at the
  // cell of the plane the next step writes
  T tm[3] = {T(0), T(0), T(0)}, tc[3] = {T(0), T(0), T(0)};
  T og[3] = {T(0), T(0), T(0)};
  zmarch<T, TX, TY, 1, VEC, 1, true>(
      ring, 3 * Z::CT, src, src, w, g, stages,
      [&](int k, const T* t, const T* c) {
        const int z = w.za - 1 + k;  // plane k
        T tn[3] = {T(0), T(0), T(0)};
        if (z >= 1 && z <= g.nz - 2) {
          for (int h = threadIdx.x; h < HT; h += Z::NT) {
            const int r = h / TX, x = w.x0 + h % TX, ly = w.y0 - 1 + r;
            const bool in = x >= 1 && x <= g.nx - 2 && ly >= 1 &&
                            ly <= g.ny - 2;
            const int i = r * Z::W + Z::V + h % TX;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const T* tj = t + j * Z::CT;
              // the plain version's order (highpass)
              hx[j * HT + h] = in ? highpass(tj[i], tj[i + 1], tj[i - 1])
                                  : T(0);
            }
          }
          __syncthreads();
          if (inner) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const T* hj = hx + j * HT;
              tn[j] = highpass(hj[oh], hj[oh + TX], hj[oh - TX]);
            }
          }
        }
        if (k >= 2 && w.valid) {
          const int zc = z - 1;  // the plane step k writes
          const bool interior = inner && zc >= 1 && zc <= g.nz - 2;
          T* d = out + zc * plane + cell;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const T res = interior ? highpass(tc[j], tn[j], tm[j]) : T(0);
            if (mode == 0)
              d[j * n] = res;
            else if (mode == 1)
              d[j * n] = c[j * Z::CT + o] - res;
            else
              d[j * n] = og[j] - res;
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          tm[j] = tc[j];
          tc[j] = tn[j];
        }
        // plane k is written in step k + 1
        if (mode == 2 && w.valid && k >= 1 && k <= L - 2) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            og[j] = __ldg(orig + j * n + z * plane + cell);
        }
      });
}

// The convolution filter's tile (conv_filter_zmarch_kernel) at order K: a
// component is R = TY + 2K rows of W = TX + 2P values, row r holding grid
// row y0 - K + r and column col holding x = x0 - P + col, where the x pad P
// is K rounded up to 16 bytes' values, so every row and the tile's cells
// start on 16 bytes. The x stage's task is a run of MX cells of one tile row
// of one component (the run length that needs the fewest high-passes of
// the busiest thread); the y stage's a run of MY cells of one column (a
// thread's own cell at K <= 2, where the run saves no work).
constexpr int conv_run_x(int K, int TX, int R, int NT, int V) {
  int best = 0, cost = 0;
  for (int m = 2; m <= 8; m *= 2) {
    if (m % V != 0 || TX % m != 0) continue;
    const int rounds = (3 * R * (TX / m) + NT - 1) / NT;
    const int c = rounds * (K * m + K * (K - 1));
    if (best == 0 || c < cost) {
      best = m;
      cost = c;
    }
  }
  return best;
}

template <typename T, int TX, int TY, int K>
struct ConvTile {
  static constexpr int NT = TX * TY;
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int P = (K + V - 1) / V * V;
  static constexpr int W = TX + 2 * P;
  static constexpr int R = TY + 2 * K;
  static constexpr int CT = R * W;
  static constexpr int MX = conv_run_x(K, TX, R, NT, V);
  static constexpr int MY = K <= 2 ? 1 : 4;
  static constexpr int XS = 3 * R * TX;                  // x-staged rows
  static constexpr int YS = MY > 1 ? 3 * TY * TX : 0;    // y-staged cells
  // the per-component registers of the z stage's levels (below)
  static constexpr int ZD = K > 2 ? K : 2;
  static constexpr int ZL = K > 1 ? K - 1 : 1;
};

// Threads an SM holds at the convolution filter's launch bound: 1,024 (64
// registers a thread) up to order 2, else 512 (128: the z levels' 3 (3K - 1)
// values and the x stage's run); sharded_stencil_plan counts on it.
constexpr int conv_sm_threads(int K) { return K <= 2 ? 1024 : 512; }

// V values at p (16-byte aligned) into v[i ...], and back.
template <typename T>
__device__ __forceinline__ void lds16(T* v, const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}

template <typename T>
__device__ __forceinline__ void sts16(T* p, const T* v) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// One level of the clamped high-pass on v[lo ... hi) (static bounds, so the
// arrays stay in registers): v[i] = clear . H v as wt(i) ((2 v[i] - v[i +
// 1]) - v[i - 1]), wt(i) 0.25 where cell i lies inside the walls and 0
// elsewhere, so a cleared cell costs no select; the plain version's order
// (highpass), exactly, for finite values.
template <typename T, int N, int LO, int HI, class Wt>
__device__ __forceinline__ void highpass_level(T (&v)[N], Wt wt) {
  T u[N];
#pragma unroll
  for (int i = LO; i < HI; ++i)
    u[i] = wt(i) * ((T(2) * v[i] - v[i + 1]) - v[i - 1]);
#pragma unroll
  for (int i = LO; i < HI; ++i) v[i] = u[i];
}

// K levels of a line of N values whose outputs are v[C ... C + M): level l
// on v[C - (K - l) ... C + M + (K - l)).
template <typename T, int N, int K, int C, int M, class Wt>
__device__ __forceinline__ void highpass_levels(T (&v)[N], Wt wt) {
  if constexpr (K > 0) {
    highpass_levels<T, N, K - 1, C - 1, M + 2>(v, wt);
    highpass_level<T, N, C, C + M>(v, wt);
  }
}

// conv_filter_zmarch_kernel: the whole convolution filter of order K on one
// device (see the file's head): per axis x, y, z in turn, g - (clear . H)^K
// g. A walk on a ring of plane tiles with a K-cell in-plane halo (no halo
// buffers: rows and planes beyond the field are never loaded) and K planes
// beyond each end of the chunk (REACH = K); the ring keeps only the newest
// plane (KEEP = 0). Step k, when plane p = za - K + k lies inside the z
// walls (block-uniform):
// - the x stage: each task loads its run's MX + 2P values of a tile row
//   from the ring (16-byte loads), forms the K levels in registers and
//   writes g1 = f - X^K f of its MX cells into the shared tile xs (R rows
//   of TX); a barrier;
// - the y stage: each thread forms g2 = g1 - Y^K g1 at its cell from 2K +
//   1 values of its xs column (MY = 1), or each task forms MY cells of a
//   column from MY + 2K values into ys, then a barrier and each thread
//   reads its cell.
// On the z-wall planes g2 = f (both stages clear the plane). The z stage
// runs from registers, one level a plane: step k forms L_i(p - i), level i
// of the z high-pass, from L_{i-1} at p - i - 1, p - i, p - i + 1 for i =
// 1 ... K (L_0 = g2), and writes plane p - K: L_0 - L_K. A thread keeps
// L_0 at p - 1 ... p - max(K, 2) and L_i at p - i - 1 and p - i - 2.
// A level of the x and y stages weighs a cell on the ring or beyond the
// field by 0, a z level selects 0 there, and only such cells read rows,
// columns or planes that were not loaded: the ring's cells beyond the field
// are zeroed once at the start and are never copied, so what they weigh is
// finite (for a finite field the result is the plain version's, bit for
// bit up to the sign of a zero). xs and ys are rewritten in the next step
// after the walk's barrier and the x stage's, when every thread has read
// them.
template <typename T, int TX, int TY, bool VEC, int K>
__global__ void __launch_bounds__(TX * TY, conv_sm_threads(K) / (TX * TY))
    conv_filter_zmarch_kernel(const T* __restrict__ f, T* __restrict__ out,
                              Geom g, int zchunk, int stages) {
  using C = ConvTile<T, TX, TY, K>;
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  T* xs = ring + stages * 3 * C::CT;
  T* ys = xs + C::XS;
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  const long long cell = (long long)w.y * g.nx + w.x;
  // the thread's cell lies in the in-plane interior
  const bool inner = w.x >= 1 && w.x <= g.nx - 2 && w.y >= 1 &&
                     w.y <= g.ny - 2;
  constexpr int RUN = VEC ? C::V : 1;
  constexpr int PER_ROW = C::W / RUN;
  constexpr int ITEMS = 3 * C::R * PER_ROW;
  // the z stage's levels, per component
  T zd[3][C::ZD], za[3][C::ZL], zb[3][C::ZL];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < C::ZD; ++i) zd[j][i] = T(0);
#pragma unroll
    for (int i = 0; i < C::ZL; ++i) za[j][i] = zb[j][i] = T(0);
  }
  // the ring's cells beyond the field are never copied: zero them once, so
  // every value a level weighs by 0 is finite
  for (int i = threadIdx.x; i < stages * 3 * C::CT; i += C::NT) ring[i] = T(0);
  __syncthreads();
  zmarch_walk<0, K>(
      ring, 3 * C::CT, w, stages,
      [&](T* stage, int z) {
        // plane z's copy items: runs of RUN values of the tile's rows,
        // halo columns included, those inside the field
        if (z < 0 || z >= g.nz) return;
        const T* fz = f + z * plane;
        for (int item = threadIdx.x; item < ITEMS; item += C::NT) {
          const int q = item % PER_ROW, rest = item / PER_ROW;
          const int r = rest % C::R, j = rest / C::R;
          const int x = w.x0 - C::P + q * RUN, ly = w.y0 - K + r;
          if (x < 0 || x >= g.nx || ly < 0 || ly >= g.ny) continue;
          const T* src = fz + j * n + (long long)ly * g.nx + x;
          T* dst = stage + j * C::CT + r * C::W + q * RUN;
          if constexpr (RUN == 1)
            cp_async_elem(dst, src);
          else
            cp_async16(dst, src);
        }
      },
      [&](int k, const T* t) {
        const int p = w.za - K + k;  // plane k
        T g2[3] = {T(0), T(0), T(0)};
        if (p >= 1 && p <= g.nz - 2) {
          // the x stage
          constexpr int RUNS = TX / C::MX;
          constexpr int NV = C::MX + 2 * C::P;
          for (int task = threadIdx.x; task < 3 * C::R * RUNS;
               task += C::NT) {
            const int m = task % RUNS, rest = task / RUNS;
            const int r = rest % C::R, j = rest / C::R;
            const int ly = w.y0 - K + r;
            const int xa = w.x0 + m * C::MX - C::P;  // x of v[0]
            const bool row_in = ly >= 1 && ly <= g.ny - 2;
            T v[NV];
            const T* src = t + j * C::CT + r * C::W + m * C::MX;
#pragma unroll
            for (int i = 0; i < NV; i += C::V) lds16<T>(v + i, src + i);
            T f0[C::MX];
#pragma unroll
            for (int i = 0; i < C::MX; ++i) f0[i] = v[C::P + i];
            highpass_levels<T, NV, K, C::P, C::MX>(v, [&](int i) {
              return row_in && xa + i >= 1 && xa + i <= g.nx - 2 ? T(0.25)
                                                                 : T(0);
            });
#pragma unroll
            for (int i = 0; i < C::MX; ++i) f0[i] = f0[i] - v[C::P + i];
            T* dst = xs + (j * C::R + r) * TX + m * C::MX;
#pragma unroll
            for (int i = 0; i < C::MX; i += C::V) sts16<T>(dst + i, f0 + i);
          }
          __syncthreads();
          // the y stage
          const bool col_in = w.x >= 1 && w.x <= g.nx - 2;
          if constexpr (C::MY == 1) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              T v[2 * K + 1];
              const T* src = xs + (j * C::R + ty) * TX + tx;
#pragma unroll
              for (int i = 0; i < 2 * K + 1; ++i) v[i] = src[i * TX];
              const T g1 = v[K];
              highpass_levels<T, 2 * K + 1, K, K, 1>(v, [&](int i) {
                const int y = w.y - K + i;
                return col_in && y >= 1 && y <= g.ny - 2 ? T(0.25) : T(0);
              });
              g2[j] = g1 - v[K];
            }
          } else {
            constexpr int RUNS_Y = TY / C::MY;
            constexpr int NV = C::MY + 2 * K;
            for (int task = threadIdx.x; task < 3 * TX * RUNS_Y;
                 task += C::NT) {
              const int c = task % TX, rest = task / TX;
              const int m = rest % RUNS_Y, j = rest / RUNS_Y;
              const int x = w.x0 + c;
              const int ya = w.y0 + m * C::MY - K;  // y of v[0]
              const bool in_x = x >= 1 && x <= g.nx - 2;
              T v[NV];
              const T* src = xs + (j * C::R + m * C::MY) * TX + c;
#pragma unroll
              for (int i = 0; i < NV; ++i) v[i] = src[i * TX];
              T g1[C::MY];
#pragma unroll
              for (int i = 0; i < C::MY; ++i) g1[i] = v[K + i];
              highpass_levels<T, NV, K, K, C::MY>(v, [&](int i) {
                return in_x && ya + i >= 1 && ya + i <= g.ny - 2 ? T(0.25)
                                                                 : T(0);
              });
              T* dst = ys + (j * TY + m * C::MY) * TX + c;
#pragma unroll
              for (int i = 0; i < C::MY; ++i) dst[i * TX] = g1[i] - v[K + i];
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < 3; ++j) g2[j] = ys[(j * TY + ty) * TX + tx];
          }
        } else if (p == 0 || p == g.nz - 1) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            g2[j] = t[j * C::CT + (K + ty) * C::W + C::P + tx];
        }
        // the z stage: L_i(p - i), i = 1 ... K
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T lv = g2[j];  // L_0(p), then L_i(p - i)
          T lm = zd[j][0], lmm = zd[j][1];  // L_{i-1}(p - i), (p - i - 1)
#pragma unroll
          for (int i = 1; i <= K; ++i) {
            const int pi = p - i;
            const T li = inner && pi >= 1 && pi <= g.nz - 2
                             ? highpass(lm, lv, lmm)
                             : T(0);
            if (i < K) {
              lm = za[j][i - 1];
              lmm = zb[j][i - 1];
              zb[j][i - 1] = za[j][i - 1];
              za[j][i - 1] = li;
            }
            lv = li;
          }
          // plane p - K, written from step 2K on
          if (k >= 2 * K && w.valid)
            out[j * n + (long long)(p - K) * plane + cell] =
                zd[j][K - 1] - lv;
#pragma unroll
          for (int i = C::ZD - 1; i > 0; --i) zd[j][i] = zd[j][i - 1];
          zd[j][0] = g2[j];
        }
      });
}

// A z-marching launch's plan, as sharded_stencil_plan computes it: the
// tile (tx, ty), planes a chunk, ring stages, dynamic shared bytes, blocks
// (tiles x chunks x shards) and 16-byte copies.
struct ZmarchPlan {
  int tx, ty, zchunk, stages, smem, blocks, vec;
};

// Dynamic shared bytes of a plan: the ring of 3 nfields components a stage,
// and the transport's two q tiles.
template <typename T>
long long zmarch_smem_bytes(int nfields, int tx, int ty, int stages) {
  const long long ct = (long long)(ty + 2) * (tx + 2 * (16 / (int)sizeof(T)));
  return (long long)sizeof(T) * ct *
         (3LL * nfields * stages + (nfields == 2 ? 6 : 0));
}

// The filter's H_x tile: 3 components of TY + 2 rows of TX values.
template <typename T>
long long filter_scratch_bytes(int tx, int ty) {
  return (long long)sizeof(T) * 3 * (ty + 2) * tx;
}

// The convolution filter's shared bytes at order K (ConvTile): the ring of
// R-row tiles, the x-staged rows and, above order 2, the y-staged cells.
template <typename T>
long long conv_smem_bytes(int K, int tx, int ty, int stages) {
  const int v = 16 / (int)sizeof(T);
  const int pad = (K + v - 1) / v * v, r = ty + 2 * K;
  return (long long)sizeof(T) *
         (3LL * stages * r * (tx + 2 * pad) + 3LL * r * tx +
          (K <= 2 ? 0 : 3LL * ty * tx));
}

// Whether the plan is the one the kernel assumes for these fields, a walk
// that keeps `keep` planes below the centre and `smem` shared bytes (-1:
// the three-point kernels' ring alone).
template <typename T>
bool zmarch_plan_ok(const ZmarchPlan& p, const HaloSrc<T>* srcs, int nfields,
                    int keep, int nshards, const Geom& g, long long smem) {
  if (nshards < 1 || nshards > 65535 || g.nz < 1 || g.ny < 1 || g.nx < 1 ||
      p.stages < 2 + keep || p.stages > 5 || p.zchunk < 1 ||
      p.zchunk > g.nz)
    return false;
  const long long tiles =
      (long long)((g.nx + p.tx - 1) / p.tx) * ((g.ny + p.ty - 1) / p.ty);
  const long long chunks = (g.nz + p.zchunk - 1) / p.zchunk;
  if (tiles > 2147483647LL || chunks > 65535 ||
      p.blocks != tiles * chunks * nshards ||
      p.smem != (smem >= 0 ? smem
                           : zmarch_smem_bytes<T>(nfields, p.tx, p.ty,
                                                  p.stages)) ||
      p.smem > 232448)
    return false;
  if (p.vec) {
    if (g.nx % (16 / (int)sizeof(T)) != 0) return false;
    for (int i = 0; i < nfields; ++i) {
      const HaloSrc<T>& h = srcs[i];
      if (((unsigned long long)h.f | (unsigned long long)h.zlo |
           (unsigned long long)h.zhi | (unsigned long long)h.ylo |
           (unsigned long long)h.yhi) %
              16 !=
          0)
        return false;
    }
  }
  return true;
}

// Let `kernel` take `smem` dynamic shared bytes on the current device; set
// once a kernel, device and size.
template <class Kernel>
int allow_smem(Kernel kernel, int smem, int& dev_set, int& smem_set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_set || smem > smem_set) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return (int)err;
    dev_set = dev;
    smem_set = smem;
  }
  return 0;
}

template <typename T>
struct ZmarchArgs {
  HaloSrc<T> f, u;  // u: the transport's velocity
  const int* coords;
  const T* pref;
  const T* add;   // the curl's add vector
  const T* ramp;  // the sponge's ramp values
  T* out;
  T* l1_max;
  int nshards;
  Geom g;
  ZmarchPlan p;
  int width;  // the diffusion's sponge width (0: none)
  const T* orig = nullptr;  // the filter's orig (null: none)

  dim3 grid() const {
    return dim3((unsigned)(((g.nx + p.tx - 1) / p.tx) *
                           ((g.ny + p.ty - 1) / p.ty)),
                (unsigned)((g.nz + p.zchunk - 1) / p.zchunk),
                (unsigned)nshards);
  }
};

template <typename T>
struct CurlZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = curl_zmarch_kernel<T, TX, TY, VEC>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f, a.coords, a.pref, a.add,
                                                a.out, a.l1_max, a.g,
                                                a.p.zchunk, a.p.stages);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct RotationalZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = rotational_zmarch_kernel<T, TX, TY, VEC>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f, a.u, a.coords, a.pref,
                                                a.out, a.g, a.p.zchunk,
                                                a.p.stages);
    return (int)cudaGetLastError();
  }
};

template <typename T, int SPONGE>
struct DiffusionZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = diffusion_zmarch_kernel<T, TX, TY, VEC, SPONGE>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f, a.coords, a.pref,
                                                a.ramp, a.out, a.g, a.width,
                                                a.p.zchunk, a.p.stages);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct FilterZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = mult_filter_zmarch_kernel<T, TX, TY, VEC>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    const int mode = a.orig == nullptr ? 0 : a.orig == a.f.f ? 1 : 2;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f, a.orig, a.out, a.g,
                                                a.p.zchunk, a.p.stages, mode);
    return (int)cudaGetLastError();
  }
};

template <typename T, int K>
struct ConvZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = conv_filter_zmarch_kernel<T, TX, TY, VEC, K>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f.f, a.out, a.g,
                                                a.p.zchunk, a.p.stages);
    return (int)cudaGetLastError();
  }
};

// Whether the sponge stays in the shard: every clamp source and the cells
// that clamp to it in one shard (width <= nz, ny) and the two wall bands of
// each axis apart (n > 2 width).
inline bool sponge_ok(const Geom& g, int width) {
  return width >= 1 && width <= g.nz && width <= g.ny &&
         2 * width < g.NZ && 2 * width < g.NY && 2 * width < g.nx;
}

// Whether every in-plane clamp source lies in its cells' tile under a
// (tx, ty) tile, so the sponge gathers (SPONGE = 1): the low x and y wall
// bands in the first tile's columns and rows, the high ones (with their
// source) in the last tile's.
inline bool sponge_gathers(const Geom& g, int tx, int ty, int width) {
  return width <= tx && width <= ty &&
         g.nx - width >= (g.nx - 1) / tx * tx &&
         g.ny - width >= (g.ny - 1) / ty * ty;
}

template <class K, int TX, int TY, typename T>
int launch_tile(const ZmarchArgs<T>& a, cudaStream_t st) {
  return a.p.vec ? K::template go<TX, TY, true>(a, st)
                 : K::template go<TX, TY, false>(a, st);
}

// The plan's tile and copies pick the instance: (32, 8), (32, 16), (64, 4)
// or (64, 8) cells (x, y), 16-byte copies or not; any other tile is
// refused.
template <class K, typename T>
int launch_zmarch(const ZmarchArgs<T>& a, int nfields, int keep,
                  cudaStream_t st, long long smem = -1) {
  const HaloSrc<T> srcs[2] = {a.f, a.u};
  if (!zmarch_plan_ok<T>(a.p, srcs, nfields, keep, a.nshards, a.g, smem))
    return (int)cudaErrorInvalidValue;
  if (a.p.tx == 32 && a.p.ty == 8) return launch_tile<K, 32, 8>(a, st);
  if (a.p.tx == 32 && a.p.ty == 16) return launch_tile<K, 32, 16>(a, st);
  if (a.p.tx == 64 && a.p.ty == 4) return launch_tile<K, 64, 4>(a, st);
  if (a.p.tx == 64 && a.p.ty == 8) return launch_tile<K, 64, 8>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The convolution filter of order K (1 ... 5: the entry point's instances)
// on one device under the plan.
template <typename T, int K>
int launch_conv(const ZmarchArgs<T>& a, cudaStream_t st) {
  return launch_zmarch<ConvZmarch<T, K>, T>(
      a, 1, 0, st, conv_smem_bytes<T>(K, a.p.tx, a.p.ty, a.p.stages));
}

}  // namespace

#define SOPHT_DEFINE_ENTRIES(T, SUFFIX)                                        \
  extern "C" int sopht_rotational_curl_add_3d_##SUFFIX(                        \
      const T* w, const T* u, const T* pref, T* out, int nz, int ny, int nx,  \
      void* stream) {                                                          \
    rotational_curl_add_kernel<T>                                              \
        <<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,                     \
           (cudaStream_t)stream>>>(w, u, pref, out, nz, ny, nx);               \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_diffusion_penalise_vector_3d_##SUFFIX(                  \
      const T* f, const T* pref, T* out, int nz, int ny, int nx, int width,    \
      void* stream) {                                                          \
    diffusion_penalise_kernel<T>                                               \
        <<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,                     \
           (cudaStream_t)stream>>>(f, pref, out, nz, ny, nx, width);           \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_curl_3d_##SUFFIX(const T* psi, const T* pref,           \
                                        const T* add, T* out, T* l1_max,       \
                                        int nz, int ny, int nx,                \
                                        void* stream) {                        \
    curl_kernel<T><<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,           \
                     (cudaStream_t)stream>>>(psi, pref, add, out, l1_max, nz,  \
                                             ny, nx);                          \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_diffusion_vector_3d_##SUFFIX(                           \
      const T* f, const T* pref, T* out, int nz, int ny, int nx,               \
      void* stream) {                                                          \
    diffusion_kernel<T><<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,      \
                          (cudaStream_t)stream>>>(f, pref, out, nz, ny, nx);   \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_conv_filter_line_3d_##SUFFIX(                           \
      const T* f, T* out, int nz, int ny, int nx, int axis, int k,             \
      void* stream) {                                                          \
    const long long lines = 3LL * nz * (axis == 0 ? ny : nx);                  \
    conv_filter_line_kernel<T>                                                 \
        <<<(unsigned)((lines + kThreads - 1) / kThreads), kThreads, 0,         \
           (cudaStream_t)stream>>>(f, out, nz, ny, nx, axis, k);               \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_conv_filter_z_pass_3d_##SUFFIX(                         \
      const T* buf, const T* orig, T* out, int nz, int ny, int nx,             \
      void* stream) {                                                          \
    conv_filter_z_pass_kernel<T>                                               \
        <<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,                     \
           (cudaStream_t)stream>>>(buf, orig, out, nz, ny, nx);                \
    return (int)cudaGetLastError();                                            \
  }                                                                            \
  extern "C" int sopht_penalise_vector_3d_##SUFFIX(                            \
      const T* f, const T* ramp, T* out, int nz, int ny, int nx, int width,    \
      void* stream) {                                                          \
    penalise_kernel<T><<<grid_of(nz, ny, nx), dim3(kBlockX, kBlockY), 0,       \
                         (cudaStream_t)stream>>>(f, ramp, out, nz, ny, nx,     \
                                                 width);                       \
    return (int)cudaGetLastError();                                            \
  }

SOPHT_DEFINE_ENTRIES(float, f32)
SOPHT_DEFINE_ENTRIES(double, f64)

// The z-marching sharded kernels: the field(s) and their four halo
// buffers, the shards' global offsets, ... (for the sponge, its ramp
// values sin(pi k / 2 width), k < width, after the prefactor), then
// (shards, nz, ny, nx) of a shard, the grid's (NZ, NY), the sponge's width
// (diffusion + sponge only) and the plan (tx, ty, zchunk, stages, smem,
// blocks, vec), which the launcher checks; the sponge's launcher picks the
// gathering instance where the plan's tile allows it. The single-device
// filter: buf, orig (null: none; buf itself on order 1), out, (nz, ny, nx)
// and the plan.
#define SOPHT_DEFINE_ZMARCH_ENTRIES(T, SUFFIX)                                 \
  extern "C" int sopht_mult_filter_3d_zmarch_##SUFFIX(                         \
      const T* buf, const T* orig, T* out, int nz, int ny, int nx, int tx,     \
      int ty, int zchunk, int stages, int smem, int blocks, int vec,           \
      void* stream) {                                                          \
    const HaloSrc<T> src{buf, nullptr, nullptr, nullptr, nullptr};             \
    const ZmarchArgs<T> a{src, src, nullptr, nullptr, nullptr, nullptr, out,   \
                          nullptr, 1, Geom{nz, ny, nx, nz, ny},                \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          0, orig};                                            \
    return launch_zmarch<FilterZmarch<T>, T>(                                  \
        a, 1, 1, (cudaStream_t)stream,                                         \
        zmarch_smem_bytes<T>(1, tx, ty, stages) +                              \
            filter_scratch_bytes<T>(tx, ty));                                  \
  }                                                                            \
  extern "C" int sopht_conv_filter_3d_zmarch_##SUFFIX(                         \
      const T* f, T* out, int nz, int ny, int nx, int order, int tx, int ty,  \
      int zchunk, int stages, int smem, int blocks, int vec, void* stream) {   \
    const HaloSrc<T> src{f, nullptr, nullptr, nullptr, nullptr};               \
    const ZmarchArgs<T> a{src, src, nullptr, nullptr, nullptr, nullptr, out,   \
                          nullptr, 1, Geom{nz, ny, nx, nz, ny},                \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          0};                                                  \
    const cudaStream_t st = (cudaStream_t)stream;                              \
    switch (order) {                                                           \
      case 1: return launch_conv<T, 1>(a, st);                                 \
      case 2: return launch_conv<T, 2>(a, st);                                 \
      case 3: return launch_conv<T, 3>(a, st);                                 \
      case 4: return launch_conv<T, 4>(a, st);                                 \
      case 5: return launch_conv<T, 5>(a, st);                                 \
      default: return (int)cudaErrorInvalidValue;                              \
    }                                                                          \
  }                                                                            \
  extern "C" int sopht_curl_3d_sharded_zmarch_##SUFFIX(                        \
      const T* f, const T* zlo, const T* zhi, const T* ylo, const T* yhi,      \
      const int* coords, const T* pref, const T* add, T* out, T* l1_max,       \
      int nshards, int nz, int ny, int nx, int NZ, int NY, int tx, int ty,     \
      int zchunk, int stages, int smem, int blocks, int vec, void* stream) {   \
    const ZmarchArgs<T> a{HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          coords, pref, add, nullptr, out, l1_max, nshards,    \
                          Geom{nz, ny, nx, NZ, NY},                            \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          0};                                                  \
    return launch_zmarch<CurlZmarch<T>, T>(a, 1, 1, (cudaStream_t)stream);     \
  }                                                                            \
  extern "C" int sopht_rotational_curl_add_3d_sharded_zmarch_##SUFFIX(         \
      const T* w, const T* w_zlo, const T* w_zhi, const T* w_ylo,              \
      const T* w_yhi, const T* u, const T* u_zlo, const T* u_zhi,              \
      const T* u_ylo, const T* u_yhi, const int* coords, const T* pref,        \
      T* out, int nshards, int nz, int ny, int nx, int NZ, int NY, int tx,     \
      int ty, int zchunk, int stages, int smem, int blocks, int vec,           \
      void* stream) {                                                          \
    const ZmarchArgs<T> a{HaloSrc<T>{w, w_zlo, w_zhi, w_ylo, w_yhi},           \
                          HaloSrc<T>{u, u_zlo, u_zhi, u_ylo, u_yhi},           \
                          coords, pref, nullptr, nullptr, out, nullptr,        \
                          nshards,                                             \
                          Geom{nz, ny, nx, NZ, NY},                            \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          0};                                                  \
    return launch_zmarch<RotationalZmarch<T>, T>(a, 2, 1,                      \
                                                 (cudaStream_t)stream);        \
  }                                                                            \
  extern "C" int sopht_diffusion_vector_3d_sharded_zmarch_##SUFFIX(            \
      const T* f, const T* zlo, const T* zhi, const T* ylo, const T* yhi,      \
      const int* coords, const T* pref, T* out, int nshards, int nz, int ny,   \
      int nx, int NZ, int NY, int tx, int ty, int zchunk, int stages,          \
      int smem, int blocks, int vec, void* stream) {                           \
    const ZmarchArgs<T> a{HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          coords, pref, nullptr, nullptr, out, nullptr,        \
                          nshards,                                             \
                          Geom{nz, ny, nx, NZ, NY},                            \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          0};                                                  \
    return launch_zmarch<DiffusionZmarch<T, 0>, T>(a, 1, 2,                    \
                                                   (cudaStream_t)stream);      \
  }                                                                            \
  extern "C" int sopht_diffusion_penalise_vector_3d_sharded_zmarch_##SUFFIX(   \
      const T* f, const T* zlo, const T* zhi, const T* ylo, const T* yhi,      \
      const int* coords, const T* pref, const T* ramp, T* out, int nshards,    \
      int nz, int ny, int nx, int NZ, int NY, int width, int tx, int ty,       \
      int zchunk, int stages, int smem, int blocks, int vec, void* stream) {   \
    const ZmarchArgs<T> a{HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          HaloSrc<T>{f, zlo, zhi, ylo, yhi},                   \
                          coords, pref, nullptr, ramp, out, nullptr, nshards,  \
                          Geom{nz, ny, nx, NZ, NY},                            \
                          ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,     \
                                     vec},                                     \
                          width};                                              \
    if (ramp == nullptr || !sponge_ok(a.g, width))                             \
      return (int)cudaErrorInvalidValue;                                       \
    if (sponge_gathers(a.g, tx, ty, width))                                    \
      return launch_zmarch<DiffusionZmarch<T, 1>, T>(a, 1, 2,                  \
                                                     (cudaStream_t)stream);    \
    return launch_zmarch<DiffusionZmarch<T, 2>, T>(a, 1, 2,                    \
                                                   (cudaStream_t)stream);      \
  }

SOPHT_DEFINE_ZMARCH_ENTRIES(float, f32)
SOPHT_DEFINE_ZMARCH_ENTRIES(double, f64)

extern "C" const char* sopht_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
