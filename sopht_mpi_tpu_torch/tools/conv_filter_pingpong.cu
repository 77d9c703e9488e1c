// A second design of the convolution filter's in-plane stages, timed beside
// conv_filter_zmarch_kernel by tools/probe_filter.py --sweep conv (built
// there with nvcc on its own; no wrapper of the package launches it).
//
// conv_filter_pingpong_kernel is conv_filter_zmarch_kernel (csrc/
// stencils_3d.cu, included below) with its x and y stages computed level by
// level in shared memory instead of in registers on runs of cells: level l
// of the x stage is formed on the tile rows' columns [P - (K - l), P + TX +
// (K - l)) (rounded out to 16 bytes) from level l - 1, ping-ponged between
// two buffers of the tile's shape with a barrier a level, the last level
// writing g1 = f - X^K f into the x-staged rows; the y stage likewise on
// rows [l, R - l) of the x-staged rows, its last level formed by each
// thread at its own cell. No cell's level is formed twice, at the price of
// 2K - 1 barriers a plane. The z stage and the walk are the kernel's.

#include "../csrc/stencils_3d.cu"

namespace {

// Buffers the ping-pong needs: none at K = 1 (the only level writes the
// x-staged rows and the y stage's is formed in registers), one at K = 2.
__host__ __device__ constexpr int ping_buffers(int K) {
  return K == 1 ? 0 : K == 2 ? 1 : 2;
}

template <typename T>
long long ping_smem_bytes(int K, int tx, int ty, int stages) {
  const int v = 16 / (int)sizeof(T);
  const int pad = (K + v - 1) / v * v, r = ty + 2 * K;
  const long long ct = 3LL * r * (tx + 2 * pad);
  return (long long)sizeof(T) *
         (stages * ct + ping_buffers(K) * ct + 3LL * r * tx);
}

// One level of the x stage: from src (component stride CT, row stride W)
// into dst at columns [qa V, qb V) of every tile row; with FINAL dst is the
// x-staged rows (row stride TX, columns from P) and gets f - level, f from
// the ring tile t. Neighbours beyond the row read its own end: those cells
// lie outside what the last level needs.
template <typename T, int TX, int TY, int K, int QA, int QB, bool FINAL>
__device__ __forceinline__ void ping_x_level(const T* src, T* dst,
                                             const T* t, int x0, int y0,
                                             const Geom& g) {
  using C = ConvTile<T, TX, TY, K>;
  constexpr int NQ = QB - QA;
  for (int task = threadIdx.x; task < 3 * C::R * NQ; task += C::NT) {
    const int q = QA + task % NQ, rest = task / NQ;
    const int r = rest % C::R, j = rest / C::R;
    const int c0 = q * C::V;
    const T* s = src + j * C::CT + r * C::W;
    T v[C::V];
    lds16<T>(v, s + c0);
    const T left = s[c0 > 0 ? c0 - 1 : 0];
    const T right = s[c0 + C::V < C::W ? c0 + C::V : C::W - 1];
    const int ly = y0 - K + r;
    const bool row_in = ly >= 1 && ly <= g.ny - 2;
    T u[C::V];
#pragma unroll
    for (int i = 0; i < C::V; ++i) {
      const int x = x0 - C::P + c0 + i;
      const T wt = row_in && x >= 1 && x <= g.nx - 2 ? T(0.25) : T(0);
      const T m = i == 0 ? left : v[i - 1];
      const T p = i == C::V - 1 ? right : v[i + 1];
      u[i] = wt * ((T(2) * v[i] - p) - m);
    }
    if constexpr (FINAL) {
      T f0[C::V];
      lds16<T>(f0, t + j * C::CT + r * C::W + c0);
#pragma unroll
      for (int i = 0; i < C::V; ++i) u[i] = f0[i] - u[i];
      sts16<T>(dst + (j * C::R + r) * TX + c0 - C::P, u);
    } else {
      sts16<T>(dst + j * C::CT + r * C::W + c0, u);
    }
  }
}

// The x stage's levels L ... K.
template <typename T, int TX, int TY, int K, int L>
__device__ __forceinline__ void ping_x_levels(const T* t, T* const* buf,
                                              T* xs, int x0, int y0,
                                              const Geom& g) {
  using C = ConvTile<T, TX, TY, K>;
  constexpr int QA = (C::P - (K - L)) / C::V;
  constexpr int QB = (C::P + TX + (K - L) + C::V - 1) / C::V;
  const T* src = L == 1 ? t : buf[(L - 1) % 2];
  if constexpr (L == K) {
    ping_x_level<T, TX, TY, K, QA, QB, true>(src, xs, t, x0, y0, g);
  } else {
    ping_x_level<T, TX, TY, K, QA, QB, false>(src, buf[L % 2], t, x0, y0, g);
  }
  __syncthreads();
  if constexpr (L < K)
    ping_x_levels<T, TX, TY, K, L + 1>(t, buf, xs, x0, y0, g);
}

// The y stage's levels L ... K - 1 on rows [L, R - L) (row stride TX).
template <typename T, int TX, int TY, int K, int L>
__device__ __forceinline__ void ping_y_levels(const T* xs, T* const* buf,
                                              int x0, int y0, const Geom& g) {
  if constexpr (L < K) {
    using C = ConvTile<T, TX, TY, K>;
    constexpr int NQ = TX / C::V, ROWS = C::R - 2 * L;
    const T* src = L == 1 ? xs : buf[(L - 1) % 2];
    T* dst = buf[L % 2];
    for (int task = threadIdx.x; task < 3 * ROWS * NQ; task += C::NT) {
      const int q = task % NQ, rest = task / NQ;
      const int r = L + rest % ROWS, j = rest / ROWS;
      const int c0 = q * C::V;
      const T* s = src + (j * C::R + r) * TX + c0;
      T m[C::V], v[C::V], p[C::V], u[C::V];
      lds16<T>(m, s - TX);
      lds16<T>(v, s);
      lds16<T>(p, s + TX);
      const int ly = y0 - K + r;
      const bool row_in = ly >= 1 && ly <= g.ny - 2;
#pragma unroll
      for (int i = 0; i < C::V; ++i) {
        const int x = x0 + c0 + i;
        const T wt = row_in && x >= 1 && x <= g.nx - 2 ? T(0.25) : T(0);
        u[i] = wt * ((T(2) * v[i] - p[i]) - m[i]);
      }
      sts16<T>(dst + (j * C::R + r) * TX + c0, u);
    }
    __syncthreads();
    ping_y_levels<T, TX, TY, K, L + 1>(xs, buf, x0, y0, g);
  }
}

// conv_filter_zmarch_kernel with the in-plane stages above; the ring, the
// walk, the wall clears and the z stage as there.
template <typename T, int TX, int TY, bool VEC, int K>
__global__ void __launch_bounds__(TX * TY, conv_sm_threads(K) / (TX * TY))
    conv_filter_pingpong_kernel(const T* __restrict__ f, T* __restrict__ out,
                                Geom g, int zchunk, int stages) {
  using C = ConvTile<T, TX, TY, K>;
  extern __shared__ __align__(16) unsigned char zmarch_smem[];
  T* ring = reinterpret_cast<T*>(zmarch_smem);
  T* bufs = ring + stages * 3 * C::CT;
  T* const buf[2] = {bufs, bufs + (ping_buffers(K) > 1 ? 3 * C::CT : 0)};
  T* xs = bufs + ping_buffers(K) * 3 * C::CT;
  const ZWalk w = zwalk<TX, TY>(g, zchunk);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long long plane = (long long)g.ny * g.nx;
  const long long n = plane * g.nz;
  const long long cell = (long long)w.y * g.nx + w.x;
  const bool inner = w.x >= 1 && w.x <= g.nx - 2 && w.y >= 1 &&
                     w.y <= g.ny - 2;
  constexpr int RUN = VEC ? C::V : 1;
  constexpr int PER_ROW = C::W / RUN;
  constexpr int ITEMS = 3 * C::R * PER_ROW;
  T zd[3][C::ZD], za[3][C::ZL], zb[3][C::ZL];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < C::ZD; ++i) zd[j][i] = T(0);
#pragma unroll
    for (int i = 0; i < C::ZL; ++i) za[j][i] = zb[j][i] = T(0);
  }
  // the ring's cells beyond the field are never copied, and the buffers'
  // cells outside a level's columns are never written: zero both once
  for (int i = threadIdx.x; i < (stages + ping_buffers(K)) * 3 * C::CT;
       i += C::NT)
    ring[i] = T(0);
  __syncthreads();
  zmarch_walk<0, K>(
      ring, 3 * C::CT, w, stages,
      [&](T* stage, int z) {
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
        const int p = w.za - K + k;
        T g2[3] = {T(0), T(0), T(0)};
        if (p >= 1 && p <= g.nz - 2) {
          ping_x_levels<T, TX, TY, K, 1>(t, buf, xs, w.x0, w.y0, g);
          ping_y_levels<T, TX, TY, K, 1>(xs, buf, w.x0, w.y0, g);
          // the y stage's last level at the thread's cell
          const int r = K + ty;
          const bool in = w.x >= 1 && w.x <= g.nx - 2 && w.y >= 1 &&
                          w.y <= g.ny - 2;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const T* s = (K == 1 ? xs : buf[(K - 1) % 2]) +
                         (j * C::R + r) * TX + tx;
            const T lev = in ? highpass(s[0], s[TX], s[-TX]) : T(0);
            g2[j] = xs[(j * C::R + r) * TX + tx] - lev;
          }
        } else if (p == 0 || p == g.nz - 1) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            g2[j] = t[j * C::CT + (K + ty) * C::W + C::P + tx];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T lv = g2[j];
          T lm = zd[j][0], lmm = zd[j][1];
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
          if (k >= 2 * K && w.valid)
            out[j * n + (long long)(p - K) * plane + cell] =
                zd[j][K - 1] - lv;
#pragma unroll
          for (int i = C::ZD - 1; i > 0; --i) zd[j][i] = zd[j][i - 1];
          zd[j][0] = g2[j];
        }
      });
}

template <typename T, int K>
struct PingZmarch {
  template <int TX, int TY, bool VEC>
  static int go(const ZmarchArgs<T>& a, cudaStream_t st) {
    auto kernel = conv_filter_pingpong_kernel<T, TX, TY, VEC, K>;
    static int dev_set = -1, smem_set = 0;
    if (const int err = allow_smem(kernel, a.p.smem, dev_set, smem_set))
      return err;
    kernel<<<a.grid(), TX * TY, a.p.smem, st>>>(a.f.f, a.out, a.g,
                                                a.p.zchunk, a.p.stages);
    return (int)cudaGetLastError();
  }
};

template <typename T, int K>
int launch_ping(const ZmarchArgs<T>& a, cudaStream_t st) {
  return launch_zmarch<PingZmarch<T, K>, T>(
      a, 1, 0, st, ping_smem_bytes<T>(K, a.p.tx, a.p.ty, a.p.stages));
}

}  // namespace

// f, out, (nz, ny, nx), the order (1 or 5), then the plan as for
// sopht_conv_filter_3d_zmarch_f32 with the shared bytes of this kernel.
extern "C" int sopht_conv_filter_3d_pingpong_f32(
    const float* f, float* out, int nz, int ny, int nx, int order, int tx,
    int ty, int zchunk, int stages, int smem, int blocks, int vec,
    void* stream) {
  const HaloSrc<float> src{f, nullptr, nullptr, nullptr, nullptr};
  const ZmarchArgs<float> a{src, src, nullptr, nullptr, nullptr, nullptr,
                            out, nullptr, 1, Geom{nz, ny, nx, nz, ny},
                            ZmarchPlan{tx, ty, zchunk, stages, smem, blocks,
                                       vec},
                            0};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (order) {
    case 1: return launch_ping<float, 1>(a, st);
    case 5: return launch_ping<float, 5>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
