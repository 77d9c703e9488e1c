// Hopper (sm_90a) kernels for the FFT passes of the doubled-domain
// free-space Poisson solve (the five exact-tier passes, the fast tier's
// fused-curl pair, the unsplit x passes and the fused edge passes), bound to
// PyTorch through a plain C
// interface (ctypes); see sopht_mpi_tpu_torch/parallel/cuda_fft.py for the
// wrappers and the plain torch.fft versions they are held against.
//
// Layout. Spectra are split real/imag float32 pairs. The middle-axis passes
// work on (A, L, B) arrays, B contiguous, transform along L. A block owns a
// tile of `t` neighbouring B columns (threadIdx.x) over the whole transform
// length, so every global load and store of a warp covers t consecutive
// floats of one or more rows. The x-edge passes transform along the
// contiguous axis: a block loads a tile of `t` rows with coalesced reads,
// transposes them through shared memory, runs the same column machinery
// (threadIdx.x = row of the tile) and transposes the result back; the
// forward r2c at power-of-two lengths has its own design (rfft_edge_kernel).
//
// Arithmetic (every kernel). Four-step factorisation of the length m into
// m = m1 * m2 (m1 the largest divisor <= sqrt(m), m2 even; the JAX package's
// mxu_fft._best_factors), n = n1 + m1 n2, k = k2 + m2 k1:
//   X[k2 + m2 k1] = sum_n1 W_m1^(k1 n1) W_m^(n1 k2) sum_n2 W_m2^(k2 n2) x[n1 + m1 n2]
// Zero padding on input is n2 < m2/2; truncation on output keeps n2 < m2/2.
// One thread owns one (n1 or k2, column) task and holds that factor's
// inputs in a register array sized by the template class (M1 >= m1,
// H2 >= m2/2, zero padded). A factor whose length fills its class as a
// power of two (every factor of m = 64, 128, 256, 512, 1024) runs as an
// unrolled radix-2 FFT in those registers; any other factor (m = 96 =
// 8 * 12, 544 = 17 * 32, ...) runs as direct sums that stream the outputs.
// The twiddles W_m1, W_m2 (as (row, column) tables, so the direct sums
// index them with compile-time offsets) and W_m are computed on the host in
// float64, rounded to float32, uploaded once per length and copied to
// shared memory by each block; every read of them is a warp broadcast. The
// intermediate between the two factors lives in shared memory only, in the
// slot k2 * m1 + n1 of its column. Plain FP32 FMA throughout: no TF32, no
// fast math. At m = 512 = 16 * 32 a complex output costs ~5 log2 m flop
// (radix-2), against ~8 (m1 + m2/2) for direct factor sums and ~4 m for a
// dense DFT.
//
// Tile choice. Shared data <= 96 KB a block, so two blocks (plus their
// twiddle tables, <= 20 KB) fit one SM's 227 KB: t = 32, 16, 8 or 4. At
// m = 512 the middle passes take t = 16 and the x edges t = 8, three
// blocks an SM. The fused-curl z pass's four-step kernel keeps three
// components' slots, 24 B a slot against 8.
//
// fft_pass_padded
//   Replaces sopht_mpi_tpu/parallel/pallas_fft.py _fft_pass_padded_impl
//   (kernel _fwd_kernel): forward DFT along L of (A, m/2, B) into (A, m, B).
//   Bound: HBM, 24 B per output column element (8 B read, 16 B written).
//
// ifft_pass_truncated
//   Replaces _ifft_pass_truncated_impl (kernel _inv_kernel): inverse DFT
//   along L of (A, m, B), optionally times a real spectrum (A or 1, m, B),
//   keeping the first m/2 outputs, 1/m applied. Same bound as above.
//
// fft_greens_ifft_pass
//   Replaces _fft_greens_ifft_pass_impl (kernel _conv_kernel): forward DFT of
//   the zero-padded column, times the real Green's spectrum (1, m, B), inverse
//   DFT, first m/2 kept. The length-m spectrum exists only in shared memory.
//   The block loads its Green's tile once and applies it to every one of the
//   A components (the TPU kernel's grid order served the same purpose). Bound:
//   HBM (16 B per input element plus the Green's read once) with radix-2
//   factors; FP32 issue with direct sums (two transforms per column). At
//   m = 64 ... 512: zconv_kernel (see the note above it), persistent blocks
//   fed by a ring of cp.async copies, the middle factor in registers.
//
// rfft_pass_padded_split
//   Replaces _rfft_pass_padded_split_impl (kernel _r2c_split_kernel): r2c of
//   each row of (R, n_in), zero-padded to m, bulk k < m/2 and the Nyquist
//   column k = m/2 returned apart. The TPU contracted a dense (n_in, m/2)
//   DFT matrix on the MXU (~52 GFLOP at 256^3, > 0.8 ms of FP32 here). At
//   power-of-two m: rfft_edge_kernel (see the note above it), a half-length
//   complex FFT a row and the split step, persistent blocks fed by bulk
//   copies. At other m: rfft_pass_padded_split_kernel, the factored
//   transform of the real row (direct first-factor sums use its Hermitian
//   symmetry), keeping k <= m/2, rows transposed through shared memory.
//   Bound: HBM (12 B per input element).
//
// irfft_pass_merge
//   Replaces _irfft_pass_merge_impl (kernel _c2r_merge_kernel): c2r of the
//   bulk plus Nyquist column, keeping the first n_out <= m/2 reals
//   (imaginary parts of k = 0 and k = m/2 dropped: the JAX weights w = 1
//   there, 2 elsewhere). At power-of-two m: irfft_edge_kernel (see the note
//   above it), the merge step and a half-length complex inverse a row,
//   persistent blocks fed by bulk copies. At other m:
//   irfft_pass_merge_kernel, the half spectrum k <= m/2 in shared memory,
//   k > m/2 read as conj(X[m - k]), the factored inverse keeping the real
//   part. Bound: HBM (8 B read per input element, 4 B written per output).
//
// rfft_pass_padded, irfft_pass_truncated
//   Replace _rfft_pass_padded_impl (kernel _r2c_kernel) and
//   _irfft_pass_truncated_impl (kernel _c2r_kernel): the two x-edge passes
//   above with the Nyquist column kept in the row, (R, m/2 + 1) pairs. The
//   same kernels with `unsplit` set: the row pitch is m/2 + 1 floats and no
//   side column is read or written. Rows lose their 16-byte alignment, so
//   the four-step kernels access them with scalars; the ring kernels move
//   tiles of a multiple of 4 rows, which are aligned spans.
//   Bound: HBM, as their split twins.
//
// rfft_fft_pass_fused, ifft_irfft_pass_fused
//   Replace _rfft_fft_pass_fused_impl (kernel _r2c_fwd_kernel) and
//   _ifft_irfft_pass_fused_impl (kernel _inv_c2r_kernel), which hold a whole
//   slab in VMEM; see the note above the two kernels for what they do
//   instead. Bound by HBM bytes as functions (4 B in, 16 B out a bulk
//   element); as written, FP32 issue and shared-memory bandwidth (dense x
//   sums). The forward pass at power-of-two lengths whose slab's slots fit
//   a cluster of at most 16 blocks: rfft_fft_cluster_kernel (see the note
//   above it), the slab's spectrum spread over a thread-block cluster's
//   shared memory, a factored r2c a row and the y transform by the
//   columns' owners. The inverse where a cluster holds a slab's column
//   tiles and rows: ifft_irfft_cluster_kernel (see the note above it), the
//   y inverse by the columns' owners, pushed to the rows' owners for a
//   factored c2r a row.
//
// The fast tier's fused-curl pair (the velocity recovery without the
// streamfunction):
//
// fft_greens_curl_ifft_pass
//   Replaces _fft_greens_curl_ifft_pass_impl (kernel _conv_curl_kernel):
//   fft_greens_ifft_pass over the three vorticity components of (3, m/2, B)
//   with the spectral central-difference curl mixed in at the full-spectral
//   point: u_hat = i s x (G w_hat), s = (sx[b], sy[b], sz[k]). The slots of
//   all three components of a column tile are live at once. At m = 64 ...
//   512: zconv_curl_kernel (see the note above it), the z conv's design
//   with the three components' slot regions as the input ring and the curl
//   mixed in registers. At other m: fft_greens_curl_ifft_pass_kernel, one
//   tile a block (t = 4 at m = 1024), the mixing in shared memory, the
//   Green's spectrum read from device memory where it is applied. Bound:
//   HBM, 16 B per input element of the three components plus the Green's
//   read once (the arithmetic, ~5 log2 m flop a complex output a
//   transform, is below the FP32 rate).
//
// irfft_pass_merge_velocity
//   Replaces _irfft_pass_merge_velocity_impl (kernel
//   _c2r_merge_velocity_kernel): irfft_pass_merge of the three velocity
//   components of (3, R, m/2) + (3, R, 1), R = nz ny, then the epilogue:
//   the width-1 wall ring zeroed (row z ny + y with z or y on a wall, or x
//   on one), the free stream added on every cell, and max over cells of
//   sum_c |u_c| (a block max, atomicMax on the float bits of a zeroed
//   device scalar: the values are non-negative, so the bit order is the
//   value order and the result exact). At power-of-two m:
//   irfft_edge_kernel<H, true> (see the note above it), the c2r ring
//   kernel walking (row tile, component) units with the epilogue in its
//   emit sink. At other m: irfft_pass_merge_velocity_kernel, a block taking
//   the same row tile of each component in turn, a shared-memory sum per
//   cell. Bound: HBM, as irfft_pass_merge on 3 R rows.

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr long long kDataBudget = 96 * 1024;
// The x-edge kernels keep three blocks on an SM (their shared data fits
// three): registers are capped at 85 a thread to match.
constexpr int kEdgeBlocks = 3;

struct Plan {
  int m, m1, m2, m1c, h2c;
  // float2 entries of the twiddle table: W1 (m1 x m1c), W2 (m2 x h2c), T (m)
  int table_len() const { return m1 * m1c + m2 * h2c + m; }
  // ... followed by the line W_m^j, j < m (the power-of-two x-edge r2c)
  int full_len() const { return table_len() + m; }
};

bool make_plan(int m, Plan* p) {
  if (m < 64 || m > 1024) return false;
  int r = 0;
  while ((r + 1) * (r + 1) <= m) ++r;
  int m1 = 1;
  for (int c = r; c > 0; --c) {
    if (m % c == 0) {
      m1 = c;
      break;
    }
  }
  const int m2 = m / m1;
  if (m1 < 4 || m2 % 2 != 0) return false;
  const int h2 = m2 / 2;
  if (m1 > 32 || h2 > 24) return false;
  p->m = m;
  p->m1 = m1;
  p->m2 = m2;
  p->m1c = m1 <= 8 ? 8 : (m1 <= 16 ? 16 : 32);
  p->h2c = h2 <= 8 ? 8 : (h2 <= 16 ? 16 : 24);
  return true;
}

// exp(-2 pi i j / n) in float64, j reduced mod n first
void twiddle(long long j, int n, float* out) {
  const double ang = -2.0 * 3.14159265358979323846 * (double)(j % n) / n;
  out[0] = (float)std::cos(ang);
  out[1] = (float)std::sin(ang);
}

__device__ __forceinline__ void cmac(float& ar, float& ai, const float2 w,
                                     const float xr, const float xi) {
  ar = fmaf(w.x, xr, ar);
  ar = fmaf(-w.y, xi, ar);
  ai = fmaf(w.x, xi, ai);
  ai = fmaf(w.y, xr, ai);
}

// accumulate conj(w) * x
__device__ __forceinline__ void cmac_conj(float& ar, float& ai, const float2 w,
                                          const float xr, const float xi) {
  ar = fmaf(w.x, xr, ar);
  ar = fmaf(w.y, xi, ar);
  ai = fmaf(w.x, xi, ai);
  ai = fmaf(-w.y, xr, ai);
}

__device__ __forceinline__ float2 cmul(const float2 w, const float2 x) {
  return make_float2(w.x * x.x - w.y * x.y, w.x * x.y + w.y * x.x);
}

__device__ __forceinline__ float2 cmul_conj(const float2 w, const float2 x) {
  return make_float2(w.x * x.x + w.y * x.y, w.x * x.y - w.y * x.x);
}

// The twiddle tables in shared memory: w1[k1 * M1 + n1] = W_m1^(k1 n1)
// (zero for n1 >= m1), w2[k2 * H2 + n2] = W_m2^(k2 n2) (zero for
// n2 >= m2/2), tw[n1 * m2 + k2] = W_m^(n1 k2).
struct Twiddles {
  const float2* w1;
  const float2* w2;
  const float2* tw;
};

template <int M1, int H2>
__device__ __forceinline__ Twiddles load_twiddles(
    const float2* __restrict__ table, float2* smem, int m1, int m2, int m) {
  const int n = m1 * M1 + m2 * H2 + m;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < n; i += nt) smem[i] = table[i];
  Twiddles s;
  s.w1 = smem;
  s.w2 = smem + m1 * M1;
  s.tw = s.w2 + m2 * H2;
  return s;
}

// sum_n w[n] y[n] over the register array
template <int N>
__device__ __forceinline__ float2 dot(const float (&yr)[N],
                                      const float (&yi)[N],
                                      const float2* w) {
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) cmac(ar, ai, w[n], yr[n], yi[n]);
  return make_float2(ar, ai);
}

// sum_n conj(w[n]) y[n]
template <int N>
__device__ __forceinline__ float2 dot_conj(const float (&yr)[N],
                                           const float (&yi)[N],
                                           const float2* w) {
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) cmac_conj(ar, ai, w[n], yr[n], yi[n]);
  return make_float2(ar, ai);
}

// y[j] = col[(base + j) * ld] for j < count, zero beyond
template <int N>
__device__ __forceinline__ void load_slots(float (&yr)[N], float (&yi)[N],
                                           const float2* col, int base,
                                           int count, int ld) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float2 v = make_float2(0.f, 0.f);
    if (j < count) v = col[(base + j) * ld];
    yr[j] = v.x;
    yi[j] = v.y;
  }
}

__host__ __device__ constexpr bool is_pow2(int n) {
  return n > 0 && (n & (n - 1)) == 0;
}

// k with its log2(N) bits reversed
template <int N>
__host__ __device__ constexpr int bit_reverse(int k) {
  int r = 0;
  for (int b = 1; b < N; b <<= 1) {
    r = (r << 1) | (k & 1);
    k >>= 1;
  }
  return r;
}

// In-register radix-2 DFT of length N (a power of two), decimation in
// frequency: on return re/im[bit_reverse<N>(k)] holds
// sum_n W_N^(+-k n) x[n] (conjugate twiddles when INV). w[j] = W_N^j,
// j < N/2. Each stage is a template instance with a fixed trip count, so
// every index is a compile-time constant once unrolled and the arrays stay
// in registers.
template <int N, int HALF, bool INV>
struct Radix2 {
  static __device__ __forceinline__ void stages(float (&re)[N], float (&im)[N],
                                                const float2* w) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const int j = q % HALF;
      const int a = (q / HALF) * (2 * HALF) + j, b = a + HALF;
      const int e = j * (N / (2 * HALF));
      const float tr = re[a] - re[b], ti = im[a] - im[b];
      re[a] += re[b];
      im[a] += im[b];
      if (e == 0) {
        re[b] = tr;
        im[b] = ti;
      } else if (4 * e == N) {  // W = -i, or +i for the inverse
        re[b] = INV ? -ti : ti;
        im[b] = INV ? tr : -tr;
      } else {
        const float2 t = w[e];
        const float ty = INV ? -t.y : t.y;
        re[b] = tr * t.x - ti * ty;
        im[b] = tr * ty + ti * t.x;
      }
    }
    Radix2<N, HALF / 2, INV>::stages(re, im, w);
  }
};

template <int N, bool INV>
struct Radix2<N, 0, INV> {
  static __device__ __forceinline__ void stages(float (&)[N], float (&)[N],
                                                const float2*) {}
};

template <int N, bool INV>
__device__ __forceinline__ void reg_fft(float (&re)[N], float (&im)[N],
                                        const float2* w) {
  Radix2<N, N / 2, INV>::stages(re, im, w);
}

// f(k, r) for k < COUNT with r = bit_reverse<N>(k) a compile-time
// constant: output k of reg_fft<N> sits at index r.
template <int N, class F, int... K>
__device__ __forceinline__ void each_output(F&& f,
                                            std::integer_sequence<int, K...>) {
  (f(K, std::integral_constant<int, bit_reverse<N>(K)>::value), ...);
}

template <int N, int COUNT = N, class F>
__device__ __forceinline__ void each_output(F&& f) {
  each_output<N>(f, std::make_integer_sequence<int, COUNT>{});
}

// The length-m1 factor: sum_n W_m1^(+-k n) y[n] for every k < m1, handed to
// emit(k, value). Radix-2 in registers when m1 fills the class M1, else
// direct sums. Clobbers y.
template <int M1, bool INV, class Emit>
__device__ __forceinline__ void dft_m1(float (&yr)[M1], float (&yi)[M1],
                                       const Twiddles& s, int m1, Emit emit) {
  if (m1 == M1) {
    reg_fft<M1, INV>(yr, yi, s.w1 + M1);
    each_output<M1>([&](int k, int r) { emit(k, make_float2(yr[r], yi[r])); });
    return;
  }
  for (int k = 0; k < m1; ++k)
    emit(k, INV ? dot_conj(yr, yi, s.w1 + k * M1) : dot(yr, yi, s.w1 + k * M1));
}

// Whether the length-m2 factor runs radix-2 in registers.
template <int H2>
__device__ __forceinline__ bool radix2_m2(int m2) {
  return is_pow2(H2) && m2 == 2 * H2;
}

// Forward first factor for one n1: slot (k2 m1 + n1) <- W_m^(n1 k2) *
// sum_n2 W_m2^(k2 n2) v[n2], every k2 < m2 (v zero past m2/2).
template <int H2>
__device__ __forceinline__ void forward_first(const float (&vr)[H2],
                                              const float (&vi)[H2],
                                              const Twiddles& s, int n1,
                                              int m1, int m2, float2* col,
                                              int ld) {
  if constexpr (is_pow2(H2)) {
    if (radix2_m2<H2>(m2)) {
      float re[2 * H2], im[2 * H2];
#pragma unroll
      for (int j = 0; j < 2 * H2; ++j) {
        re[j] = j < H2 ? vr[j] : 0.f;
        im[j] = j < H2 ? vi[j] : 0.f;
      }
      reg_fft<2 * H2, false>(re, im, s.w2 + H2);
      each_output<2 * H2>([&](int k2, int r) {
        col[(k2 * m1 + n1) * ld] =
            cmul(s.tw[n1 * m2 + k2], make_float2(re[r], im[r]));
      });
      return;
    }
  }
  for (int k2 = 0; k2 < m2; ++k2) {
    const float2 y = dot(vr, vi, s.w2 + k2 * H2);
    col[(k2 * m1 + n1) * ld] = cmul(s.tw[n1 * m2 + k2], y);
  }
}

// Inverse first factor for one k2 from v[k1] = X[k2 + m2 k1]: slot
// (k2 m1 + n1) <- conj(W_m^(n1 k2)) sum_k1 conj(W_m1^(n1 k1)) v[k1].
// Clobbers v.
template <int M1>
__device__ __forceinline__ void inverse_first(float (&vr)[M1], float (&vi)[M1],
                                              const Twiddles& s, int k2,
                                              int m1, int m2, float2* col,
                                              int ld) {
  dft_m1<M1, true>(vr, vi, s, m1, [&](int n1, float2 z) {
    col[(k2 * m1 + n1) * ld] = cmul_conj(s.tw[n1 * m2 + k2], z);
  });
}

// Inverse second factor from the slots slot(k2), k2 < m2, of one n1:
// acc[n2] = sum_k2 conj(W_m2^(k2 n2)) slot(k2), n2 < m2/2 (unscaled).
template <int H2, class Slot>
__device__ __forceinline__ void inverse_second_of(float (&ar)[H2],
                                                  float (&ai)[H2],
                                                  const Twiddles& s, int m2,
                                                  Slot slot) {
  if constexpr (is_pow2(H2)) {
    if (radix2_m2<H2>(m2)) {
      float re[2 * H2], im[2 * H2];
#pragma unroll
      for (int k2 = 0; k2 < 2 * H2; ++k2) {
        const float2 z = slot(k2);
        re[k2] = z.x;
        im[k2] = z.y;
      }
      reg_fft<2 * H2, true>(re, im, s.w2 + H2);
      each_output<2 * H2, H2>([&](int n2, int r) {
        ar[n2] = re[r];
        ai[n2] = im[r];
      });
      return;
    }
  }
#pragma unroll
  for (int n2 = 0; n2 < H2; ++n2) ar[n2] = ai[n2] = 0.f;
  for (int k2 = 0; k2 < m2; ++k2) {
    const float2 z = slot(k2);
    const float2* w = s.w2 + k2 * H2;
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) cmac_conj(ar[n2], ai[n2], w[n2], z.x, z.y);
  }
}

// Inverse second factor for one n1 from the column's slots k2 m1 + n1.
template <int H2>
__device__ __forceinline__ void inverse_second(float (&ar)[H2],
                                               float (&ai)[H2],
                                               const Twiddles& s,
                                               const float2* col, int n1,
                                               int m1, int m2, int ld) {
  inverse_second_of(ar, ai, s, m2,
                    [&](int k2) { return col[(k2 * m1 + n1) * ld]; });
}

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads)
    fft_pass_padded_kernel(const float* __restrict__ xr,
                           const float* __restrict__ xi,
                           float* __restrict__ out_r, float* __restrict__ out_i,
                           const float2* __restrict__ table, long long B,
                           int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  float2* col = smem + (m1 * M1 + m2 * H2 + m) + threadIdx.x;
  const long long b = (long long)blockIdx.x * t + threadIdx.x;
  const bool live = b < B;
  const long long a = blockIdx.y;
  const int h = m / 2, h2 = m2 / 2;
  __syncthreads();
  for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
    float vr[H2], vi[H2];
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) {
      vr[n2] = vi[n2] = 0.f;
      if (live && n2 < h2) {
        const long long i = (a * h + n1 + (long long)m1 * n2) * B + b;
        vr[n2] = xr[i];
        vi[n2] = xi[i];
      }
    }
    forward_first(vr, vi, s, n1, m1, m2, col, t);
  }
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    float yr[M1], yi[M1];
    load_slots(yr, yi, col, k2 * m1, m1, t);
    dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
      if (live) {
        const long long i = (a * m + k2 + (long long)m2 * k1) * B + b;
        out_r[i] = v.x;
        out_i[i] = v.y;
      }
    });
  }
}

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads)
    ifft_pass_truncated_kernel(const float* __restrict__ xr,
                               const float* __restrict__ xi,
                               const float* __restrict__ g, int g_shared,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i,
                               const float2* __restrict__ table, long long B,
                               int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  float2* col = smem + (m1 * M1 + m2 * H2 + m) + threadIdx.x;
  const long long b = (long long)blockIdx.x * t + threadIdx.x;
  const bool live = b < B;
  const long long a = blockIdx.y;
  const long long ga = g_shared ? 0 : a;
  const int h = m / 2, h2 = m2 / 2;
  const float inv_m = 1.0f / (float)m;
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    float vr[M1], vi[M1];
#pragma unroll
    for (int k1 = 0; k1 < M1; ++k1) {
      vr[k1] = vi[k1] = 0.f;
      if (live && k1 < m1) {
        const long long k = k2 + (long long)m2 * k1;
        float gv = 1.f;
        if (g != nullptr) gv = g[(ga * m + k) * B + b];
        vr[k1] = xr[(a * m + k) * B + b] * gv;
        vi[k1] = xi[(a * m + k) * B + b] * gv;
      }
    }
    inverse_first(vr, vi, s, k2, m1, m2, col, t);
  }
  __syncthreads();
  for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
    float ar[H2], ai[H2];
    inverse_second(ar, ai, s, col, n1, m1, m2, t);
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) {
      if (live && n2 < h2) {
        const long long i = (a * h + n1 + (long long)m1 * n2) * B + b;
        out_r[i] = ar[n2] * inv_m;
        out_i[i] = ai[n2] * inv_m;
      }
    }
  }
}

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads)
    fft_greens_ifft_pass_kernel(const float* __restrict__ xr,
                                const float* __restrict__ xi,
                                const float* __restrict__ g,
                                float* __restrict__ out_r,
                                float* __restrict__ out_i,
                                const float2* __restrict__ table, int A,
                                long long B, int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  float2* slots = smem + (m1 * M1 + m2 * H2 + m);
  float2* col = slots + threadIdx.x;
  float* gcol = reinterpret_cast<float*>(slots + (long long)m * t) + threadIdx.x;
  const long long b = (long long)blockIdx.x * t + threadIdx.x;
  const bool live = b < B;
  const int h = m / 2, h2 = m2 / 2;
  const float inv_m = 1.0f / (float)m;
  // the block's Green's tile, read once for all A components
  for (int k = threadIdx.y; k < m; k += blockDim.y)
    gcol[k * t] = live ? g[(long long)k * B + b] : 0.f;
  __syncthreads();
  for (long long a = 0; a < A; ++a) {
    for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
      float vr[H2], vi[H2];
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        vr[n2] = vi[n2] = 0.f;
        if (live && n2 < h2) {
          const long long i = (a * h + n1 + (long long)m1 * n2) * B + b;
          vr[n2] = xr[i];
          vi[n2] = xi[i];
        }
      }
      forward_first(vr, vi, s, n1, m1, m2, col, t);
    }
    __syncthreads();
    for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
      float yr[M1], yi[M1];
      load_slots(yr, yi, col, k2 * m1, m1, t);
      // forward second factor times the Green's spectrum, back into this
      // thread's own slots (k2 m1 + k1)
      dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
        const float gv = gcol[(k2 + m2 * k1) * t];
        col[(k2 * m1 + k1) * t] = make_float2(v.x * gv, v.y * gv);
      });
      load_slots(yr, yi, col, k2 * m1, m1, t);
      inverse_first(yr, yi, s, k2, m1, m2, col, t);
    }
    __syncthreads();
    for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
      float ar[H2], ai[H2];
      inverse_second(ar, ai, s, col, n1, m1, m2, t);
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        if (live && n2 < h2) {
          const long long i = (a * h + n1 + (long long)m1 * n2) * B + b;
          out_r[i] = ar[n2] * inv_m;
          out_i[i] = ai[n2] * inv_m;
        }
      }
    }
    __syncthreads();
  }
}

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, kEdgeBlocks)
    rfft_pass_padded_split_kernel(const float* __restrict__ x,
                                  float* __restrict__ br,
                                  float* __restrict__ bi,
                                  float* __restrict__ sr,
                                  float* __restrict__ si,
                                  const float2* __restrict__ table,
                                  long long R, int n_in, int m, int m1,
                                  int m2, int unsplit) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x, tp = t + 1;
  float2* slots = smem + (m1 * M1 + m2 * H2 + m);
  float2* col = slots + threadIdx.x;
  float2* stage = slots + (long long)m * t;     // (m/2 + 1) x tp outputs
  float* xs = reinterpret_cast<float*>(stage);  // n_in x tp inputs
  const int tid = threadIdx.y * t + threadIdx.x;
  const int nt = t * blockDim.y;
  const long long row0 = (long long)blockIdx.x * t;
  const int h = m / 2, h2 = m2 / 2;
  // several rows in flight per thread
#pragma unroll 4
  for (int r = 0; r < t; ++r) {
    const long long row = row0 + r;
    for (int n = tid; n < n_in; n += nt)
      xs[n * tp + r] = row < R ? x[row * n_in + n] : 0.f;
  }
  __syncthreads();
  for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
    float v[H2], zero[H2];
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) {
      const int n = n1 + m1 * n2;
      v[n2] = (n2 < h2 && n < n_in) ? xs[n * tp + threadIdx.x] : 0.f;
      zero[n2] = 0.f;
    }
    if (radix2_m2<H2>(m2)) {
      forward_first(v, zero, s, n1, m1, m2, col, t);
      continue;
    }
    // direct sums on real input: the first factor is Hermitian in k2
    for (int k2 = 0; k2 <= h2; ++k2) {
      const float2* w = s.w2 + k2 * H2;
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        ar = fmaf(w[n2].x, v[n2], ar);
        ai = fmaf(w[n2].y, v[n2], ai);
      }
      col[(k2 * m1 + n1) * t] = cmul(s.tw[n1 * m2 + k2], make_float2(ar, ai));
      if (k2 > 0 && k2 < h2)
        col[((m2 - k2) * m1 + n1) * t] =
            cmul(s.tw[n1 * m2 + m2 - k2], make_float2(ar, -ai));
    }
  }
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    float yr[M1], yi[M1];
    load_slots(yr, yi, col, k2 * m1, m1, t);
    if (m1 == M1) {  // radix-2 computes every k1; keep k <= m/2
      dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
        if (k2 + m2 * k1 <= h) stage[(k2 + m2 * k1) * tp + threadIdx.x] = v;
      });
      continue;
    }
    for (int k1 = 0; k1 < m1 && k2 + m2 * k1 <= h; ++k1)
      stage[(k2 + m2 * k1) * tp + threadIdx.x] = dot(yr, yi, s.w1 + k1 * M1);
  }
  __syncthreads();
  // unsplit: the Nyquist column stays in the row, rows of m/2 + 1 floats
  // (row starts then lose their 16-byte alignment: scalar stores only)
  const int ld = unsplit ? h + 1 : h;
  // several rows in flight per thread
#pragma unroll 4
  for (int r = 0; r < t && row0 + r < R; ++r) {
    const long long row = row0 + r;
    for (int k = tid; k < ld; k += nt) {
      const float2 v = stage[k * tp + r];
      br[row * ld + k] = v.x;
      bi[row * ld + k] = v.y;
    }
  }
  if (unsplit) return;
  for (int r = tid; r < t; r += nt) {
    const long long row = row0 + r;
    if (row < R) {
      const float2 v = stage[h * tp + r];
      sr[row] = v.x;
      si[row] = v.y;
    }
  }
}

// ---------------------------------------------------------------------------
// rfft_pass_padded_split / rfft_pass_padded at power-of-two lengths
// (m = 64 ... 1024): the forward x-edge r2c, designed for Hopper.
//
// Replaces, with the kernel above for the other lengths,
// sopht_mpi_tpu/parallel/pallas_fft.py _rfft_pass_padded_split_impl and
// _rfft_pass_padded_impl. Bound: HBM, 4 B read and 8 B written per output
// column (at 256^3, 196,608 rows of 256 floats to m = 512: 201 MB in,
// 404 MB out, 0.18 ms at 3.35 TB/s); the r2c needs ~2.5 m log2 m flop a
// row, 0.034 ms of the FP32 rate. The kernel above holds ~24 rows an SM
// in flight, loads the 10 KB twiddle table once per 8 rows, transforms
// the real row as complex and keeps half of a full spectrum, and moves
// every float with its own 4-byte access. This design:
//
// 1. Half-length complex transform. A row x of n_in <= m/2 reals, zero
//    padded to m, is z[n] = x[2n] + i x[2n+1] (zero past the row), one
//    complex FFT of length h = m/2, then the split step
//      X[k] = E - i W_m^k O,  X[h-k] = conj(E) - i conj(W_m^k O),
//      E = (Z[k] + conj Z[h-k]) / 2,  O = (Z[k] - conj Z[h-k]) / 2,
//    Z[h] = Z[0], one thread producing k and h - k from the same two
//    values (k = 0 gives X[0] and X[h] with exactly zero imaginary parts).
// 2. A lane group per row. G = h / P lanes own a row (G = 32 at m = 1024,
//    16 at m = 512, so one or two rows a warp; 4 at m <= 128), each lane
//    P = 16 values (8 at m = 64). The h-point FFT is Stockham passes of
//    radix P (the last one smaller where h is not a power of P): each lane
//    loads its P / R butterflies of R inputs from the group's padded
//    buffer in shared memory, applies the pass twiddles, runs the radix-R
//    DFT in registers (Radix2 above) and writes its outputs in Stockham
//    order; only __syncwarp separates passes. The first pass reads the
//    packed input from the staged row and skips its zero half. The buffer
//    index is padded (i + i >> SH) so that no pass's loads or stores
//    conflict in the banks by more than a few percent. Twiddles are the
//    host's float64 table rounded to float32 (the W_m line appended to the
//    table), copied once per block into shared memory, the pass twiddles
//    laid out [r][j mod Ns] so that a warp's reads are consecutive.
// 3. Persistent blocks and a ring of bulk copies. The host plan
//    (edge_tile_plan in parallel/cuda_fft.py, checked here) gives T rows a
//    tile (a multiple of 4, one lane group a row), the block count (at
//    most the tiles, about two blocks an SM) and the ring depth S. Each
//    block walks its tiles; a full tile's input, T n_in contiguous floats,
//    is one cp.async.bulk into a ring stage whose mbarrier counts its
//    bytes, issued S - 1 tiles ahead of the tile being computed. The
//    outputs of a tile (T h floats each of re/im and T of each side
//    column, or T (h + 1) of re/im unsplit) are staged in one of two
//    buffers and leave as bulk stores; a store group is waited on (for its
//    reads) before its buffer is written again. With T a multiple of 4
//    every span starts 16-byte aligned and is a multiple of 16 bytes,
//    unsplit rows of h + 1 floats included.
// 4. The last tile when it is ragged, and every tile of an input whose
//    pointer is not 16-byte aligned (a view with a storage offset), move
//    through the same stages with ordinary coalesced loads (and the ragged
//    tile with ordinary stores).
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the barrier's arrival for a stage, expecting `bytes` from its copies
__device__ __forceinline__ void bulk_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// a bulk copy into shared memory whose bytes the barrier counts
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  bulk_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  // a copy that never lands traps (an error on the stream) after ~1e8
  // polls, rather than holding the card
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 27)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// The sizes of the design at h = m / 2 (host and device).
template <int H>
struct EdgeShape {
  static constexpr int P = H >= 64 ? 16 : 8;  // values a lane holds
  static constexpr int G = H / P;             // lanes a row
  static constexpr int SH = (H == 32 || H == 512) ? 4 : 5;
  static constexpr int HP = H + (H >> SH);    // padded row buffer (float2)
  static __host__ __device__ constexpr int pad(int i) { return i + (i >> SH); }
  // float2 entries of the pass twiddle tables (every pass after the first)
  static __host__ __device__ constexpr int pass_len() {
    int n = 0;
    for (int ns = P; ns < H; ns *= (H / ns < P ? H / ns : P))
      n += ns * (H / ns < P ? H / ns : P);
    return n;
  }
  // float2 twiddles in shared memory: W_m^j for j < h, then the pass tables
  static constexpr int TW = H + pass_len();
};

// The default sink of the last Stockham pass: the group's buffer.
struct ToBuffer {};

// Stockham pass of radix R = min(P, H / NS) over the group's buffer, then
// the next pass. The last pass hands output n (natural order) to
// emit(n, re, im) in place of the buffer when a sink is given.
template <int H, int NS>
struct EdgePass {
  template <class Emit = ToBuffer>
  static __device__ __forceinline__ void run(float2* buf, int q,
                                             const float2* line,
                                             const float2* tp,
                                             Emit emit = {}) {
    if constexpr (NS < H) {
      using S = EdgeShape<H>;
      constexpr int R = H / NS < S::P ? H / NS : S::P;
      constexpr int NB = S::P / R;  // butterflies a lane
      float re[NB][R], im[NB][R];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = q + S::G * b;
        const int jm = j & (NS - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 v = buf[S::pad(j + r * (H / R))];
          if (r == 0) {
            re[b][r] = v.x;
            im[b][r] = v.y;
          } else {  // times W_(NS R)^(jm r)
            const float2 w = tp[r * NS + jm];
            re[b][r] = v.x * w.x - v.y * w.y;
            im[b][r] = v.x * w.y + v.y * w.x;
          }
        }
      }
      __syncwarp();
      float2 wr[R / 2];
#pragma unroll
      for (int e = 0; e < R / 2; ++e) wr[e] = line[e * (H / R) * 2];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = q + S::G * b;
        const int base = (j / NS) * NS * R + (j & (NS - 1));
        reg_fft<R, false>(re[b], im[b], wr);
        each_output<R>([&](int k, int rr) {
          if constexpr (NS * R == H && !std::is_same<Emit, ToBuffer>::value)
            emit(base + k * NS, re[b][rr], im[b][rr]);
          else
            buf[S::pad(base + k * NS)] = make_float2(re[b][rr], im[b][rr]);
        });
      }
      __syncwarp();
      EdgePass<H, NS * R>::run(buf, q, line, tp + NS * R, emit);
    }
  }
};

// The design's twiddles in shared memory: the line W_m^j, j < h, then the
// pass tables tp[r Ns + i] = W_(Ns R)^(i r) = W_m^(i r m / (Ns R)), pass by
// pass (every pass after the first).
template <int H>
__device__ __forceinline__ void load_edge_twiddles(float2* line, float2* tp,
                                                   const float2* line_g) {
  constexpr int P = EdgeShape<H>::P, m = 2 * H;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < H; i += nt) line[i] = line_g[i];
  int off = 0;
  for (int ns = P; ns < H;) {
    const int r_ = H / ns < P ? H / ns : P;
    for (int i = tid; i < ns * r_; i += nt) {
      const int r = i / ns, j = i % ns;
      tp[off + i] = line_g[j * r * (m / (ns * r_))];
    }
    off += ns * r_;
    ns *= r_;
  }
}

// The r2c of one staged row of n_in <= h reals (zero padded to m = 2h) as
// the packed h-point complex FFT: the first pass (radix P, butterfly j = q,
// inputs z[q + G r], the zero half skipped) reads the row, the Stockham
// passes leave Z in natural order in the group's buffer.
template <int H>
__device__ __forceinline__ void r2c_row_fft(const float* xin, int n_in,
                                            float2* buf, int q,
                                            const float2* line,
                                            const float2* tp) {
  using S = EdgeShape<H>;
  constexpr int P = S::P, G = S::G;
  const int nz = (n_in + 1) >> 1;  // complex inputs of a row
  float re[P], im[P];
  const bool pairs = (n_in & 1) == 0;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int n = q + G * r;
    re[r] = im[r] = 0.f;
    if (r < P / 2 && n < nz) {
      if (pairs) {
        const float2 v = reinterpret_cast<const float2*>(xin)[n];
        re[r] = v.x;
        im[r] = v.y;
      } else {
        re[r] = xin[2 * n];
        if (2 * n + 1 < n_in) im[r] = xin[2 * n + 1];
      }
    }
  }
  float2 wr[P / 2];
#pragma unroll
  for (int e = 0; e < P / 2; ++e) wr[e] = line[e * (H / P) * 2];
  reg_fft<P, false>(re, im, wr);
  each_output<P>([&](int k, int rr) {
    buf[S::pad(q * P + k)] = make_float2(re[rr], im[rr]);
  });
  __syncwarp();
  EdgePass<H, P>::run(buf, q, line, tp);
}

// The split step at k from the packed spectrum Z in buf: lo = X[k] and
// hi = X[h - k] (X[h], the Nyquist value, at k = 0).
template <int H>
__device__ __forceinline__ void r2c_split(const float2* buf,
                                          const float2* line, int k,
                                          float2& lo, float2& hi) {
  using S = EdgeShape<H>;
  const float2 a = buf[S::pad(k)];
  const float2 c = buf[S::pad((H - k) & (H - 1))];
  const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
  const float odr = 0.5f * (a.x - c.x), odi = 0.5f * (a.y + c.y);
  const float2 w = line[k];
  const float pr = w.x * odr - w.y * odi, pi = w.x * odi + w.y * odr;
  lo = make_float2(er + pi, ei - pr);
  hi = make_float2(er - pi, -ei - pr);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    rfft_edge_kernel(const float* __restrict__ x, float* __restrict__ br,
                     float* __restrict__ bi, float* __restrict__ sr,
                     float* __restrict__ si,
                     const float2* __restrict__ line_g, long long R,
                     int n_in, int T, int stages, int bulk, int unsplit) {
  using S = EdgeShape<H>;
  constexpr int P = S::P, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* line = reinterpret_cast<float2*>(smem_raw);  // W_m^j, j < h
  float2* tp = line + H;                               // pass tables
  float* ring = reinterpret_cast<float*>(line + S::TW);
  const int in_floats = T * n_in;
  const int ld = unsplit ? H + 1 : H;
  const int out_floats = 2 * T * ld + (unsplit ? 0 : 2 * T);
  float* outb = ring + (long long)stages * in_floats;
  float2* work = reinterpret_cast<float2*>(outb + 2 * out_floats);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(work + T * S::HP);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = tid / G, q = tid % G;
  float2* buf = work + grp * S::HP;

  load_edge_twiddles<H>(line, tp, line_g);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (R + T - 1) / T;
  // the input of this block's it-th tile into stage it % stages
  auto produce = [&](long long it) {
    const long long tile = blockIdx.x + it * gridDim.x;
    if (tile >= ntiles) return;
    float* dst = ring + (it % stages) * in_floats;
    const long long row0 = tile * T;
    const int rows = (int)(R - row0 < T ? R - row0 : T);
    const float* src = x + row0 * n_in;
    if (bulk && rows == T) {
      if (tid == 0)
        bulk_load(dst, src, 4u * in_floats, &bars[it % stages]);
    } else {
      for (int i = tid; i < rows * n_in; i += nt) dst[i] = src[i];
    }
  };
  for (int s = 0; s < stages - 1; ++s) produce(s);
  __syncthreads();  // the ordinary loads of the prologue

  for (long long it = 0; blockIdx.x + it * gridDim.x < ntiles; ++it) {
    const long long tile = blockIdx.x + it * gridDim.x;
    produce(it + stages - 1);  // into the stage the last tile freed
    const long long row0 = tile * T;
    const int rows = (int)(R - row0 < T ? R - row0 : T);
    if (bulk && rows == T)
      mbar_wait(&bars[it % stages], (unsigned)((it / stages) & 1));
    const float* xin = ring + (it % stages) * in_floats + grp * n_in;

    r2c_row_fft<H>(xin, n_in, buf, q, line, tp);

    // split step into the staging buffer of this tile
    float* ob = outb + (it & 1) * out_floats;
    float* orr = ob + grp * ld;
    float* oi = ob + T * ld + grp * ld;
    auto split = [&](int k, bool both) {
      float2 lo, hi;
      r2c_split<H>(buf, line, k, lo, hi);
      orr[k] = lo.x;
      oi[k] = lo.y;
      if (!both) return;
      if (k > 0) {
        orr[H - k] = hi.x;
        oi[H - k] = hi.y;
      } else if (unsplit) {
        orr[H] = hi.x;
        oi[H] = hi.y;
      } else {
        ob[2 * T * ld + grp] = hi.x;
        ob[2 * T * ld + T + grp] = hi.y;
      }
    };
#pragma unroll
    for (int s = 0; s < P / 2; ++s) split(q + G * s, true);
    if (q == 0) split(H / 2, false);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (rows == T) {
      if (tid == 0) {
        const unsigned bytes = 4u * T * ld;
        bulk_store(br + row0 * ld, ob, bytes);
        bulk_store(bi + row0 * ld, ob + T * ld, bytes);
        if (!unsplit) {
          bulk_store(sr + row0, ob + 2 * T * ld, 4u * T);
          bulk_store(si + row0, ob + 2 * T * ld + T, 4u * T);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the group before this one has read its buffer, which the next
        // tile writes
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      }
    } else {
      for (int i = tid; i < rows * ld; i += nt) {
        br[row0 * ld + i] = ob[i];
        bi[row0 * ld + i] = ob[T * ld + i];
      }
      if (!unsplit)
        for (int i = tid; i < rows; i += nt) {
          sr[row0 + i] = ob[2 * T * ld + i];
          si[row0 + i] = ob[2 * T * ld + T + i];
        }
    }
    __syncthreads();  // the stage and the other staging buffer are free
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// irfft_pass_merge and irfft_pass_truncated at m = 64, 128, 256, 512, 1024:
// the c2r x edge, designed for Hopper (rfft_edge_kernel run backwards).
//
// Replaces, with irfft_pass_merge_kernel above for the lengths with a
// factor that is not a power of two, sopht_mpi_tpu/parallel/pallas_fft.py:757
// _irfft_pass_merge_impl (split: the bulk (R, m/2) pair and the Nyquist
// (R, 1) pair) and :683 _irfft_pass_truncated_impl (unsplit: the (R, m/2 + 1)
// pair), both into (R, n_out <= m/2) reals:
//   y[n] = (1/m) sum'_k w_k (Re X[k] cos - Im X[k] sin)(2 pi k n / m),
// w = 1 at k = 0 and k = m/2, 2 elsewhere, so Im X[0] and Im X[m/2] do not
// enter (the Nyquist si is not read). Bound: HBM, 8 B read per bulk input
// element, 4 B per side column element and 4 B written per output (at
// 256^3, 196,608 rows of 256 pairs and a side value into 256 reals: 403 MB
// in, 201 MB out, 0.18 ms at 3.35 TB/s); the
// arithmetic, ~5 h log2 h flop a row, is 0.04 ms of the FP32 rate. The
// kernel above runs a full m-point complex inverse of the Hermitian spectrum
// (twice the arithmetic and shared memory needed), takes 8 rows a block and
// reloads the 10 KB twiddle table in each of 24,576 blocks, loads, computes
// and stores in turn with every float moved by its own 4-byte access and
// each row transposed through shared memory twice, and sets its attributes
// on every call. This design:
//
// 1. The merge step and a half-length inverse. With h = m/2,
//      Z[k] = Xe + i Xo,  Xe = X[k] + conj X[h-k],
//      Xo = (X[k] - conj X[h-k]) conj(W_m^k),
//    is twice the h-point spectrum of z[n] = y[2n] + i y[2n+1], so
//    z[n] = (1/m) sum_k Z[k] W_h^(-kn): 1/m is the whole scaling, and z
//    stored as float2 is the interleaved real row. X[h] is the side column
//    (the row's last value unsplit); Im X[0] and Im X[h] are taken as 0.
//    The inverse runs as conj(FFT(conj Z)) through the r2c's Stockham
//    passes (EdgePass) and twiddles.
// 2. A lane group per row, as in the r2c: G = h / P lanes own a row. The
//    first pass (radix P, butterfly q, inputs Z[q + G r]) merges its inputs
//    straight from the staged tile, each lane reading X[k] and X[h - k], so
//    Z never passes through shared memory. Staged rows sit h floats apart,
//    on the same banks, so lane q of the w-th group of a warp reads slot
//    r ^ w at step r (the groups of a warp read disjoint banks) and a few
//    selects put the slots back in order. The last pass hands its outputs
//    n < ceil(n_out / 2) to the staging buffer and drops the rest.
// 3. Persistent blocks and a ring of bulk copies. The host plan
//    (c2r_tile_plan in parallel/cuda_fft.py, checked here) gives T rows a
//    tile (a multiple of 4), the block count and the ring depth S. A full
//    tile's input is one contiguous span each of re and im (T h floats, or
//    T (h + 1) unsplit) and T floats of the side column, three bulk copies
//    counted by the stage's mbarrier, issued S - 1 tiles ahead. The tile's
//    T n_out outputs leave from one of two staging buffers as one bulk
//    store; with T a multiple of 4 every span starts 16-byte aligned and is
//    a multiple of 16 bytes. Twiddles are loaded once a block, the kernel's
//    attributes set once a shape.
// 4. The last tile when it is ragged, and every tile of an input whose
//    pointers are not 16-byte aligned (a view with a storage offset), move
//    through the same stages with ordinary loads (and the ragged tile with
//    ordinary stores).
//
// irfft_pass_merge_velocity (VEL; replaces pallas_fft.py:824
// _irfft_pass_merge_velocity_impl at these lengths) is the same kernel over
// the three components of (3, R, m/2) + (3, R, 1), R = nz ny, with the
// velocity epilogue; the kernel for the other lengths runs a full m-point
// inverse a component, with loads, compute and stores in turn and a block
// reduction and atomicMax every 8 rows. Here:
// 5. A block's units are (row tile, component), the component inner: its
//    it-th unit is component it % 3 of tile blockIdx.x + (it / 3) gridDim.x,
//    so the ring runs on across components and tiles alike. A unit's input
//    is the tile's spans of component c (re and im at c R h + row0 h, the
//    side column at c R + row0), its output the span at c R n_out + row0
//    n_out. Blocks are counted in tiles, each taking its tiles' three units.
// 6. The epilogue sits in the emit sink: the pair (y[2n], y[2n+1]) is
//    masked by the row's wall test (one divide a unit) and by x against 0
//    and n_out - 1, given the free stream, and written to the staging
//    buffer. The lane -> cell map does not depend on c, and the staging
//    buffers alternate by unit, so at c = 2 the buffer of this unit still
//    holds the lane's own cells of c = 0 (its bulk store only reads it) and
//    the other buffer those of c = 1: the lane sums |u_c| there, with no
//    extra shared memory or registers, into a running maximum kept across
//    its tiles. One block reduction and one atomicMax a block, after the
//    walk. Rows past R in a ragged tile do not enter the maximum.
// 7. Bulk copies and stores only when every component's spans are 16-byte
//    aligned (the plan's bulk: the pointers aligned and R a multiple of 4);
//    otherwise ordinary loads and stores.
// ---------------------------------------------------------------------------

// The velocity epilogue's arguments (VEL; unused otherwise).
struct VelocityEpilogue {
  const float* fsv;  // the free stream, (3,)
  float* l1_max;     // a zeroed device float, raised to max sum_c |u_c|
  int ny, nz;        // row = z ny + y
};

// The block's maximum of v (v >= 0 on every thread, blockDim a multiple of
// 32) raised into *out by atomicMax on the float bits. `per_warp` is free
// shared memory for a float a warp; the caller makes no other use of the
// block after.
__device__ __forceinline__ void block_max_atomic(float v, float* per_warp,
                                                 float* out) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((tid & 31) == 0) per_warp[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < nt / 32 ? per_warp[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (tid == 0)
      atomicMax(reinterpret_cast<unsigned int*>(out), __float_as_uint(v));
  }
}

template <int H, bool VEL>
__global__ void __launch_bounds__(kThreads, 2)
    irfft_edge_kernel(const float* __restrict__ br,
                      const float* __restrict__ bi,
                      const float* __restrict__ sr, float* __restrict__ out,
                      const float2* __restrict__ line_g, long long R,
                      int n_out, int T, int stages, int bulk, int unsplit,
                      VelocityEpilogue ve) {
  using S = EdgeShape<H>;
  constexpr int P = S::P, G = S::G, m = 2 * H;
  constexpr int C = VEL ? 3 : 1;  // components: units a tile
  static_assert(P < H, "the last pass is not the first");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* line = reinterpret_cast<float2*>(smem_raw);  // W_m^j, j < h
  float2* tp = line + H;                               // pass tables
  float* ring = reinterpret_cast<float*>(line + S::TW);
  const int ld = unsplit ? H + 1 : H;
  // a stage: re (T x ld), im (T x ld), the side column (T) when split
  const int in_floats = 2 * T * ld + (unsplit ? 0 : T);
  float* outb = ring + (long long)stages * in_floats;  // 2 x (T x n_out)
  float2* work = reinterpret_cast<float2*>(outb + 2 * T * n_out);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(work + T * S::HP);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = tid / G, q = tid % G;
  const int gw = (tid & 31) / G;  // the group's rank in its warp
  float2* buf = work + grp * S::HP;

  load_edge_twiddles<H>(line, tp, line_g);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (R + T - 1) / T;
  // the input of this block's it-th unit (component it % C of its
  // (it / C)-th tile) into stage it % stages
  auto produce = [&](long long it) {
    const long long tile = blockIdx.x + (it / C) * gridDim.x;
    if (tile >= ntiles) return;
    const long long c = it % C;
    float* dst = ring + (it % stages) * in_floats;
    const long long row0 = tile * T;
    const int rows = (int)(R - row0 < T ? R - row0 : T);
    const float* cbr = br + (c * R + row0) * ld;
    const float* cbi = bi + (c * R + row0) * ld;
    const float* csr = sr + c * R + row0;
    if (bulk && rows == T) {
      if (tid == 0) {
        unsigned long long* bar = &bars[it % stages];
        const unsigned bytes = 4u * T * ld;
        bulk_expect(bar, 2 * bytes + (unsplit ? 0u : 4u * T));
        bulk_copy(dst, cbr, bytes, bar);
        bulk_copy(dst + T * ld, cbi, bytes, bar);
        if (!unsplit) bulk_copy(dst + 2 * T * ld, csr, 4u * T, bar);
      }
    } else {
      for (int i = tid; i < rows * ld; i += nt) {
        dst[i] = cbr[i];
        dst[T * ld + i] = cbi[i];
      }
      if (!unsplit)
        for (int i = tid; i < rows; i += nt) dst[2 * T * ld + i] = csr[i];
    }
  };
  for (int s = 0; s < stages - 1; ++s) produce(s);
  __syncthreads();  // the ordinary loads of the prologue

  const int nh = (n_out + 1) >> 1;  // complex outputs of a row
  const bool pairs = (n_out & 1) == 0;
  const float inv_m = 1.0f / (float)m;
  // the stores leave as bulk copies where the spans are aligned: always
  // for one component, by the plan for three
  const bool bulk_out = !VEL || bulk;
  float best = 0.f;  // VEL: the lane's max of sum_c |u_c| so far
  for (long long it = 0; blockIdx.x + (it / C) * gridDim.x < ntiles; ++it) {
    const long long tile = blockIdx.x + (it / C) * gridDim.x;
    const int c = (int)(it % C);
    produce(it + stages - 1);  // into the stage the last unit freed
    const long long row0 = tile * T;
    const int rows = (int)(R - row0 < T ? R - row0 : T);
    if (bulk && rows == T)
      mbar_wait(&bars[it % stages], (unsigned)((it / stages) & 1));
    const float* stage = ring + (it % stages) * in_floats;
    const float* xr = stage + grp * ld;
    const float* xi = stage + T * ld + grp * ld;
    const float xh = unsplit ? xr[H] : stage[2 * T * ld + grp];  // X[h]

    // first pass: radix P, butterfly q, inputs conj Z[q + G r] merged from
    // the staged row; step r reads slot r ^ gw
    {
      float re[P], im[P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int k = q + G * (r ^ gw);
        const float ar = xr[k], ai = k ? xi[k] : 0.f;
        const float cr = k ? xr[H - k] : xh, ci = k ? xi[H - k] : 0.f;
        const float2 w = line[k];
        const float er = ar + cr, ei = ai - ci;  // Xe
        const float dr = ar - cr, di = ai + ci;  // X[k] - conj X[h-k]
        const float odr = dr * w.x + di * w.y, odi = di * w.x - dr * w.y;
        re[r] = er - odi;  // conj(Xe + i Xo)
        im[r] = -(ei + odr);
      }
#pragma unroll
      for (int b = 1; b < 32 / G; b <<= 1) {  // slot r ^ gw back to r
        const bool flip = gw & b;
#pragma unroll
        for (int r = 0; r < P; ++r) {
          if (r & b) continue;
          const float a0 = re[r], a1 = re[r | b], c0 = im[r], c1 = im[r | b];
          re[r] = flip ? a1 : a0;
          re[r | b] = flip ? a0 : a1;
          im[r] = flip ? c1 : c0;
          im[r | b] = flip ? c0 : c1;
        }
      }
      float2 wr[P / 2];
#pragma unroll
      for (int e = 0; e < P / 2; ++e) wr[e] = line[e * (H / P) * 2];
      reg_fft<P, false>(re, im, wr);
      each_output<P>([&](int k, int rr) {
        buf[S::pad(q * P + k)] = make_float2(re[rr], im[rr]);
      });
      __syncwarp();
    }
    // VEL: the unit's wall test (row z ny + y on a z or y wall), its free
    // stream, and whether the lane's row is one of the tile's
    bool wall = false, live = false;
    float add = 0.f;
    if constexpr (VEL) {
      const int row = (int)row0 + grp, z = row / ve.ny, y = row - z * ve.ny;
      wall = z == 0 || z == ve.nz - 1 || y == 0 || y == ve.ny - 1;
      live = grp < rows;
      add = __ldg(ve.fsv + c);
    }
    // the other passes; the last one writes z[n] = conj(F[n]) / m, n < nh,
    // into the staging buffer of this unit (VEL: after the epilogue)
    float* ob = outb + (it & 1) * T * n_out;
    float* orow = ob + grp * n_out;
    EdgePass<H, P>::run(buf, q, line, tp, [&](int n, float fr, float fi) {
      if (n >= nh) return;
      float y0 = fr * inv_m, y1 = -fi * inv_m;
      const bool two = pairs || 2 * n + 1 < n_out;  // y[2n + 1] is a cell
      if constexpr (VEL) {
        y0 = (wall || n == 0 || 2 * n == n_out - 1) ? add : y0 + add;
        y1 = (wall || 2 * n + 1 == n_out - 1) ? add : y1 + add;
        if (c == 2 && live) {
          // this buffer still holds the lane's cells of c = 0, the other
          // one those of c = 1
          const float* u0 = orow;
          const float* u1 = outb + ((it + 1) & 1) * T * n_out + grp * n_out;
          best = fmaxf(best, fabsf(u0[2 * n]) + fabsf(u1[2 * n]) + fabsf(y0));
          if (two)
            best = fmaxf(best, fabsf(u0[2 * n + 1]) + fabsf(u1[2 * n + 1]) +
                                   fabsf(y1));
        }
      }
      if (pairs) {
        reinterpret_cast<float2*>(orow)[n] = make_float2(y0, y1);
      } else {
        orow[2 * n] = y0;
        if (two) orow[2 * n + 1] = y1;
      }
    });
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    float* dst = out + ((long long)c * R + row0) * n_out;
    if (bulk_out && rows == T) {
      if (tid == 0) {
        bulk_store(dst, ob, 4u * T * n_out);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the group before this one has read its buffer, which the next
        // unit writes
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      }
    } else {
      for (int i = tid; i < rows * n_out; i += nt) dst[i] = ob[i];
      // no group was committed: the earlier ones must have read the other
      // buffer before the next unit writes it (VEL: a ragged tile's three
      // units follow bulk ones)
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    __syncthreads();  // the stage and the other staging buffer are free
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  // the work buffers are free: a float a warp for the block's maximum
  if constexpr (VEL)
    block_max_atomic(best, reinterpret_cast<float*>(work), ve.l1_max);
}

// ---------------------------------------------------------------------------
// fft_greens_ifft_pass at m = 64, 128, 256, 512: the z conv, designed for
// Hopper.
//
// Replaces, with fft_greens_ifft_pass_kernel above for m = 1024 and the
// lengths with a factor that is not a power of two,
// sopht_mpi_tpu/parallel/pallas_fft.py:384 _fft_greens_ifft_pass_impl.
// Bound: HBM, 16 B per input element (8 B read, 8 B written) plus the
// Green's spectrum read once: at 256^3, (3, 256, 131072) pairs at m = 512,
// 1.88 GB, 0.56 ms at 3.35 TB/s. FP32 issue is close behind: a column's
// two length-m transforms and the product take ~29k adds and multiplies
// here (radix-2 butterflies, one issue slot each), ~0.4 ms of the card's
// issue rate at 256^3, and every shared-memory access takes a slot too.
// The kernel above keeps two 16-warp blocks on an SM that load, compute
// and store in turn (no load in flight while a block computes) and takes
// every element through shared memory six times. This design:
//
// 1. The same four-step factorisation, m = m1 m2 (16 x 32 at m = 512), in
//    a block of T columns x m1 threads. Thread (c, j) runs the length-m2
//    first factor of n1 = j (the zero-padded half of its input folded away
//    at compile time), then the middle factor of k2 = j + m1 s for each
//    s < m2 / m1 -- forward DFT, Green's product and inverse DFT, all in
//    registers -- then the inverse length-m2 factor of n1 = j, keeping
//    n2 < m2 / 2. Shared memory holds a column's m values after the first
//    factor and after the middle one: four shared-memory passes an element
//    instead of six. (A lane group a column through rfft_edge_kernel's
//    Stockham passes, radix 16, 16, 2 at m = 512, would write each element
//    to shared memory six times and read it five; the four-step split does
//    each transform in two register radices, 32 and 16.) The slot of
//    (k2, n1) in column c is k2 (m1 T + P) + n1 T + c, P = T below T = 16
//    (else 0), so that each phase's accesses fall on distinct banks.
// 2. The radix-2 twiddles of the register FFTs (powers of W_32) are
//    compile-time constants: no shared-memory read for them. The W_m^(n1
//    k2) twiddles between the factors are the host's table, copied into
//    shared memory in rows of m2 + 1 (conflict-free).
// 3. Persistent blocks fed by a two-stage ring of cp.async copies. The
//    host plan (zconv_tile_plan in parallel/cuda_fft.py, checked here)
//    gives the tile (T columns) and the block count (every block
//    resident). A block walks (tile, component) iterations; the input of
//    iteration i + 1 (h x T floats each of re and im) is copied into the
//    other stage while iteration i is transformed, so loads stay in flight
//    through the arithmetic. A tile reads h row segments of 4 T bytes with
//    a stride of 4 B bytes: the longer the segment, the fewer DRAM pages a
//    byte costs (on the H100 at 256^3, device time: 1.23-1.27 ms at
//    32-byte segments, 0.97 at 64; 128-byte ones, loaded as 32 columns and
//    computed as two sub-tiles of 16, took 1.01, their extra sync and
//    registers costing more than the longer segments saved), hence T = 16,
//    and T = 8 only where 16-column tiles would leave SMs without a block.
//    Three or four stages were within 2% of two. The copies are 16 bytes
//    a thread where both input pointers are 16-byte aligned and B is a
//    multiple of 4 (a segment is too small to give each its own bulk copy;
//    cp.async spreads them over every thread and needs no mbarrier), 4
//    bytes otherwise (a view with a storage offset); columns past B are
//    zero-filled by the copy itself. Each thread waits for its own copy
//    groups, then a __syncthreads publishes the stage.
// 4. The Green's tile (m x T floats) is read once a tile into registers
//    (the m2 / m1 x m1 values of a thread's middle-factor work) and shared
//    by the A components; the next tile's Green's values are read after
//    the last component's middle factor.
// 5. The outputs leave from registers by plain stores (fire and forget),
//    32 / T rows of T consecutive floats a warp.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0)
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

// cos(2 pi e / 32) for e <= 8, float64 rounded to float32 (as the host's
// table rounds its twiddles)
__host__ __device__ constexpr float cos32(int e) {
  return e == 0   ? 1.0f
         : e == 1 ? 0x1.f6297cp-1f
         : e == 2 ? 0x1.d906bcp-1f
         : e == 3 ? 0x1.a9b662p-1f
         : e == 4 ? 0x1.6a09e6p-1f
         : e == 5 ? 0x1.1c73b4p-1f
         : e == 6 ? 0x1.87de2ap-2f
         : e == 7 ? 0x1.8f8b84p-3f
                  : 0.0f;
}

// W_32^f = exp(-2 pi i f / 32), f < 16
__host__ __device__ constexpr float w32_re(int f) {
  return f <= 8 ? cos32(f) : -cos32(16 - f);
}
__host__ __device__ constexpr float w32_im(int f) {
  return f <= 8 ? -cos32(8 - f) : -cos32(f - 8);
}

// Radix2 with compile-time twiddles, for N a power of two <= 32. TOP0: the
// input's top half is zero, so the first stage's sums are its inputs.
template <int N, int HALF, bool INV, bool TOP0 = false>
struct Radix2c {
  static __device__ __forceinline__ void stages(float (&re)[N],
                                                float (&im)[N]) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const int j = q % HALF;
      const int a = (q / HALF) * (2 * HALF) + j, b = a + HALF;
      const int f = j * (32 / (2 * HALF));  // W_(2 HALF)^j = W_32^f
      const float tr = TOP0 ? re[a] : re[a] - re[b];
      const float ti = TOP0 ? im[a] : im[a] - im[b];
      if (!TOP0) {
        re[a] += re[b];
        im[a] += im[b];
      }
      if (f == 0) {
        re[b] = tr;
        im[b] = ti;
      } else if (f == 8) {  // W = -i, or +i for the inverse
        re[b] = INV ? -ti : ti;
        im[b] = INV ? tr : -tr;
      } else {
        const float wx = w32_re(f), wy = INV ? -w32_im(f) : w32_im(f);
        re[b] = tr * wx - ti * wy;
        im[b] = tr * wy + ti * wx;
      }
    }
    Radix2c<N, HALF / 2, INV>::stages(re, im);
  }
};

template <int N, bool INV, bool TOP0>
struct Radix2c<N, 0, INV, TOP0> {
  static __device__ __forceinline__ void stages(float (&)[N], float (&)[N]) {}
};

// The sizes of the design at m = M1 M2 with tiles of T columns (host and
// device).
template <int M1, int M2, int T>
struct ZconvShape {
  static constexpr int m = M1 * M2, h = m / 2, H2 = M2 / 2;
  static constexpr int NT = T * M1;   // threads a block
  static constexpr int KS = M2 / M1;  // middle factors a thread
  static constexpr int RS = M1 * T + (T < 16 ? T : 0);  // slots of a k2
  static constexpr int TWP = M2 + 1;                     // twiddle row
  static constexpr int SLOTS = M2 * RS;                  // float2
  static constexpr int STAGE = m * T;  // floats: h rows of re, then of im
  static constexpr int STAGES = 2;
  // threads an SM the plans fill: 256 at m = 512 (<= 255 registers a
  // thread), up to 512 at the shorter lengths (<= 128)
  static constexpr int SM_THREADS = m == 512 ? 256 : 512;
  static constexpr int SMEM = 4 * STAGES * STAGE + 8 * SLOTS + 8 * M1 * TWP;
};

template <int M1, int M2, int T>
__global__ void __launch_bounds__(
    T * M1, ZconvShape<M1, M2, T>::SM_THREADS / (T * M1))
    zconv_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ g, float* __restrict__ out_r,
                 float* __restrict__ out_i, const float2* __restrict__ tw_g,
                 int A, long long B, int bulk) {
  using S = ZconvShape<M1, M2, T>;
  constexpr int h = S::h, H2 = S::H2, NT = S::NT, KS = S::KS, RS = S::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float2* slots = reinterpret_cast<float2*>(ring + S::STAGES * S::STAGE);
  float2* tw = slots + S::SLOTS;
  const int tid = threadIdx.x, c = tid % T, j = tid / T;

  // W_m^(n1 k2), rows of m2 + 1
  for (int i = tid; i < M1 * M2; i += NT)
    tw[(i / M2) * S::TWP + i % M2] = tw_g[i];

  const long long ntiles = (B + T - 1) / T;
  const long long iters =
      (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x * A;

  // the input of this block's it-th (tile, component) into stage it % 2,
  // then one commit (an empty group past the last iteration)
  auto produce = [&](long long it) {
    if (it < iters) {
      const long long tile = blockIdx.x + (it / A) * gridDim.x;
      const long long a = it % A, b0 = tile * T;
      float* st = ring + (it % S::STAGES) * S::STAGE;
      if (bulk) {  // 16 bytes a copy: T / 4 of a row's segment
        constexpr int Q = T / 4;
        for (int o = tid; o < 2 * h * Q; o += NT) {
          const int p = o / (h * Q), r = (o / Q) % h, q = o % Q;
          const long long col = b0 + 4 * q;
          const bool live = col < B;
          const float* src = (p ? xi : xr) + (a * h + r) * B + col;
          cp_async16(st + 4 * o, live ? src : xr, live);
        }
      } else {
        for (int o = tid; o < 2 * h * T; o += NT) {
          const int p = o / (h * T), r = (o / T) % h, q = o % T;
          const long long col = b0 + q;
          const bool live = col < B;
          const float* src = (p ? xi : xr) + (a * h + r) * B + col;
          cp_async4(st + o, live ? src : xr, live);
        }
      }
    }
    cp_async_commit();
  };

  // the Green's values of this thread's middle factors in a tile:
  // gv[s][k1] = g[k2 + m2 k1] at k2 = j + m1 s
  float gv[KS][M1];
  auto load_green = [&](long long tile) {
    const long long b = tile * T + c;
    const bool live = b < B;
    const float* gp = g + (long long)j * B + (live ? b : 0);
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1)
        gv[s][k1] =
            live ? __ldg(gp + (long long)(M1 * s + M2 * k1) * B) : 0.f;
  };

  load_green(blockIdx.x);
  produce(0);
  const float inv_m = 1.0f / (float)S::m;
  // slot (k2, n1) of column c: the first and last factors' n1 = j, the
  // middle factor's k2 = j + m1 s
  float2* slot13 = slots + j * T + c;
  float2* slot2 = slots + j * RS + c;
  const float2* tw1 = tw + j * S::TWP;
  const float2* tw2 = tw + j;

  for (long long it = 0; it < iters; ++it) {
    produce(it + 1);  // into the stage iteration it - 1 read
    cp_async_wait<1>();
    __syncthreads();  // the stage is in; the slots are free
    const long long tile = blockIdx.x + (it / A) * gridDim.x;
    const long long a = it % A, b = tile * T + c;
    {  // first factor of n1 = j
      const float* st = ring + (it % S::STAGES) * S::STAGE + j * T + c;
      float re[M2], im[M2];
#pragma unroll
      for (int n2 = 0; n2 < M2; ++n2) {
        re[n2] = n2 < H2 ? st[n2 * M1 * T] : 0.f;
        im[n2] = n2 < H2 ? st[h * T + n2 * M1 * T] : 0.f;
      }
      Radix2c<M2, M2 / 2, false, true>::stages(re, im);
      each_output<M2>([&](int k2, int r) {
        float2 v = make_float2(re[r], im[r]);
        if (k2 > 0) v = cmul(tw1[k2], v);
        slot13[k2 * RS] = v;
      });
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < KS; ++s) {  // middle factor of k2 = j + m1 s
      float yr[M1], yi[M1], zr[M1], zi[M1];
#pragma unroll
      for (int n1 = 0; n1 < M1; ++n1) {
        const float2 v = slot2[s * M1 * RS + n1 * T];
        yr[n1] = v.x;
        yi[n1] = v.y;
      }
      Radix2c<M1, M1 / 2, false>::stages(yr, yi);
      each_output<M1>([&](int k1, int r) {  // X[k2 + m2 k1] G[k2 + m2 k1]
        zr[k1] = yr[r] * gv[s][k1];
        zi[k1] = yi[r] * gv[s][k1];
      });
      Radix2c<M1, M1 / 2, true>::stages(zr, zi);
      each_output<M1>([&](int n1, int r) {
        float2 v = make_float2(zr[r], zi[r]);
        if (n1 > 0) v = cmul_conj(tw2[n1 * S::TWP + M1 * s], v);
        slot2[s * M1 * RS + n1 * T] = v;
      });
    }
    if (a == A - 1 && tile + gridDim.x < ntiles) load_green(tile + gridDim.x);
    __syncthreads();
    {  // inverse first factor of n1 = j, n2 < m2 / 2 kept
      float re[M2], im[M2];
#pragma unroll
      for (int k2 = 0; k2 < M2; ++k2) {
        const float2 v = slot13[k2 * RS];
        re[k2] = v.x;
        im[k2] = v.y;
      }
      Radix2c<M2, M2 / 2, true>::stages(re, im);
      if (b < B) {
        float* orr = out_r + (a * h + j) * B + b;
        float* oi = out_i + (a * h + j) * B + b;
        each_output<M2, H2>([&](int n2, int r) {
          orr[(long long)n2 * M1 * B] = re[r] * inv_m;
          oi[(long long)n2 * M1 * B] = im[r] * inv_m;
        });
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fft_greens_curl_ifft_pass at m = 64, 128, 256, 512: the fast tier's z
// pass, designed for Hopper on zconv_kernel's plan.
//
// Replaces, with fft_greens_curl_ifft_pass_kernel below for m = 1024 and
// the lengths with a factor that is not a power of two,
// sopht_mpi_tpu/parallel/pallas_fft.py:478 _fft_greens_curl_ifft_pass_impl.
// Bound: HBM, the z conv's bytes plus the symbols: 1.88 GB at 256^3, 0.56
// ms at 3.35 TB/s. The arithmetic is zconv_kernel's, thread (c, j) of a
// block of T columns x m1 threads running the first factor of n1 = j, the
// middle factors of k2 = j + m1 s and the inverse last factor of n1 = j,
// with the same slot layout. What differs: the curl u = i s x (G psi)
// needs the three components' spectra at the same k at once.
// 1. A tile's three components are live together in shared memory, one
//    region of zconv_kernel's slots each, and the regions are the input
//    ring: component a's input of the next tile is copied (cp.async, 16
//    bytes where both pointers are aligned and B % 4 == 0) into region a
//    as soon as this tile's last factor has read region a into registers.
//    The copies run behind the last factors of this tile and the first
//    factors of the next. A ring of its own would not fit: at m = 512 and
//    T = 16 the regions take 192 KB and one stage of one component 32 KB.
// 2. The first factor of component a reads its input from region a into
//    registers; after a sync it writes its slots over that input.
// 3. The middle factor of k2 runs the forward length-m1 DFT of each
//    component in registers, the Green's product, the curl at the
//    thread's own k = k2 + m2 k1 and the three inverse DFTs: no pass over
//    shared memory of its own. At m = 512 it holds 96 floats of spectra.
// 4. The Green's values of a thread's middle factors (m2 / m1 x m1) and
//    its column's sym_yx are read into registers once a tile, after the
//    middle factors; sym_z at the thread's own k once a block. The
//    twiddles go to shared memory once a block.
// 5. The loops over the components in the first and last factors and over
//    a thread's middle factors stay rolled, so the loop body holds one copy
//    of each transform (the middle factor's three components unrolled).
//    Fully unrolled, the m = 512 instance was 10,216 SASS instructions
//    against 5,472 and took 1.71 ms of device time at 256^3 on an H100
//    against 0.98 (tools/probe_edge_passes.py: the first form and the
//    sweep): the loop body most likely outgrew the instruction cache.
// Blocks an SM: one of 256 threads at m = 256 and 512 (up to 255
// registers a thread), up to 512 threads at the shorter lengths.
// ---------------------------------------------------------------------------

// The sizes of the design at m = M1 M2 with tiles of T columns (host and
// device).
template <int M1, int M2, int T>
struct ZcurlShape {
  using Z = ZconvShape<M1, M2, T>;
  static constexpr int m = Z::m, NT = Z::NT, RS = Z::RS, TWP = Z::TWP;
  static constexpr int REGION = M2 * RS;  // float2 a component
  static constexpr int STAGES = 3;        // the regions, as the input ring
  static constexpr int SM_THREADS = m >= 256 ? 256 : 512;
  static constexpr int SMEM = 8 * STAGES * REGION + 8 * M1 * TWP;
};

template <int M1, int M2, int T>
__global__ void __launch_bounds__(
    T * M1, ZcurlShape<M1, M2, T>::SM_THREADS / (T * M1))
    zconv_curl_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi,
                      const float* __restrict__ g,
                      const float* __restrict__ sym_z,
                      const float* __restrict__ sym_yx,
                      float* __restrict__ out_r, float* __restrict__ out_i,
                      const float2* __restrict__ tw_g, long long B,
                      int bulk) {
  using S = ZcurlShape<M1, M2, T>;
  constexpr int h = S::m / 2, H2 = M2 / 2, NT = S::NT, KS = M2 / M1;
  constexpr int RS = S::RS;
  static_assert(KS == 1 || KS == 2, "a thread's middle factors: 1 or 2");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* regions = reinterpret_cast<float2*>(smem_raw);
  float2* tw = regions + 3 * S::REGION;
  const int tid = threadIdx.x, c = tid % T, j = tid / T;

  // W_m^(n1 k2), rows of m2 + 1
  for (int i = tid; i < M1 * M2; i += NT)
    tw[(i / M2) * S::TWP + i % M2] = tw_g[i];

  const long long ntiles = (B + T - 1) / T;
  const long long iters = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // component a of this block's it-th tile into region a (h rows of T
  // floats of re, then of im), then one commit (an empty group past the
  // last tile)
  auto produce = [&](long long it, int a) {
    if (it < iters) {
      const long long b0 = (blockIdx.x + it * gridDim.x) * T;
      float* st = reinterpret_cast<float*>(regions + a * S::REGION);
      if (bulk) {  // 16 bytes a copy: T / 4 of a row's segment
        constexpr int Q = T / 4;
        for (int o = tid; o < 2 * h * Q; o += NT) {
          const int p = o / (h * Q), r = (o / Q) % h, q = o % Q;
          const long long col = b0 + 4 * q;
          const bool live = col < B;
          const float* src = (p ? xi : xr) + ((long long)a * h + r) * B + col;
          cp_async16(st + 4 * o, live ? src : xr, live);
        }
      } else {
        for (int o = tid; o < 2 * h * T; o += NT) {
          const int p = o / (h * T), r = (o / T) % h, q = o % T;
          const long long col = b0 + q;
          const bool live = col < B;
          const float* src = (p ? xi : xr) + ((long long)a * h + r) * B + col;
          cp_async4(st + o, live ? src : xr, live);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's Green's values in a tile, gv[s][k1] = g[k2 + m2 k1] at
  // k2 = j + m1 s, and its column's symbols
  float gv[KS][M1], sy, sx;
  auto load_green = [&](long long tile) {
    const long long b = tile * T + c;
    const bool live = b < B;
    const long long bl = live ? b : 0;
    const float* gp = g + (long long)j * B + bl;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1)
        gv[s][k1] =
            live ? __ldg(gp + (long long)(M1 * s + M2 * k1) * B) : 0.f;
    sy = live ? __ldg(sym_yx + bl) : 0.f;
    sx = live ? __ldg(sym_yx + B + bl) : 0.f;
  };
  float sz[KS][M1];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int k1 = 0; k1 < M1; ++k1) sz[s][k1] = __ldg(sym_z + j + M1 * s + M2 * k1);

  load_green(blockIdx.x);
  produce(0, 0);
  produce(0, 1);
  produce(0, 2);
  const float inv_m = 1.0f / (float)S::m;
  const float2* tw1 = tw + j * S::TWP;
  const float2* tw2 = tw + j;

  for (long long it = 0; it < iters; ++it) {
    const long long tile = blockIdx.x + it * gridDim.x, b = tile * T + c;
#pragma unroll 1
    for (int a = 0; a < 3; ++a) {  // first factor of n1 = j
      if (a == 0) cp_async_wait<2>();
      else if (a == 1) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();  // region a holds its input
      float2* region = regions + a * S::REGION;
      const float* st = reinterpret_cast<const float*>(region) + j * T + c;
      float re[M2], im[M2];
#pragma unroll
      for (int n2 = 0; n2 < M2; ++n2) {
        re[n2] = n2 < H2 ? st[n2 * M1 * T] : 0.f;
        im[n2] = n2 < H2 ? st[h * T + n2 * M1 * T] : 0.f;
      }
      Radix2c<M2, M2 / 2, false, true>::stages(re, im);
      __syncthreads();  // every thread has read the input
      float2* slot13 = region + j * T + c;
      each_output<M2>([&](int k2, int r) {
        float2 v = make_float2(re[r], im[r]);
        if (k2 > 0) v = cmul(tw1[k2], v);
        slot13[k2 * RS] = v;
      });
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < KS; ++s) {  // middle factor of k2 = j + m1 s
      float gs[M1], zs[M1];  // this k2's Green's values and sym_z
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1) {
        gs[k1] = s ? gv[KS - 1][k1] : gv[0][k1];
        zs[k1] = s ? sz[KS - 1][k1] : sz[0][k1];
      }
      float pr[3][M1], pi[3][M1];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float2* slot2 = regions + a * S::REGION + (j + M1 * s) * RS + c;
        float yr[M1], yi[M1];
#pragma unroll
        for (int n1 = 0; n1 < M1; ++n1) {
          const float2 v = slot2[n1 * T];
          yr[n1] = v.x;
          yi[n1] = v.y;
        }
        Radix2c<M1, M1 / 2, false>::stages(yr, yi);
        each_output<M1>([&](int k1, int r) {  // psi = G X at k2 + m2 k1
          pr[a][k1] = yr[r] * gs[k1];
          pi[a][k1] = yi[r] * gs[k1];
        });
      }
      // u = i s x psi, s = (sx, sy, sz[k]): re u = -(s x im psi),
      // im u = s x re psi
      float ur[3][M1], ui[3][M1];
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1) {
        const float z = zs[k1];
        ur[0][k1] = z * pi[1][k1] - sy * pi[2][k1];
        ui[0][k1] = sy * pr[2][k1] - z * pr[1][k1];
        ur[1][k1] = sx * pi[2][k1] - z * pi[0][k1];
        ui[1][k1] = z * pr[0][k1] - sx * pr[2][k1];
        ur[2][k1] = sy * pi[0][k1] - sx * pi[1][k1];
        ui[2][k1] = sx * pr[1][k1] - sy * pr[0][k1];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        Radix2c<M1, M1 / 2, true>::stages(ur[a], ui[a]);
        float2* slot2 = regions + a * S::REGION + (j + M1 * s) * RS + c;
        each_output<M1>([&](int n1, int r) {
          float2 v = make_float2(ur[a][r], ui[a][r]);
          if (n1 > 0) v = cmul_conj(tw2[n1 * S::TWP + M1 * s], v);
          slot2[n1 * T] = v;
        });
      }
    }
    if (it + 1 < iters) load_green(tile + gridDim.x);
    __syncthreads();
#pragma unroll 1
    for (int a = 0; a < 3; ++a) {  // inverse last factor of n1 = j
      const float2* slot13 = regions + a * S::REGION + j * T + c;
      float re[M2], im[M2];
#pragma unroll
      for (int k2 = 0; k2 < M2; ++k2) {
        const float2 v = slot13[k2 * RS];
        re[k2] = v.x;
        im[k2] = v.y;
      }
      __syncthreads();  // region a is read: the next tile's input goes in
      produce(it + 1, a);
      Radix2c<M2, M2 / 2, true>::stages(re, im);
      if (b < B) {
        float* orr = out_r + ((long long)a * h + j) * B + b;
        float* oi = out_i + ((long long)a * h + j) * B + b;
        each_output<M2, H2>([&](int n2, int r) {
          orr[(long long)n2 * M1 * B] = re[r] * inv_m;
          oi[(long long)n2 * M1 * B] = im[r] * inv_m;
        });
      }
    }
  }
}

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, kEdgeBlocks)
    irfft_pass_merge_kernel(const float* __restrict__ br,
                            const float* __restrict__ bi,
                            const float* __restrict__ sr,
                            const float* __restrict__ si,
                            float* __restrict__ out,
                            const float2* __restrict__ table, long long R,
                            int n_out, int m, int m1, int m2, int unsplit) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x, tp = t + 1;
  float2* slots = smem + (m1 * M1 + m2 * H2 + m);
  float2* col = slots + threadIdx.x;
  // k <= m/2 of the Hermitian spectrum, (m/2 + 1) x tp; k > m/2 is read as
  // conj(X[m - k])
  float2* xf = slots + (long long)m * t;
  float* ys = reinterpret_cast<float*>(xf);  // m/2 x tp real outputs
  const int tid = threadIdx.y * t + threadIdx.x;
  const int nt = t * blockDim.y;
  const long long row0 = (long long)blockIdx.x * t;
  const int h = m / 2, h2 = m2 / 2;
  const float inv_m = 1.0f / (float)m;
  // unsplit: the Nyquist column is the last of the row's m/2 + 1 floats
  const int ld = unsplit ? h + 1 : h;
  // several rows in flight per thread
#pragma unroll 4
  for (int r = 0; r < t; ++r) {
    const long long row = row0 + r;
    for (int k = tid; k < ld; k += nt) {
      float2 v = make_float2(0.f, 0.f);
      if (row < R) v = make_float2(br[row * ld + k], bi[row * ld + k]);
      if (k == 0 || k == h) v.y = 0.f;
      xf[k * tp + r] = v;
    }
  }
  if (!unsplit) {
    for (int r = tid; r < t; r += nt) {
      const long long row = row0 + r;
      xf[h * tp + r] = make_float2(row < R ? sr[row] : 0.f, 0.f);
    }
  }
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    float vr[M1], vi[M1];
#pragma unroll
    for (int k1 = 0; k1 < M1; ++k1) {
      float2 v = make_float2(0.f, 0.f);
      const int k = k2 + m2 * k1;
      if (k1 < m1) {
        if (k <= h) {
          v = xf[k * tp + threadIdx.x];
        } else {
          v = xf[(m - k) * tp + threadIdx.x];
          v.y = -v.y;
        }
      }
      vr[k1] = v.x;
      vi[k1] = v.y;
    }
    inverse_first(vr, vi, s, k2, m1, m2, col, t);
  }
  __syncthreads();
  for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
    if (radix2_m2<H2>(m2)) {
      float ar[H2], ai[H2];
      inverse_second(ar, ai, s, col, n1, m1, m2, t);
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2)
        ys[(n1 + m1 * n2) * tp + threadIdx.x] = ar[n2] * inv_m;
      continue;
    }
    // direct sums, real part only: sum_k2 Re(conj(W_m2^(k2 n2)) z)
    float acc[H2];
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) acc[n2] = 0.f;
    for (int k2 = 0; k2 < m2; ++k2) {
      const float2 z = col[(k2 * m1 + n1) * t];
      const float2* w = s.w2 + k2 * H2;
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2)
        acc[n2] = fmaf(w[n2].y, z.y, fmaf(w[n2].x, z.x, acc[n2]));
    }
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2)
      if (n2 < h2) ys[(n1 + m1 * n2) * tp + threadIdx.x] = acc[n2] * inv_m;
  }
  __syncthreads();
  // several rows in flight per thread
#pragma unroll 4
  for (int r = 0; r < t && row0 + r < R; ++r) {
    const long long row = row0 + r;
    for (int n = tid; n < n_out; n += nt) out[row * n_out + n] = ys[n * tp + r];
  }
}

// fft_greens_ifft_pass_kernel over the three components at once, the curl
// mixed in between the Green's multiply and the inverse transform: the
// fast tier's z pass at m = 1024 and the lengths with a factor that is not
// a power of two (zconv_curl_kernel above takes m = 64 ... 512).
template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, 2)
    fft_greens_curl_ifft_pass_kernel(const float* __restrict__ xr,
                                     const float* __restrict__ xi,
                                     const float* __restrict__ g,
                                     const float* __restrict__ sym_z,
                                     const float* __restrict__ sym_yx,
                                     float* __restrict__ out_r,
                                     float* __restrict__ out_i,
                                     const float2* __restrict__ table,
                                     long long B, int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  // component a's slot j of this thread's column: slots[a cs + j t + x]
  float2* slots = smem + (m1 * M1 + m2 * H2 + m);
  const long long cs = (long long)m * t;
  const long long b = (long long)blockIdx.x * t + threadIdx.x;
  const bool live = b < B;
  const int h = m / 2, h2 = m2 / 2;
  const float inv_m = 1.0f / (float)m;
  const float sy = live ? sym_yx[b] : 0.f;
  const float sx = live ? sym_yx[B + b] : 0.f;
  __syncthreads();
  for (int task = threadIdx.y; task < 3 * m1; task += blockDim.y) {
    const int a = task / m1, n1 = task - a * m1;
    float vr[H2], vi[H2];
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) {
      vr[n2] = vi[n2] = 0.f;
      if (live && n2 < h2) {
        const long long i = ((long long)a * h + n1 + (long long)m1 * n2) * B + b;
        vr[n2] = xr[i];
        vi[n2] = xi[i];
      }
    }
    forward_first(vr, vi, s, n1, m1, m2, slots + a * cs + threadIdx.x, t);
  }
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    // forward second factor times the Green's spectrum, per component,
    // back into this thread's own slots (k2 m1 + k1)
    for (int a = 0; a < 3; ++a) {
      float2* col = slots + a * cs + threadIdx.x;
      float yr[M1], yi[M1];
      load_slots(yr, yi, col, k2 * m1, m1, t);
      dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
        const float gv =
            live ? g[(long long)(k2 + m2 * k1) * B + b] : 0.f;
        col[(k2 * m1 + k1) * t] = make_float2(v.x * gv, v.y * gv);
      });
    }
    // u = i s x psi at k = k2 + m2 k1: re(u) = -(s x im psi),
    // im(u) = s x re psi, components (x, y, z)
    for (int k1 = 0; k1 < m1; ++k1) {
      const long long i = (long long)(k2 * m1 + k1) * t + threadIdx.x;
      const float2 p0 = slots[i], p1 = slots[cs + i], p2 = slots[2 * cs + i];
      const float sz = sym_z[k2 + m2 * k1];
      slots[i] = make_float2(sz * p1.y - sy * p2.y, sy * p2.x - sz * p1.x);
      slots[cs + i] =
          make_float2(sx * p2.y - sz * p0.y, sz * p0.x - sx * p2.x);
      slots[2 * cs + i] =
          make_float2(sy * p0.y - sx * p1.y, sx * p1.x - sy * p0.x);
    }
    for (int a = 0; a < 3; ++a) {
      float2* col = slots + a * cs + threadIdx.x;
      float yr[M1], yi[M1];
      load_slots(yr, yi, col, k2 * m1, m1, t);
      inverse_first(yr, yi, s, k2, m1, m2, col, t);
    }
  }
  __syncthreads();
  for (int task = threadIdx.y; task < 3 * m1; task += blockDim.y) {
    const int a = task / m1, n1 = task - a * m1;
    float ar[H2], ai[H2];
    inverse_second(ar, ai, s, slots + a * cs + threadIdx.x, n1, m1, m2, t);
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) {
      if (live && n2 < h2) {
        const long long i = ((long long)a * h + n1 + (long long)m1 * n2) * B + b;
        out_r[i] = ar[n2] * inv_m;
        out_i[i] = ai[n2] * inv_m;
      }
    }
  }
}

// irfft_pass_merge_kernel over the three components of a row tile, with
// the ring / free-stream / max |u|_1 epilogue: the lengths with a factor
// that is not a power of two (irfft_edge_kernel<H, true> takes the others).
template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, kEdgeBlocks)
    irfft_pass_merge_velocity_kernel(const float* __restrict__ br,
                                     const float* __restrict__ bi,
                                     const float* __restrict__ sr,
                                     const float* __restrict__ fsv,
                                     float* __restrict__ out,
                                     float* __restrict__ l1_max,
                                     const float2* __restrict__ table,
                                     long long R, int n_out, int ny, int nz,
                                     int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x, tp = t + 1;
  const int h = m / 2, h2 = m2 / 2;
  float2* slots = smem + (m1 * M1 + m2 * H2 + m);
  float2* col = slots + threadIdx.x;
  float2* xf = slots + (long long)m * t;     // (m/2 + 1) x tp spectrum
  float* ys = reinterpret_cast<float*>(xf);  // m/2 x tp real outputs
  // sum_c |u_c| of each cell of the tile, n_out x tp
  float* l1 = reinterpret_cast<float*>(xf + (long long)(h + 1) * tp);
  const int tid = threadIdx.y * t + threadIdx.x;
  const int nt = t * blockDim.y;
  const long long row0 = (long long)blockIdx.x * t;
  const float inv_m = 1.0f / (float)m;
  for (int c = 0; c < 3; ++c) {
    const float* cbr = br + c * R * h;
    const float* cbi = bi + c * R * h;
    // several rows in flight per thread
#pragma unroll 4
    for (int r = 0; r < t; ++r) {
      const long long row = row0 + r;
      for (int k = tid; k < h; k += nt) {
        float2 v = make_float2(0.f, 0.f);
        if (row < R) v = make_float2(cbr[row * h + k], cbi[row * h + k]);
        if (k == 0) v.y = 0.f;
        xf[k * tp + r] = v;
      }
    }
    for (int r = tid; r < t; r += nt) {
      const long long row = row0 + r;
      xf[h * tp + r] = make_float2(row < R ? sr[c * R + row] : 0.f, 0.f);
    }
    __syncthreads();
    for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
      float vr[M1], vi[M1];
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1) {
        float2 v = make_float2(0.f, 0.f);
        const int k = k2 + m2 * k1;
        if (k1 < m1) {
          if (k <= h) {
            v = xf[k * tp + threadIdx.x];
          } else {
            v = xf[(m - k) * tp + threadIdx.x];
            v.y = -v.y;
          }
        }
        vr[k1] = v.x;
        vi[k1] = v.y;
      }
      inverse_first(vr, vi, s, k2, m1, m2, col, t);
    }
    __syncthreads();
    for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
      if (radix2_m2<H2>(m2)) {
        float ar[H2], ai[H2];
        inverse_second(ar, ai, s, col, n1, m1, m2, t);
#pragma unroll
        for (int n2 = 0; n2 < H2; ++n2)
          ys[(n1 + m1 * n2) * tp + threadIdx.x] = ar[n2] * inv_m;
        continue;
      }
      float acc[H2];
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) acc[n2] = 0.f;
      for (int k2 = 0; k2 < m2; ++k2) {
        const float2 z = col[(k2 * m1 + n1) * t];
        const float2* w = s.w2 + k2 * H2;
#pragma unroll
        for (int n2 = 0; n2 < H2; ++n2)
          acc[n2] = fmaf(w[n2].y, z.y, fmaf(w[n2].x, z.x, acc[n2]));
      }
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2)
        if (n2 < h2) ys[(n1 + m1 * n2) * tp + threadIdx.x] = acc[n2] * inv_m;
    }
    __syncthreads();
    // the epilogue: wall ring zeroed, free stream added, |u_c| summed
    const float add = fsv[c];
    float* cout = out + c * R * n_out;
#pragma unroll 4
    for (int r = 0; r < t && row0 + r < R; ++r) {
      const long long row = row0 + r;
      const long long z = row / ny, y = row - z * ny;
      const bool wall = z == 0 || z == nz - 1 || y == 0 || y == ny - 1;
      for (int n = tid; n < n_out; n += nt) {
        float v = (wall || n == 0 || n == n_out - 1) ? 0.f : ys[n * tp + r];
        v += add;
        cout[row * n_out + n] = v;
        l1[n * tp + r] = c == 0 ? fabsf(v) : l1[n * tp + r] + fabsf(v);
      }
    }
    __syncthreads();  // xf, ys and the slots serve the next component
  }
  float best = 0.f;
  for (int r = 0; r < t && row0 + r < R; ++r)
    for (int n = tid; n < n_out; n += nt) best = fmaxf(best, l1[n * tp + r]);
  // the slots are free
  block_max_atomic(best, reinterpret_cast<float*>(slots), l1_max);
}

// The fused edge passes: the x r2c folded into the y forward pass, and the
// y inverse folded into the x c2r. A slab's bulk spectrum between the two
// transforms (ny x mx/2 complex, 512 KB at 256^3) exceeds an SM's shared
// memory, so neither kernel holds a slab: the x transform of a column tile
// is a dense DFT against the table xw[j] = W_mx^j (mx entries, built by the
// wrapper in float64), and only the y transform is the factored one. The
// dense sums make both kernels FP32-issue bound (2 nx FMA a bulk output
// against ~5 log2 mx for a factored row transform).
//
// The x table sits in shared memory skewed, entry j at j + j / 16: a warp
// reads it at a stride (the column or the cell index), and unskewed every
// stride that is a multiple of 16 would hit one bank.
constexpr int kXChunk = 16;  // x cells of a slab staged at a time
constexpr int kXLd = 20;     // their row pitch in floats (16-byte rows)

__device__ __forceinline__ int skew(int j) { return j + (j >> 4); }

// entries of the skewed table, even so that what follows it in shared
// memory stays 16-byte aligned
__host__ __device__ constexpr int skewed_len(int mx) {
  return (mx + mx / 16 + 2) & ~1;
}

__device__ __forceinline__ void load_x_table(const float2* __restrict__ xw,
                                             float2* xws, int mx, int tid,
                                             int nt) {
  for (int j = tid; j < mx; j += nt) xws[skew(j)] = xw[j];
}

// rfft_fft_pass_fused (the shapes no cluster holds: a length that is not a
// power of two, or slots above 16 blocks' shared memory, as 512 x 512
// slabs): a block owns t bulk kx columns of one slab. The
// slab's rows pass through shared memory kXChunk cells at a time (coalesced
// loads; every column tile re-reads the slab, which stays in L2), and the
// thread (column b, n1) sums the x r2c of its own rows n1 + m1 n2 at kx = b
// straight into the registers the y first factor takes, so the x spectrum
// never exists in memory. Block column 0 also writes the slab's Nyquist
// column sum_n (-1)^n x[n] (its imaginary part is zero).
static_assert(2 * kThreads >= 512, "the Nyquist sum covers 2 rows a thread");

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, 2)
    rfft_fft_pass_fused_kernel(const float* __restrict__ x,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i,
                               float* __restrict__ side_r,
                               float* __restrict__ side_i,
                               const float2* __restrict__ table,
                               const float2* __restrict__ xw, int nx, int mx,
                               int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  float2* xws = smem + (m1 * M1 + m2 * H2 + m);
  float2* slots = xws + skewed_len(mx);
  float2* col = slots + threadIdx.x;
  float* xs = reinterpret_cast<float*>(slots + (long long)m * t);
  const int tid = threadIdx.y * t + threadIdx.x;
  const int nt = t * blockDim.y;
  load_x_table(xw, xws, mx, tid, nt);
  const int B = mx / 2;
  const int b = blockIdx.x * t + threadIdx.x;
  const bool live = b < B;
  const long long a = blockIdx.y;
  const int h = m / 2, h2 = m2 / 2;  // h = ny rows of the slab
  const float* xa = x + a * h * nx;
  // block column 0 sums the Nyquist column from the staged chunks: rows tid
  // and tid + nt (ny <= 512 = 2 nt)
  float side[2] = {0.f, 0.f};
  for (int n1base = 0; n1base < m1; n1base += blockDim.y) {
    const int n1 = n1base + threadIdx.y;
    const bool active = live && n1 < m1;
    float vr[H2], vi[H2];
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2) vr[n2] = vi[n2] = 0.f;
    int idx = 0;  // (b n) mod mx
    for (int n0 = 0; n0 < nx; n0 += kXChunk) {
      const int quads = (nx - n0 < kXChunk ? nx - n0 : kXChunk) / 4;
      __syncthreads();  // the table is loaded, the last chunk consumed
      for (int i = tid; i < h * quads; i += nt) {
        const int row = i / quads, q = i - row * quads;
        *reinterpret_cast<float4*>(xs + row * kXLd + 4 * q) =
            *reinterpret_cast<const float4*>(xa + (long long)row * nx + n0 +
                                             4 * q);
      }
      __syncthreads();
      if (blockIdx.x == 0 && n1base == 0) {
        for (int i = 0; i < 2; ++i) {
          const int y = tid + i * nt;
          if (y < h)
            for (int c = 0; c < 4 * quads; c += 2)
              side[i] += xs[y * kXLd + c] - xs[y * kXLd + c + 1];
        }
      }
      if (!active) continue;
      for (int q = 0; q < quads; ++q) {
        float2 w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = xws[skew(idx)];
          idx += b;
          if (idx >= mx) idx -= mx;
        }
        // no branch in here, so that the loads and the 8 H2 sums schedule
        // as one block: a register row past m2/2 re-reads row n1 and is
        // zeroed after the loop
#pragma unroll
        for (int n2 = 0; n2 < H2; ++n2) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (n2 < h2 ? n1 + m1 * n2 : n1) * kXLd + 4 * q);
          vr[n2] = fmaf(v.x, w[0].x, vr[n2]);
          vi[n2] = fmaf(v.x, w[0].y, vi[n2]);
          vr[n2] = fmaf(v.y, w[1].x, vr[n2]);
          vi[n2] = fmaf(v.y, w[1].y, vi[n2]);
          vr[n2] = fmaf(v.z, w[2].x, vr[n2]);
          vi[n2] = fmaf(v.z, w[2].y, vi[n2]);
          vr[n2] = fmaf(v.w, w[3].x, vr[n2]);
          vi[n2] = fmaf(v.w, w[3].y, vi[n2]);
        }
      }
    }
#pragma unroll
    for (int n2 = 0; n2 < H2; ++n2)
      if (n2 >= h2) vr[n2] = vi[n2] = 0.f;
    if (n1 < m1) forward_first(vr, vi, s, n1, m1, m2, col, t);
  }
  __syncthreads();
  for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
    float yr[M1], yi[M1];
    load_slots(yr, yi, col, k2 * m1, m1, t);
    dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
      if (live) {
        const long long i = (a * m + k2 + (long long)m2 * k1) * B + b;
        out_r[i] = v.x;
        out_i[i] = v.y;
      }
    });
  }
  if (blockIdx.x != 0) return;
  for (int i = 0; i < 2; ++i) {
    const int y = tid + i * nt;
    if (y < h) {
      side_r[a * h + y] = side[i];
      side_i[a * h + y] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// rfft_fft_pass_fused where mx and my are powers of two and a cluster of at
// most 16 blocks holds a slab's slots: the fused forward edge, designed for
// Hopper as a thread-block-cluster kernel (rfft_fft_cluster_kernel).
//
// Replaces, with rfft_fft_pass_fused_kernel above for the other shapes,
// sopht_mpi_tpu/parallel/pallas_fft.py:1272 _rfft_fft_pass_fused_impl
// (kernel _r2c_fwd_kernel, which holds a whole slab in VMEM). Bound: HBM,
// 4 B read a real input and 8 B written a bulk output (at 256^3, 768 slabs
// of 256 x 256 reals into 512 x 256 pairs: 201 MB in, 805 MB out, 0.301 ms
// at 3.35 TB/s); the arithmetic, an r2c a row and an my-point FFT a bulk
// column (~8.8 MFLOP a 256^3 slab), is a third of that at the FP32 rate.
// One SM cannot hold a slab's spectrum (512 KB at 256^3), which is why the
// kernel above sums a dense x DFT for each column tile. A cluster can:
//
// 1. A cluster of C blocks (C = 1, 2, 4, 8 or 16, the last Hopper's
//    non-portable size) owns one slab at a time; the blocks' shared memory
//    together holds its spectrum. Persistent clusters walk the slabs
//    a = cluster + k clusters; every block of a cluster walks the same
//    slabs and meets the same barriers.
// 2. x phase. Block r takes the slab's rows [r ny/C, (r+1) ny/C), one
//    contiguous span moved by one cp.async.bulk (issued during the last
//    slab's y phase), and runs rfft_edge_kernel's r2c on each: a lane
//    group of G = nx / P lanes a row, the packed nx-point complex FFT in
//    Stockham passes, the split step. The split step writes the Nyquist
//    value to sr / si and pushes each bulk X[y, kx] into the block that
//    owns column kx, rank kx / t with t = nx / C columns a block, as a
//    remote st.shared::cluster (a push does not wait for a round trip).
//    The owner keeps its spectrum as rows [y][kx local]: a group's lanes
//    store consecutive columns of one row.
// 3. A cluster barrier (release / acquire) puts the slab's spectrum in
//    place for its owners.
// 4. y phase. Block r transforms its t columns as fft_pass_padded does
//    (four steps, my = m1 m2, threads (column, n1) then (column, k2)), in
//    place: the first factor's thread reads rows n1 + m1 n2 (n2 < m2/2)
//    and writes slots k2 m1 + n1 (k2 < m2), rows of its own residue class,
//    so the slot array is the spectrum buffer extended to my rows. The
//    second factor's lanes run over columns, so each output row's t
//    columns leave as coalesced stores (64 B at 256^3, where t = 16).
// 5. A second cluster barrier, split: a block arrives once its y phase has
//    read its slots and waits only before the next slab's first push, so
//    the next slab's x transforms overlap the peers' y phases. The x
//    phase's work buffers lie in the upper rows of the block's slot
//    buffer, which no peer writes.
// 6. One slot buffer a block: it is twice the spectrum, so a second one
//    does not fit at 256^3; where a second cluster fits an SM, it overlaps
//    the phases instead (two buffers a block ran slower on an H100).
// 7. The host plan (fused_r2c_cluster_plan in parallel/cuda_fft.py,
//    checked here) gives C, threads a block (256 or 512), the clusters
//    launched (at most those the card holds at once) and the shared bytes.
//    Its all-zero plan takes the kernel above, which the launcher accepts
//    only where no cluster holds the slots.
// What sets the pace on an H100 (PERF.md): the y phase as a whole (its
// shared-memory traffic, block barriers, stores and arithmetic; about four
// times its FP32 work, cause not isolated) and the waits at the per-slab
// cluster barriers, not HBM; at 256^3 the plan takes clusters of 16 so
// that two 256-thread blocks share an SM.
// ---------------------------------------------------------------------------

// The shared address of *p in block `rank` of this block's cluster.
__device__ __forceinline__ unsigned cluster_map(const void* p,
                                                unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void cluster_store(unsigned addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
               ::"r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

// Every thread of the cluster arrives (its earlier writes released) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

// ... and waits for all the others (their writes acquired).
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

constexpr int kClusterThreads = 512;

// The shared bytes of rfft_fft_cluster_kernel<HX, M1, H2> at my = p.m: the
// x twiddles, the y tables, the slot buffer (ny t pairs of spectrum, then
// the my - ny = ny rows of slots above it, or the x phase's work buffers
// where those are larger), the staged input rows and the input's barrier.
template <int HX, int M1, int H2>
long long cluster_smem_bytes(const Plan& p, int C, int threads) {
  using S = EdgeShape<HX>;
  const long long ny = p.m / 2, lower = ny * (HX / C);
  const long long work = (long long)(threads / S::G) * S::HP;
  const long long slots = lower + (lower > work ? lower : work);
  return 8LL * (S::TW + p.m1 * M1 + p.m2 * H2 + p.m + slots) +
         4LL * (ny / C) * HX + 8;
}

template <int HX, int M1, int H2>
__global__ void __launch_bounds__(kClusterThreads, 1)
    rfft_fft_cluster_kernel(const float* __restrict__ x,
                            float* __restrict__ out_r,
                            float* __restrict__ out_i,
                            float* __restrict__ side_r,
                            float* __restrict__ side_i,
                            const float2* __restrict__ ytable,
                            const float2* __restrict__ xline, int A, int m,
                            int m1, int m2, int C, int bulk) {
  using S = EdgeShape<HX>;
  constexpr int P = S::P, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* line = reinterpret_cast<float2*>(smem_raw);  // W_mx^j, j < nx
  float2* tp = line + HX;                              // pass tables
  const Twiddles s = load_twiddles<M1, H2>(ytable, line + S::TW, m1, m2, m);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ny = m / 2, h2 = m2 / 2, t = HX / C, rows = ny / C;
  const int groups = nt / G;
  float2* slots = line + S::TW + (m1 * M1 + m2 * H2 + m);
  float2* work = slots + ny * t;  // the x phase's, in the upper rows
  const int lower = ny * t, wk = groups * S::HP;
  float* stage =
      reinterpret_cast<float*>(slots + lower + (lower > wk ? lower : wk));
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(stage + rows * HX);
  const int rank = blockIdx.x % C;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int grp = tid / G, q = tid % G;
  float2* buf = work + grp * S::HP;

  load_edge_twiddles<HX>(line, tp, xline);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's rows of the cluster's it-th slab into the stage
  auto produce = [&](int it) {
    const long long a = cid + (long long)it * ncl;
    if (a >= A) return;
    const float* src = x + (a * ny + (long long)rank * rows) * HX;
    if (bulk) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_load(stage, src, 4u * rows * HX, bar);
      }
    } else {
      for (int i = tid; i < rows * HX; i += nt) stage[i] = src[i];
    }
  };
  produce(0);
  __syncthreads();  // the ordinary loads of the first slab
  // the peers have started (their shared memory may be written) once this
  // phase completes, at the first push
  cluster_arrive();

  const int c = tid & (t - 1), ty = tid / t, trows = nt / t;
  float2* col = slots + c;
  for (int it = 0; cid + (long long)it * ncl < A; ++it) {
    const long long a = cid + (long long)it * ncl;
    if (bulk) mbar_wait(bar, (unsigned)(it & 1));
    for (int r0 = 0; r0 < rows; r0 += groups) {
      const int row = r0 + grp;
      const bool live = row < rows;  // a dead group transforms row 0 unseen
      r2c_row_fft<HX>(stage + (live ? row : 0) * HX, HX, buf, q, line, tp);
      if (r0 == 0) cluster_wait();  // the peers' slots are free
      const int y = rank * rows + row;
      auto push = [&](int kx, float2 v) {
        cluster_store(cluster_map(slots + y * t + (kx & (t - 1)), kx / t), v);
      };
#pragma unroll
      for (int j = 0; j < P / 2; ++j) {
        const int k = q + G * j;
        float2 lo, hi;
        r2c_split<HX>(buf, line, k, lo, hi);
        if (!live) continue;
        push(k, lo);
        if (k > 0) {
          push(HX - k, hi);
        } else {
          side_r[a * ny + y] = hi.x;
          side_i[a * ny + y] = hi.y;
        }
      }
      if (q == 0) {
        float2 lo, hi;
        r2c_split<HX>(buf, line, HX / 2, lo, hi);
        if (live) push(HX / 2, lo);
      }
      __syncwarp();  // the next round's first pass rewrites buf
    }
    cluster_arrive();
    cluster_wait();  // the slab's spectrum is in place
    produce(it + 1);
    // first factor in place: slots k2 m1 + n1 <- rows n1 + m1 n2
    for (int n1 = ty; n1 < m1; n1 += trows) {
      float vr[H2], vi[H2];
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        const float2 v =
            n2 < h2 ? col[(n1 + m1 * n2) * t] : make_float2(0.f, 0.f);
        vr[n2] = v.x;
        vi[n2] = v.y;
      }
      forward_first(vr, vi, s, n1, m1, m2, col, t);
    }
    __syncthreads();
    const long long out0 = a * m * HX + rank * t + c;
    for (int k2 = ty; k2 < m2; k2 += trows) {
      float yr[M1], yi[M1];
      load_slots(yr, yi, col, k2 * m1, m1, t);
      dft_m1<M1, false>(yr, yi, s, m1, [&](int k1, float2 v) {
        const long long i = out0 + (long long)(k2 + m2 * k1) * HX;
        out_r[i] = v.x;
        out_i[i] = v.y;
      });
    }
    __syncthreads();  // the slots and the work buffers above them are free
    if (cid + (long long)(it + 1) * ncl < A) cluster_arrive();
  }
}

// ifft_irfft_pass_fused (the shapes no cluster holds: a length that is not
// a power of two, or a column tile above 16 blocks' shared memory, as
// 512 x 512 slabs): a block owns kBlockRowsC2r output rows x
// kBlockColsC2r cells of one slab, every thread a register tile of
// kRowsC2r rows x kColsC2r cells (lanes over cells, so a warp's stores
// cover whole 128-byte lines), and walks the slab's bulk kx columns a tile
// of t at a time. Per tile: the factored y inverse (as ifft_pass_truncated)
// of the whole column tile, of which the block keeps its own rows, with the
// c2r weights (1 at kx = 0, 2 elsewhere, over mx my; the imaginary part of
// kx = 0 dropped), in shared memory; then every thread adds the tile's terms
// sum_k Re(z[k][y] conj(W_mx^(k n))) to its cells. The sums stay in
// registers over all tiles and start from the Nyquist column's term
// (-1)^n sr / mx, so the output is written once, by plain stores, and the
// order of each sum is fixed. The price is that the ny / kBlockRowsC2r row
// blocks of a slab each repeat its y inverse (from L2).
constexpr int kRowsC2r = 8;
constexpr int kColsC2r = 8;
constexpr int kBlockRowsC2r = (kThreads / 32) * kRowsC2r;
constexpr int kBlockColsC2r = 32 * kColsC2r;

template <int M1, int H2>
__global__ void __launch_bounds__(kThreads, 2)
    ifft_irfft_pass_fused_kernel(const float* __restrict__ br,
                                 const float* __restrict__ bi,
                                 const float* __restrict__ sr,
                                 float* __restrict__ out,
                                 const float2* __restrict__ table,
                                 const float2* __restrict__ xw, int nx, int mx,
                                 int m, int m1, int m2) {
  extern __shared__ float2 smem[];
  const Twiddles s = load_twiddles<M1, H2>(table, smem, m1, m2, m);
  const int t = blockDim.x;
  float2* xws = smem + (m1 * M1 + m2 * H2 + m);
  float2* slots = xws + skewed_len(mx);
  float2* col = slots + threadIdx.x;
  // the block's rows of the y inverse of a column tile, z[k][row], behind
  // the slots, which also serve as t x kBlockColsC2r twiddles
  float2* z = slots + (long long)(m > kBlockColsC2r ? m : kBlockColsC2r) * t;
  const int tid = threadIdx.y * t + threadIdx.x;
  const int nt = t * blockDim.y;
  load_x_table(xw, xws, mx, tid, nt);
  const int B = mx / 2;
  const long long a = blockIdx.z;
  const int h = m / 2, h2 = m2 / 2;  // h = ny rows of the slab
  const float inv_my = 1.0f / (float)m, inv_mx = 1.0f / (float)mx;
  const int lane = tid & 31, warp = tid >> 5;
  const int block_row0 = blockIdx.y * kBlockRowsC2r;
  const int row0 = block_row0 + warp * kRowsC2r;
  const int nb = blockIdx.x * kBlockColsC2r;
  float acc[kRowsC2r][kColsC2r];
#pragma unroll
  for (int q = 0; q < kColsC2r; ++q) {
    const int n = nb + lane + 32 * q;
#pragma unroll
    for (int r = 0; r < kRowsC2r; ++r)
      acc[r][q] = row0 + r < h ? (n & 1 ? -inv_mx : inv_mx) * sr[a * h + row0 + r]
                               : 0.f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < B; c0 += t) {
    const int b = c0 + threadIdx.x;
    const bool live = b < B;
    for (int k2 = threadIdx.y; k2 < m2; k2 += blockDim.y) {
      float vr[M1], vi[M1];
#pragma unroll
      for (int k1 = 0; k1 < M1; ++k1) {
        vr[k1] = vi[k1] = 0.f;
        if (live && k1 < m1) {
          const long long i = (a * m + k2 + (long long)m2 * k1) * B + b;
          vr[k1] = br[i];
          vi[k1] = bi[i];
        }
      }
      inverse_first(vr, vi, s, k2, m1, m2, col, t);
    }
    __syncthreads();
    const float wk = (b == 0 ? 1.0f : 2.0f) * inv_my * inv_mx;
    for (int n1 = threadIdx.y; n1 < m1; n1 += blockDim.y) {
      float ar[H2], ai[H2];
      inverse_second(ar, ai, s, col, n1, m1, m2, t);
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        const int row = n1 + m1 * n2 - block_row0;
        if (n2 < h2 && row >= 0 && row < kBlockRowsC2r)
          z[threadIdx.x * kBlockRowsC2r + row] =
              make_float2(ar[n2] * wk, b == 0 ? 0.f : ai[n2] * wk);
      }
    }
    __syncthreads();
    // the tile's twiddles W_mx^(k n) for the block's cells, laid out by
    // cell in the slots (free until the next tile's y inverse): the sums
    // below then read them without bank conflicts, which the strided reads
    // of the table itself would have (5 wavefronts a load on average)
    const int kt = B - c0 < t ? B - c0 : t;  // live columns of the tile
    for (int i = tid; i < kt * kBlockColsC2r; i += nt) {
      const int j = i / kBlockColsC2r, c = i - j * kBlockColsC2r;
      slots[i] = xws[skew(((c0 + j) * (nb + c)) % mx)];
    }
    __syncthreads();
    for (int j = 0; j < kt; ++j) {
      float2 w[kColsC2r];
#pragma unroll
      for (int q = 0; q < kColsC2r; ++q)
        w[q] = slots[j * kBlockColsC2r + lane + 32 * q];
      // rows in 16-byte pairs; no branch in here, so that the loads and
      // the sums schedule as one block (a row past the slab holds whatever
      // the shared memory did and is never stored)
      const float4* zj = reinterpret_cast<const float4*>(
          z + j * kBlockRowsC2r + warp * kRowsC2r);
#pragma unroll
      for (int r = 0; r < kRowsC2r; r += 2) {
        const float4 v = zj[r / 2];
#pragma unroll
        for (int q = 0; q < kColsC2r; ++q) {
          acc[r][q] = fmaf(v.y, w[q].y, fmaf(v.x, w[q].x, acc[r][q]));
          acc[r + 1][q] = fmaf(v.w, w[q].y, fmaf(v.z, w[q].x, acc[r + 1][q]));
        }
      }
    }
    __syncthreads();  // the slots and z serve the next tile
  }
  float* outa = out + a * h * nx;
#pragma unroll
  for (int q = 0; q < kColsC2r; ++q) {
    const int n = nb + lane + 32 * q;
#pragma unroll
    for (int r = 0; r < kRowsC2r; ++r)
      if (row0 + r < h && n < nx) outa[(long long)(row0 + r) * nx + n] = acc[r][q];
  }
}

// ---------------------------------------------------------------------------
// ifft_irfft_pass_fused where mx and my are powers of two and a cluster of
// at most 16 blocks holds a slab's column tiles and rows: the fused inverse
// edge, designed for Hopper as a thread-block-cluster kernel
// (ifft_irfft_cluster_kernel), rfft_fft_cluster_kernel run backwards.
//
// Replaces, with ifft_irfft_pass_fused_kernel above for the other shapes,
// sopht_mpi_tpu/parallel/pallas_fft.py:1341 _ifft_irfft_pass_fused_impl
// (kernel _inv_c2r_kernel, which holds a whole slab in VMEM). Bound: HBM,
// 8 B read a bulk input, 4 B a side value and 4 B written an output (at
// 256^3, 768 slabs of 512 x 256 pairs into 256 x 256 reals: 805 MB in,
// 201 MB out, 0.30 ms at 3.35 TB/s); the arithmetic, an my-point inverse a
// bulk column and a half-length c2r a row (~9 MFLOP a 256^3 slab), is a
// third of that at the FP32 rate. The kernel above sums a dense x DFT for
// every output cell (~51 GFLOP at 256^3) and repeats each slab's y inverse
// in each of its row blocks. Here:
//
// 1. A cluster of C blocks (C = 1, 2, 4, 8 or 16) owns one slab at a time;
//    persistent clusters walk the slabs a = cluster + k clusters, every
//    block of a cluster meeting the same barriers.
// 2. y phase. Block r owns the bulk columns [r t, (r+1) t), t = nx / C, and
//    brings in their (my, t) tiles of br and bi as two float planes, by
//    16-byte cp.async from every thread (4-byte where the pointers are not
//    16-byte aligned). It runs the y inverse as ifft_pass_truncated does
//    (four steps, my = m1 m2, threads (two neighbouring columns, k2), with
//    8-byte accesses, then (column, n1)) in place: the first factor's
//    thread reads rows k2 + m2 k1 and writes slots k2 + m2 n1, the same
//    rows, so the tile is its own slot array.
//    Each run of m2 rows is followed by a row of padding, so the 32 / t
//    rows a warp covers in either factor fall on distinct banks and every
//    address is a base plus a multiple of one stride.
// 3. Push. The second factor's thread (column c, n1) holds z[y][kx] for
//    y = n1 + m1 n2 < ny, kx = r t + c, and stores each, times 1 / (my mx),
//    straight from registers into the block that owns row y (rank
//    y / (ny / C)) as a remote st.shared::cluster: lanes over consecutive
//    columns, so a warp writes row segments. The owner keeps its rows
//    [y][kx] at the c2r's padded row pitch.
// 4. A cluster barrier (release / acquire) puts the rows in place.
// 5. c2r phase. Each block runs irfft_edge_kernel's c2r on its ny / C rows,
//    a lane group of G = nx / P lanes a row, in place in the row's receive
//    buffer: the merge step in the first pass (the Nyquist value sr / mx
//    read from device memory; si does not enter), the nx-point inverse in
//    Stockham passes, the interleaved reals written to the front of the
//    buffer. A row's nx reals are one contiguous span of out and leave as
//    one cp.async.bulk store, issued by the group's first lane. A warp
//    holds whole rows or none (the plan: ny / C a multiple of the groups a
//    warp holds), so the __syncwarp of the passes never waits for a lane
//    without a row.
// 6. A second cluster barrier, split: a block arrives once its stores have
//    read its receive buffers and waits only before the next slab's first
//    push, so the next slab's first factor overlaps the peers' c2r phases.
// 7. The next slab's tile is copied while this slab's second factor, pushes
//    and c2r phase run: where a column's t <= 32 lanes lie in one warp, the
//    warp issues the copies of run n1 (input rows m2 n1 .. m2 n1 + m2 - 1)
//    as soon as its lanes have read that run's slots; otherwise the block
//    issues them all once the second factor has read the tile.
// 8. The host plan (fused_c2r_cluster_plan in parallel/cuda_fft.py,
//    checked here) gives C, threads a block (256 or 512), the clusters
//    launched (at most those the card holds at once), the shared bytes and
//    the copy width (bulk: 16 bytes). Its all-zero plan takes the kernel
//    above, which the launcher accepts only where no cluster plan fits.
// What sets the pace on an H100 (PERF.md): the c2r phase (about as long
// as the whole unfused c2r kernel), the per-slab cluster barriers and the
// y phase, one after another: the two blocks an SM holds run in step and
// hide little of each other. At 256^3 the plan takes clusters of 16, two
// 256-thread blocks an SM.
// ---------------------------------------------------------------------------

template <int HX, int M1, int H2>
__global__ void __launch_bounds__(kClusterThreads, 1)
    ifft_irfft_cluster_kernel(const float* __restrict__ br,
                              const float* __restrict__ bi,
                              const float* __restrict__ sr,
                              float* __restrict__ out,
                              const float2* __restrict__ ytable,
                              const float2* __restrict__ xline, int A, int m,
                              int m1, int m2, int C, int bulk) {
  using S = EdgeShape<HX>;
  constexpr int P = S::P, G = S::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* line = reinterpret_cast<float2*>(smem_raw);  // W_mx^j, j < nx
  float2* tp = line + HX;                              // pass tables
  const Twiddles s = load_twiddles<M1, H2>(ytable, line + S::TW, m1, m2, m);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ny = m / 2, h2 = m2 / 2, t = HX / C, rows = ny / C;
  const int groups = nt / G;
  // the column tile's planes ((my + m1) x t floats each: a row of padding
  // after each run of m2 rows), then the receive buffers (rows x HP pairs)
  const int plane = (m + m1) * t, run = (m2 + 1) * t;
  float* tr =
      reinterpret_cast<float*>(line + S::TW + (m1 * M1 + m2 * H2 + m));
  float* ti = tr + plane;
  float2* recv = reinterpret_cast<float2*>(ti + plane);
  const int rank = blockIdx.x % C;
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int grp = tid / G, q = tid % G;
  const int c = tid & (t - 1), ty = tid / t, trows = nt / t;
  const int lg_rows = __ffs(rows) - 1;
  const bool by_warp = t <= 32;  // a column's lanes in one warp

  load_edge_twiddles<HX>(line, tp, xline);

  // run n1 (input rows m2 n1 .. m2 n1 + m2 - 1) of this block's column tile
  // of the cluster's it-th slab into the planes, by the t lanes of row ty:
  // lane c copies rows c / (t / width) + width k of the run at column
  // width (c % (t / width))
  auto produce = [&](int it, int n1) {
    const long long a = cid + (long long)it * ncl;
    if (a >= A) return;
    const int width = bulk ? 4 : 1, per_row = t / width;
    const int r = c / per_row, col = width * (c & (per_row - 1));
    const long long g =
        a * m * HX + (long long)rank * t + (long long)(m2 * n1 + r) * HX + col;
    const float* sre = br + g;
    const float* sim = bi + g;
    const int d = n1 * run + r * t + col;
    float* dre = tr + d;
    float* dim = ti + d;
    for (int k = r; k < m2; k += width) {
      if (bulk) {
        cp_async16(dre, sre, true);
        cp_async16(dim, sim, true);
      } else {
        cp_async4(dre, sre, true);
        cp_async4(dim, sim, true);
      }
      dre += width * t;
      dim += width * t;
      sre += (long long)width * HX;
      sim += (long long)width * HX;
    }
  };
  for (int n1 = ty; n1 < m1; n1 += trows) produce(0, n1);
  cp_async_commit();
  // the peers have started (their shared memory may be written) once this
  // phase completes, at the first push
  cluster_arrive();

  const float inv_mx = 1.0f / (float)(2 * HX);
  const float scale = inv_mx / (float)m;  // 1 / (my mx)
  const int kx = rank * t + c;
  for (int it = 0; cid + (long long)it * ncl < A; ++it) {
    const long long a = cid + (long long)it * ncl;
    cp_async_wait<0>();
    __syncthreads();  // the tile (and at it = 0 the twiddles) in place
    // the Nyquist value X[h] of the group's first c2r row, read while the y
    // phase runs
    const long long y0 = a * ny + (long long)rank * rows;
    const float xh0 = grp < rows ? sr[y0 + grp] * inv_mx : 0.f;
    // first factor in place: slots k2 + m2 n1 <- rows k2 + m2 k1, at
    // k2 t + c + k1 (m2 + 1) t; a thread takes two neighbouring columns
    // (8-byte accesses) where their registers fit, m1 = M1 (radix 2)
    if constexpr (M1 <= 16) {
      const int half = t / 2, c2 = 2 * (tid & (half - 1));
      for (int k2 = tid / half; k2 < m2; k2 += nt / half) {
        const int b1 = k2 * t + c2;
        float vr[2][M1], vi[2][M1];
#pragma unroll
        for (int k1 = 0; k1 < M1; ++k1) {
          const float2 r = *reinterpret_cast<const float2*>(tr + b1 + k1 * run);
          const float2 i = *reinterpret_cast<const float2*>(ti + b1 + k1 * run);
          vr[0][k1] = r.x;
          vr[1][k1] = r.y;
          vi[0][k1] = i.x;
          vi[1][k1] = i.y;
        }
        reg_fft<M1, true>(vr[0], vi[0], s.w1 + M1);
        reg_fft<M1, true>(vr[1], vi[1], s.w1 + M1);
        each_output<M1>([&](int n1, int rr) {
          const float2 w = s.tw[n1 * m2 + k2];
          const float2 v0 = cmul_conj(w, make_float2(vr[0][rr], vi[0][rr]));
          const float2 v1 = cmul_conj(w, make_float2(vr[1][rr], vi[1][rr]));
          *reinterpret_cast<float2*>(tr + b1 + n1 * run) = make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(ti + b1 + n1 * run) = make_float2(v0.y, v1.y);
        });
      }
    } else {
      for (int k2 = ty; k2 < m2; k2 += trows) {
        const int b1 = k2 * t + c;
        float vr[M1], vi[M1];
#pragma unroll
        for (int k1 = 0; k1 < M1; ++k1) {
          vr[k1] = tr[b1 + k1 * run];
          vi[k1] = ti[b1 + k1 * run];
        }
        dft_m1<M1, true>(vr, vi, s, m1, [&](int n1, float2 z) {
          const float2 v = cmul_conj(s.tw[n1 * m2 + k2], z);
          tr[b1 + n1 * run] = v.x;
          ti[b1 + n1 * run] = v.y;
        });
      }
    }
    __syncthreads();
    // second factor: slots m2 n1 + k2 (run n1) of column kx into rows
    // y = n1 + m1 n2, pushed to their owners once the peers' receive
    // buffers are free (each warp waits once: its lanes' trip counts agree)
    bool peers_free = false;
    for (int n1 = ty; n1 < m1; n1 += trows) {
      const int b2 = n1 * run + c;
      float ar[H2], ai[H2];
      inverse_second_of(ar, ai, s, m2, [&](int k2) {
        return make_float2(tr[b2 + k2 * t], ti[b2 + k2 * t]);
      });
      if (by_warp) {  // the warp has read run n1: the next slab's into it
        __syncwarp();
        produce(it + 1, n1);
      }
      if (!peers_free) cluster_wait();
      peers_free = true;
#pragma unroll
      for (int n2 = 0; n2 < H2; ++n2) {
        if (n2 >= h2) break;
        const int y = n1 + m1 * n2, owner = y >> lg_rows;
        cluster_store(cluster_map(recv + (y - owner * rows) * S::HP +
                                      S::pad(kx), owner),
                      make_float2(ar[n2] * scale, ai[n2] * scale));
      }
    }
    if (!peers_free) cluster_wait();
    if (!by_warp) {
      __syncthreads();  // the tile has been read
      for (int n1 = ty; n1 < m1; n1 += trows) produce(it + 1, n1);
    }
    cp_async_commit();
    cluster_arrive();
    cluster_wait();  // the slab's rows are in place
    // c2r phase: a lane group a row, in place in its receive buffer
    for (int r0 = 0; r0 < rows; r0 += groups) {
      const int row = r0 + grp;
      if (row >= rows) break;  // whole warps (the plan)
      float2* buf = recv + row * S::HP;
      const long long y = y0 + row;
      const float xh = r0 ? sr[y] * inv_mx : xh0;  // X[h]
      // first pass: radix P, butterfly q, inputs conj Z[q + G r] merged
      // from the row
      float re[P], im[P];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int k = q + G * r;
        const float2 xa = buf[S::pad(k)];
        const float2 xc =
            k ? buf[S::pad((HX - k) & (HX - 1))] : make_float2(xh, 0.f);
        const float ai = k ? xa.y : 0.f;
        const float2 w = line[k];
        const float er = xa.x + xc.x, ei = ai - xc.y;  // Xe
        const float dr = xa.x - xc.x, di = ai + xc.y;  // X[k] - conj X[h-k]
        const float odr = dr * w.x + di * w.y, odi = di * w.x - dr * w.y;
        re[r] = er - odi;  // conj(Xe + i Xo)
        im[r] = -(ei + odr);
      }
      float2 wr[P / 2];
#pragma unroll
      for (int e = 0; e < P / 2; ++e) wr[e] = line[e * (HX / P) * 2];
      reg_fft<P, false>(re, im, wr);
      __syncwarp();  // the group has read its row
      each_output<P>([&](int k, int rr) {
        buf[S::pad(q * P + k)] = make_float2(re[rr], im[rr]);
      });
      __syncwarp();
      // the other passes; the last writes the reals z[n] = conj(F[n]),
      // n < nx / 2, to the front of the buffer
      EdgePass<HX, P>::run(buf, q, line, tp, [&](int n, float fr, float fi) {
        if (n < HX / 2) reinterpret_cast<float2*>(buf)[n] = make_float2(fr, -fi);
      });
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (q == 0) {
        bulk_store(out + y * HX, buf, 4u * HX);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    // the stores have read the receive buffers, which the peers' next
    // pushes write
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    if (cid + (long long)(it + 1) * ncl < A) cluster_arrive();
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Largest tile t in {32, 16, 8, 4} whose shared data fits the budget.
template <class Bytes>
int pick_tile(Bytes bytes) {
  for (int t = 32; t >= 4; t /= 2)
    if (bytes(t) <= kDataBudget) return t;
  return 0;
}

template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int t, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, dim3(t, kThreads / t), smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

inline size_t table_bytes(const Plan& p) {
  return sizeof(float2) * (size_t)p.table_len();
}

struct FftPassPadded {
  template <int M1, int H2>
  static int go(const Plan& p, const float* xr, const float* xi, float* out_r,
                float* out_i, const float* table, int A, long long B,
                cudaStream_t st) {
    const int t = pick_tile([&](int t) { return 8LL * p.m * t; });
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = table_bytes(p) + 8ull * p.m * t;
    const dim3 grid((unsigned)((B + t - 1) / t), (unsigned)A);
    return launch(fft_pass_padded_kernel<M1, H2>, grid, t, smem, st, xr, xi,
                  out_r, out_i, (const float2*)table, B, p.m, p.m1, p.m2);
  }
};

struct IfftPassTruncated {
  template <int M1, int H2>
  static int go(const Plan& p, const float* xr, const float* xi,
                const float* g, int g_shared, float* out_r, float* out_i,
                const float* table, int A, long long B, cudaStream_t st) {
    const int t = pick_tile([&](int t) { return 8LL * p.m * t; });
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = table_bytes(p) + 8ull * p.m * t;
    const dim3 grid((unsigned)((B + t - 1) / t), (unsigned)A);
    return launch(ifft_pass_truncated_kernel<M1, H2>, grid, t, smem, st, xr,
                  xi, g, g_shared, out_r, out_i, (const float2*)table, B, p.m,
                  p.m1, p.m2);
  }
};

// The arguments of the z conv entry point, with the host's plan.
struct ZconvArgs {
  const float *xr, *xi, *g;
  float *out_r, *out_i;
  const float* table;
  int A;
  long long B;
  int T, blocks, stages, smem, bulk, threads;
};

// The four-step kernel (m = 1024 and the lengths with a factor that is not
// a power of two): pick_tile's tile, one a block. The host passes no plan
// for it (every field 0).
struct FftGreensIfftPass {
  template <int M1, int H2>
  static int go(const Plan& p, const ZconvArgs& a, cudaStream_t st) {
    if (a.T || a.blocks || a.stages || a.smem || a.bulk || a.threads)
      return (int)cudaErrorInvalidValue;
    const int t = pick_tile([&](int t) { return 12LL * p.m * t; });
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = table_bytes(p) + 12ull * p.m * t;
    const dim3 grid((unsigned)((a.B + t - 1) / t));
    return launch(fft_greens_ifft_pass_kernel<M1, H2>, grid, t, smem, st,
                  a.xr, a.xi, a.g, a.out_r, a.out_i, (const float2*)a.table,
                  a.A, a.B, p.m, p.m1, p.m2);
  }
};

// The arguments of both x-edge r2c entry points, with the host's plan.
struct EdgeArgs {
  const float* x;
  float *br, *bi, *sr, *si;
  const float* table;
  long long R;
  int n_in, unsplit;
  int T, blocks, stages, smem, bulk, threads;
};

struct RfftPassPaddedSplit {
  template <int M1, int H2>
  static int go(const Plan& p, const EdgeArgs& a, cudaStream_t st);
};

// The arguments of the x-edge c2r entry points (both c2r passes and the
// velocity one), with the host's plan.
struct C2rArgs {
  const float *br, *bi, *sr;
  float* out;
  const float* table;
  long long R;
  int n_out, unsplit;
  int T, blocks, stages, smem, bulk, threads;
  VelocityEpilogue ve;
};

// The kernel of the other passes' plan (lengths with a factor that is not a
// power of two); the plan is that of pick_tile, one tile a block.
struct IrfftPassMerge {
  template <int M1, int H2>
  static int go(const Plan& p, const C2rArgs& a, cudaStream_t st) {
    auto bytes = [&](int t) {
      return 8LL * p.m * t + 8LL * (p.m / 2 + 1) * (t + 1);
    };
    const int t = pick_tile(bytes);
    const long long smem = (long long)table_bytes(p) + bytes(t);
    if (t == 0 || a.T != t || a.blocks != (a.R + t - 1) / t || a.stages != 0 ||
        a.bulk != 0 || a.threads != kThreads || a.smem != smem)
      return (int)cudaErrorInvalidValue;
    return launch(irfft_pass_merge_kernel<M1, H2>, dim3((unsigned)a.blocks), t,
                  (size_t)smem, st, a.br, a.bi, a.sr, (const float*)nullptr,
                  a.out, (const float2*)a.table, a.R, a.n_out, p.m, p.m1,
                  p.m2, a.unsplit);
  }
};

// The arguments of the fast tier's z pass entry point, with the host's
// plan.
struct ZcurlArgs {
  const float *xr, *xi, *g, *sym_z, *sym_yx;
  float *out_r, *out_i;
  const float* table;
  long long B;
  int T, blocks, stages, smem, bulk, threads;
};

// The four-step kernel (m = 1024 and the lengths with a factor that is not
// a power of two): pick_tile's tile, one a block. The host passes no plan
// for it (every field 0).
struct FftGreensCurlIfftPass {
  template <int M1, int H2>
  static int go(const Plan& p, const ZcurlArgs& a, cudaStream_t st) {
    if (a.T || a.blocks || a.stages || a.smem || a.bulk || a.threads)
      return (int)cudaErrorInvalidValue;
    // three components' slots: 24 B per slot
    const int t = pick_tile([&](int t) { return 24LL * p.m * t; });
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = table_bytes(p) + 24ull * p.m * t;
    const dim3 grid((unsigned)((a.B + t - 1) / t));
    return launch(fft_greens_curl_ifft_pass_kernel<M1, H2>, grid, t, smem,
                  st, a.xr, a.xi, a.g, a.sym_z, a.sym_yx, a.out_r, a.out_i,
                  (const float2*)a.table, a.B, p.m, p.m1, p.m2);
  }
};

// The four-step velocity kernel (the lengths with a factor that is not a
// power of two): pick_tile's tile, one a block. The host passes no plan
// for it (every field 0).
struct IrfftPassMergeVelocity {
  template <int M1, int H2>
  static int go(const Plan& p, const C2rArgs& a, cudaStream_t st) {
    if (a.T || a.blocks || a.stages || a.smem || a.bulk || a.threads)
      return (int)cudaErrorInvalidValue;
    auto bytes = [&](int t) {
      return 8LL * p.m * t + 8LL * (p.m / 2 + 1) * (t + 1) +
             4LL * a.n_out * (t + 1);
    };
    const int t = pick_tile(bytes);
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem = table_bytes(p) + (size_t)bytes(t);
    const dim3 grid((unsigned)((a.R + t - 1) / t));
    return launch(irfft_pass_merge_velocity_kernel<M1, H2>, grid, t, smem, st,
                  a.br, a.bi, a.sr, a.ve.fsv, a.out, a.ve.l1_max,
                  (const float2*)a.table, a.R, a.n_out, a.ve.ny, a.ve.nz, p.m,
                  p.m1, p.m2);
  }
};

struct RfftFftPassFused {
  template <int M1, int H2>
  static int go(const Plan& p, const float* x, float* out_r, float* out_i,
                float* side_r, float* side_i, const float* table,
                const float* xw, int A, int nx, int mx, cudaStream_t st) {
    // slots (m x t) plus the staged chunk of the slab's rows; the x table
    // rides beside the y twiddles, off the budget
    auto bytes = [&](int t) { return 8LL * p.m * t + 4LL * (p.m / 2) * kXLd; };
    const int t = pick_tile(bytes);
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem =
        table_bytes(p) + (size_t)bytes(t) + 8ull * skewed_len(mx);
    const dim3 grid((unsigned)((mx / 2 + t - 1) / t), (unsigned)A);
    return launch(rfft_fft_pass_fused_kernel<M1, H2>, grid, t, smem, st, x,
                  out_r, out_i, side_r, side_i, (const float2*)table,
                  (const float2*)xw, nx, mx, p.m, p.m1, p.m2);
  }
};

struct IfftIrfftPassFused {
  template <int M1, int H2>
  static int go(const Plan& p, const float* br, const float* bi,
                const float* sr, float* out, const float* table,
                const float* xw, int A, int nx, int mx, cudaStream_t st) {
    // slots (m x t, which also hold the tile's t x kBlockColsC2r twiddles)
    // plus the block's rows of a column tile's y inverse
    auto bytes = [&](int t) {
      const long long slots = p.m > kBlockColsC2r ? p.m : kBlockColsC2r;
      return 8LL * slots * t + 8LL * kBlockRowsC2r * t;
    };
    const int t = pick_tile(bytes);
    if (t == 0) return (int)cudaErrorInvalidValue;
    const size_t smem =
        table_bytes(p) + (size_t)bytes(t) + 8ull * skewed_len(mx);
    const dim3 grid((unsigned)((nx + kBlockColsC2r - 1) / kBlockColsC2r),
                    (unsigned)((p.m / 2 + kBlockRowsC2r - 1) / kBlockRowsC2r),
                    (unsigned)A);
    return launch(ifft_irfft_pass_fused_kernel<M1, H2>, grid, t, smem, st, br,
                  bi, sr, out, (const float2*)table, (const float2*)xw, nx,
                  mx, p.m, p.m1, p.m2);
  }
};

// Instantiate the kernel for the plan's register classes.
template <class Run, class... Args>
int dispatch(const Plan& p, Args... args) {
  switch (p.m1c * 100 + p.h2c) {
    case 808: return Run::template go<8, 8>(p, args...);
    case 816: return Run::template go<8, 16>(p, args...);
    case 824: return Run::template go<8, 24>(p, args...);
    case 1608: return Run::template go<16, 8>(p, args...);
    case 1616: return Run::template go<16, 16>(p, args...);
    case 1624: return Run::template go<16, 24>(p, args...);
    case 3208: return Run::template go<32, 8>(p, args...);
    case 3216: return Run::template go<32, 16>(p, args...);
    case 3224: return Run::template go<32, 24>(p, args...);
  }
  return (int)cudaErrorInvalidValue;
}


// The kernel of the other passes' plan (lengths with a factor that is not a
// power of two); the plan is that of pick_tile, one tile a block.
template <int M1, int H2>
int RfftPassPaddedSplit::go(const Plan& p, const EdgeArgs& a,
                            cudaStream_t st) {
  const long long h = p.m / 2;
  auto bytes = [&](int t) {
    const long long stage = 8LL * (h + 1) * (t + 1);
    const long long in = 4LL * a.n_in * (t + 1);
    return 8LL * p.m * t + (stage > in ? stage : in);
  };
  const int t = pick_tile(bytes);
  const long long smem = (long long)table_bytes(p) + bytes(t);
  if (t == 0 || a.T != t || a.blocks != (a.R + t - 1) / t || a.stages != 0 ||
      a.bulk != 0 || a.threads != kThreads || a.smem != smem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.blocks);
  return launch(rfft_pass_padded_split_kernel<M1, H2>, grid, t, (size_t)smem,
                st, a.x, a.br, a.bi, a.sr, a.si, (const float2*)a.table, a.R,
                a.n_in, p.m, p.m1, p.m2, a.unsplit);
}

// The plan of rfft_edge_kernel<H> as edge_tile_plan computes it, checked
// against what the kernel assumes; 0 when it holds.
template <int H>
long long edge_smem_bytes(int T, int n_in, int stages, int unsplit) {
  using S = EdgeShape<H>;
  const long long ld = unsplit ? H + 1 : H;
  const long long out = 2LL * T * ld + (unsplit ? 0 : 2LL * T);
  return 8LL * S::TW + 4LL * stages * T * n_in + 8 * out + 8LL * T * S::HP +
         8LL * stages;
}

// The attributes and the residency of a persistent kernel's block shape,
// kept per device: set up once a shape (shared bytes, threads), not once a
// call.
struct ShapeCache {
  int dev = -1, smem = -1, threads = -1, sms = 0, per_sm = 0;
};

// 0 and the blocks the card holds at once in *resident, or a CUDA error.
template <class Kernel>
int resident_blocks(Kernel kernel, int smem, int threads, ShapeCache& c,
                    long long* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != c.dev || smem != c.smem || threads != c.threads) {
    c.dev = -1;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c.per_sm, kernel, threads, smem)) != cudaSuccess)
      return (int)err;
    c.dev = dev;
    c.smem = smem;
    c.threads = threads;
  }
  *resident = (long long)c.per_sm * c.sms;
  return 0;
}

template <int H>
int launch_edge(const Plan& p, const EdgeArgs& a, cudaStream_t st) {
  using S = EdgeShape<H>;
  const long long tiles = (a.R + a.T - 1) / a.T;
  const bool aligned =
      ((unsigned long long)a.br | (unsigned long long)a.bi |
       (a.unsplit ? 0ULL : (unsigned long long)a.sr | (unsigned long long)a.si)) %
          16 == 0;
  if (a.T < 4 || a.T % 4 != 0 || a.threads != a.T * S::G ||
      a.threads > kThreads || a.threads % 32 != 0 || a.blocks < 1 ||
      a.blocks > tiles || a.stages < 2 || a.stages > 4 || !aligned ||
      (a.bulk && (unsigned long long)a.x % 16 != 0) ||
      a.smem != edge_smem_bytes<H>(a.T, a.n_in, a.stages, a.unsplit) ||
      a.smem > 232448)
    return (int)cudaErrorInvalidValue;
  auto kernel = rfft_edge_kernel<H>;
  static ShapeCache cache;
  long long resident = 0;
  if (const int err = resident_blocks(kernel, a.smem, a.threads, cache,
                                      &resident))
    return err;
  // persistent blocks: every planned block must be resident at once
  if (a.blocks > resident) return (int)cudaErrorInvalidValue;
  const float2* line = (const float2*)a.table + p.table_len();
  kernel<<<a.blocks, a.threads, a.smem, st>>>(a.x, a.br, a.bi, a.sr, a.si,
                                              line, a.R, a.n_in, a.T,
                                              a.stages, a.bulk, a.unsplit);
  return (int)cudaGetLastError();
}

// The plan of irfft_edge_kernel<H> as c2r_tile_plan computes it, checked
// against what the kernel assumes.
template <int H>
long long c2r_smem_bytes(int T, int n_out, int stages, int unsplit) {
  using S = EdgeShape<H>;
  const long long ld = unsplit ? H + 1 : H;
  const long long in = 2LL * T * ld + (unsplit ? 0 : T);
  return 8LL * S::TW + 4LL * stages * in + 8LL * T * n_out +
         8LL * T * S::HP + 8LL * stages;
}

// VEL: the three components' units, every span aligned for bulk copies
// only where R is a multiple of 4.
template <int H, bool VEL>
int launch_c2r(const Plan& p, const C2rArgs& a, cudaStream_t st) {
  using S = EdgeShape<H>;
  if (a.T < 4 || a.T % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (a.R + a.T - 1) / a.T;
  const bool in_aligned =
      ((unsigned long long)a.br | (unsigned long long)a.bi |
       (a.unsplit ? 0ULL : (unsigned long long)a.sr)) % 16 == 0 &&
      (!VEL || a.R % 4 == 0);
  if ((VEL && a.unsplit) || a.threads != a.T * S::G || a.threads > kThreads ||
      a.threads % 32 != 0 || a.blocks < 1 || a.blocks > tiles ||
      a.stages < 2 || a.stages > 4 || (unsigned long long)a.out % 16 != 0 ||
      (a.bulk && !in_aligned) ||
      a.smem != c2r_smem_bytes<H>(a.T, a.n_out, a.stages, a.unsplit) ||
      a.smem > 232448)
    return (int)cudaErrorInvalidValue;
  auto kernel = irfft_edge_kernel<H, VEL>;
  static ShapeCache cache;
  long long resident = 0;
  if (const int err = resident_blocks(kernel, a.smem, a.threads, cache,
                                      &resident))
    return err;
  // persistent blocks: every planned block must be resident at once
  if (a.blocks > resident) return (int)cudaErrorInvalidValue;
  const float2* line = (const float2*)a.table + p.table_len();
  kernel<<<a.blocks, a.threads, a.smem, st>>>(a.br, a.bi, a.sr, a.out, line,
                                              a.R, a.n_out, a.T, a.stages,
                                              a.bulk, a.unsplit, a.ve);
  return (int)cudaGetLastError();
}

// The plan of zconv_kernel<M1, M2, T> as zconv_tile_plan computes it,
// checked against what the kernel assumes, then the launch.
template <int M1, int M2, int T>
int launch_zconv(const Plan& p, const ZconvArgs& a, cudaStream_t st) {
  using S = ZconvShape<M1, M2, T>;
  const long long tiles = (a.B + T - 1) / T;
  const bool aligned =
      ((unsigned long long)a.xr | (unsigned long long)a.xi) % 16 == 0 &&
      a.B % 4 == 0;
  if (p.m1 != M1 || p.m2 != M2 || a.threads != S::NT || a.blocks < 1 ||
      a.blocks > tiles || a.stages != S::STAGES || (a.bulk && !aligned) ||
      a.smem != S::SMEM)
    return (int)cudaErrorInvalidValue;
  auto kernel = zconv_kernel<M1, M2, T>;
  // the attributes and the residency, kept per device (one set-up an
  // instance, not one a call)
  static int set_dev = -1, sms = 0, per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != set_dev) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, S::NT, S::SMEM)) != cudaSuccess)
      return (int)err;
    set_dev = dev;
  }
  // persistent blocks: every planned block must be resident at once
  if ((long long)a.blocks > (long long)per_sm * sms)
    return (int)cudaErrorInvalidValue;
  const float2* tw = (const float2*)a.table + (p.m1 * p.m1c + p.m2 * p.h2c);
  kernel<<<a.blocks, S::NT, S::SMEM, st>>>(a.xr, a.xi, a.g, a.out_r,
                                           a.out_i, tw, a.A, a.B, a.bulk);
  return (int)cudaGetLastError();
}

// The plan of zconv_curl_kernel<M1, M2, T> as zconv_curl_tile_plan
// computes it, checked against what the kernel assumes, then the launch.
template <int M1, int M2, int T>
int launch_zconv_curl(const Plan& p, const ZcurlArgs& a, cudaStream_t st) {
  using S = ZcurlShape<M1, M2, T>;
  const long long tiles = (a.B + T - 1) / T;
  const bool aligned =
      ((unsigned long long)a.xr | (unsigned long long)a.xi) % 16 == 0 &&
      a.B % 4 == 0;
  if (p.m1 != M1 || p.m2 != M2 || a.threads != S::NT || a.blocks < 1 ||
      a.blocks > tiles || a.stages != S::STAGES || (a.bulk && !aligned) ||
      a.smem != S::SMEM)
    return (int)cudaErrorInvalidValue;
  auto kernel = zconv_curl_kernel<M1, M2, T>;
  // the attributes and the residency, kept per device
  static ShapeCache cache;
  long long resident = 0;
  if (const int err = resident_blocks(kernel, S::SMEM, S::NT, cache,
                                      &resident))
    return err;
  // persistent blocks: every planned block must be resident at once
  if (a.blocks > resident) return (int)cudaErrorInvalidValue;
  const float2* tw = (const float2*)a.table + (p.m1 * p.m1c + p.m2 * p.h2c);
  kernel<<<a.blocks, S::NT, S::SMEM, st>>>(a.xr, a.xi, a.g, a.sym_z,
                                           a.sym_yx, a.out_r, a.out_i, tw,
                                           a.B, a.bulk);
  return (int)cudaGetLastError();
}

// The instance of the plan's tile (zconv_tile_plan's ZCONV_COLUMNS).
template <int M1, int M2>
int zconv_by_columns(const Plan& p, const ZconvArgs& a, cudaStream_t st) {
  switch (a.T) {
    case 8: return launch_zconv<M1, M2, 8>(p, a, st);
    case 16: return launch_zconv<M1, M2, 16>(p, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The z conv entry point: the design above at m = 64 ... 512, with the
// plan zconv_tile_plan gives; the four-step kernel otherwise, with none.
int fft_greens_ifft(const Plan& p, const ZconvArgs& a, cudaStream_t st) {
  switch (p.m) {
    case 64: return zconv_by_columns<8, 8>(p, a, st);
    case 128: return zconv_by_columns<8, 16>(p, a, st);
    case 256: return zconv_by_columns<16, 16>(p, a, st);
    case 512: return zconv_by_columns<16, 32>(p, a, st);
  }
  return dispatch<FftGreensIfftPass>(p, a, st);
}

template <int M1, int M2>
int zconv_curl_by_columns(const Plan& p, const ZcurlArgs& a,
                          cudaStream_t st) {
  switch (a.T) {
    case 8: return launch_zconv_curl<M1, M2, 8>(p, a, st);
    case 16: return launch_zconv_curl<M1, M2, 16>(p, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The fast tier's z pass entry point: the ring design above at
// m = 64 ... 512, with the plan zconv_curl_tile_plan gives; the four-step
// kernel otherwise, with none.
int fft_greens_curl_ifft(const Plan& p, const ZcurlArgs& a,
                         cudaStream_t st) {
  switch (p.m) {
    case 64: return zconv_curl_by_columns<8, 8>(p, a, st);
    case 128: return zconv_curl_by_columns<8, 16>(p, a, st);
    case 256: return zconv_curl_by_columns<16, 16>(p, a, st);
    case 512: return zconv_curl_by_columns<16, 32>(p, a, st);
  }
  return dispatch<FftGreensCurlIfftPass>(p, a, st);
}

// Both x-edge r2c entry points: the design above at power-of-two lengths,
// the kernel of the other passes' four-step plan otherwise; either way the
// plan must be the one edge_tile_plan gives.
int rfft_edge(const Plan& p, const EdgeArgs& a, cudaStream_t st) {
  switch (p.m) {
    case 64: return launch_edge<32>(p, a, st);
    case 128: return launch_edge<64>(p, a, st);
    case 256: return launch_edge<128>(p, a, st);
    case 512: return launch_edge<256>(p, a, st);
    case 1024: return launch_edge<512>(p, a, st);
  }
  return dispatch<RfftPassPaddedSplit>(p, a, st);
}

// The x-edge c2r entry points: the design above at power-of-two lengths,
// the four-step kernels otherwise; either way the plan must be the one
// c2r_tile_plan (VEL: c2r_velocity_tile_plan) gives.
template <bool VEL>
int irfft_edge(const Plan& p, const C2rArgs& a, cudaStream_t st) {
  switch (p.m) {
    case 64: return launch_c2r<32, VEL>(p, a, st);
    case 128: return launch_c2r<64, VEL>(p, a, st);
    case 256: return launch_c2r<128, VEL>(p, a, st);
    case 512: return launch_c2r<256, VEL>(p, a, st);
    case 1024: return launch_c2r<512, VEL>(p, a, st);
  }
  if (VEL) return dispatch<IrfftPassMergeVelocity>(p, a, st);
  return dispatch<IrfftPassMerge>(p, a, st);
}

// The arguments of the fused forward pass's cluster kernel, with the host's
// plan (fused_r2c_cluster_plan): cluster size C, threads a block, clusters
// launched, shared bytes, bulk input copies.
struct ClusterArgs {
  const float* x;
  float *out_r, *out_i, *side_r, *side_i;
  const float *table, *xline;
  int A, C, threads, clusters, smem, bulk;
};

// The arguments of the fused inverse pass's cluster kernel, with the host's
// plan (fused_c2r_cluster_plan): cluster size C, threads a block, clusters
// launched, shared bytes, 16-byte tile copies.
struct C2rClusterArgs {
  const float *br, *bi, *sr;
  float* out;
  const float *table, *xline;
  int A, C, threads, clusters, smem, bulk;
};

// The shared bytes of ifft_irfft_cluster_kernel<HX, M1, H2> at my = p.m:
// the x twiddles, the y tables, the column tile's two planes ((my + m1) x t
// floats each) and the receive buffers (ny / C rows of HP pairs).
template <int HX, int M1, int H2>
long long c2r_cluster_smem_bytes(const Plan& p, int C) {
  using S = EdgeShape<HX>;
  return 8LL * (S::TW + p.m1 * M1 + p.m2 * H2 + p.m) +
         8LL * (p.m + p.m1) * (HX / C) + 8LL * (p.m / 2 / C) * S::HP;
}

// The forward (INV false) or inverse cluster kernel at (nx, my) = (HX,
// p.m), its shared bytes under (C, threads), and whether (C, threads, smem)
// is one of its plans: t = nx / C columns a block dividing the threads;
// the inverse also takes t >= 4 (16-byte copies of a tile row) and whole
// warps of c2r rows (ny / C a multiple of the lane groups a warp holds).
template <bool INV, int HX, int M1, int H2>
auto cluster_kernel() {
  if constexpr (INV)
    return ifft_irfft_cluster_kernel<HX, M1, H2>;
  else
    return rfft_fft_cluster_kernel<HX, M1, H2>;
}

template <bool INV, int HX, int M1, int H2>
long long cluster_smem(const Plan& p, int C, int threads) {
  if constexpr (INV) return c2r_cluster_smem_bytes<HX, M1, H2>(p, C);
  return cluster_smem_bytes<HX, M1, H2>(p, C, threads);
}

template <bool INV, int HX, int M1, int H2>
bool cluster_plan_ok(const Plan& p, int C, int threads, long long smem) {
  constexpr int G = EdgeShape<HX>::G;
  const int t = HX / C, rows = p.m / 2 / C;
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) &&
         (threads == 256 || threads == kClusterThreads) &&
         threads % t == 0 &&
         (!INV || (t >= 4 && (G >= 32 || rows % (32 / G) == 0))) &&
         smem == cluster_smem<INV, HX, M1, H2>(p, C, threads) &&
         smem <= 232448;
}

// The clusters of one plan the card holds at once, kept per device: set up
// once a plan, not once a call.
struct ClusterCache {
  int dev = -1, C = -1, threads = -1, smem = -1, most = 0;
};

template <class Kernel>
int cluster_capacity(Kernel kernel, int C, int threads, int smem,
                     ClusterCache& c, int* most) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != c.dev || C != c.C || threads != c.threads || smem != c.smem) {
    c.dev = -1;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return (int)err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if ((err = cudaOccupancyMaxActiveClusters(&c.most, kernel, &cfg)) !=
        cudaSuccess)
      return (int)err;
    c.dev = dev;
    c.C = C;
    c.threads = threads;
    c.smem = smem;
  }
  *most = c.most;
  return 0;
}

// 1 where some plan of the cluster kernel fits the shape, else 0.
template <bool INV>
struct ClusterHolds {
  template <int HX, int M1, int H2>
  static int go(const Plan& p) {
    for (int C = 1; C <= 16; C *= 2)
      for (int threads = 256; threads <= kClusterThreads; threads *= 2)
        if (cluster_plan_ok<INV, HX, M1, H2>(
                p, C, threads, cluster_smem<INV, HX, M1, H2>(p, C, threads)))
          return 1;
    return 0;
  }
};

// 0 and the clusters the card holds at once in *most, or a CUDA error.
template <bool INV>
struct ClusterCapacity {
  template <int HX, int M1, int H2>
  static int go(const Plan& p, int C, int threads, int smem, int* most) {
    if (!cluster_plan_ok<INV, HX, M1, H2>(p, C, threads, smem))
      return (int)cudaErrorInvalidValue;
    static ClusterCache cache;
    return cluster_capacity(cluster_kernel<INV, HX, M1, H2>(), C, threads,
                            smem, cache, most);
  }
};

// The launch of `clusters` clusters of C blocks of a cluster kernel whose
// plan has been checked, every one resident at once.
template <class Kernel, class... Args>
int launch_clusters(Kernel kernel, int C, int threads, int clusters,
                    int smem, ClusterCache& cache, cudaStream_t st,
                    Args... args) {
  int most = 0;
  if (const int err = cluster_capacity(kernel, C, threads, smem, cache, &most))
    return err;
  if (clusters > most) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The forward pass's plan checked against what the kernel assumes, then the
// launch.
struct ClusterLaunch {
  template <int HX, int M1, int H2>
  static int go(const Plan& p, const ClusterArgs& a, cudaStream_t st) {
    if (!cluster_plan_ok<false, HX, M1, H2>(p, a.C, a.threads, a.smem) ||
        a.clusters < 1 || a.clusters > a.A ||
        (a.bulk && (unsigned long long)a.x % 16 != 0))
      return (int)cudaErrorInvalidValue;
    static ClusterCache cache;
    return launch_clusters(
        rfft_fft_cluster_kernel<HX, M1, H2>, a.C, a.threads, a.clusters,
        a.smem, cache, st, a.x, a.out_r, a.out_i, a.side_r, a.side_i,
        (const float2*)a.table, (const float2*)a.xline, a.A, p.m, p.m1, p.m2,
        a.C, a.bulk);
  }
};

// The inverse pass's plan checked against what the kernel assumes (the
// rows' bulk stores need out 16-byte aligned), then the launch.
struct C2rClusterLaunch {
  template <int HX, int M1, int H2>
  static int go(const Plan& p, const C2rClusterArgs& a, cudaStream_t st) {
    if (!cluster_plan_ok<true, HX, M1, H2>(p, a.C, a.threads, a.smem) ||
        a.clusters < 1 || a.clusters > a.A ||
        (unsigned long long)a.out % 16 != 0 ||
        (a.bulk &&
         ((unsigned long long)a.br | (unsigned long long)a.bi) % 16 != 0))
      return (int)cudaErrorInvalidValue;
    static ClusterCache cache;
    return launch_clusters(
        ifft_irfft_cluster_kernel<HX, M1, H2>, a.C, a.threads, a.clusters,
        a.smem, cache, st, a.br, a.bi, a.sr, a.out, (const float2*)a.table,
        (const float2*)a.xline, a.A, p.m, p.m1, p.m2, a.C, a.bulk);
  }
};

// Run::go<nx, M1, H2> at my = p.m's register classes, instantiated where a
// cluster of 16 can hold the slots (my nx <= 256 Ki: the slots are 8 my nx
// bytes); -1 where no instance exists.
template <class Run, int HX, class... Args>
int cluster_dispatch_y(const Plan& p, Args... args) {
  switch (p.m1c * 100 + p.h2c) {
    case 808: return Run::template go<HX, 8, 8>(p, args...);  // my = 64, 128
    case 1608: return Run::template go<HX, 16, 8>(p, args...);  // 256
    case 1616: return Run::template go<HX, 16, 16>(p, args...);  // 512
    case 3216:  // 1024
      if constexpr (HX <= 256) return Run::template go<HX, 32, 16>(p, args...);
      break;
  }
  return -1;
}

template <class Run, class... Args>
int cluster_dispatch(const Plan& p, int nx, Args... args) {
  if (!is_pow2(p.m)) return -1;
  switch (nx) {
    case 32: return cluster_dispatch_y<Run, 32>(p, args...);
    case 64: return cluster_dispatch_y<Run, 64>(p, args...);
    case 128: return cluster_dispatch_y<Run, 128>(p, args...);
    case 256: return cluster_dispatch_y<Run, 256>(p, args...);
    case 512: return cluster_dispatch_y<Run, 512>(p, args...);
  }
  return -1;
}

}  // namespace

// Number of floats of the twiddle table for length m (0: unsupported).
extern "C" int sopht_fft_table_floats(int m) {
  Plan p;
  return make_plan(m, &p) ? 2 * p.full_len() : 0;
}

// Fill the host buffer `out` (sopht_fft_table_floats(m) floats) with the
// twiddle table of length m, computed in float64 and rounded to float32.
extern "C" int sopht_fft_fill_table(int m, float* out) {
  Plan p;
  if (!make_plan(m, &p)) return (int)cudaErrorInvalidValue;
  float* w1 = out;
  float* w2 = w1 + 2 * p.m1 * p.m1c;
  float* tw = w2 + 2 * p.m2 * p.h2c;
  for (int k1 = 0; k1 < p.m1; ++k1) {
    for (int n1 = 0; n1 < p.m1c; ++n1) {
      float* e = w1 + 2 * (k1 * p.m1c + n1);
      e[0] = e[1] = 0.f;
      if (n1 < p.m1) twiddle((long long)k1 * n1, p.m1, e);
    }
  }
  for (int k2 = 0; k2 < p.m2; ++k2) {
    for (int n2 = 0; n2 < p.h2c; ++n2) {
      float* e = w2 + 2 * (k2 * p.h2c + n2);
      e[0] = e[1] = 0.f;
      if (n2 < p.m2 / 2) twiddle((long long)k2 * n2, p.m2, e);
    }
  }
  for (int n1 = 0; n1 < p.m1; ++n1)
    for (int k2 = 0; k2 < p.m2; ++k2)
      twiddle((long long)n1 * k2, p.m, tw + 2 * (n1 * p.m2 + k2));
  float* line = out + 2 * p.table_len();
  for (int j = 0; j < p.m; ++j) twiddle(j, p.m, line + 2 * j);
  return 0;
}

extern "C" int sopht_fft_pass_padded_f32(const float* xr, const float* xi,
                                         float* out_r, float* out_i,
                                         const float* table, int A,
                                         long long B, int m, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || A <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<FftPassPadded>(p, xr, xi, out_r, out_i, table, A, B,
                                 (cudaStream_t)stream);
}

extern "C" int sopht_ifft_pass_truncated_f32(const float* xr, const float* xi,
                                             const float* g, int g_shared,
                                             float* out_r, float* out_i,
                                             const float* table, int A,
                                             long long B, int m,
                                             void* stream) {
  Plan p;
  if (!make_plan(m, &p) || A <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<IfftPassTruncated>(p, xr, xi, g, g_shared, out_r, out_i,
                                     table, A, B, (cudaStream_t)stream);
}

// The plan (columns a tile T, blocks, ring stages, shared bytes, 16-byte
// input copies, threads a block) is zconv_tile_plan's: all 0 for the
// four-step kernel's lengths. One that breaks the kernel's assumptions is
// refused with cudaErrorInvalidValue.
extern "C" int sopht_fft_greens_ifft_pass_f32(
    const float* xr, const float* xi, const float* g, float* out_r,
    float* out_i, const float* table, int A, long long B, int m, int T,
    int blocks, int stages, int smem, int bulk, int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || A <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const ZconvArgs a{xr, xi, g, out_r, out_i, table, A,
                    B, T, blocks, stages, smem, bulk, threads};
  return fft_greens_ifft(p, a, (cudaStream_t)stream);
}

// The plan (rows a tile T, blocks, ring stages, shared bytes, bulk input
// copies, threads a block) is edge_tile_plan's; one that breaks the
// kernel's assumptions is refused with cudaErrorInvalidValue.
extern "C" int sopht_rfft_pass_padded_split_f32(
    const float* x, float* br, float* bi, float* sr, float* si,
    const float* table, long long R, int n_in, int m, int T, int blocks,
    int stages, int smem, int bulk, int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || R <= 0 || n_in <= 0 || n_in > m / 2)
    return (int)cudaErrorInvalidValue;
  const EdgeArgs a{x, br, bi, sr, si, table, R, n_in, 0,
                   T, blocks, stages, smem, bulk, threads};
  return rfft_edge(p, a, (cudaStream_t)stream);
}

// the unsplit r2c: xr, xi (R, m/2 + 1), the Nyquist column kept in the row
extern "C" int sopht_rfft_pass_padded_f32(const float* x, float* xr, float* xi,
                                          const float* table, long long R,
                                          int n_in, int m, int T, int blocks,
                                          int stages, int smem, int bulk,
                                          int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || R <= 0 || n_in <= 0 || n_in > m / 2)
    return (int)cudaErrorInvalidValue;
  const EdgeArgs a{x, xr, xi, nullptr, nullptr, table, R, n_in, 1,
                   T, blocks, stages, smem, bulk, threads};
  return rfft_edge(p, a, (cudaStream_t)stream);
}

// The plan (rows a tile T, blocks, ring stages, shared bytes, bulk input
// copies, threads a block) is c2r_tile_plan's; one that breaks the kernel's
// assumptions is refused with cudaErrorInvalidValue. The Nyquist column's
// imaginary part does not enter, so only sr is passed.
extern "C" int sopht_irfft_pass_merge_f32(
    const float* br, const float* bi, const float* sr, float* out,
    const float* table, long long R, int m, int n_out, int T, int blocks,
    int stages, int smem, int bulk, int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || R <= 0 || n_out <= 0 || n_out > m / 2)
    return (int)cudaErrorInvalidValue;
  const C2rArgs a{br, bi, sr, out, table, R, n_out, 0,
                  T, blocks, stages, smem, bulk, threads, {}};
  return irfft_edge<false>(p, a, (cudaStream_t)stream);
}

// the unsplit c2r: xr, xi (R, m/2 + 1) with the Nyquist column in the row
extern "C" int sopht_irfft_pass_truncated_f32(
    const float* xr, const float* xi, float* out, const float* table,
    long long R, int m, int n_out, int T, int blocks, int stages, int smem,
    int bulk, int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || R <= 0 || n_out <= 0 || n_out > m / 2)
    return (int)cudaErrorInvalidValue;
  const C2rArgs a{xr, xi, nullptr, out, table, R, n_out, 1,
                  T, blocks, stages, smem, bulk, threads, {}};
  return irfft_edge<false>(p, a, (cudaStream_t)stream);
}

// The plan (columns a tile T, blocks, ring stages, shared bytes, 16-byte
// input copies, threads a block) is zconv_curl_tile_plan's: all 0 for the
// four-step kernel's lengths. One that breaks the kernel's assumptions is
// refused with cudaErrorInvalidValue.
extern "C" int sopht_fft_greens_curl_ifft_pass_f32(
    const float* xr, const float* xi, const float* g, const float* sym_z,
    const float* sym_yx, float* out_r, float* out_i, const float* table,
    long long B, int m, int T, int blocks, int stages, int smem, int bulk,
    int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || B <= 0) return (int)cudaErrorInvalidValue;
  const ZcurlArgs a{xr, xi, g, sym_z, sym_yx, out_r, out_i, table, B,
                    T, blocks, stages, smem, bulk, threads};
  return fft_greens_curl_ifft(p, a, (cudaStream_t)stream);
}

// br, bi (3, R, m/2), sr (3, R, 1) (the Nyquist column's imaginary part
// does not enter), fsv (3,), out (3, R, n_out), R = nz ny; l1_max: a zeroed
// device float, raised to max over cells of sum_c |u_c|. The plan (rows a
// tile T, blocks, ring stages, shared bytes, bulk copies, threads a block)
// is c2r_velocity_tile_plan's: all 0 for the four-step kernel's lengths.
// One that breaks the kernel's assumptions is refused with
// cudaErrorInvalidValue.
extern "C" int sopht_irfft_pass_merge_velocity_f32(
    const float* br, const float* bi, const float* sr, const float* fsv,
    float* out, float* l1_max, const float* table, long long R, int m,
    int n_out, int ny, int nz, int T, int blocks, int stages, int smem,
    int bulk, int threads, void* stream) {
  Plan p;
  if (!make_plan(m, &p) || R <= 0 || n_out <= 0 || n_out > m / 2 ||
      ny <= 0 || nz <= 0 || (long long)ny * nz != R)
    return (int)cudaErrorInvalidValue;
  const C2rArgs a{br, bi, sr, out, table, R, n_out, 0,
                  T, blocks, stages, smem, bulk, threads,
                  {fsv, l1_max, ny, nz}};
  return irfft_edge<true>(p, a, (cudaStream_t)stream);
}

// x: (A, ny, nx) real, my = 2 ny = m, mx = 2 nx. out: (A, my, mx/2) pair,
// side: (A, ny) pair. The plan (cluster size C, threads a block, clusters,
// shared bytes, bulk input copies) is fused_r2c_cluster_plan's:
// the cluster kernel reads the twiddle tables of m (table) and mx (xtable);
// the all-zero plan takes the dense-x kernel and its table xw (mx, 2)
// floats, xw[j] = exp(-2 pi i j / mx), and only where no cluster plan
// fits. One that breaks the kernels' assumptions is refused with
// cudaErrorInvalidValue.
extern "C" int sopht_rfft_fft_pass_fused_f32(
    const float* x, float* out_r, float* out_i, float* side_r, float* side_i,
    const float* table, const float* xtable, const float* xw, int A, int nx,
    int mx, int m, int C, int threads, int clusters, int smem, int bulk,
    void* stream) {
  Plan p, px;
  if (!make_plan(m, &p) || !make_plan(mx, &px) || A <= 0 || nx <= 0 ||
      mx != 2 * nx || nx % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool holds = cluster_dispatch<ClusterHolds<false>>(p, nx) == 1;
  if (!(C | threads | clusters | smem | bulk)) {
    if (holds || xw == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch<RfftFftPassFused>(p, x, out_r, out_i, side_r, side_i,
                                      table, xw, A, nx, mx, st);
  }
  if (!holds || xtable == nullptr) return (int)cudaErrorInvalidValue;
  const ClusterArgs a{x, out_r, out_i, side_r, side_i, table,
                      (const float*)((const float2*)xtable + px.table_len()),
                      A, C, threads, clusters, smem, bulk};
  return cluster_dispatch<ClusterLaunch>(p, nx, a, st);
}

// The clusters of the fused forward (inverse 0) or inverse (1) pass's
// cluster kernel at (nx, m) under the plan (C, threads, smem) that the card
// holds at once, or minus a CUDA error.
extern "C" int sopht_fused_cluster_capacity(int inverse, int nx, int m, int C,
                                            int threads, int smem) {
  Plan p;
  if (!make_plan(m, &p)) return -(int)cudaErrorInvalidValue;
  int most = 0;
  const int err =
      inverse ? cluster_dispatch<ClusterCapacity<true>>(p, nx, C, threads,
                                                         smem, &most)
              : cluster_dispatch<ClusterCapacity<false>>(p, nx, C, threads,
                                                          smem, &most);
  if (err) return err < 0 ? -(int)cudaErrorInvalidValue : -err;
  return most;
}

// br, bi: (A, my, mx/2), sr: (A, ny) (the Nyquist column's imaginary part
// does not enter); out: (A, ny, nx) real, every cell written. The plan
// (cluster size C, threads a block, clusters, shared bytes, 16-byte tile
// copies) is fused_c2r_cluster_plan's: the cluster kernel reads the twiddle
// tables of m (table) and mx (xtable); the all-zero plan takes the dense-x
// kernel and its table xw (mx, 2) floats, xw[j] = exp(-2 pi i j / mx), and
// only where no cluster plan fits. One that breaks the kernels'
// assumptions is refused with cudaErrorInvalidValue.
extern "C" int sopht_ifft_irfft_pass_fused_f32(
    const float* br, const float* bi, const float* sr, float* out,
    const float* table, const float* xtable, const float* xw, int A, int nx,
    int mx, int m, int C, int threads, int clusters, int smem, int bulk,
    void* stream) {
  Plan p, px;
  if (!make_plan(m, &p) || !make_plan(mx, &px) || A <= 0 || nx <= 0 ||
      mx != 2 * nx)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool holds = cluster_dispatch<ClusterHolds<true>>(p, nx) == 1;
  if (!(C | threads | clusters | smem | bulk)) {
    if (holds || xw == nullptr) return (int)cudaErrorInvalidValue;
    return dispatch<IfftIrfftPassFused>(p, br, bi, sr, out, table, xw, A, nx,
                                        mx, st);
  }
  if (!holds || xtable == nullptr) return (int)cudaErrorInvalidValue;
  const C2rClusterArgs a{br, bi, sr, out, table,
                         (const float*)((const float2*)xtable + px.table_len()),
                         A, C, threads, clusters, smem, bulk};
  return cluster_dispatch<C2rClusterLaunch>(p, nx, a, st);
}

extern "C" const char* sopht_fft_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
