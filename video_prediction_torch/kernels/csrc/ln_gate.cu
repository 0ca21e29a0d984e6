// K2: per-gate LayerNorm + ConvLSTM gate math, forward and backward.
//
// Replaces video_prediction_tpu/ops/pallas_kernels.py:fused_ln_gate (body
// _ln_gate_kernel, helper _ln_rows). Rows x channels: z [R,4C] gate
// pre-activations (i, f, g, o slices of C), c [R,C] previous cell state,
// lnp [10,C] fp32 LayerNorm scale/bias rows in the order i, f, g, o, c:
//
//   i = sigmoid(LN_i(z_i)), f = sigmoid(LN_f(z_f) + forget_bias),
//   g = tanh(LN_g(z_g)),    o = sigmoid(LN_o(z_o))
//   c' = f*c + i*g,         h = o * tanh(LN_c(c'))
//
// LayerNorm is over the C channels of a row, eps 1e-6, two-pass variance, all
// maths in fp32; c' and h are stored in the dtype of z and c.
//
// The backward replaces the XLA transpose of the JAX package's LayerNorm
// ConvLSTM gate maths (video_prediction_tpu/ops/rnn.py:ConvLSTMCell, the
// use_norm path), which is what JAX differentiates in training: the Pallas
// kernel is forward only. From dc' (c' feeds the next step) and dh (h feeds
// the next layer) it gives dz [R,4C], dc [R,C] and dlnp [10,C] summed over
// the rows. The LayerNorm statistics are recomputed, not saved: z and c are
// read anyway.
//
// Bound on the H100: bytes. In fp32 the forward moves 28 B a row-channel
// (z, c in; c', h out) and the backward 48 B (z, c, dc', dh in; dz, dc
// out), at about 50 and 100 flops, far below the card's flop/byte line.
// What the design does about it:
// - Row-to-lane mapping of 16-byte chunks: a row spans L = clamp(C/V, 4, 32)
//   lanes (V = 4 fp32 or 8 bf16 values a chunk), so a warp takes 32/L rows at
//   once (4 at C=32 in fp32) and the row sums are log2(L) width-limited
//   shuffles. Shared and device memory are read and written 16 bytes a lane.
//   The flagship widths 32, 64, 128, 256 are compile-time instantiations
//   (no masks, no index maths); every other C <= 512, a C that is no
//   multiple of V and an unaligned base pointer take the run-time
//   instantiation (CT = 0: one row a warp, lane l holding channels l, l+32,
//   ..., scalar loads and stores).
// - Loads overlap compute: each warp walks its row tiles (a persistent grid
//   sized by the occupancy the registers and shared memory allow) through a
//   two-stage ring in shared memory. While it computes one tile, the next
//   tile's z, c (dc', dh) are in flight: one cp.async.bulk per tensor (the
//   tile's rows are contiguous), completing on the stage's mbarrier. A
//   warp's first tile is in flight while the block stages ln_params (at
//   batch 8 most warps have one tile). The run-time instantiation copies
//   through registers, one stage.
// - Few live registers and instructions: the statistics are kept as
//   scalars and x-hat is recomputed from the staged z gate by gate, so that
//   a few [VPT] arrays are live at a time; ln_params sit in shared memory
//   once a block; sigmoid and tanh take one __expf and one __fdividef each.
//   These are approximations, not fp32-exact maths: tanh as 1 - 2/(1+e^2x)
//   has an absolute error near fp32's rounding of 1, so it loses relative
//   precision for small arguments. Against the plain version (expf, tanhf)
//   the fp32 outputs differ by at most 7.2e-7 forward and 1.9e-6 in dz, dc
//   (chip_smoke.py on an H100 80GB HBM3 at 700 W), inside the 1e-5
//   tolerance; a caller that needs exact transcendentals needs another
//   kernel.
// - d ln_params without atomics, deterministic: each lane adds its rows'
//   terms into its own slots of a per-warp [10, VPT, 32] shared slice; at
//   the end the block sums its warps' slices in a fixed order into one
//   [10, C] partial, and ln_gate_grad_reduce sums the blocks' partials with
//   16 threads a column (a strided split, then a fixed-order sum).
// The 4C gate channels of a pixel must be adjacent: the ConvLSTM keeps its
// gate conv in channels-last layout and hands its output over as a [R,4C]
// view. The geometry (lanes, rows a warp, warps a block, stages, shared
// memory, blocks) is chosen by kernels/ln_gate.py#plan and passed in; the
// launchers check it against the instantiation's own.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into on the H100
constexpr int kReduceWarps = 16;

// Compile-time geometry of an instantiation: CT the width (0: run time),
// VPT the values of one gate a lane holds.
template <typename T, int CT, int VPT>
struct Geo {
  static constexpr bool kVec = CT != 0;
  static constexpr int V = kVec ? 16 / (int)sizeof(T) : 1;  // values a chunk
  static constexpr int L = kVec ? (CT / V < 4 ? 4 : (CT / V > 32 ? 32 : CT / V)) : 32;  // lanes a row
  static constexpr int G = 32 / L;                          // rows a warp tile
  static constexpr int NCH = VPT / V;                       // chunks of a gate a lane
  static_assert(!kVec || VPT * L == CT, "VPT must be CT / L");
  static_assert(!kVec || NCH * V == VPT, "VPT must be whole chunks");
};

// the VPT of compile-time width CT
template <typename T, int CT>
constexpr int vec_vpt() {
  constexpr int v = 16 / (int)sizeof(T);
  constexpr int l = CT / v < 4 ? 4 : (CT / v > 32 ? 32 : CT / v);
  return CT / l;
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Dynamic shared memory of a block: the warps' mbarriers (two each),
// ln_params, the warps' staging rings, and (backward) the warps' d
// ln_params slices. kernels/ln_gate.py#plan computes the same.
__host__ __device__ constexpr int bar_bytes(int warps) { return align16(8 * 2 * warps); }
__host__ __device__ constexpr int stage_bytes(int G, int C, int itemsize, bool bwd) {
  return align16(G * (bwd ? 7 : 5) * C * itemsize);
}
__host__ __device__ constexpr int smem_bytes(int G, int VPT, int C, int itemsize, bool bwd, int warps, int stages) {
  return bar_bytes(warps) + align16(10 * C * 4) + warps * stages * stage_bytes(G, C, itemsize, bwd) +
         (bwd ? warps * 10 * VPT * 32 * 4 : 0);
}

template <typename T>
struct Args {
  const T* z;
  const T* c;
  const T* dco;  // backward: d c'
  const T* dho;  // backward: d h
  const float* lnp;
  T* out0;  // forward c', backward dz
  T* out1;  // forward h, backward dc
  float* partial;  // backward [gridDim.x, 10, C]
  int R, C;
  float forget_bias;
  int stages;
};

// sigmoid and tanh from one __expf (ex2.approx) and one __fdividef each, at
// a fraction of expf's and tanhf's instructions, which at C <= 128 are the
// kernels' other limit besides bytes; approximate (header note)
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

__device__ __forceinline__ float tanh_(float x) { return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x)); }

// n values from src to dst by the warp's lanes, through registers
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

// Lane j of a row's L lanes, slot k: channel (j + L*(k/V))*V + k%V, or j + 32k
// at run time (ln_gate.py#lane_channels computes the same).
template <typename T, int CT, int VPT>
struct Row {
  using G_ = Geo<T, CT, VPT>;
  int j, C;

  __device__ __forceinline__ bool on(int k) const { return G_::kVec || j + 32 * k < C; }

  // the row's VPT values of the lane from p (shared or global, dtype)
  __device__ __forceinline__ void load(const T* p, float (&v)[VPT]) const {
    if constexpr (G_::kVec) {
#pragma unroll
      for (int m = 0; m < G_::NCH; ++m) vp::ld16<T>(p + (j + G_::L * m) * G_::V, v + m * G_::V);
    } else {
#pragma unroll
      for (int k = 0; k < VPT; ++k) v[k] = on(k) ? vp::to_float(p[j + 32 * k]) : 0.0f;
    }
  }

  // fp32 parameters (shared)
  __device__ __forceinline__ void param(const float* p, float (&v)[VPT]) const {
    if constexpr (G_::kVec) {
#pragma unroll
      for (int m = 0; m < G_::NCH; ++m)
#pragma unroll
        for (int u = 0; u < G_::V; u += 4) vp::ld16<float>(p + (j + G_::L * m) * G_::V + u, v + m * G_::V + u);
    } else {
#pragma unroll
      for (int k = 0; k < VPT; ++k) v[k] = on(k) ? p[j + 32 * k] : 0.0f;
    }
  }

  __device__ __forceinline__ void store(T* p, const float (&v)[VPT]) const {
    if constexpr (G_::kVec) {
#pragma unroll
      for (int m = 0; m < G_::NCH; ++m) vp::st16<T>(p + (j + G_::L * m) * G_::V, v + m * G_::V);
    } else {
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (on(k)) p[j + 32 * k] = vp::from_float<T>(v[k]);
    }
  }
};

// N row sums over the L lanes of a row, interleaved
template <int L, int N>
__device__ __forceinline__ void row_sums(float (&s)[N]) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] += __shfl_xor_sync(0xffffffffu, s[n], off);
}

// mean and rstd (two-pass) of the four gates of the staged row zr
template <typename T, int CT, int VPT>
__device__ __forceinline__ void gate_stats(const Row<T, CT, VPT>& row, const T* zr, float inv_c, float (&mean)[4],
                                           float (&rstd)[4]) {
  constexpr int L = Geo<T, CT, VPT>::L;
  float s[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[VPT];
    row.load(zr + q * row.C, v);
    s[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) s[q] += v[k];
  }
  row_sums<L, 4>(s);
#pragma unroll
  for (int q = 0; q < 4; ++q) mean[q] = s[q] * inv_c;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[VPT];
    row.load(zr + q * row.C, v);
    s[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float d = v[k] - mean[q];
      s[q] += row.on(k) ? d * d : 0.0f;
    }
  }
  row_sums<L, 4>(s);
#pragma unroll
  for (int q = 0; q < 4; ++q) rstd[q] = rsqrtf(s[q] * inv_c + kEps);
}

// x-hat of gate q from the staged row
template <typename T, int CT, int VPT>
__device__ __forceinline__ void xhat(const Row<T, CT, VPT>& row, const T* zr, int q, float mean, float rstd,
                                     float (&v)[VPT]) {
  row.load(zr + q * row.C, v);
#pragma unroll
  for (int k = 0; k < VPT; ++k) v[k] = (v[k] - mean) * rstd;
}

// mean and rstd of one row held in registers
template <typename T, int CT, int VPT>
__device__ __forceinline__ void row_stats(const Row<T, CT, VPT>& row, const float (&v)[VPT], float inv_c,
                                          float* mean, float* rstd) {
  constexpr int L = Geo<T, CT, VPT>::L;
  float s[1] = {0.0f};
#pragma unroll
  for (int k = 0; k < VPT; ++k) s[0] += row.on(k) ? v[k] : 0.0f;
  row_sums<L, 1>(s);
  *mean = s[0] * inv_c;
  s[0] = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const float d = v[k] - *mean;
    s[0] += row.on(k) ? d * d : 0.0f;
  }
  row_sums<L, 1>(s);
  *rstd = rsqrtf(s[0] * inv_c + kEps);
}

// i, f, g of the staged row and c' = f*c + i*g; i and g kept where asked
template <typename T, int CT, int VPT>
__device__ __forceinline__ void cell(const Row<T, CT, VPT>& row, const T* zr, const T* cr, const float* lnp,
                                     const float (&mean)[4], const float (&rstd)[4], float forget_bias,
                                     float (&cn)[VPT]) {
  const int C = row.C;
  float a[VPT], sc[VPT], bi[VPT];
  xhat(row, zr, 1, mean[1], rstd[1], a);  // f
  row.param(lnp + 2 * C, sc);
  row.param(lnp + 3 * C, bi);
  row.load(cr, cn);
#pragma unroll
  for (int k = 0; k < VPT; ++k) cn[k] *= sigm(a[k] * sc[k] + bi[k] + forget_bias);
  float ig[VPT];
  xhat(row, zr, 0, mean[0], rstd[0], a);  // i
  row.param(lnp + 0 * C, sc);
  row.param(lnp + 1 * C, bi);
#pragma unroll
  for (int k = 0; k < VPT; ++k) ig[k] = sigm(a[k] * sc[k] + bi[k]);
  xhat(row, zr, 2, mean[2], rstd[2], a);  // g
  row.param(lnp + 4 * C, sc);
  row.param(lnp + 5 * C, bi);
#pragma unroll
  for (int k = 0; k < VPT; ++k) cn[k] += ig[k] * tanh_(a[k] * sc[k] + bi[k]);
}

template <typename T, int CT, int VPT>
__device__ __forceinline__ void forward_row(const Row<T, CT, VPT>& row, const T* zr, const T* cr, const float* lnp,
                                            const Args<T>& a, int r, bool valid) {
  const int C = row.C;
  const float inv_c = 1.0f / C;
  float mean[4], rstd[4];
  gate_stats(row, zr, inv_c, mean, rstd);
  float cn[VPT];
  cell(row, zr, cr, lnp, mean, rstd, a.forget_bias, cn);
  if (valid) row.store(a.out0 + (size_t)r * C, cn);
  float cm, cr_;
  row_stats(row, cn, inv_c, &cm, &cr_);
  float o[VPT], sc[VPT], bi[VPT];
  xhat(row, zr, 3, mean[3], rstd[3], o);
  row.param(lnp + 6 * C, sc);
  row.param(lnp + 7 * C, bi);
#pragma unroll
  for (int k = 0; k < VPT; ++k) o[k] = sigm(o[k] * sc[k] + bi[k]);
  row.param(lnp + 8 * C, sc);
  row.param(lnp + 9 * C, bi);
#pragma unroll
  for (int k = 0; k < VPT; ++k) o[k] *= tanh_((cn[k] - cm) * cr_ * sc[k] + bi[k]);
  if (valid) row.store(a.out1 + (size_t)r * C, o);
}

// acc slots of this lane: [10][VPT] strided by 32 lanes
template <int VPT>
__device__ __forceinline__ void accumulate(float* acc, int q, const float (&v)[VPT], bool valid) {
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[(q * VPT + k) * 32] += v[k];
}

template <typename T, int CT, int VPT>
__device__ __forceinline__ void backward_row(const Row<T, CT, VPT>& row, const T* zr, const T* cr, const T* dcr,
                                             const T* dhr, const float* lnp, float* acc, const Args<T>& a, int r,
                                             bool valid) {
  constexpr int L = Geo<T, CT, VPT>::L;
  const int C = row.C;
  const float inv_c = 1.0f / C;
  float mean[4], rstd[4];
  gate_stats(row, zr, inv_c, mean, rstd);
  float cn[VPT];
  cell(row, zr, cr, lnp, mean, rstd, a.forget_bias, cn);
  float cm, crs;
  row_stats(row, cn, inv_c, &cm, &crs);

  // h = o * tanh(LN_c(c')): d of LN_c's output and of LN_o's output
  float dxc[VPT], dxo[VPT], s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  {
    float xo[VPT], dh[VPT], s6[VPT], b6[VPT], s8[VPT], b8[VPT];
    xhat(row, zr, 3, mean[3], rstd[3], xo);
    row.load(dhr, dh);
    row.param(lnp + 6 * C, s6);
    row.param(lnp + 7 * C, b6);
    row.param(lnp + 8 * C, s8);
    row.param(lnp + 9 * C, b8);
    float t0[VPT], t1[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float chat = (cn[k] - cm) * crs;
      const float tc = tanh_(chat * s8[k] + b8[k]);
      const float o = sigm(xo[k] * s6[k] + b6[k]);
      const float dyo = row.on(k) ? dh[k] * tc * o * (1.0f - o) : 0.0f;
      const float dyc = row.on(k) ? dh[k] * o * (1.0f - tc * tc) : 0.0f;
      dxc[k] = dyc * s8[k];
      s[0] += dxc[k];
      s[1] += dxc[k] * chat;
      dxo[k] = dyo * s6[k];
      s[2] += dxo[k];
      s[3] += dxo[k] * xo[k];
      t0[k] = dyc * chat;
      t1[k] = dyo * xo[k];
      dh[k] = dyo;  // reused for the bias terms
      xo[k] = dyc;
    }
    accumulate(acc, 8, t0, valid);
    accumulate(acc, 9, xo, valid);
    accumulate(acc, 6, t1, valid);
    accumulate(acc, 7, dh, valid);
  }
  row_sums<L, 4>(s);
#pragma unroll
  for (int n = 0; n < 4; ++n) s[n] *= inv_c;

  // dz of gate o; dc' = LN_c backward + the upstream dc'
  {
    float xo[VPT];
    xhat(row, zr, 3, mean[3], rstd[3], xo);
#pragma unroll
    for (int k = 0; k < VPT; ++k) xo[k] = rstd[3] * (dxo[k] - s[2] - xo[k] * s[3]);
    if (valid) row.store(a.out0 + (size_t)r * 4 * C + 3 * C, xo);
    float dco[VPT];
    row.load(dcr, dco);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float chat = (cn[k] - cm) * crs;
      cn[k] = crs * (dxc[k] - s[0] - chat * s[1]) + dco[k];  // cn is dc' from here on
    }
  }

  // the gates i, f, g: d of each LN's output, dc, and the LN backward sums
  float dx[3][VPT], u[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  {
    float xi[VPT], xg[VPT], sc[VPT], bi[VPT], ig[VPT], gg[VPT];
    xhat(row, zr, 0, mean[0], rstd[0], xi);
    row.param(lnp + 0 * C, sc);
    row.param(lnp + 1 * C, bi);
#pragma unroll
    for (int k = 0; k < VPT; ++k) ig[k] = sigm(xi[k] * sc[k] + bi[k]);
    float s0[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) s0[k] = sc[k];
    xhat(row, zr, 2, mean[2], rstd[2], xg);
    row.param(lnp + 4 * C, sc);
    row.param(lnp + 5 * C, bi);
#pragma unroll
    for (int k = 0; k < VPT; ++k) gg[k] = tanh_(xg[k] * sc[k] + bi[k]);
    // gate i and gate g
    float t[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float dy0 = row.on(k) ? cn[k] * gg[k] * ig[k] * (1.0f - ig[k]) : 0.0f;
      const float dy2 = row.on(k) ? cn[k] * ig[k] * (1.0f - gg[k] * gg[k]) : 0.0f;
      dx[0][k] = dy0 * s0[k];
      u[0] += dx[0][k];
      u[1] += dx[0][k] * xi[k];
      dx[2][k] = dy2 * sc[k];
      u[4] += dx[2][k];
      u[5] += dx[2][k] * xg[k];
      t[k] = dy0 * xi[k];
      xi[k] = dy0;
      ig[k] = dy2 * xg[k];
      gg[k] = dy2;
    }
    accumulate(acc, 0, t, valid);
    accumulate(acc, 1, xi, valid);
    accumulate(acc, 4, ig, valid);
    accumulate(acc, 5, gg, valid);
    // gate f, and dc = dc' * f
    float xf[VPT], cv[VPT];
    xhat(row, zr, 1, mean[1], rstd[1], xf);
    row.param(lnp + 2 * C, sc);
    row.param(lnp + 3 * C, bi);
    row.load(cr, cv);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float f = sigm(xf[k] * sc[k] + bi[k] + a.forget_bias);
      const float dy1 = row.on(k) ? cn[k] * cv[k] * f * (1.0f - f) : 0.0f;
      cv[k] = cn[k] * f;  // dc
      dx[1][k] = dy1 * sc[k];
      u[2] += dx[1][k];
      u[3] += dx[1][k] * xf[k];
      t[k] = dy1 * xf[k];
      xf[k] = dy1;
    }
    if (valid) row.store(a.out1 + (size_t)r * C, cv);
    accumulate(acc, 2, t, valid);
    accumulate(acc, 3, xf, valid);
  }
  row_sums<L, 6>(u);
#pragma unroll
  for (int n = 0; n < 6; ++n) u[n] *= inv_c;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float x[VPT];
    xhat(row, zr, q, mean[q], rstd[q], x);
#pragma unroll
    for (int k = 0; k < VPT; ++k) x[k] = rstd[q] * (dx[q][k] - u[2 * q] - x[k] * u[2 * q + 1]);
    if (valid) row.store(a.out0 + (size_t)r * 4 * C + q * C, x);
  }
}

// One body for both directions: a persistent grid of warps, each walking row
// tiles tile = global warp, + all warps, ... through its staging ring.
template <bool BWD, typename T, int CT, int VPT>
__device__ __forceinline__ void rows_body(const Args<T>& a) {
  using G_ = Geo<T, CT, VPT>;
  constexpr int G = G_::G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CT ? CT : a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int sbytes = stage_bytes(G, C, sizeof(T), BWD), lead = bar_bytes(nwarps);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + 2 * warp;
  float* lnp = reinterpret_cast<float*>(smem + lead);
  unsigned char* ring = smem + lead + align16(10 * C * 4) + warp * a.stages * sbytes;
  float* acc = reinterpret_cast<float*>(smem + lead + align16(10 * C * 4) + nwarps * a.stages * sbytes) +
               warp * 10 * VPT * 32 + lane;

  // stage s holds z [G,4C], c [G,C] (and dc', dh [G,C]) in dtype
  auto zs = [&](int s) { return reinterpret_cast<T*>(ring + s * sbytes); };
  auto issue = [&](int tile, int s) {
    const int r0 = tile * G, nr = min(G, a.R - r0);
    T* z = zs(s);
    T* cs[3] = {z + G * 4 * C, z + G * 5 * C, z + G * 6 * C};
    const T* cg[3] = {a.c + (size_t)r0 * C, BWD ? a.dco + (size_t)r0 * C : nullptr,
                      BWD ? a.dho + (size_t)r0 * C : nullptr};
    constexpr int n_c = BWD ? 3 : 1;
    if constexpr (G_::kVec) {
      if (lane == 0) {
        const uint32_t zb = nr * 4 * C * sizeof(T), cb = nr * C * sizeof(T);
        vp::bar_expect(bars + s, zb + n_c * cb);
        vp::bulk_load(z, a.z + (size_t)r0 * 4 * C, zb, bars + s);
#pragma unroll
        for (int t = 0; t < n_c; ++t) vp::bulk_load(cs[t], cg[t], cb, bars + s);
      }
    } else {
      copy_rows(z, a.z + (size_t)r0 * 4 * C, nr * 4 * C, lane);
#pragma unroll
      for (int t = 0; t < n_c; ++t) copy_rows(cs[t], cg[t], nr * C, lane);
    }
  };

  const Row<T, CT, VPT> row{lane % G_::L, C};
  const int grp = lane / G_::L;
  const int tiles = (a.R + G - 1) / G, stride = gridDim.x * nwarps;
  uint32_t phase = 0;  // bit s: the parity the next wait on stage s expects
  int s = 0;
  if constexpr (BWD) {
#pragma unroll
    for (int k = 0; k < 10 * VPT; ++k) acc[k * 32] = 0.0f;
  }
  if constexpr (G_::kVec) {
    // the first tile's copies are in flight while ln_params come in through
    // L1 (every block reads the same 40 C bytes), 16 bytes a thread
    if (lane == 0) {
      vp::bar_init(bars);
      vp::bar_init(bars + 1);
    }
    __syncwarp();
    if (blockIdx.x * nwarps + warp < tiles) issue(blockIdx.x * nwarps + warp, 0);
    const float4* src = reinterpret_cast<const float4*>(a.lnp);
    float4* dst = reinterpret_cast<float4*>(lnp);
#pragma unroll 4
    for (int i = threadIdx.x; i < 10 * C / 4; i += blockDim.x) dst[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < 10 * C; i += blockDim.x) lnp[i] = a.lnp[i];
  }
  __syncthreads();
  for (int tile = blockIdx.x * nwarps + warp; tile < tiles; tile += stride) {
    if (a.stages == 1) issue(tile, 0);
    const bool ahead = a.stages == 2 && tile + stride < tiles;
    if (ahead) issue(tile + stride, s ^ 1);
    if constexpr (G_::kVec) {
      vp::bar_wait(bars + s, (phase >> s) & 1u);
      phase ^= 1u << s;
    }
    __syncwarp();
    const T* z = zs(s) + grp * 4 * C;
    const T* c = zs(s) + G * 4 * C + grp * C;
    const int r = tile * G + grp;
    if constexpr (BWD)
      backward_row(row, z, c, c + G * C, c + 2 * G * C, lnp, acc, a, r, r < a.R);
    else
      forward_row(row, z, c, lnp, a, r, r < a.R);
    // every lane is done with stage s before it is refilled
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (a.stages == 2) s ^= 1;
  }

  if constexpr (BWD) {
    // the block's [10, C] partial: warps, then a warp's row groups, in order
    __syncthreads();
    const float* slices = acc - warp * 10 * VPT * 32 - lane;
    for (int i = threadIdx.x; i < 10 * C; i += blockDim.x) {
      const int q = i / C, ch = i - q * C;
      int j, k;
      if constexpr (G_::kVec) {
        const int chunk = ch / G_::V;
        j = chunk % G_::L;
        k = (chunk / G_::L) * G_::V + ch % G_::V;
      } else {
        j = ch % 32;
        k = ch / 32;
      }
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w)
#pragma unroll
        for (int g = 0; g < G; ++g) sum += slices[w * 10 * VPT * 32 + (q * VPT + k) * 32 + g * G_::L + j];
      a.partial[(size_t)blockIdx.x * 10 * C + i] = sum;
    }
  }
}

template <typename T, int CT, int VPT>
__global__ void __launch_bounds__(kMaxThreads, CT ? 2 : 1) ln_gate_forward_kernel(const Args<T> a) {
  rows_body<false, T, CT, VPT>(a);
}

template <typename T, int CT, int VPT>
__global__ void __launch_bounds__(kMaxThreads, CT ? 2 : 1) ln_gate_backward_kernel(const Args<T> a) {
  rows_body<true, T, CT, VPT>(a);
}

// partial [nblocks, M] -> dlnp [M]: a block takes 32 columns; its 16 warps
// sum the partials w, w+16, ... each, then warp 0 adds the 16 in order.
__global__ void __launch_bounds__(32 * kReduceWarps) ln_gate_grad_reduce(const float* __restrict__ partial,
                                                                         float* __restrict__ dlnp, int nblocks,
                                                                         int M) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, col = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (col < M) {
#pragma unroll 4
    for (int b = w; b < nblocks; b += kReduceWarps) s += partial[(size_t)b * M + col];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && col < M) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) t += red[i][lane];
    dlnp[col] = t;
  }
}

template <bool BWD, typename T, int CT, int VPT>
auto kernel_of() {
  if constexpr (BWD)
    return ln_gate_backward_kernel<T, CT, VPT>;
  else
    return ln_gate_forward_kernel<T, CT, VPT>;
}

// the plan's warps, stages and shared memory, checked against the instantiation:
// compile-time widths take a two-stage ring of bulk copies, the run-time one
// a single stage copied through registers
template <bool BWD, typename T, int CT, int VPT>
bool plan_ok(int C, int warps, int stages, int smem) {
  using G_ = Geo<T, CT, VPT>;
  if (warps < 1 || warps * 32 > kMaxThreads || stages != (CT ? 2 : 1)) return false;
  if (CT ? C != CT : (C > 32 * VPT || (VPT > 1 && C <= 16 * VPT))) return false;
  return smem <= kSmemLimit && smem == smem_bytes(G_::G, VPT, C, sizeof(T), BWD, warps, stages);
}

// Every plan passes through here before its first launch (ln_gate.py caches
// the answer), so this is where the instantiation is allowed the most
// dynamic shared memory any plan may ask for; the launches then set nothing.
template <bool BWD, typename T, int CT, int VPT>
int occupancy(int C, int warps, int stages, int smem) {
  if (!plan_ok<BWD, T, CT, VPT>(C, warps, stages, smem)) return -(int)cudaErrorInvalidValue;
  auto kernel = kernel_of<BWD, T, CT, VPT>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

template <bool BWD, typename T, int CT, int VPT>
int launch_rows(const Args<T>& a, int warps, int blocks, int smem, cudaStream_t stream) {
  if (!plan_ok<BWD, T, CT, VPT>(a.C, warps, a.stages, smem) || blocks < 1) return cudaErrorInvalidValue;
  kernel_of<BWD, T, CT, VPT>()<<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// calls f(CT, VPT) as std::integral_constants for the instantiation of width
// (0: run time) and vpt; -cudaErrorInvalidValue if there is none
template <typename T, typename F>
int with_instantiation(int width, int vpt, F&& f) {
  using std::integral_constant;
#define VP_LN_VEC(W)                                                                  \
  case W:                                                                             \
    return vpt == vec_vpt<T, W>() ? f(integral_constant<int, W>{},                    \
                                      integral_constant<int, vec_vpt<T, W>()>{})      \
                                  : -(int)cudaErrorInvalidValue;
#define VP_LN_RT(P) \
  case P:           \
    return f(integral_constant<int, 0>{}, integral_constant<int, P>{});
  switch (width) {
    VP_LN_VEC(32)
    VP_LN_VEC(64)
    VP_LN_VEC(128)
    VP_LN_VEC(256)
    case 0:
      switch (vpt) {
        VP_LN_RT(1)
        VP_LN_RT(2)
        VP_LN_RT(4)
        VP_LN_RT(8)
        VP_LN_RT(16)
      }
  }
#undef VP_LN_VEC
#undef VP_LN_RT
  return -(int)cudaErrorInvalidValue;
}

template <bool BWD, typename T>
int run(const void* z, const void* c, const void* dco, const void* dho, const void* lnp, void* out0, void* out1,
        void* dlnp, void* partial, int R, int C, float forget_bias, int width, int vpt, int warps, int stages,
        int blocks, int smem, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(z), static_cast<const T*>(c), static_cast<const T*>(dco),
                  static_cast<const T*>(dho), static_cast<const float*>(lnp), static_cast<T*>(out0),
                  static_cast<T*>(out1), static_cast<float*>(partial), R, C, forget_bias, stages};
  const int err = with_instantiation<T>(width, vpt, [&](auto ct, auto vp_) {
    return launch_rows<BWD, T, decltype(ct)::value, decltype(vp_)::value>(a, warps, blocks, smem, stream);
  });
  if (err != 0) return err < 0 ? -err : err;
  if constexpr (BWD) {
    ln_gate_grad_reduce<<<vp::ceil_div(10 * C, 32), 32 * kReduceWarps, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(dlnp), blocks, 10 * C);
    return cudaGetLastError();
  }
  return 0;
}

}  // namespace

// Blocks of a launch that fit on one SM (registers, shared memory), for the
// instantiation of (backward, dtype, width, vpt) with this plan; a negative
// CUDA error code if the plan does not match an instantiation.
VP_EXPORT int vp_ln_gate_blocks_per_sm(int backward, int dtype, int C, int width, int vpt, int warps, int stages,
                                       int smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
#define VP_LN_OCC(BWD, T)                                                                                 \
  with_instantiation<T>(width, vpt, [&](auto ct, auto vp_) {                                            \
    return occupancy<BWD, T, decltype(ct)::value, decltype(vp_)::value>(C, warps, stages, smem);       \
  })
  if (dtype == vp::kFloat32) return backward ? VP_LN_OCC(true, float) : VP_LN_OCC(false, float);
  if (dtype == vp::kBFloat16) return backward ? VP_LN_OCC(true, __nv_bfloat16) : VP_LN_OCC(false, __nv_bfloat16);
#undef VP_LN_OCC
  return -(int)cudaErrorInvalidValue;
}

// z, dz [R,4C]; c, dc_out, dh_out, dc [R,C] (dtype); lnp, dlnp [10,C] and
// partial [blocks,10,C] fp32; all contiguous. The plan (width, vpt, warps,
// stages, blocks, smem) is ln_gate.py#plan's.
VP_EXPORT int vp_ln_gate_backward(const void* z, const void* c, const void* lnp, const void* dc_out,
                                  const void* dh_out, void* dz, void* dc, void* dlnp, void* partial, int R, int C,
                                  float forget_bias, int width, int vpt, int warps, int stages, int blocks, int smem,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32)
    return run<true, float>(z, c, dc_out, dh_out, lnp, dz, dc, dlnp, partial, R, C, forget_bias, width, vpt, warps,
                            stages, blocks, smem, s);
  if (dtype == vp::kBFloat16)
    return run<true, __nv_bfloat16>(z, c, dc_out, dh_out, lnp, dz, dc, dlnp, partial, R, C, forget_bias, width, vpt,
                                    warps, stages, blocks, smem, s);
  return cudaErrorInvalidValue;
}

// z [R,4C], c [R,C], c_out [R,C], h_out [R,C] (dtype); lnp [10,C] fp32; all
// contiguous; the plan as for the backward.
VP_EXPORT int vp_ln_gate_forward(const void* z, const void* c, const void* lnp, void* c_out, void* h_out, int R,
                                 int C, float forget_bias, int width, int vpt, int warps, int stages, int blocks,
                                 int smem, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32)
    return run<false, float>(z, c, nullptr, nullptr, lnp, c_out, h_out, nullptr, nullptr, R, C, forget_bias, width,
                             vpt, warps, stages, blocks, smem, s);
  if (dtype == vp::kBFloat16)
    return run<false, __nv_bfloat16>(z, c, nullptr, nullptr, lnp, c_out, h_out, nullptr, nullptr, R, C, forget_bias,
                                     width, vpt, warps, stages, blocks, smem, s);
  return cudaErrorInvalidValue;
}
