// K2: per-gate LayerNorm + ConvLSTM gate math, forward.
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
// Bound on the H100: memory. Each row reads 5C values and writes 2C, with
// about 40 flops per value, far below the card's flop/byte ratio. Design: one
// warp per row, so the five LayerNorm reductions (two passes each) are warp
// shuffles with no shared memory or block barrier. Lane l holds channels
// l, l+32, ... of each gate in registers (VPT = ceil(C/32) values per gate),
// so the row is read once and reads are coalesced across the warp. The 4C
// gate channels of a pixel must be adjacent: the ConvLSTM keeps its gate conv
// in channels-last layout and hands its output over as a [R,4C] view.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kEps = 1e-6f;

template <int VPT>
__device__ __forceinline__ void layer_norm(float (&v)[VPT], const float* __restrict__ scale,
                                           const float* __restrict__ bias, int C, int lane) {
  const float inv_c = 1.0f / C;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (lane + 32 * k < C) s += v[k];
  const float mean = vp::warp_sum(s) * inv_c;
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (lane + 32 * k < C) {
      const float d = v[k] - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(vp::warp_sum(ss) * inv_c + kEps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int ch = lane + 32 * k;
    if (ch < C) v[k] = (v[k] - mean) * rstd * scale[ch] + bias[ch];
  }
}

template <typename T, int VPT>
__global__ void ln_gate_forward_kernel(const T* __restrict__ z, const T* __restrict__ c,
                                       const float* __restrict__ lnp, T* __restrict__ c_out,
                                       T* __restrict__ h_out, int R, int C, float forget_bias) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform over the warp: every lane of a warp shares its row

  const T* zr = z + (size_t)row * 4 * C;
  float gate[4][VPT];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int ch = lane + 32 * k;
      gate[q][k] = ch < C ? vp::to_float(zr[q * C + ch]) : 0.0f;
    }
    layer_norm<VPT>(gate[q], lnp + (2 * q) * C, lnp + (2 * q + 1) * C, C, lane);
  }

  const T* cr = c + (size_t)row * C;
  float cn[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int ch = lane + 32 * k;
    float cv = ch < C ? vp::to_float(cr[ch]) : 0.0f;
    const float i = vp::sigmoidf(gate[0][k]);
    const float f = vp::sigmoidf(gate[1][k] + forget_bias);
    const float g = tanhf(gate[2][k]);
    cn[k] = f * cv + i * g;
  }

  T* co = c_out + (size_t)row * C;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int ch = lane + 32 * k;
    if (ch < C) co[ch] = vp::from_float<T>(cn[k]);
  }

  layer_norm<VPT>(cn, lnp + 8 * C, lnp + 9 * C, C, lane);
  T* ho = h_out + (size_t)row * C;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int ch = lane + 32 * k;
    if (ch < C) ho[ch] = vp::from_float<T>(vp::sigmoidf(gate[3][k]) * tanhf(cn[k]));
  }
}

template <typename T, int VPT>
cudaError_t launch_vpt(const void* z, const void* c, const void* lnp, void* c_out, void* h_out, int R,
                       int C, float forget_bias, cudaStream_t stream) {
  ln_gate_forward_kernel<T, VPT><<<vp::ceil_div(R, kRowsPerBlock), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(c), static_cast<const float*>(lnp),
      static_cast<T*>(c_out), static_cast<T*>(h_out), R, C, forget_bias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* z, const void* c, const void* lnp, void* c_out, void* h_out, int R,
                   int C, float forget_bias, cudaStream_t s) {
  if (C <= 32) return launch_vpt<T, 1>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  if (C <= 64) return launch_vpt<T, 2>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  if (C <= 128) return launch_vpt<T, 4>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  if (C <= 256) return launch_vpt<T, 8>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  if (C <= 512) return launch_vpt<T, 16>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  return cudaErrorInvalidValue;
}

// K2 backward. Replaces the XLA transpose of the JAX package's LayerNorm
// ConvLSTM gate maths (video_prediction_tpu/ops/rnn.py:ConvLSTMCell, the
// use_norm path), which is what JAX differentiates in training: the Pallas
// kernel is forward only. Upstream gradients dc' (c' feeds the next step)
// and dh (h feeds the next layer) give
//
//   dz [R,4C], dc [R,C], dlnp [10,C] (summed over the R rows).
//
// Statistics: recomputed, not saved. The backward reads z and c again (it
// needs them for the normalized values anyway), and recomputes the five
// means and rstds with the forward's own two-pass warp reductions, so the
// forward keeps its outputs unchanged and no [R,5] side tensor is stored.
//
// Bound on the H100: memory, like the forward (reads 7C values a row,
// writes 5C). Design: one warp per row with lane l holding channels l,
// l+32, ... of every gate in registers; each LayerNorm backward needs two
// row sums (mean of dxhat and of dxhat*xhat), both warp shuffles. dlnp is a
// reduction over rows, done in two passes without atomics (deterministic):
// each warp walks rows_per_warp rows keeping its 10 x VPT partial sums in
// registers; the block's warps add them in warp order in shared memory and
// write one [10,C] partial per block; ln_grad_reduce sums the blocks'
// partials in block order.
template <int VPT>
__device__ __forceinline__ void ln_stats(const float (&v)[VPT], int C, int lane, float* mean, float* rstd) {
  const float inv_c = 1.0f / C;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    if (lane + 32 * k < C) s += v[k];
  *mean = vp::warp_sum(s) * inv_c;
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (lane + 32 * k < C) {
      const float d = v[k] - *mean;
      ss += d * d;
    }
  }
  *rstd = rsqrtf(vp::warp_sum(ss) * inv_c + kEps);
}

// dy -> dx of y = xhat * scale + bias, xhat = (x - mean) * rstd, in place on dy;
// adds dy * xhat and dy to the scale and bias partial sums.
template <int VPT>
__device__ __forceinline__ void ln_backward(float (&dy)[VPT], const float (&xhat)[VPT], float rstd,
                                            const float* __restrict__ scale, float (&ds)[VPT], float (&db)[VPT],
                                            int C, int lane) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int ch = lane + 32 * k;
    if (ch < C) {
      ds[k] += dy[k] * xhat[k];
      db[k] += dy[k];
      dy[k] *= scale[ch];  // dxhat
      s1 += dy[k];
      s2 += dy[k] * xhat[k];
    }
  }
  const float inv_c = 1.0f / C;
  const float m1 = vp::warp_sum(s1) * inv_c, m2 = vp::warp_sum(s2) * inv_c;
#pragma unroll
  for (int k = 0; k < VPT; ++k) dy[k] = rstd * (dy[k] - m1 - xhat[k] * m2);
}

template <typename T, int VPT>
__global__ void ln_gate_backward_kernel(const T* __restrict__ z, const T* __restrict__ c,
                                        const float* __restrict__ lnp, const T* __restrict__ dc_out,
                                        const T* __restrict__ dh_out, T* __restrict__ dz, T* __restrict__ dc,
                                        float* __restrict__ partial, int R, int C, float forget_bias,
                                        int rows_per_warp) {
  __shared__ float red[10 * 32 * VPT];  // the block's [10, C] partial
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float acc[10][VPT];
#pragma unroll
  for (int q = 0; q < 10; ++q)
#pragma unroll
    for (int k = 0; k < VPT; ++k) acc[q][k] = 0.0f;

  const int row0 = (blockIdx.x * kRowsPerBlock + warp) * rows_per_warp;
  const int row1 = min(row0 + rows_per_warp, R);
  for (int row = row0; row < row1; ++row) {  // uniform over the warp
    const T* zr = z + (size_t)row * 4 * C;
    float xh[4][VPT], rs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int ch = lane + 32 * k;
        xh[q][k] = ch < C ? vp::to_float(zr[q * C + ch]) : 0.0f;
      }
      float mean;
      ln_stats<VPT>(xh[q], C, lane, &mean, &rs[q]);
#pragma unroll
      for (int k = 0; k < VPT; ++k) xh[q][k] = lane + 32 * k < C ? (xh[q][k] - mean) * rs[q] : 0.0f;
    }
    // activations, c', its normalized value and tanh
    float act[4][VPT], cv[VPT], chat[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int ch = lane + 32 * k;
      const bool on = ch < C;
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = on ? xh[q][k] * lnp[(2 * q) * C + ch] + lnp[(2 * q + 1) * C + ch] : 0.0f;
      act[0][k] = vp::sigmoidf(y[0]);
      act[1][k] = vp::sigmoidf(y[1] + forget_bias);
      act[2][k] = tanhf(y[2]);
      act[3][k] = vp::sigmoidf(y[3]);
      cv[k] = on ? vp::to_float(c[(size_t)row * C + ch]) : 0.0f;
      chat[k] = on ? act[1][k] * cv[k] + act[0][k] * act[2][k] : 0.0f;  // c' for now
    }
    float cmean, crs;
    ln_stats<VPT>(chat, C, lane, &cmean, &crs);
    float dcn[VPT], dyc[VPT], dyo[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int ch = lane + 32 * k;
      const bool on = ch < C;
      chat[k] = on ? (chat[k] - cmean) * crs : 0.0f;
      const float tc = on ? tanhf(chat[k] * lnp[8 * C + ch] + lnp[9 * C + ch]) : 0.0f;
      const float dh = on ? vp::to_float(dh_out[(size_t)row * C + ch]) : 0.0f;
      const float o = act[3][k];
      dyo[k] = dh * tc * o * (1.0f - o);
      dyc[k] = dh * o * (1.0f - tc * tc);
    }
    ln_backward<VPT>(dyc, chat, crs, lnp + 8 * C, acc[8], acc[9], C, lane);  // dyc is now d c' from h
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int ch = lane + 32 * k;
      dcn[k] = ch < C ? dyc[k] + vp::to_float(dc_out[(size_t)row * C + ch]) : 0.0f;
    }
    // gate pre-LN gradients dy_q, then through each gate's LayerNorm
    float dy[4][VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float i = act[0][k], f = act[1][k], g = act[2][k];
      dy[0][k] = dcn[k] * g * i * (1.0f - i);
      dy[1][k] = dcn[k] * cv[k] * f * (1.0f - f);
      dy[2][k] = dcn[k] * i * (1.0f - g * g);
      dy[3][k] = dyo[k];
    }
    T* dzr = dz + (size_t)row * 4 * C;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ln_backward<VPT>(dy[q], xh[q], rs[q], lnp + (2 * q) * C, acc[2 * q], acc[2 * q + 1], C, lane);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int ch = lane + 32 * k;
        if (ch < C) dzr[q * C + ch] = vp::from_float<T>(dy[q][k]);
      }
    }
    T* dcr = dc + (size_t)row * C;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int ch = lane + 32 * k;
      if (ch < C) dcr[ch] = vp::from_float<T>(dcn[k] * act[1][k]);
    }
  }

  // the block's partial: warps add in order 0, 1, ... (deterministic)
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < 10; ++q)
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int ch = lane + 32 * k;
          if (ch < C) red[q * C + ch] = (w == 0 ? 0.0f : red[q * C + ch]) + acc[q][k];
        }
    }
    __syncthreads();
  }
  float* pb = partial + (size_t)blockIdx.x * 10 * C;
  for (int i = threadIdx.x; i < 10 * C; i += blockDim.x) pb[i] = red[i];
}

// partial [nblocks, 10*C] -> dlnp [10*C], summed in block order.
__global__ void ln_grad_reduce(const float* __restrict__ partial, float* __restrict__ dlnp, int nblocks, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M) return;
  float acc = 0.0f;
  for (int b = 0; b < nblocks; ++b) acc += partial[(size_t)b * M + idx];
  dlnp[idx] = acc;
}

template <typename T, int VPT>
cudaError_t launch_backward_vpt(const void* z, const void* c, const void* lnp, const void* dc_out,
                                const void* dh_out, void* dz, void* dc, void* dlnp, void* partial, int R, int C,
                                float forget_bias, int rows_per_warp, int nblocks, cudaStream_t stream) {
  ln_gate_backward_kernel<T, VPT><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(c), static_cast<const float*>(lnp),
      static_cast<const T*>(dc_out), static_cast<const T*>(dh_out), static_cast<T*>(dz), static_cast<T*>(dc),
      static_cast<float*>(partial), R, C, forget_bias, rows_per_warp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_grad_reduce<<<vp::ceil_div(10 * C, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dlnp), nblocks, 10 * C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* z, const void* c, const void* lnp, const void* dc_out, const void* dh_out,
                            void* dz, void* dc, void* dlnp, void* partial, int R, int C, float forget_bias,
                            int rows_per_warp, int nblocks, cudaStream_t s) {
#define VP_LN_BWD(V)                                                                                         \
  launch_backward_vpt<T, V>(z, c, lnp, dc_out, dh_out, dz, dc, dlnp, partial, R, C, forget_bias, rows_per_warp, \
                            nblocks, s)
  if (C <= 32) return VP_LN_BWD(1);
  if (C <= 64) return VP_LN_BWD(2);
  if (C <= 128) return VP_LN_BWD(4);
  if (C <= 256) return VP_LN_BWD(8);
  if (C <= 512) return VP_LN_BWD(16);
#undef VP_LN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the backward for R rows on `device`: each warp walks
// ceil(R / (4 * SMs * 8)) rows, so that the grid is about four blocks per
// SM; the wrapper sizes the [nblocks, 10, C] partial scratch with it. 0 if
// the SM count cannot be read.
VP_EXPORT int vp_ln_gate_backward_blocks(int R, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  const long long warps = 4LL * sms * kRowsPerBlock;
  const int rows_per_warp = (int)((R + warps - 1) / warps);
  return vp::ceil_div(R, kRowsPerBlock * rows_per_warp);
}

// z, dz [R,4C]; c, dc_out, dh_out, dc [R,C] (dtype); lnp, dlnp [10,C] and
// partial [nblocks,10,C] fp32; all contiguous.
VP_EXPORT int vp_ln_gate_backward(const void* z, const void* c, const void* lnp, const void* dc_out,
                                  const void* dh_out, void* dz, void* dc, void* dlnp, void* partial, int R, int C,
                                  float forget_bias, int nblocks, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nblocks < 1) return cudaErrorInvalidValue;
  const int rows_per_warp = vp::ceil_div(R, nblocks * kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32)
    return launch_backward<float>(z, c, lnp, dc_out, dh_out, dz, dc, dlnp, partial, R, C, forget_bias,
                                  rows_per_warp, nblocks, s);
  if (dtype == vp::kBFloat16)
    return launch_backward<__nv_bfloat16>(z, c, lnp, dc_out, dh_out, dz, dc, dlnp, partial, R, C, forget_bias,
                                          rows_per_warp, nblocks, s);
  return cudaErrorInvalidValue;
}

// z [R,4C], c [R,C], c_out [R,C], h_out [R,C] (dtype); lnp [10,C] fp32; all contiguous.
VP_EXPORT int vp_ln_gate_forward(const void* z, const void* c, const void* lnp, void* c_out,
                                 void* h_out, int R, int C, float forget_bias, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32) return launch<float>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  if (dtype == vp::kBFloat16)
    return launch<__nv_bfloat16>(z, c, lnp, c_out, h_out, R, C, forget_bias, s);
  return cudaErrorInvalidValue;
}
