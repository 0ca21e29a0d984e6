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

}  // namespace

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
