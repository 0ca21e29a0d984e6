// K3: softmax mask compositing, forward.
//
// Replaces video_prediction_tpu/ops/pallas_kernels.py:composite_fused (body
// _composite_kernel), which stands in for models/savp.py:381-390. Candidates
// cand [B,K,H,W,C] and mask logits [B,H,W,K]:
//
//   mask[b,y,x,:] = softmax_k(logits[b,y,x,:])
//   out[b,y,x,c]  = sum_k mask[b,y,x,k] * cand[b,k,y,x,c]
//
// fp32 maths, out in the candidates' dtype; the fp32 masks are written too
// when a masks pointer is given (the generator's output_aux).
//
// Bound on the H100: memory. A pixel reads K*C + K values and writes C (+K);
// a few flops per value. Design: one thread per pixel. The thread reads the
// pixel's K logits (adjacent in memory), takes the softmax with max
// subtraction in registers, then forms the C weighted sums; consecutive
// threads read consecutive pixels of each candidate plane.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

template <typename T>
__global__ void composite_forward_kernel(const T* __restrict__ cand, const T* __restrict__ logits,
                                         T* __restrict__ out, float* __restrict__ masks, int B,
                                         int P, int K, int C) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;  // pixel index in [0, B*P)
  if (idx >= (size_t)B * P) return;
  const size_t b = idx / P, p = idx % P;

  const T* lg = logits + idx * K;
  float w[kMaxK];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      w[k] = vp::to_float(lg[k]);
      m = fmaxf(m, w[k]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      w[k] = expf(w[k] - m);
      s += w[k];
    }
  }
  const float inv = 1.0f / s;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) w[k] *= inv;
  if (masks != nullptr) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) masks[idx * K + k] = w[k];
  }

  const T* cb = cand + (b * K * P + p) * C;
  const size_t kstride = (size_t)P * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) acc = fmaf(w[k], vp::to_float(cb[k * kstride + c]), acc);
    out[idx * C + c] = vp::from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* cand, const void* logits, void* out, void* masks, int B, int P, int K,
                   int C, cudaStream_t stream) {
  if (K < 1 || K > kMaxK) return cudaErrorInvalidValue;
  const long long pixels = (long long)B * P;
  composite_forward_kernel<T><<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(cand), static_cast<const T*>(logits), static_cast<T*>(out),
      static_cast<float*>(masks), B, P, K, C);
  return cudaGetLastError();
}

// K3 backward. Replaces the XLA transpose of the JAX package's compositing
// maths (video_prediction_tpu/models/savp.py:381-390), which is what JAX
// differentiates in training: the Pallas kernel is forward only. With g =
// d out [B,H,W,C] and m = softmax(logits):
//
//   d cand[b,k,y,x,c] = m_k * g_c
//   d logit_k         = m_k * (<g, cand_k> - sum_j m_j <g, cand_j>),  <.,.> over C
//
// Bound on the H100: memory (reads K*C + K + C values a pixel, writes K*C +
// K). Design: one thread per pixel, as in the forward. The thread
// recomputes the softmax from the K logits in registers, reads g's C values
// once into registers, then walks the K candidate planes, writing d cand
// and forming <g, cand_k>; consecutive threads touch consecutive pixels.
constexpr int kMaxC = 4;  // the thread keeps g's C values in registers

template <typename T>
__global__ void composite_backward_kernel(const T* __restrict__ cand, const T* __restrict__ logits,
                                          const T* __restrict__ g, T* __restrict__ d_cand,
                                          T* __restrict__ d_logits, int B, int P, int K, int C) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;  // pixel index in [0, B*P)
  if (idx >= (size_t)B * P) return;
  const size_t b = idx / P, p = idx % P;

  const T* lg = logits + idx * K;
  float w[kMaxK];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      w[k] = vp::to_float(lg[k]);
      m = fmaxf(m, w[k]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      w[k] = expf(w[k] - m);
      s += w[k];
    }
  }
  const float inv = 1.0f / s;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) w[k] *= inv;

  float gv[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) gv[c] = c < C ? vp::to_float(g[idx * C + c]) : 0.0f;

  const size_t kstride = (size_t)P * C;
  const T* cb = cand + (b * K * P + p) * C;
  T* dcb = d_cand + (b * K * P + p) * C;
  float dot[kMaxK];
  float sdot = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          acc = fmaf(gv[c], vp::to_float(cb[k * kstride + c]), acc);
          dcb[k * kstride + c] = vp::from_float<T>(w[k] * gv[c]);
        }
      }
      dot[k] = acc;
      sdot = fmaf(w[k], acc, sdot);
    }
  }
  T* dl = d_logits + idx * K;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) dl[k] = vp::from_float<T>(w[k] * (dot[k] - sdot));
}

template <typename T>
cudaError_t launch_backward(const void* cand, const void* logits, const void* g, void* d_cand, void* d_logits,
                            int B, int P, int K, int C, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC) return cudaErrorInvalidValue;
  const long long pixels = (long long)B * P;
  composite_backward_kernel<T><<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(cand), static_cast<const T*>(logits), static_cast<const T*>(g),
      static_cast<T*>(d_cand), static_cast<T*>(d_logits), B, P, K, C);
  return cudaGetLastError();
}

}  // namespace

// cand, d_cand [B,K,H,W,C]; logits, d_logits [B,H,W,K]; g [B,H,W,C] (dtype);
// P = H*W; C <= 4; all contiguous.
VP_EXPORT int vp_composite_backward(const void* cand, const void* logits, const void* g, void* d_cand,
                                    void* d_logits, int B, int P, int K, int C, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32) return launch_backward<float>(cand, logits, g, d_cand, d_logits, B, P, K, C, s);
  if (dtype == vp::kBFloat16)
    return launch_backward<__nv_bfloat16>(cand, logits, g, d_cand, d_logits, B, P, K, C, s);
  return cudaErrorInvalidValue;
}

// cand [B,K,H,W,C], logits [B,H,W,K], out [B,H,W,C] (dtype); masks [B,H,W,K]
// fp32 or null; P = H*W; all contiguous.
VP_EXPORT int vp_composite_forward(const void* cand, const void* logits, void* out, void* masks, int B,
                                   int P, int K, int C, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32) return launch<float>(cand, logits, out, masks, B, P, K, C, s);
  if (dtype == vp::kBFloat16) return launch<__nv_bfloat16>(cand, logits, out, masks, B, P, K, C, s);
  return cudaErrorInvalidValue;
}

// Message for an error code returned by any vp_* function.
VP_EXPORT const char* vp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
