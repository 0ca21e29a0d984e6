// K3: softmax mask compositing, forward and backward.
//
// Replaces video_prediction_tpu/ops/pallas_kernels.py:composite_fused (body
// _composite_kernel), which stands in for models/savp.py:381-390. Candidates
// cand [B,K,H,W,C] and mask logits [B,H,W,K], P = H*W pixels a sample:
//
//   mask[b,p,:] = softmax_k(logits[b,p,:])           (max subtracted, expf)
//   out[b,p,c]  = sum_k mask[b,p,k] * cand[b,k,p,c]  (k in order, fmaf)
//
// fp32 maths, out in the candidates' dtype; the fp32 masks are written too
// when a masks pointer is given (the generator's output_aux).
//
// Forward. Bound on the H100: bytes. A pixel reads K*C + K values and
// writes C (+ K fp32), at about K*(4 + 2C) flops: 0.5 flop a byte in fp32,
// far below the card's line. At batch 8 the 4 MB of a call take 1.2 us at
// 3.35 TB/s, so what counts is how many memory round trips a block waits for
// and how many blocks the SMs hold meanwhile. The design:
// - A tile of TP pixels of one sample a block (TP = 64, 32 where 64 would
//   leave SMs without a block; kernels/composite.py#plan), TP threads. A
//   tile's slice of each candidate plane (TP*C values), its logits (TP*K)
//   and its outputs (TP*C, and TP*K masks) are contiguous, and with TP a
//   multiple of 8 each is a whole number of 16-byte chunks in fp32 and bf16.
//   Batch 8 gives 512 tiles, about 4 an SM; batch 64 4,096, which the
//   hardware scheduler feeds to the SMs as blocks finish. (At batch 32 and
//   64 this runs at the device-memory bound already, from L2, so a
//   persistent grid with a ring was not tried.)
// - Compile-time K and C for the zoo's shapes (K = 7 for ours_*, 6 for
//   sv2p; C = 3), aligned tensors and P a multiple of 64: thread 0 issues
//   the tile's logits slice, then its K candidate slices, into shared memory
//   as K + 1 cp.async.bulk copies on two mbarriers, so a tile costs one
//   memory round trip. As soon as the logits are in (while the candidates
//   arrive), each thread takes the softmaxes of the pixels its outputs
//   belong to (2 in fp32, up to 4 in bf16) into registers; then the
//   weighted sums of its 16-byte chunk of the tile's flat TP*C outputs (4
//   fp32 or 8 bf16, from 16-byte chunks of each staged candidate), stored as
//   one 16-byte chunk: no block barrier between the copies' arrival and the
//   stores. With masks, each thread also writes its own pixel's weights to
//   shared memory, and the block stores them as 16-byte chunks at the end.
//   Measured alternatives (PERF.md, section 6): one mbarrier for all copies,
//   16-byte loads by every thread instead of bulk copies, 32-pixel tiles,
//   and the weights in shared memory behind a block barrier were slower at
//   batch 8; the copies issued by K + 1 threads and 128-pixel tiles were no
//   faster at batch 8 and slower at 32 or 64.
// - A run-time instantiation for everything else (K 1..16, any C, P no
//   multiple of TP, views off a 16-byte boundary): the block stages the
//   logits as fp32 into the weights' shared array (coalesced scalar loads),
//   takes the softmax in place, and forms the flat outputs from the
//   candidates in device memory, consecutive threads on consecutive values.
// - exp is expf (exact): K3 is not instruction-bound.
// The geometry (instantiation, TP, tiles, shared memory) is chosen by
// kernels/composite.py#plan and passed in; the launcher checks it against
// the instantiation's own. Shared memory stays under the 48 KB a block gets
// without opting in (at most 9 KB), so nothing is set at launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // the backward's block
constexpr int kMaxK = 16;
constexpr int kMinTile = 32, kMaxTile = 64;  // pixels a tile (and threads a block) of the forward
constexpr int kSmemDefault = 48 * 1024;      // dynamic shared memory a block gets without opting in

// A forward block's dynamic shared memory (kernels/composite.py#smem_bytes
// computes the same). Staged (compile-time K, C): two mbarriers (16 bytes),
// the K candidate slices [K][TP*C] and the logits [TP*K] in the dtype, the
// weights [TP][K] fp32, each a whole number of 16-byte chunks (TP is 32 or
// 64). Run time: the weights only.
__host__ __device__ constexpr int forward_smem_bytes(bool staged, int tp, int K, int C, int itemsize) {
  return staged ? 16 + (K * tp * C + tp * K) * itemsize + tp * K * 4 : tp * K * 4;
}

template <typename T>
struct Fwd {
  const T* cand;    // [B,K,P,C]
  const T* logits;  // [B,P,K]
  T* out;           // [B,P,C]
  float* masks;     // [B,P,K] fp32, or null
  int P, K, C;
  int tp, tiles;  // pixels a tile, tiles a sample
};

// softmax with max subtraction of the K <= KN values at x into y (fp32;
// y may be x)
template <int KN, typename S>
__device__ __forceinline__ void softmax(const S* x, float* y, int K) {
  float v[KN];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    if (k < K) {
      v[k] = vp::to_float(x[k]);
      m = fmaxf(m, v[k]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    if (k < K) {
      v[k] = expf(v[k] - m);
      s += v[k];
    }
  }
  const float inv = 1.0f / s;
#pragma unroll
  for (int k = 0; k < KN; ++k)
    if (k < K) y[k] = v[k] * inv;
}

// One tile of TP pixels of one sample a block, TP threads (header). KT, CT:
// the compile-time K and C of a staged instantiation; 0, 0: run time.
template <typename T, int KT, int CT>
__global__ void __launch_bounds__(kMaxTile) composite_forward_kernel(const Fwd<T> a) {
  constexpr bool kStaged = KT != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = kStaged ? KT : a.K, C = kStaged ? CT : a.C, tp = a.tp, t = threadIdx.x;
  const int b = blockIdx.x / a.tiles, p0 = (blockIdx.x - b * a.tiles) * tp;
  const int n = min(tp, a.P - p0);                                   // pixels of the tile (tp when staged)
  const size_t px = (size_t)b * a.P + p0;                            // its first pixel of [B*P]
  const T* cand = a.cand + ((size_t)b * K * a.P + p0) * C;          // its slice of candidate 0
  const size_t kstride = (size_t)a.P * C;                            // candidate k's slice: + k * kstride
  T* out = a.out + px * C;

  if constexpr (kStaged) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [2]: logits, candidates
    T* cs = reinterpret_cast<T*>(smem + 16);  // [K][TP*C]
    T* ls = cs + KT * tp * CT;               // [TP*K]
    float* w = reinterpret_cast<float*>(ls + tp * KT);
    if (t == 0) {
      vp::bar_init(bar);
      vp::bar_init(bar + 1);
    }
    __syncthreads();  // the mbarriers are initialised before any thread waits on them
    if (t == 0) {
      const uint32_t slice = tp * CT * sizeof(T), lbytes = tp * KT * sizeof(T);
      vp::bar_expect(bar, lbytes);
      vp::bulk_load(ls, a.logits + px * KT, lbytes, bar);
      vp::bar_expect(bar + 1, KT * slice);
#pragma unroll
      for (int k = 0; k < KT; ++k) vp::bulk_load(cs + k * tp * CT, cand + k * kstride, slice, bar + 1);
    }
    // The thread's outputs: one 16-byte chunk of V, j0 .. j0+V-1 of the
    // tile's flat TP*C (tp*CT/V of the tp threads have one), spanning at most
    // NP pixels from q0 on; it takes their softmaxes itself, into registers.
    constexpr int V = 16 / sizeof(T);
    constexpr int NP = (V + CT - 2) / CT + 1;
    const int j0 = t * V, q0 = j0 / CT, r = j0 - q0 * CT;
    const bool writes = j0 < tp * CT;
    float wt[NP][KT];
    vp::bar_wait(bar, 0);  // the logits: the softmaxes run while the candidates arrive
    if (a.masks != nullptr) softmax<KT>(ls + t * KT, w + t * KT, KT);
    if (writes) {
#pragma unroll
      for (int q = 0; q < NP; ++q)
        if (q0 + q < tp) softmax<KT>(ls + (q0 + q) * KT, wt[q], KT);
    }
    vp::bar_wait(bar + 1, 0);
    if (writes) {
      float acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = 0.0f;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        float c[V];
        vp::ld16<T>(cs + k * tp * CT + j0, c);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int q = (r + u) / CT;  // output u's pixel, q0 + q; selected, so that wt stays in registers
          float wk = wt[0][k];
#pragma unroll
          for (int qq = 1; qq < NP; ++qq) wk = q == qq ? wt[qq][k] : wk;
          acc[u] = fmaf(wk, c[u], acc[u]);
        }
      }
      vp::st16<T>(out + j0, acc);
    }
    if (a.masks != nullptr) {
      __syncthreads();  // every pixel's weights are in shared memory
      float4* mg = reinterpret_cast<float4*>(a.masks + px * KT);
      for (int i = t; i < tp * KT / 4; i += tp) mg[i] = reinterpret_cast<const float4*>(w)[i];
    }
  } else {
    float* w = reinterpret_cast<float*>(smem);  // [n][K]: the logits, then the weights
    const T* lg = a.logits + px * K;
    for (int i = t; i < n * K; i += tp) w[i] = vp::to_float(lg[i]);
    __syncthreads();
    if (t < n) softmax<kMaxK>(w + t * K, w + t * K, K);
    __syncthreads();
    if (a.masks != nullptr) {
      float* mg = a.masks + px * K;
      for (int i = t; i < n * K; i += tp) mg[i] = w[i];
    }
    for (int j = t; j < n * C; j += tp) {
      const float* wp = w + j / C * K;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc = fmaf(wp[k], vp::to_float(cand[k * kstride + j]), acc);
      out[j] = vp::from_float<T>(acc);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the plan's tile, tiles and shared memory, checked against the instantiation
template <typename T, int KT, int CT>
bool forward_plan_ok(const Fwd<T>& a, int B, int smem) {
  constexpr bool staged = KT != 0;
  if (a.K < 1 || a.K > kMaxK || a.C < 1 || a.P < 1 || B < 1) return false;
  if (a.tp < kMinTile || a.tp > kMaxTile || (a.tp & (a.tp - 1)) || a.tiles != vp::ceil_div(a.P, a.tp)) return false;
  if ((long long)B * a.tiles > 0x7fffffffLL) return false;
  if (staged && (a.K != KT || a.C != CT || a.P % a.tp || !aligned16(a.cand) || !aligned16(a.logits) ||
                 !aligned16(a.out) || (a.masks != nullptr && !aligned16(a.masks))))
    return false;
  return smem <= kSmemDefault && smem == forward_smem_bytes(staged, a.tp, a.K, a.C, sizeof(T));
}

template <typename T, int KT, int CT>
cudaError_t launch_forward(const Fwd<T>& a, int B, int smem, cudaStream_t stream) {
  if (!forward_plan_ok<T, KT, CT>(a, B, smem)) return cudaErrorInvalidValue;
  composite_forward_kernel<T, KT, CT><<<B * a.tiles, a.tp, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* cand, const void* logits, void* out, void* masks, int B, int P, int K, int C,
                    int staged_k, int tile, int smem, cudaStream_t stream) {
  const Fwd<T> a{static_cast<const T*>(cand), static_cast<const T*>(logits), static_cast<T*>(out),
                 static_cast<float*>(masks), P, K, C, tile, tile > 0 ? vp::ceil_div(P, tile) : 0};
  switch (staged_k) {
    case 7:
      return launch_forward<T, 7, 3>(a, B, smem, stream);
    case 6:
      return launch_forward<T, 6, 3>(a, B, smem, stream);
    case 0:
      return launch_forward<T, 0, 0>(a, B, smem, stream);
  }
  return cudaErrorInvalidValue;
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
// K). Design: one thread per pixel, in blocks of 256 threads. The thread
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
// fp32 or null; P = H*W; all contiguous. The plan (staged_k: 7, 6 or 0 for
// the run-time instantiation; tile; smem) is composite.py#plan's.
VP_EXPORT int vp_composite_forward(const void* cand, const void* logits, void* out, void* masks, int B, int P,
                                   int K, int C, int staged_k, int tile, int smem, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32)
    return forward<float>(cand, logits, out, masks, B, P, K, C, staged_k, tile, smem, s);
  if (dtype == vp::kBFloat16)
    return forward<__nv_bfloat16>(cand, logits, out, masks, B, P, K, C, staged_k, tile, smem, s);
  return cudaErrorInvalidValue;
}

// Message for an error code returned by any vp_* function.
VP_EXPORT const char* vp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
