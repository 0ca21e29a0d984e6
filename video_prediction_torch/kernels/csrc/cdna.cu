// K1: CDNA kernel application, forward.
//
// Replaces video_prediction_tpu/ops/pallas_kernels.py:apply_cdna_kernels_fused
// (body _cdna_kernel). Per sample b, the image [H,W,C] is cross-correlated with
// N kernels of KHxKW taps that are shared over channels, with zero SAME padding
// ((K-1)//2 before):
//
//   out[b,n,y,x,c] = sum_{i,j} kern[b,i,j,n] * img[b, y+i-ph, x+j-pw, c]
//
// The TPU kernel stacks the 25 shifted taps into a [25, H*W*C] VMEM scratch for
// one MXU matmul; at N=4 that matmul is tiny, so here it is a direct stencil.
//
// Bound on the H100: memory and launch latency. At the slice's shapes
// (64x64x3, N=4) a sample reads 48 KB of image and writes 4x that; the 25*N
// multiply-adds per output come from shared memory. Design: one block per
// (sample, tile of kTileRows image rows). The tile and its (KH-1)-row,
// (KW-1)-column zero halo are staged once in shared memory, so every image
// value is read from device memory about once; the sample's KH*KW*N weights
// sit in shared memory too. Each thread computes the N outputs of one
// (y, x, c), and for each n consecutive threads write consecutive addresses.
// Accumulation is fp32; the output is stored in the image dtype.
#include "common.cuh"

namespace {

constexpr int kTileRows = 4;
constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;

template <typename T>
__global__ void cdna_forward_kernel(const T* __restrict__ img, const float* __restrict__ kern,
                                    T* __restrict__ out, int H, int W, int C, int KH, int KW, int N,
                                    int tile_rows) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, H - y0);
  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;
  const int SH = rows + KH - 1, SW = W + KW - 1;
  const int taps = KH * KW;

  float* wts = smem;                // [KH*KW, N]
  float* tile = smem + taps * N;    // [SH, SW, C]

  const float* kb = kern + (size_t)b * taps * N;
  for (int i = threadIdx.x; i < taps * N; i += blockDim.x) wts[i] = kb[i];

  const T* ib = img + (size_t)b * H * W * C;
  for (int i = threadIdx.x; i < SH * SW * C; i += blockDim.x) {
    const int c = i % C;
    const int t = i / C;
    const int sx = t % SW, sy = t / SW;
    const int gy = y0 + sy - ph, gx = sx - pw;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = vp::to_float(ib[((size_t)gy * W + gx) * C + c]);
    tile[i] = v;
  }
  __syncthreads();

  const size_t plane = (size_t)H * W * C;
  T* ob = out + (size_t)b * N * plane + (size_t)y0 * W * C;
  for (int i = threadIdx.x; i < rows * W * C; i += blockDim.x) {
    const int c = i % C;
    const int t = i / C;
    const int x = t % W, y = t / W;
    for (int n = 0; n < N; ++n) {
      float acc = 0.0f;
      for (int ki = 0; ki < KH; ++ki) {
        const float* trow = tile + ((size_t)(y + ki) * SW + x) * C + c;
        const float* wrow = wts + ki * KW * N + n;
        for (int kj = 0; kj < KW; ++kj) acc = fmaf(wrow[kj * N], trow[kj * C], acc);
      }
      ob[n * plane + i] = vp::from_float<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* img, const void* kern, void* out, int B, int H, int W, int C, int KH,
                   int KW, int N, cudaStream_t stream) {
  int tile_rows = min(kTileRows, H);
  size_t smem = 0;
  for (; tile_rows > 0; --tile_rows) {
    smem = sizeof(float) * ((size_t)KH * KW * N + (size_t)(tile_rows + KH - 1) * (W + KW - 1) * C);
    if (smem <= kMaxSmemBytes) break;
  }
  if (tile_rows == 0) return cudaErrorInvalidValue;
  dim3 grid(vp::ceil_div(H, tile_rows), B);
  cdna_forward_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(kern), static_cast<T*>(out), H, W, C, KH,
      KW, N, tile_rows);
  return cudaGetLastError();
}

}  // namespace

// img [B,H,W,C] (dtype), kern [B,KH,KW,N] fp32, out [B,N,H,W,C] (dtype); all contiguous.
VP_EXPORT int vp_cdna_forward(const void* img, const void* kern, void* out, int B, int H, int W,
                              int C, int KH, int KW, int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32) return launch<float>(img, kern, out, B, H, W, C, KH, KW, N, s);
  if (dtype == vp::kBFloat16) return launch<__nv_bfloat16>(img, kern, out, B, H, W, C, KH, KW, N, s);
  return cudaErrorInvalidValue;
}
