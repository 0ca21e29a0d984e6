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

// K1 backward. Replaces the XLA transpose of the JAX package's shifted
// multiply-adds (video_prediction_tpu/ops/cdna.py:apply_cdna_kernels), which
// is what JAX differentiates in training: the Pallas kernel is forward only.
// With g = d out [B,N,H,W,C]:
//
//   d img[b,p,q,c]    = sum_{n,i,j} kern[b,i,j,n] * g[b,n, p-i+ph, q-j+pw, c]
//   d kern[b,i,j,n]   = sum_{y,x,c} g[b,n,y,x,c] * img[b, y+i-ph, x+j-pw, c]
//
// Bound on the H100: memory and launch latency, like the forward (a sample
// reads 48 KB of image and 4x that of g at the slice's shapes). Design: one
// block per (sample, tile of rows), as in the forward. The block stages the
// image tile with its forward halo and the N planes of g with the mirrored
// halo in shared memory, so each value is read from device memory about
// once. d img is the correlation with the flipped taps, one thread per
// (y, x, c). d kern is a reduction over the whole sample, so it takes two
// passes instead of atomics (deterministic): each warp reduces some of the
// KH*KW*N taps over the tile with shuffles and writes one partial per
// (block, tap), then cdna_kernel_grad_reduce sums each tap's partials over
// the row tiles in a fixed order.
template <typename T>
__global__ void cdna_backward_kernel(const T* __restrict__ img, const float* __restrict__ kern,
                                     const T* __restrict__ g, T* __restrict__ d_img,
                                     float* __restrict__ partial, int H, int W, int C, int KH, int KW,
                                     int N, int tile_rows) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, H - y0);
  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;
  const int SH = tile_rows + KH - 1, SW = W + KW - 1;
  const int taps = KH * KW;

  float* wts = smem;                        // [KH*KW, N]
  float* itile = wts + taps * N;            // [SH, SW, C]: image rows y0-ph .., cols -pw ..
  float* gtile = itile + SH * SW * C;       // [N, SH, SW, C]: g rows y0-(KH-1-ph) .., cols -(KW-1-pw) ..

  const float* kb = kern + (size_t)b * taps * N;
  for (int i = threadIdx.x; i < taps * N; i += blockDim.x) wts[i] = kb[i];

  const T* ib = img + (size_t)b * H * W * C;
  const size_t plane = (size_t)H * W * C;
  const T* gb = g + (size_t)b * N * plane;
  const int gh = KH - 1 - ph, gw = KW - 1 - pw;  // g's halo before the tile
  for (int i = threadIdx.x; i < SH * SW * C; i += blockDim.x) {
    const int c = i % C;
    const int t = i / C;
    const int sx = t % SW, sy = t / SW;
    int gy = y0 + sy - ph, gx = sx - pw;
    itile[i] = (sy < rows + KH - 1 && gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? vp::to_float(ib[((size_t)gy * W + gx) * C + c])
                   : 0.0f;
    gy = y0 + sy - gh;
    gx = sx - gw;
    const bool in = sy < rows + KH - 1 && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t off = ((size_t)gy * W + gx) * C + c;
    for (int n = 0; n < N; ++n) gtile[(size_t)n * SH * SW * C + i] = in ? vp::to_float(gb[n * plane + off]) : 0.0f;
  }
  __syncthreads();

  // d img: out pixel (y, x) reads image (y+i-ph, x+j-pw), so image pixel (p, q)
  // collects g at (p-i+ph, q-j+pw) = gtile row (p-y0) + (KH-1-i), col q + (KW-1-j)
  T* db = d_img + (size_t)b * plane + (size_t)y0 * W * C;
  for (int i = threadIdx.x; i < rows * W * C; i += blockDim.x) {
    const int c = i % C;
    const int t = i / C;
    const int x = t % W, y = t / W;
    float acc = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float* gn = gtile + (size_t)n * SH * SW * C;
      for (int ki = 0; ki < KH; ++ki) {
        const float* grow = gn + ((size_t)(y + KH - 1 - ki) * SW + x) * C + c;
        const float* wrow = wts + ki * KW * N + n;
        for (int kj = 0; kj < KW; ++kj) acc = fmaf(wrow[kj * N], grow[(KW - 1 - kj) * C], acc);
      }
    }
    db[i] = vp::from_float<T>(acc);
  }

  // d kern partials over this tile: g (y, x) sits at gtile row y + gh, col x + gw;
  // the image value it multiplies at tap (ki, kj) at itile row y + ki, col x + kj
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, nwarps = blockDim.x / 32;
  const int count = rows * W * C;
  float* pb = partial + ((size_t)b * gridDim.x + blockIdx.x) * taps * N;
  for (int o = warp; o < taps * N; o += nwarps) {
    const int n = o % N, tap = o / N;
    const int ki = tap / KW, kj = tap % KW;
    const float* gn = gtile + (size_t)n * SH * SW * C;
    float acc = 0.0f;
    for (int i = lane; i < count; i += 32) {
      const int c = i % C;
      const int t = i / C;
      const int x = t % W, y = t / W;
      acc = fmaf(gn[((size_t)(y + gh) * SW + x + gw) * C + c], itile[((size_t)(y + ki) * SW + x + kj) * C + c], acc);
    }
    acc = vp::warp_sum(acc);
    if (lane == 0) pb[o] = acc;
  }
}

// partial [B, tiles, M] -> d_kern [B, M] (M = KH*KW*N), summed in tile order.
__global__ void cdna_kernel_grad_reduce(const float* __restrict__ partial, float* __restrict__ d_kern, int B,
                                        int tiles, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * M) return;
  const int b = idx / M, o = idx % M;
  const float* p = partial + (size_t)b * tiles * M + o;
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) acc += p[(size_t)t * M];
  d_kern[idx] = acc;
}

// Rows per tile and the dynamic shared memory the backward needs for them.
inline int backward_tile_rows(int H, int W, int C, int KH, int KW, int N, size_t* smem) {
  for (int tile_rows = min(kTileRows, H); tile_rows > 0; --tile_rows) {
    *smem = sizeof(float) *
            ((size_t)KH * KW * N + (size_t)(tile_rows + KH - 1) * (W + KW - 1) * C * (1 + (size_t)N));
    if (*smem <= kMaxSmemBytes) return tile_rows;
  }
  return 0;
}

template <typename T>
cudaError_t launch_backward(const void* img, const void* kern, const void* g, void* d_img, void* d_kern,
                            void* partial, int B, int H, int W, int C, int KH, int KW, int N,
                            cudaStream_t stream) {
  size_t smem = 0;
  const int tile_rows = backward_tile_rows(H, W, C, KH, KW, N, &smem);
  if (tile_rows == 0) return cudaErrorInvalidValue;
  const int tiles = vp::ceil_div(H, tile_rows);
  cdna_backward_kernel<T><<<dim3(tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(kern), static_cast<const T*>(g),
      static_cast<T*>(d_img), static_cast<float*>(partial), H, W, C, KH, KW, N, tile_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = KH * KW * N;
  cdna_kernel_grad_reduce<<<vp::ceil_div(B * M, kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(d_kern), B, tiles, M);
  return cudaGetLastError();
}

}  // namespace

// Row tiles of the backward at these sizes (the wrapper sizes the partial
// scratch [B, tiles, KH*KW*N] fp32 from it); 0 if even one row does not fit.
VP_EXPORT int vp_cdna_backward_tiles(int H, int W, int C, int KH, int KW, int N) {
  size_t smem = 0;
  const int tile_rows = backward_tile_rows(H, W, C, KH, KW, N, &smem);
  return tile_rows == 0 ? 0 : vp::ceil_div(H, tile_rows);
}

// img [B,H,W,C], g [B,N,H,W,C], d_img [B,H,W,C] (dtype); kern, d_kern [B,KH,KW,N]
// and partial [B,tiles,KH*KW*N] fp32; all contiguous.
VP_EXPORT int vp_cdna_backward(const void* img, const void* kern, const void* g, void* d_img, void* d_kern,
                               void* partial, int B, int H, int W, int C, int KH, int KW, int N, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vp::kFloat32)
    return launch_backward<float>(img, kern, g, d_img, d_kern, partial, B, H, W, C, KH, KW, N, s);
  if (dtype == vp::kBFloat16)
    return launch_backward<__nv_bfloat16>(img, kern, g, d_img, d_kern, partial, B, H, W, C, KH, KW, N, s);
  return cudaErrorInvalidValue;
}

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
