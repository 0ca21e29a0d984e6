// K1: CDNA kernel application, forward and backward.
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
// Bound on the H100: memory. At the slice's shapes (64x64x3, N=4) a sample
// reads 48 KB of image and writes 4x that, with 25 N multiply-adds per
// output, far below the card's flop/byte ratio.
//
// Design (both directions): one block per (sample, tile of rows). The tile
// and its (KH-1)-row, (KW-1)-column zero halo are staged in dynamic shared
// memory; in fp32 with 16-byte aligned rows (the flagship's case) each image
// row is one Hopper bulk copy (cp.async.bulk, completion on an mbarrier)
// issued by a lane of warp 0, and the outputs are gathered in shared memory
// and written by one bulk copy per kernel plane, so the threads spend their
// instructions on arithmetic; otherwise 4-byte cp.async (fp32) or loads
// through registers (bf16) stage the tile and the threads store. The tile
// height is the largest that still gives two blocks per SM, so that one
// block's staging overlaps another's arithmetic while the halo is re-read
// (from L2) as little as that allows. The kernels are templates on C, the kernel size and N: at the
// flagship's C=3, 5x5, N=4 every loop has constant bounds, and each thread
// computes RX=4 adjacent x positions of one row for all C channels and all N
// kernels (48 accumulators) from the row's window of RX + 4 pixels, read once
// per kernel row with aligned 16-byte shared memory loads (free of bank
// conflicts at the 48-byte stride between threads) instead of once per tap.
// Any other shape takes the run-time instantiation of the same kernels (one
// x, one channel, one kernel at a time). Accumulation is fp32 in the tap order
// i, j; outputs are stored in the image dtype.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRx = 4;  // adjacent x positions a thread computes in the specialized kernels

// Compile-time sizes of an instantiation: CT, KT, NT, or 0 for the run-time ones.
template <int CT, int KT, int NT>
struct Dims {
  static constexpr int RX = CT ? kRx : 1;  // x positions a thread
  static constexpr int CB = CT ? CT : 1;   // channels a thread at once
  static constexpr int NB = NT ? NT : 1;   // kernels at once
  static constexpr int KJB = KT ? KT : 1;  // taps of a row at once (d kernels)
  // specialized: a row's window of RX + KT - 1 pixels, read by 16-byte loads
  // from M0 floats past a 16-byte boundary (image column 0 of a staged row
  // is 16-byte aligned, and a thread's RX pixels are RX * CT floats, a
  // multiple of 4)
  static constexpr int WIN = CT ? (RX + KT - 1) * CT : 1;
  static constexpr int M0 = CT ? (4 - ((KT - 1) / 2 * CT) % 4) % 4 : 0;
  static_assert(CT == 0 || (RX * CT) % 4 == 0, "a thread's run of pixels must be whole 16-byte pieces");
  static_assert(KT == 0 || KT % 2 == 1, "the specialized kernels take odd kernel sizes");
  int C, KH, KW, N;
  __device__ Dims(int c, int kh, int kw, int n) : C(CT ? CT : c), KH(KT ? KT : kh), KW(KT ? KT : kw), N(NT ? NT : n) {}
};

inline __host__ __device__ int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of a block, in floats, each region 16-byte aligned:
// [weights KH*KW*N][warp sums of d kernels (backward)][output rows staged
// for the bulk store: nout x tile_rows x W*C][planes: (tile_rows + KH - 1)
// rows of `stride` floats, plus 4 floats so that image column 0 of every
// staged row can sit on a 16-byte boundary].
struct Layout {
  int taps_n, wsum, obuf, stride, plane;
  __host__ __device__ Layout(int KH, int KW, int N, int C, int W, int tile_rows, int SW, int nwarps_wsum, int nout)
      : taps_n(round4(KH * KW * N)),
        wsum(round4(nwarps_wsum * KH * KW * N)),
        obuf(round4(nout * tile_rows * W * C)),
        stride(round4(SW * C)),
        plane(round4((tile_rows + KH - 1) * round4(SW * C)) + 4) {}
  __host__ __device__ int plane_begin(int i) const { return taps_n + wsum + obuf + i * plane; }
  __host__ __device__ size_t bytes(int nplanes) const { return sizeof(float) * (size_t)plane_begin(nplanes); }
};

// Start of a staged plane whose rows hold image column 0 at float `lead`:
// shifted so that column 0 is 16-byte aligned (the bulk copies need it).
__device__ __forceinline__ float* plane_at(float* begin, int lead) { return begin + ((4 - (lead & 3)) & 3); }

__device__ __forceinline__ int rows_inside(int y_first, int rows, int H) {
  return max(0, min(H, y_first + rows) - max(0, y_first));
}

// Stage rows [y_first, y_first + rows) of plane p [H, W, C] (dtype) into
// shared rows of `stride` floats, image column 0 at float `lead`; zero
// outside the plane. Without bulk copies: fp32 goes by cp.async (4 bytes
// each, zero-filled outside), all of a thread's copies in flight at once;
// bf16 is loaded 8 values a thread at a time into registers and converted.
// The caller waits with stage_wait() and a block barrier.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ p, float* __restrict__ s, int y_first, int rows,
                                           int lead, int stride, int H, int W, int C) {
  const int row_len = W * C, total = rows * stride;
  if constexpr (sizeof(T) == 4) {
    for (int sy = 0; sy < rows; ++sy) {
      const int gy = y_first + sy;
      const bool in = gy >= 0 && gy < H;
      for (int e = threadIdx.x; e < stride; e += blockDim.x) {
        const int ge = e - lead;  // element offset in the plane's row
        const bool take = in && ge >= 0 && ge < row_len;
        const T* src = take ? p + (size_t)gy * row_len + ge : p;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         vp::smem_u32(s + (size_t)sy * stride + e)),
                     "l"(src), "r"(take ? 4 : 0)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    constexpr int U = 8;
    for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = base + u * blockDim.x;
        const int sy = idx / stride, ge = idx - sy * stride - lead, gy = y_first + sy;
        v[u] = (idx < total && gy >= 0 && gy < H && ge >= 0 && ge < row_len)
                   ? vp::to_float(p[(size_t)gy * row_len + ge])
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * blockDim.x < total) s[base + u * blockDim.x] = v[u];
    }
  }
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// With bulk copies (fp32, 16-byte aligned rows): every thread zeroes what
// lies outside the image, and the lanes of warp 0 copy each image row with
// one cp.async.bulk, completing on `bar`.
__device__ __forceinline__ void zero_outside(float* s, int y_first, int rows, int lead, int stride, int H,
                                             int row_len) {
  for (int sy = 0; sy < rows; ++sy) {
    const int gy = y_first + sy;
    float* row = s + (size_t)sy * stride;
    if (gy < 0 || gy >= H) {
      for (int e = threadIdx.x; e < stride; e += blockDim.x) row[e] = 0.0f;
    } else {
      for (int e = threadIdx.x; e < lead; e += blockDim.x) row[e] = 0.0f;
      for (int e = lead + row_len + threadIdx.x; e < stride; e += blockDim.x) row[e] = 0.0f;
    }
  }
}

__device__ __forceinline__ void bulk_rows(const float* p, float* s, int y_first, int rows, int lead, int stride,
                                          int H, int row_len, uint64_t* bar, int lane) {
  for (int sy = lane; sy < rows; sy += 32) {
    const int gy = y_first + sy;
    if (gy >= 0 && gy < H)
      vp::bulk_load(s + (size_t)sy * stride + lead, p + (size_t)gy * row_len, row_len * 4, bar);
  }
}

// Rows staged in shared memory to device memory with one bulk copy (a
// lane of warp 0 each); called by the whole block after its last write.
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(vp::smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Floats [0, NF) from p, which sits M0 floats past a 16-byte boundary, by
// aligned 16-byte shared memory loads.
template <int NF, int M0>
__device__ __forceinline__ void ld_window(const float* p, float (&v)[NF]) {
  constexpr int NQ = (M0 + NF + 3) / 4;
  const float4* a = reinterpret_cast<const float4*>(p - M0);
  float t[NQ * 4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 f = a[q];
    t[4 * q] = f.x, t[4 * q + 1] = f.y, t[4 * q + 2] = f.z, t[4 * q + 3] = f.w;
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) v[i] = t[M0 + i];
}

// Store RX * CB contiguous outputs: 16-byte (fp32) or 8-byte (bf16) pieces
// where the run is whole and aligned, else one value at a time.
template <typename T, int N_VALUES>
__device__ __forceinline__ void store_run(T* p, const float (&v)[N_VALUES], int valid) {
  if constexpr (sizeof(T) == 4 && N_VALUES % 4 == 0) {
    if (valid == N_VALUES && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int e = 0; e < N_VALUES; e += 4)
        *reinterpret_cast<float4*>(p + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      return;
    }
  }
  if constexpr (sizeof(T) == 2 && N_VALUES % 4 == 0) {
    if (valid == N_VALUES && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
#pragma unroll
      for (int e = 0; e < N_VALUES; e += 4) {
        uint2 u;
        u.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[e])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[e + 1])) << 16);
        u.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[e + 2])) |
              ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[e + 3])) << 16);
        *reinterpret_cast<uint2*>(p + e) = u;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N_VALUES; ++e)
    if (e < valid) p[e] = vp::from_float<T>(v[e]);
}

template <typename T, int CT, int KT, int NT>
__global__ void __launch_bounds__(kMaxThreads)
    cdna_forward_kernel(const T* __restrict__ img, const float* __restrict__ kern, T* __restrict__ out, int H,
                        int W, int c_, int kh_, int kw_, int n_, int tile_rows, int xblocks, int bulk) {
  using D = Dims<CT, KT, NT>;
  constexpr int RX = D::RX, CB = D::CB, NB = D::NB;
  const D d(c_, kh_, kw_, n_);
  const int C = d.C, KH = d.KH, KW = d.KW, N = d.N;
  __shared__ uint64_t bar;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, H - y0);
  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;
  const int taps = KH * KW, row_len = W * C;
  const Layout L(KH, KW, N, C, W, tile_rows, xblocks * RX + KW - 1, 0, N);
  const int stride = L.stride;

  float* wts = smem;                                     // [KH*KW, N]
  float* obuf = smem + L.taps_n;                         // [N, tile_rows, W*C] for the bulk store
  float* tile = plane_at(smem + L.plane_begin(0), pw * C);  // image rows y0-ph.., cols -pw..
  const size_t plane = (size_t)H * row_len;
  const T* ib = img + (size_t)b * plane;
  if constexpr (sizeof(T) == 4) {
    if (bulk) {
      if (threadIdx.x == 0) vp::bar_init(&bar);
      __syncthreads();
      if (threadIdx.x < 32) {
        if (threadIdx.x == 0) vp::bar_expect(&bar, rows_inside(y0 - ph, rows + KH - 1, H) * row_len * 4);
        __syncwarp();
        bulk_rows(ib, tile, y0 - ph, rows + KH - 1, pw * C, stride, H, row_len, &bar, threadIdx.x);
      }
      zero_outside(tile, y0 - ph, rows + KH - 1, pw * C, stride, H, row_len);
    }
  }
  if (!bulk) stage_rows(ib, tile, y0 - ph, rows + KH - 1, pw * C, stride, H, W, C);
  const float* kb = kern + (size_t)b * taps * N;
  for (int i = threadIdx.x; i < taps * N; i += blockDim.x) wts[i] = kb[i];
  if (bulk)
    vp::bar_wait(&bar, 0);
  else
    stage_wait();
  __syncthreads();

  for (int item = threadIdx.x; item < rows * xblocks; item += blockDim.x) {
    const int ty = item / xblocks, x0 = (item % xblocks) * RX;
    for (int n0 = 0; n0 < N; n0 += NB) {
      for (int c0 = 0; c0 < C; c0 += CB) {
        float acc[NB][RX * CB];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < RX * CB; ++e) acc[n][e] = 0.0f;
#pragma unroll
        for (int ki = 0; ki < KH; ++ki) {
          const float* srow = tile + (size_t)(ty + ki) * stride + x0 * C + c0;
          float win[D::WIN];  // the row's window of RX + KW - 1 pixels (specialized)
          if constexpr (CT != 0) ld_window<D::WIN, D::M0>(srow, win);
#pragma unroll
          for (int kj = 0; kj < KW; ++kj) {
            float w[NB];
#pragma unroll
            for (int n = 0; n < NB; ++n) w[n] = wts[(ki * KW + kj) * N + n0 + n];
#pragma unroll
            for (int rx = 0; rx < RX; ++rx)
#pragma unroll
              for (int c = 0; c < CB; ++c) {
                const float v = CT != 0 ? win[(rx + kj) * CB + c] : srow[(rx + kj) * C + c];
#pragma unroll
                for (int n = 0; n < NB; ++n) acc[n][rx * CB + c] = fmaf(w[n], v, acc[n][rx * CB + c]);
              }
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          T* o = bulk ? reinterpret_cast<T*>(obuf + ((size_t)(n0 + n) * tile_rows + ty) * row_len + x0 * C + c0)
                      : out + ((size_t)b * N + n0 + n) * plane + ((size_t)(y0 + ty) * W + x0) * C + c0;
          store_run<T, RX * CB>(o, acc[n], min(RX, W - x0) * CB);  // CB is C or 1
        }
      }
    }
  }
  if constexpr (sizeof(T) == 4) {
    if (bulk) {  // each kernel's rows of the tile are contiguous in `out`
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x < 32) {
        for (int n = threadIdx.x; n < N; n += 32)
          bulk_store(reinterpret_cast<float*>(out) + ((size_t)b * N + n) * plane + (size_t)y0 * row_len,
                     obuf + (size_t)n * tile_rows * row_len, rows * row_len * 4);
        bulk_store_wait();
      }
    }
  }
}

// K1 backward. Replaces the XLA transpose of the JAX package's shifted
// multiply-adds (video_prediction_tpu/ops/cdna.py:apply_cdna_kernels), which
// is what JAX differentiates in training: the Pallas kernel is forward only.
// With g = d out [B,N,H,W,C]:
//
//   d img[b,p,q,c]    = sum_{n,i,j} kern[b,i,j,n] * g[b,n, p-i+ph, q-j+pw, c]
//   d kern[b,i,j,n]   = sum_{y,x,c} g[b,n,y,x,c] * img[b, y+i-ph, x+j-pw, c]
//
// Bound on the H100: memory, like the forward (a sample reads 48 KB of image
// and 4x that of g at the slice's shapes). Design: one block per (sample,
// tile of rows), as in the forward, staging the image tile with its forward
// halo and the N planes of g with the mirrored halo in shared memory. d img
// is the correlation with the flipped taps, RX x positions and C channels a
// thread. d kern is a reduction over the whole sample, so it takes two passes
// instead of atomics (deterministic): the block takes one tap row at a time;
// each thread adds g * image over its (y, x-run) units into KW x N registers,
// each warp sums them with shuffles into its own slot of shared memory, and
// the block adds its warps in order into one partial per (block, tap);
// cdna_kernel_grad_reduce then sums each tap's partials over the row tiles in
// a fixed order.
template <typename T, int CT, int KT, int NT>
__global__ void __launch_bounds__(kMaxThreads)
    cdna_backward_kernel(const T* __restrict__ img, const float* __restrict__ kern, const T* __restrict__ g,
                         T* __restrict__ d_img, float* __restrict__ partial, int H, int W, int c_, int kh_, int kw_,
                         int n_, int tile_rows, int xblocks, int bulk) {
  using D = Dims<CT, KT, NT>;
  constexpr int RX = D::RX, CB = D::CB, NB = D::NB, KJB = D::KJB;
  const D d(c_, kh_, kw_, n_);
  const int C = d.C, KH = d.KH, KW = d.KW, N = d.N;
  __shared__ uint64_t bar;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, H - y0);
  const int ph = (KH - 1) / 2, pw = (KW - 1) / 2;
  const int gh = KH - 1 - ph, gw = KW - 1 - pw;  // g's halo before the tile
  const int taps = KH * KW, M = taps * N, row_len = W * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, nwarps = blockDim.x / 32;
  const Layout L(KH, KW, N, C, W, tile_rows, xblocks * RX + KW - 1, nwarps, 1);
  const int stride = L.stride;

  float* wts = smem;                  // [KH*KW, N]
  float* wsum = smem + L.taps_n;      // [nwarps, KH*KW*N] d kern sums of each warp
  float* obuf = wsum + L.wsum;        // [tile_rows, W*C] d img for the bulk store
  float* itile = plane_at(smem + L.plane_begin(0), pw * C);  // image rows y0-ph.., cols -pw..
  float* gtile = plane_at(smem + L.plane_begin(1), gw * C);  // [N planes of L.plane]: g rows y0-gh.., cols -gw..

  const size_t plane = (size_t)H * row_len;
  const int srows = rows + KH - 1;
  if constexpr (sizeof(T) == 4) {
    if (bulk) {
      if (threadIdx.x == 0) vp::bar_init(&bar);
      __syncthreads();
      if (warp == 0) {
        if (lane == 0)
          vp::bar_expect(&bar, (rows_inside(y0 - ph, srows, H) + N * rows_inside(y0 - gh, srows, H)) * row_len * 4);
        __syncwarp();
        bulk_rows(img + (size_t)b * plane, itile, y0 - ph, srows, pw * C, stride, H, row_len, &bar, lane);
        for (int n = 0; n < N; ++n)
          bulk_rows(g + ((size_t)b * N + n) * plane, gtile + n * L.plane, y0 - gh, srows, gw * C, stride, H, row_len, &bar, lane);
      }
      zero_outside(itile, y0 - ph, srows, pw * C, stride, H, row_len);
      for (int n = 0; n < N; ++n) zero_outside(gtile + n * L.plane, y0 - gh, srows, gw * C, stride, H, row_len);
    }
  }
  if (!bulk) {
    stage_rows(img + (size_t)b * plane, itile, y0 - ph, srows, pw * C, stride, H, W, C);
    for (int n = 0; n < N; ++n) stage_rows(g + ((size_t)b * N + n) * plane, gtile + n * L.plane, y0 - gh, srows, gw * C, stride, H, W, C);
  }
  const float* kb = kern + (size_t)b * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) wts[i] = kb[i];
  if (bulk)
    vp::bar_wait(&bar, 0);
  else
    stage_wait();
  __syncthreads();

  // d img: image pixel (p, q) collects g at (p-i+ph, q-j+pw) = gtile row
  // (p-y0) + (KH-1-i), col q + (KW-1-j)
  for (int item = threadIdx.x; item < rows * xblocks; item += blockDim.x) {
    const int ty = item / xblocks, x0 = (item % xblocks) * RX;
    for (int c0 = 0; c0 < C; c0 += CB) {
      float acc[RX * CB];
#pragma unroll
      for (int e = 0; e < RX * CB; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int ki = 0; ki < KH; ++ki) {
          const float* grow = gtile + n * L.plane + (size_t)(ty + KH - 1 - ki) * stride + x0 * C + c0;
          float win[D::WIN];
          if constexpr (CT != 0) ld_window<D::WIN, D::M0>(grow, win);
#pragma unroll
          for (int kj = 0; kj < KW; ++kj) {
            const float w = wts[(ki * KW + kj) * N + n];
#pragma unroll
            for (int rx = 0; rx < RX; ++rx)
#pragma unroll
              for (int c = 0; c < CB; ++c) {
                const int e = (rx + KW - 1 - kj) * CB + c;
                acc[rx * CB + c] = fmaf(w, CT != 0 ? win[e] : grow[(rx + KW - 1 - kj) * C + c], acc[rx * CB + c]);
              }
          }
        }
      }
      T* o = bulk ? reinterpret_cast<T*>(obuf + (size_t)ty * row_len + x0 * C + c0)
                  : d_img + (size_t)b * plane + ((size_t)(y0 + ty) * W + x0) * C + c0;
      store_run<T, RX * CB>(o, acc, min(RX, W - x0) * CB);
    }
  }

  // d kern, one tap row (and, at run-time sizes, one tap and one kernel) at a
  // time: g (y, x) sits at gtile row y + gh, col x + gw; the image value it
  // multiplies at tap (ki, kj) at itile row y + ki, col x + kj
  const int cunits = C / CB, units = rows * xblocks * cunits;
  for (int ki = 0; ki < KH; ++ki) {
    for (int kj0 = 0; kj0 < KW; kj0 += KJB) {
      for (int n0 = 0; n0 < N; n0 += NB) {
        float acc[KJB][NB];
#pragma unroll
        for (int j = 0; j < KJB; ++j)
#pragma unroll
          for (int n = 0; n < NB; ++n) acc[j][n] = 0.0f;
        for (int u = threadIdx.x; u < units; u += blockDim.x) {
          const int c0 = (u % cunits) * CB, t = u / cunits;
          const int ty = t / xblocks, x0 = (t % xblocks) * RX;
          const float* irow = itile + (size_t)(ty + ki) * stride + (x0 + kj0) * C + c0;
          if constexpr (CT != 0) {  // windows by 16-byte loads; the g run of RX pixels is 16-byte aligned
            float iwin[D::WIN];
            ld_window<D::WIN, D::M0>(irow, iwin);
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              float gwin[RX * CB];
              ld_window<RX * CB, 0>(gtile + n * L.plane + (size_t)(ty + gh) * stride + (x0 + gw) * C, gwin);
#pragma unroll
              for (int c = 0; c < CB; ++c)
#pragma unroll
                for (int rx = 0; rx < RX; ++rx)
#pragma unroll
                  for (int j = 0; j < KJB; ++j)
                    acc[j][n] = fmaf(gwin[rx * CB + c], iwin[(rx + j) * CB + c], acc[j][n]);
            }
          } else {  // one x, one channel, one tap, one kernel
            const float* grow = gtile + n0 * L.plane + (size_t)(ty + gh) * stride + (x0 + gw) * C + c0;
            acc[0][0] = fmaf(grow[0], irow[0], acc[0][0]);
          }
        }
#pragma unroll
        for (int j = 0; j < KJB; ++j)
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float v = vp::warp_sum(acc[j][n]);
            if (lane == 0) wsum[warp * M + (ki * KW + kj0 + j) * N + n0 + n] = v;
          }
      }
    }
  }
  if constexpr (sizeof(T) == 4)
    if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float* pb = partial + ((size_t)b * gridDim.x + blockIdx.x) * M;
  for (int o = threadIdx.x; o < M; o += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < nwarps; ++w) acc += wsum[w * M + o];  // warps in order: deterministic
    pb[o] = acc;
  }
  if constexpr (sizeof(T) == 4) {
    if (bulk && warp == 0) {  // the tile's rows of d img are contiguous
      if (lane == 0)
        bulk_store(reinterpret_cast<float*>(d_img) + (size_t)b * plane + (size_t)y0 * row_len, obuf,
                   rows * row_len * 4);
      bulk_store_wait();
    }
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

// ---------------------------------------------------------------------------
// host side

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Tiling of a call: rows a tile, x runs a row, threads, dynamic shared memory.
struct Tiling {
  int tile_rows = 0, xblocks = 0, threads = 0;
  size_t smem = 0;
  int tiles(int H) const { return vp::ceil_div(H, tile_rows); }
};

// The tallest tile (up to 32 rows) that fits the shared memory and still
// gives two blocks per SM (so that one block's staging overlaps another's
// arithmetic), else the shortest that fits.
Tiling plan_tiles(bool backward, bool specialized, int B, int H, int W, int C, int KH, int KW, int N, int device) {
  Tiling best;
  int sms = 0, optin = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return best;
  const int rx = specialized ? kRx : 1;
  const int xblocks = vp::ceil_div(W, rx);
  const int SW = xblocks * rx + KW - 1;
  for (int tr = 32; tr >= 1; tr /= 2) {
    if (tr > H && tr / 2 >= H) continue;  // the same tile as a shorter candidate
    const int rows = std::min(tr, H);
    const int threads = std::min(kMaxThreads, std::max(32, vp::ceil_div(rows * xblocks, 32) * 32));
    const Layout L(KH, KW, N, C, W, rows, SW, backward ? threads / 32 : 0, backward ? 1 : N);
    const size_t smem = L.bytes(backward ? 1 + N : 1);
    if (smem + sizeof(uint64_t) > (size_t)optin) continue;
    best = Tiling{rows, xblocks, threads, smem};
    if ((long long)B * vp::ceil_div(H, rows) >= 2LL * sms) break;
  }
  return best;
}

template <typename T, int CT, int KT, int NT>
cudaError_t launch_forward(const void* img, const void* kern, void* out, int B, int H, int W, int C, int KH, int KW,
                           int N, int device, cudaStream_t stream) {
  const Tiling t = plan_tiles(false, CT != 0, B, H, W, C, KH, KW, N, device);
  if (t.tile_rows == 0) return cudaErrorInvalidValue;
  auto kernel = cdna_forward_kernel<T, CT, KT, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  const int bulk = sizeof(T) == 4 && (W * C) % 4 == 0 && aligned16(img) && aligned16(out);
  kernel<<<dim3(t.tiles(H), B), t.threads, t.smem, stream>>>(static_cast<const T*>(img),
                                                             static_cast<const float*>(kern), static_cast<T*>(out),
                                                             H, W, C, KH, KW, N, t.tile_rows, t.xblocks, bulk);
  return cudaGetLastError();
}

template <typename T, int CT, int KT, int NT>
cudaError_t launch_backward(const void* img, const void* kern, const void* g, void* d_img, void* d_kern,
                            void* partial, int B, int H, int W, int C, int KH, int KW, int N, int tiles, int device,
                            cudaStream_t stream) {
  const Tiling t = plan_tiles(true, CT != 0, B, H, W, C, KH, KW, N, device);
  if (t.tile_rows == 0 || t.tiles(H) != tiles) return cudaErrorInvalidValue;
  auto kernel = cdna_backward_kernel<T, CT, KT, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  const int bulk = sizeof(T) == 4 && (W * C) % 4 == 0 && aligned16(img) && aligned16(g) && aligned16(d_img);
  kernel<<<dim3(tiles, B), t.threads, t.smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(kern), static_cast<const T*>(g), static_cast<T*>(d_img),
      static_cast<float*>(partial), H, W, C, KH, KW, N, t.tile_rows, t.xblocks, bulk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = KH * KW * N;
  cdna_kernel_grad_reduce<<<vp::ceil_div(B * M, kMaxThreads), kMaxThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(d_kern), B, tiles, M);
  return cudaGetLastError();
}

// The flagship's shape (C=3, 5x5, N=4) has its own instantiation.
bool flagship(int C, int KH, int KW, int N) { return C == 3 && KH == 5 && KW == 5 && N == 4; }

}  // namespace

// Row tiles of the backward for these sizes on `device` (the wrapper sizes
// the partial scratch [B, tiles, KH*KW*N] fp32 from it); 0 if even one row
// does not fit the shared memory.
VP_EXPORT int vp_cdna_backward_tiles(int B, int H, int W, int C, int KH, int KW, int N, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const Tiling t = plan_tiles(true, flagship(C, KH, KW, N), B, H, W, C, KH, KW, N, device);
  return t.tile_rows == 0 ? 0 : t.tiles(H);
}

// img [B,H,W,C], g [B,N,H,W,C], d_img [B,H,W,C] (dtype); kern, d_kern [B,KH,KW,N]
// and partial [B,tiles,KH*KW*N] fp32; all contiguous.
VP_EXPORT int vp_cdna_backward(const void* img, const void* kern, const void* g, void* d_img, void* d_kern,
                               void* partial, int B, int H, int W, int C, int KH, int KW, int N, int tiles, int dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = flagship(C, KH, KW, N);
#define VP_CDNA_BWD(T, CT, KT, NT) \
  launch_backward<T, CT, KT, NT>(img, kern, g, d_img, d_kern, partial, B, H, W, C, KH, KW, N, tiles, device, s)
  if (dtype == vp::kFloat32) return f ? VP_CDNA_BWD(float, 3, 5, 4) : VP_CDNA_BWD(float, 0, 0, 0);
  if (dtype == vp::kBFloat16) return f ? VP_CDNA_BWD(__nv_bfloat16, 3, 5, 4) : VP_CDNA_BWD(__nv_bfloat16, 0, 0, 0);
#undef VP_CDNA_BWD
  return cudaErrorInvalidValue;
}

// img [B,H,W,C] (dtype), kern [B,KH,KW,N] fp32, out [B,N,H,W,C] (dtype); all contiguous.
VP_EXPORT int vp_cdna_forward(const void* img, const void* kern, void* out, int B, int H, int W,
                              int C, int KH, int KW, int N, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = flagship(C, KH, KW, N);
#define VP_CDNA_FWD(T, CT, KT, NT) launch_forward<T, CT, KT, NT>(img, kern, out, B, H, W, C, KH, KW, N, device, s)
  if (dtype == vp::kFloat32) return f ? VP_CDNA_FWD(float, 3, 5, 4) : VP_CDNA_FWD(float, 0, 0, 0);
  if (dtype == vp::kBFloat16) return f ? VP_CDNA_FWD(__nv_bfloat16, 3, 5, 4) : VP_CDNA_FWD(__nv_bfloat16, 0, 0, 0);
#undef VP_CDNA_FWD
  return cudaErrorInvalidValue;
}
