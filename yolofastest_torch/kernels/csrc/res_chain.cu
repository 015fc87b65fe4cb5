// Fused chain of K inverted-residual blocks, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of yolofastest_tpu/kernels/res_block.py:
//   _chain_kernel       (launched by fused_res_chain_cf):   x is a channels-first
//                       plane (C, B*H*W);
//   _chain_rows_kernel  (launched by fused_res_chain_rows): x is a row-major
//                       plane (B*H*W, C), i.e. NHWC memory.
// Both compute the same function, so here they are ONE templated body with two
// index maps: element (pixel p, channel c) lives at p*pix_stride + c*ch_stride,
// with (pix_stride, ch_stride) = (1, B*H*W) channels-first and (C, 1) row-major.
//
// For each block k of the chain (weights stacked on a leading K axis):
//   h1 = relu(x . W1[k] + b1[k])                 1x1 expand, C -> I, rounded to T
//   h2 = relu(dw3x3(h1; W2[k]) + b2[k])          zero padding at EVERY image border
//                                                for EVERY block, rounded to T
//   y  = (h2 . W3[k] + b3[k]) + x                1x1 project + residual, rounded to T
// Sums are kept in fp32; T is float or bf16.  Weights arrive in T, biases in fp32
// (the Pallas wrappers' casts, res_block.py:143-146).
//
// What bounds it on this card: per pixel the chain does K*(4*C*I + 18*I) flops
// and has to move only 2*C values (read x, write y).  For the six YOLO-Fastest
// chains that is 8-600 flops per byte, so every chain but res1_1 is bound by
// arithmetic (the card's 67 TFLOP/s of fp32 FMA outside the tensor cores),
// and layer-by-layer code, which moves K*(2C+4I) values per pixel, would be
// bound by bytes instead.
//
// What the design does about it: the chain runs in ONE launch and nothing but
// x and y touches device memory.  A thread block owns a spatial tile of one
// image plus a K-pixel halo, which it recomputes: the region a block works on
// shrinks by one pixel per block, and every region is clipped to the image, so
// halo pixels outside the image are never computed and the 3x3 taps there are
// skipped (zero padding by (y, x) coordinates, as the Pallas masks do).  The
// x and y planes of the region live in shared memory as fp32; the I-wide
// expanded activation is taken kChunk channels at a time (the depthwise is per
// channel, so the projection accumulates over chunks).  Plain FMA loops: the
// tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // inner channels per pass (CHUNK in res_block.py)
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
};

// Round an fp32 value to T and back: the kernel's rounding points.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(Cvt<T>::from(v));
}

struct ChainArgs {
  const void* x;
  void* out;
  const void* w1;  // (K, C, I) in T
  const float* b1;  // (K, I)
  const void* w2;  // (K, 3, 3, I) in T
  const float* b2;  // (K, I)
  const void* w3;  // (K, I, C) in T
  const float* b3;  // (K, C)
  int B, H, W, C, I, K;
  int tile_h, tile_w, tiles_w, n_tiles;
  int plane_w, plane;  // shared-memory plane: row stride and channel stride
  long long ch_stride, pix_stride;
};

// Shared memory: x plane (C), y plane (C) and one chunk of h1 (kChunk), each
// `plane` floats.  `plane` is odd so that a warp walking channels does not hit
// one bank.
__host__ __device__ inline int plane_floats(int plane_h, int plane_w) {
  return (plane_h * plane_w) | 1;
}

template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads) res_chain_kernel(ChainArgs a) {
  extern __shared__ float smem[];
  const int plane = a.plane;
  float* xs = smem;
  float* ys = xs + a.C * plane;
  float* h1s = ys + a.C * plane;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  const T* __restrict__ w1 = static_cast<const T*>(a.w1);
  const T* __restrict__ w2 = static_cast<const T*>(a.w2);
  const T* __restrict__ w3 = static_cast<const T*>(a.w3);

  const int b = blockIdx.x / a.n_tiles;
  const int tile = blockIdx.x % a.n_tiles;
  const int ty0 = (tile / a.tiles_w) * a.tile_h;
  const int tx0 = (tile % a.tiles_w) * a.tile_w;
  const int ty1 = min(ty0 + a.tile_h, a.H);
  const int tx1 = min(tx0 + a.tile_w, a.W);
  // Origin of the shared planes: the top-left corner of block 0's input region.
  const int py0 = max(ty0 - a.K, 0);
  const int px0 = max(tx0 - a.K, 0);
  const long long img0 = (long long)b * a.H * a.W;

  // Load x on block 0's input region (the tile plus a K-pixel halo, clipped to
  // the image).  Neighbouring threads take neighbouring addresses: channels in
  // the row-major layout, pixels in the channels-first one.
  {
    const int y1 = min(ty1 + a.K, a.H), x1 = min(tx1 + a.K, a.W);
    const int rw = x1 - px0, n = (y1 - py0) * rw;
    for (int idx = threadIdx.x; idx < n * a.C; idx += kThreads) {
      const int c = kRows ? idx % a.C : idx / n;
      const int p = kRows ? idx / a.C : idx % n;
      const int yy = py0 + p / rw, xx = px0 + p % rw;
      const long long g = (img0 + (long long)yy * a.W + xx) * a.pix_stride + c * a.ch_stride;
      xs[c * plane + (yy - py0) * a.plane_w + (xx - px0)] = to_f(x[g]);
    }
  }
  __syncthreads();

  for (int k = 0; k < a.K; ++k) {
    // Block k reads its input on the tile + (K-k) halo and writes its output
    // on the tile + (K-k-1) halo, both clipped to the image.
    const int hin = a.K - k, hout = hin - 1;
    const int iy0 = max(ty0 - hin, 0), ix0 = max(tx0 - hin, 0);
    const int iy1 = min(ty1 + hin, a.H), ix1 = min(tx1 + hin, a.W);
    const int oy0 = max(ty0 - hout, 0), ox0 = max(tx0 - hout, 0);
    const int oy1 = min(ty1 + hout, a.H), ox1 = min(tx1 + hout, a.W);
    const int irw = ix1 - ix0, in_n = (iy1 - iy0) * irw;
    const int orw = ox1 - ox0, out_n = (oy1 - oy0) * orw;
    const T* w1k = w1 + (size_t)k * a.C * a.I;
    const float* b1k = a.b1 + (size_t)k * a.I;
    const T* w2k = w2 + (size_t)k * 9 * a.I;
    const float* b2k = a.b2 + (size_t)k * a.I;
    const T* w3k = w3 + (size_t)k * a.I * a.C;
    const float* b3k = a.b3 + (size_t)k * a.C;

    for (int i0 = 0; i0 < a.I; i0 += kChunk) {
      const int ic = min(kChunk, a.I - i0);
      // h1 for this chunk on the input region: one thread per pixel.
      for (int p = threadIdx.x; p < in_n; p += kThreads) {
        const int so = (iy0 + p / irw - py0) * a.plane_w + (ix0 + p % irw - px0);
        float acc[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
        for (int c = 0; c < a.C; ++c) {
          const float xv = xs[c * plane + so];
          const T* wr = w1k + (size_t)c * a.I + i0;
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            if (j < ic) acc[j] = fmaf(xv, to_f(wr[j]), acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < ic) h1s[j * plane + so] = round_to<T>(fmaxf(acc[j] + b1k[i0 + j], 0.f));
      }
      __syncthreads();

      // h2 for this chunk on the output region, then its share of the
      // projection, accumulated into the y plane: one thread per pixel, so the
      // read-modify-write of y is the thread's own.
      for (int p = threadIdx.x; p < out_n; p += kThreads) {
        const int yy = oy0 + p / orw, xx = ox0 + p % orw;
        const int so = (yy - py0) * a.plane_w + (xx - px0);
        float h2[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          h2[j] = 0.f;
          if (j < ic) {
            float acc = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const int sy = yy + dy - 1;
              if (sy < 0 || sy >= a.H) continue;  // zero padding: skip the tap
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int sx = xx + dx - 1;
                if (sx < 0 || sx >= a.W) continue;
                acc = fmaf(h1s[j * plane + so + (dy - 1) * a.plane_w + (dx - 1)],
                           to_f(w2k[(dy * 3 + dx) * a.I + i0 + j]), acc);
              }
            }
            h2[j] = round_to<T>(fmaxf(acc + b2k[i0 + j], 0.f));
          }
        }
        for (int c = 0; c < a.C; ++c) {
          float acc = i0 == 0 ? 0.f : ys[c * plane + so];
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            if (j < ic) acc = fmaf(h2[j], to_f(w3k[(size_t)(i0 + j) * a.C + c]), acc);
          ys[c * plane + so] = acc;
        }
      }
      __syncthreads();
    }

    // y = (h2 . W3 + b3) + x, rounded to T: the next block's input.
    for (int p = threadIdx.x; p < out_n; p += kThreads) {
      const int so = (oy0 + p / orw - py0) * a.plane_w + (ox0 + p % orw - px0);
      for (int c = 0; c < a.C; ++c) {
        const int o = c * plane + so;
        ys[o] = round_to<T>((ys[o] + b3k[c]) + xs[o]);
      }
    }
    __syncthreads();
    float* t = xs;
    xs = ys;
    ys = t;
  }

  // After the last block the output region is the tile itself.
  {
    const int rw = tx1 - tx0, n = (ty1 - ty0) * rw;
    for (int idx = threadIdx.x; idx < n * a.C; idx += kThreads) {
      const int c = kRows ? idx % a.C : idx / n;
      const int p = kRows ? idx / a.C : idx % n;
      const int yy = ty0 + p / rw, xx = tx0 + p % rw;
      const long long g = (img0 + (long long)yy * a.W + xx) * a.pix_stride + c * a.ch_stride;
      out[g] = Cvt<T>::from(xs[c * plane + (yy - py0) * a.plane_w + (xx - px0)]);
    }
  }
}

// Shared memory a launch with this tile needs, in bytes (smem_bytes in
// res_block.py, which picks the tile).
long long smem_bytes(int H, int W, int C, int K, int tile_h, int tile_w) {
  const int plane_h = tile_h + 2 * K < H ? tile_h + 2 * K : H;
  const int plane_w = tile_w + 2 * K < W ? tile_w + 2 * K : W;
  return (long long)sizeof(float) * (2 * C + kChunk) * plane_floats(plane_h, plane_w);
}

template <typename T, bool kRows>
cudaError_t launch(const ChainArgs& a, int smem, cudaStream_t stream) {
  auto kern = res_chain_kernel<T, kRows>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<a.n_tiles * a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inner channels per pass; the Python side checks that it agrees.
int yf_res_chain_chunk() { return kChunk; }

// Run a K-block chain.  dtype: 0 = float32, 1 = bfloat16.  rows: 1 for the
// row-major (B*H*W, C) layout, 0 for channels-first (C, B*H*W).  out must not
// alias x.  Returns a cudaError_t: 0 when the launch was accepted.
int yf_res_chain(int dtype, int rows, const void* x, void* out, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3, const void* b3, int B, int H, int W,
                 int C, int I, int K, int tile_h, int tile_w, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || I < 1 || K < 1 || tile_h < 1 || tile_w < 1 ||
      tile_h > H || tile_w > W || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(H, W, C, K, tile_h, tile_w);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.x = x;
  a.out = out;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.w3 = w3;
  a.b3 = static_cast<const float*>(b3);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.I = I;
  a.K = K;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.tiles_w = (W + tile_w - 1) / tile_w;
  a.n_tiles = ((H + tile_h - 1) / tile_h) * a.tiles_w;
  a.plane_w = tile_w + 2 * K < W ? tile_w + 2 * K : W;
  const int plane_h = tile_h + 2 * K < H ? tile_h + 2 * K : H;
  a.plane = plane_floats(plane_h, a.plane_w);
  if ((long long)a.n_tiles * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.pix_stride = rows ? C : 1;
  a.ch_stride = rows ? 1 : (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = rows ? launch<float, true>(a, (int)smem, s) : launch<float, false>(a, (int)smem, s);
  else
    e = rows ? launch<__nv_bfloat16, true>(a, (int)smem, s)
             : launch<__nv_bfloat16, false>(a, (int)smem, s);
  return (int)e;
}

const char* yf_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
