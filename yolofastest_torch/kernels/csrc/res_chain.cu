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
// Only the loads of x and the stores of y use the map; everything between runs
// on the same shared-memory planes, so the two layouts give the same bits.
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
// and has to move only 2*C values (read x, write y).  The two 1x1 products are
// 77-92% of those flops and map onto the tensor cores; the depthwise (18*I per
// pixel) runs on the CUDA cores.  So every chain but res1_1 is bound by
// operations, and by latency where a plane is too small to fill 132 SMs.
//
// What the design does about it:
// * One launch per chain; nothing but x and y touches device memory.  A thread
//   block owns a spatial tile of one image plus a K-pixel halo, which it
//   recomputes: the region shrinks by one pixel per block, every region is
//   clipped to the image, and a 3x3 tap outside the image reads zero (zero
//   padding by (y, x) coordinates, as the Pallas masks do).
// * The work unit is an mma tile, not a pixel.  In the expand a warp takes a
//   16-pixel row tile with all the chunk's 8-channel tiles, so one A fragment
//   feeds up to four independent products.  Both 1x1 products run on the
//   tensor cores with mma.sync: bf16 as m16n8k16 (bf16 in, fp32 sums: the
//   plain version's rounding points exactly), fp32 as 3xTF32 m16n8k8 (each
//   operand split as tf32(a) + tf32(a - tf32(a)), three products, each step's
//   sums added to the running ones with round-to-nearest on the CUDA cores),
//   which keeps the kernel about as close to exact arithmetic as the plain
//   fp32 version.  mma.sync and not wgmma: the products are
//   narrow (depth C = 4..48, N = 8..48) on regions of 40-600 pixels, so a
//   64-row warpgroup tile would idle most of its rows, and mma.sync lets eight
//   warps each take 16-pixel tiles of a region as small as res5's 80 pixels.
// * Projection sums stay in registers: warp w owns the output region's 16-pixel
//   row tiles w, w+8, ..., whose C fragments it keeps across all inner chunks of
//   block k; they are written once per block, with bias, residual and rounding,
//   in place over x (y at a pixel needs x only at that pixel).
// * The depthwise runs on the CUDA cores, one channel per lane: a thread takes
//   kRun pixels of a row down kSeg rows, sliding a 3-row window, so one h1
//   value read from shared memory feeds up to nine taps; the channel's 9 taps
//   and bias sit in registers.
// * The weights of each inner chunk (W1[:, chunk], W2[..., chunk], W3[chunk, :],
//   b1, b2), zero-padded to mma multiples, are staged with cp.async (16, 8 or 4
//   bytes a copy, as the widths and addresses allow) into one of two buffers
//   while the previous chunk computes: the next chunk's (or the next block's
//   first chunk's) weights load during this chunk's three phases.  The x region
//   loads (16-byte cp.async for fp32) and y stores four channels at a time
//   where the row-major layout allows.
// * Tiles are picked on the host (res_block.py pick_tile) from the batch and
//   the SM count so that small planes still fill the card; two blocks of 256
//   threads (<= 128 registers, <= 113 KB shared memory) fit one SM.  Where
//   even so there are fewer than two blocks per SM (res5, whose halo covers
//   the whole 8x10 plane: one block per image), a thread-block cluster of 2 or
//   4 CTAs shares each tile: every CTA holds the x plane, takes every 2nd or
//   4th inner chunk, and the partial projections are summed once per block
//   through distributed shared memory.
// Zero padding of ragged widths (C = 4, I = 20, 136, ...) is in shared memory;
// tails read only zeros or valid pixels (row tiles clamp to the region's last
// pixel, whose results are discarded).
//
// The guards SKIP_STAGE, SKIP_EXPAND, SKIP_DW and SKIP_PROJ each compile one
// phase of the chunk loop out, for tools/torch_chain_phases.py, which times the
// kernel phase by phase; such a build computes wrong values.  The library the
// port loads defines none of them.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32;      // inner channels per chunk: 16 or 32
constexpr int kRun = 4;            // depthwise: pixels of a row per thread ...
constexpr int kSeg = 4;            // ... down kSeg rows, sliding a 3-row window
constexpr int kAccTiles = 8;       // projection accumulators per warp: (16 x 8) tiles
constexpr int kSmemBudget = 113 * 1024;  // two blocks per SM (228 KB, 1 KB each reserved)

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 8-channel output tiles of the projection for a block width C (0: too wide).
__host__ __device__ constexpr int proj_tiles(int C) {
  return C <= 8 ? 1 : C <= 16 ? 2 : C <= 24 ? 3 : C <= 48 ? 6 : 0;
}
// Row length of a staged weight matrix of n columns: a B-fragment load
// (rows tig, columns g) then hits 32 distinct banks.
__host__ __device__ constexpr int weight_ld(int n) { return n % 16 == 8 ? n : n + 8; }

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

// ------------------------------------------------------------ async copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ mma fragments
// Lane l of a warp has g = l / 4 and t = l % 4.  For an m16n8 product the C
// fragment is c0, c1 = C[g][2t, 2t+1] and c2, c3 = C[g+8][2t, 2t+1].
template <typename T>
struct Frag;

// fp32 as 3xTF32, m16n8k8: A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// B[t][g], B[t+4][g].
template <>
struct Frag<float> {
  static constexpr int kK = 8;  // mma depth
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };
  static __device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(v - __uint_as_float(big)));
  }
  // lo, hi: rows g and g+8 of A at the step's first column (fp32 in shared memory)
  static __device__ __forceinline__ A load_a(const float* lo, const float* hi, int t) {
    A a;
    split(lo[t], a.big[0], a.small[0]);
    split(hi[t], a.big[1], a.small[1]);
    split(lo[t + 4], a.big[2], a.small[2]);
    split(hi[t + 4], a.big[3], a.small[3]);
    return a;
  }
  // w: B at (first row of the step, first column of the tile), rows ld apart
  static __device__ __forceinline__ B load_b(const float* w, int ld, int t, int g) {
    B b;
    split(w[t * ld + g], b.big[0], b.small[0]);
    split(w[(t + 4) * ld + g], b.big[1], b.small[1]);
    return b;
  }
  static __device__ __forceinline__ void mma1(float* d, const uint32_t* a, const uint32_t* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // d += A.B.  The tensor cores add into their accumulator with truncation,
  // so a long chain of mma into d drifts: on the card, chains of K=5 blocks
  // came out 2.5-4x further from float64 than the plain fp32 version.  So the
  // two small cross terms and the big product each start from zero (one
  // truncation of at most eight exact products) and reach d by round-to-nearest
  // adds on the CUDA cores, which keeps the kernel as close to float64 as the
  // plain version is.
  static __device__ __forceinline__ void mma(float* d, const A& a, const B& b) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, p[4] = {0.f, 0.f, 0.f, 0.f};
    mma1(s, a.small, b.big);
    mma1(s, a.big, b.small);
    mma1(p, a.big, b.big);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += p[e] + s[e];
  }
};

// bf16, m16n8k16: A registers hold pairs (A[g][2t, 2t+1]), (A[g+8][2t, 2t+1]),
// (A[g][2t+8, 2t+9]), (A[g+8][2t+8, 2t+9]); B holds (B[2t, 2t+1][g]),
// (B[2t+8, 2t+9][g]); the lower column or row in the lower half.
template <>
struct Frag<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact: the values are bf16 already
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ A load_a(const float* lo, const float* hi, int t) {
    const float2 a0 = *reinterpret_cast<const float2*>(lo + 2 * t);
    const float2 a1 = *reinterpret_cast<const float2*>(hi + 2 * t);
    const float2 a2 = *reinterpret_cast<const float2*>(lo + 2 * t + 8);
    const float2 a3 = *reinterpret_cast<const float2*>(hi + 2 * t + 8);
    return A{{pack(a0.x, a0.y), pack(a1.x, a1.y), pack(a2.x, a2.y), pack(a3.x, a3.y)}};
  }
  static __device__ __forceinline__ B load_b(const __nv_bfloat16* w, int ld, int t, int g) {
    return B{{pack(w[2 * t * ld + g], w[(2 * t + 1) * ld + g]),
              pack(w[(2 * t + 8) * ld + g], w[(2 * t + 9) * ld + g])}};
  }
  static __device__ __forceinline__ void mma(float* d, const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

// ------------------------------------------------------------ layout
// Shared memory of one block, all in bytes from the base (smem_bytes in
// res_block.py computes the same total):
//   xs   plane of x (then y, in place): plane pixels x cs floats
//   h1s  one chunk of h1 on the same plane: plane pixels x hs floats
//   h2s  one chunk of h2 on block 0's output region, compact: pixels x hs2 floats
//   ps   in a cluster: this CTA's partial projection sums, pixels x C floats
//   two weight buffers: W1 (cp x ldw1), W3 (nc x ldw3), W2 (9 x nc) in T,
//   b1, b2 (nc) in fp32
struct Layout {
  int cp;             // C padded to the mma depth (8 fp32, 16 bf16)
  int cn;             // C padded to the projection's 8-column tiles
  int cs, hs, hs2;    // floats per pixel of xs, h1s, h2s
  int ldw1, ldw3;     // elements per row of the staged W1 and W3
  int off_h1, off_h2, off_ps, off_w;  // byte offsets of h1s, h2s, ps and the weight buffers
  int w_w3, w_w2, w_b1, w_b2;    // byte offsets inside one weight buffer
  int w_bytes;                   // bytes of one weight buffer
  long long bytes;               // total
};

long long r16(long long v) { return (v + 15) / 16 * 16; }

Layout make_layout(int itemsize, int H, int W, int C, int K, int tile_h, int tile_w, int nc,
                   int cluster) {
  Layout L;
  const int ks = itemsize == 4 ? 8 : 16, pad = itemsize == 4 ? 4 : 8;
  L.cp = round_up(C, ks);
  L.cn = 8 * proj_tiles(C);
  L.cs = L.cp + pad;
  // h1 rows: nc + 8 floats makes the expand's float2 stores conflict-free; at
  // nc = 16 the depthwise's two half-warps read pixels kRun apart, which
  // nc + 4 puts 16 banks apart instead of on the same banks.
  L.hs = nc == 16 ? nc + 4 : nc + 8;
  L.hs2 = nc + pad;
  L.ldw1 = weight_ld(nc);
  L.ldw3 = weight_ld(L.cn);
  const long long ph = tile_h + 2 * K < H ? tile_h + 2 * K : H;
  const long long pw = tile_w + 2 * K < W ? tile_w + 2 * K : W;
  const long long oh = tile_h + 2 * (K - 1) < H ? tile_h + 2 * (K - 1) : H;
  const long long ow = tile_w + 2 * (K - 1) < W ? tile_w + 2 * (K - 1) : W;
  long long o = r16(4 * ph * pw * L.cs);
  L.off_h1 = (int)o;
  o += r16(4 * ph * pw * L.hs);
  L.off_h2 = (int)o;
  o += r16(4 * oh * ow * L.hs2);
  L.off_ps = (int)o;
  if (cluster > 1) o += r16(4 * oh * ow * C);
  L.off_w = (int)o;
  long long w = r16((long long)itemsize * L.cp * L.ldw1);
  L.w_w3 = (int)w;
  w += r16((long long)itemsize * nc * L.ldw3);
  L.w_w2 = (int)w;
  w += r16((long long)itemsize * 9 * nc);
  L.w_b1 = (int)w;
  w += r16(4LL * nc);
  L.w_b2 = (int)w;
  w += r16(4LL * nc);
  L.w_bytes = (int)w;
  L.bytes = o + 2 * w;
  return L;
}

// Elements per cp.async for rows of `n` elements of `itemsize` bytes at
// address bits `ptr`: the widest of 16, 8 and 4 bytes that divides the row
// and the address (every chunk starts at a multiple of 16 elements); 0 where
// none does, and the copy goes by plain loads.
int copy_unit(int n, uintptr_t ptr, int itemsize) {
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    const int unit = bytes / itemsize;
    if (n % unit == 0 && ptr % bytes == 0) return unit;
  }
  return 0;
}

// Pixels a block's output region may hold: the projection's row tiles per warp.
constexpr int max_out_pixels(int C) {
  return proj_tiles(C) ? 16 * kWarps * (kAccTiles / proj_tiles(C) > 0 ? kAccTiles / proj_tiles(C) : 1)
                       : 0;
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
  int plane_w;      // row stride (pixels) of the shared planes
  int nc, n_chunks;  // inner channels per chunk (16 or 32) and chunks per block
  int cluster;       // CTAs per tile, splitting its chunks (1, 2 or 4)
  int x_vec, y_vec;  // row-major x loads and y stores go four channels at a time
  int unit_i, unit_c, unit_b;  // elements per cp.async of W1 and W2, W3, biases (0: plain)
  long long ch_stride, pix_stride;
  Layout L;
};

// Copy a rows x cols tile of T (valid_rows x valid_cols of it from src, row
// stride ld_src; zeros elsewhere) into shared memory with row stride ld_dst,
// `unit` elements per cp.async (4, 8 or 16 bytes: the host checks that rows,
// valid columns and pointers allow it), or by plain loads where unit is 0
// (bf16 of odd width).
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld_dst, int rows, int cols, const T* src,
                                          int ld_src, int valid_rows, int valid_cols, int unit) {
  if (unit == 0) {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, c = idx % cols;
      dst[r * ld_dst + c] =
          r < valid_rows && c < valid_cols ? src[(size_t)r * ld_src + c] : Cvt<T>::from(0.f);
    }
    return;
  }
  const int wc = cols / unit, bytes = unit * (int)sizeof(T);
  for (int idx = threadIdx.x; idx < rows * wc; idx += kThreads) {
    const int r = idx / wc, c = (idx % wc) * unit;
    T* d = dst + r * ld_dst + c;
    const T* g = src + (size_t)r * ld_src + c;
    const bool ok = r < valid_rows && c < valid_cols;
    if (bytes == 16) {
      if (ok)
        cp_async16(d, g);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (bytes == 8) {
      if (ok)
        cp_async8(d, g);
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else {
      if (ok)
        cp_async4(d, g);
      else
        *reinterpret_cast<uint32_t*>(d) = 0u;
    }
  }
}

// Stage the weights of block k's chunk j (inner channels from j * nc) into
// the buffer at buf.
template <typename T>
__device__ __forceinline__ void stage_weights(const ChainArgs& a, int k, int j, unsigned char* buf) {
  const int i0 = j * a.nc;
  const int ic = min(a.nc, a.I - i0);
  const T* w1 = static_cast<const T*>(a.w1) + (size_t)k * a.C * a.I + i0;
  const T* w2 = static_cast<const T*>(a.w2) + (size_t)k * 9 * a.I + i0;
  const T* w3 = static_cast<const T*>(a.w3) + ((size_t)k * a.I + i0) * a.C;
  copy_tile<T>(reinterpret_cast<T*>(buf), a.L.ldw1, a.L.cp, a.nc, w1, a.I, a.C, ic, a.unit_i);
  copy_tile<T>(reinterpret_cast<T*>(buf + a.L.w_w3), a.L.ldw3, a.nc, a.L.cn, w3, a.C, ic, a.C,
               a.unit_c);
  copy_tile<T>(reinterpret_cast<T*>(buf + a.L.w_w2), a.nc, 9, a.nc, w2, a.I, 9, ic, a.unit_i);
  copy_tile<float>(reinterpret_cast<float*>(buf + a.L.w_b1), a.nc, 1, a.nc,
                   a.b1 + (size_t)k * a.I + i0, a.I, 1, ic, a.unit_b);
  copy_tile<float>(reinterpret_cast<float*>(buf + a.L.w_b2), a.nc, 1, a.nc,
                   a.b2 + (size_t)k * a.I + i0, a.I, 1, ic, a.unit_b);
}

// One row of the depthwise window: image row sy from the h1 plane, window
// columns [vlo, vhi] read and the rest zero (a row outside the image is all
// zero: zero padding by coordinates).
__device__ __forceinline__ void load_window_row(float* v, const float* col, int sy, int py0, int pw,
                                                int hs, int H, int vlo, int vhi) {
  const bool in = sy >= 0 && sy < H;
  const float* src = col + (sy - py0) * pw * hs;
#pragma unroll
  for (int u = 0; u < kRun + 2; ++u) v[u] = in && u >= vlo && u <= vhi ? src[u * hs] : 0.f;
}

// y = round((sum of the cluster's partials + b3) + x) for the (pixel, 4
// channels) groups rank, rank + S, ... of the output region, written into the
// x plane of every CTA of the cluster.  C is a multiple of 4 (the host checks).
template <typename T>
__device__ __forceinline__ void reduce_partials(cg::cluster_group& cluster, float* xs,
                                                float* ps, const float* b3k, int C, int cs,
                                                int out_n, int orw, int out_base, int pw,
                                                int rank, int S) {
  const int c4 = C / 4;
  for (int gi = rank * kThreads + threadIdx.x; gi < out_n * c4; gi += kThreads * S) {
    const int p = gi / c4, c = (gi % c4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < S; ++r) {
      const float4 part =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(ps, r) + p * C + c);
      sum.x += part.x, sum.y += part.y, sum.z += part.z, sum.w += part.w;
    }
    const int off = (out_base + (p / orw) * pw + p % orw) * cs + c;
    const float4 y = make_float4(round_to<T>((sum.x + b3k[c]) + xs[off]),
                                 round_to<T>((sum.y + b3k[c + 1]) + xs[off + 1]),
                                 round_to<T>((sum.z + b3k[c + 2]) + xs[off + 2]),
                                 round_to<T>((sum.w + b3k[c + 3]) + xs[off + 3]));
    for (int r = 0; r < S; ++r)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(xs, r) + off) = y;
  }
}

template <typename T, bool kRows, int NT>
__global__ void __launch_bounds__(kThreads, 2) res_chain_kernel(const ChainArgs a) {
  using F = Frag<T>;
  constexpr int MT = kAccTiles / NT > 0 ? kAccTiles / NT : 1;  // output row tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* h1s = reinterpret_cast<float*>(smem + a.L.off_h1);
  float* h2s = reinterpret_cast<float*>(smem + a.L.off_h2);
  unsigned char* wbuf = smem + a.L.off_w;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = a.C, H = a.H, W = a.W, K = a.K, nc = a.nc, pw = a.plane_w;
  const int cs = a.L.cs, hs = a.L.hs, hs2 = a.L.hs2;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);

  // A cluster of a.cluster CTAs shares one tile; CTA `rank` takes the chunks
  // rank, rank + cluster, ... of every block (own: how many, at least one).
  const int S = a.cluster;
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int own = (a.n_chunks - rank + S - 1) / S;
  const int b = blockIdx.x / S / a.n_tiles;
  const int tile = blockIdx.x / S % a.n_tiles;
  const int ty0 = (tile / a.tiles_w) * a.tile_h;
  const int tx0 = (tile % a.tiles_w) * a.tile_w;
  const int ty1 = min(ty0 + a.tile_h, H);
  const int tx1 = min(tx0 + a.tile_w, W);
  // Origin of the shared planes: the top-left corner of block 0's input region.
  const int py0 = max(ty0 - K, 0);
  const int px0 = max(tx0 - K, 0);
  const long long img0 = (long long)b * H * W;

  // Chunk 0's weights start loading, then x on block 0's input region (the
  // tile plus a K-pixel halo, clipped to the image); one group for both.
  stage_weights<T>(a, 0, rank, wbuf);
  {
    const int y1 = min(ty1 + K, H), x1 = min(tx1 + K, W);
    const int rw = x1 - px0, n = (y1 - py0) * rw;
    bool done = false;
    if constexpr (kRows) {
      if (a.x_vec) {  // four channels a copy: 16-byte cp.async (fp32), 8-byte loads (bf16)
        const int c4 = C / 4;
        for (int idx = tid; idx < n * c4; idx += kThreads) {
          const int p = idx / c4, c = (idx % c4) * 4;
          const int yy = py0 + p / rw, xx = px0 + p % rw;
          float* d = xs + ((yy - py0) * pw + (xx - px0)) * cs + c;
          const T* src = x + (img0 + (long long)yy * W + xx) * C + c;
          if constexpr (sizeof(T) == 4) {
            cp_async16(d, src);
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(src);
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
            *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
          }
        }
        done = true;
      }
    }
    if (!done) {
      // Neighbouring threads take neighbouring addresses: channels in the
      // row-major layout, pixels in the channels-first one.
      for (int idx = tid; idx < n * C; idx += kThreads) {
        const int c = kRows ? idx % C : idx / n;
        const int p = kRows ? idx / C : idx % n;
        const int yy = py0 + p / rw, xx = px0 + p % rw;
        const long long gi = (img0 + (long long)yy * W + xx) * a.pix_stride + c * a.ch_stride;
        xs[((yy - py0) * pw + (xx - px0)) * cs + c] = to_f(x[gi]);
      }
    }
    const int padc = a.L.cp - C;  // zero channels up to the mma depth
    for (int idx = tid; idx < n * padc; idx += kThreads) {
      const int p = idx / padc;
      xs[((p / rw) * pw + p % rw) * cs + C + idx % padc] = 0.f;
    }
  }
  cp_async_commit();

  float acc[MT][NT][4];
  const int n_q = K * own;
  int q = 0;
  for (int k = 0; k < K; ++k) {
    // Block k reads its input on the tile + (K-k) halo and writes its output
    // on the tile + (K-k-1) halo, both clipped to the image.
    const int hin = K - k, hout = hin - 1;
    const int iy0 = max(ty0 - hin, 0), ix0 = max(tx0 - hin, 0);
    const int iy1 = min(ty1 + hin, H), ix1 = min(tx1 + hin, W);
    const int oy0 = max(ty0 - hout, 0), ox0 = max(tx0 - hout, 0);
    const int oy1 = min(ty1 + hout, H), ox1 = min(tx1 + hout, W);
    const int irw = ix1 - ix0, in_n = (iy1 - iy0) * irw;
    const int orw = ox1 - ox0, orh = oy1 - oy0, out_n = orh * orw;
    const int in_base = (iy0 - py0) * pw + (ix0 - px0);
    const int out_base = (oy0 - py0) * pw + (ox0 - px0);
    const int in_mt = (in_n + 15) >> 4, out_mt = (out_n + 15) >> 4;

#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][n][e] = 0.f;

    for (int m = 0; m < own; ++m, ++q) {
      // This chunk's weights (and at q = 0 the x region) have landed, and every
      // warp is done with the previous chunk: stage the next one.
      cp_async_wait_all();
      __syncthreads();
#ifndef SKIP_STAGE
      if (q + 1 < n_q)
        stage_weights<T>(a, (q + 1) / own, rank + (q + 1) % own * S,
                         wbuf + ((q + 1) & 1) * a.L.w_bytes);
#endif
      cp_async_commit();
      const unsigned char* wb = wbuf + (q & 1) * a.L.w_bytes;
      const T* w1s = reinterpret_cast<const T*>(wb);
      const T* w3s = reinterpret_cast<const T*>(wb + a.L.w_w3);
      const T* w2s = reinterpret_cast<const T*>(wb + a.L.w_w2);
      const float* b1s = reinterpret_cast<const float*>(wb + a.L.w_b1);
      const float* b2s = reinterpret_cast<const float*>(wb + a.L.w_b2);

      // 1. h1 = relu(x . W1 + b1) on the input region: warp w takes the
      //    16-pixel row tiles w, w+8, ... with all nc/8 channel tiles, so one A
      //    fragment feeds up to four independent products.  Row tiles past the
      //    region clamp to its last pixel.
#ifndef SKIP_EXPAND
      const int n8 = nc >> 3;
      for (int mt = warp; mt < in_mt; mt += kWarps) {
        const int p_lo = mt * 16 + g, p_hi = p_lo + 8;
        const int q_lo = min(p_lo, in_n - 1), q_hi = min(p_hi, in_n - 1);
        const int s_lo = in_base + (q_lo / irw) * pw + q_lo % irw;
        const int s_hi = in_base + (q_hi / irw) * pw + q_hi % irw;
        float d[kMaxChunk / 8][4];
#pragma unroll
        for (int n = 0; n < kMaxChunk / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
        for (int k0 = 0; k0 < a.L.cp; k0 += F::kK) {
          const typename F::A fa = F::load_a(xs + s_lo * cs + k0, xs + s_hi * cs + k0, t);
#pragma unroll
          for (int n = 0; n < kMaxChunk / 8; ++n)
            if (n < n8) F::mma(d[n], fa, F::load_b(w1s + k0 * a.L.ldw1 + n * 8, a.L.ldw1, t, g));
        }
#pragma unroll
        for (int n = 0; n < kMaxChunk / 8; ++n) {
          if (n >= n8) break;
          const int c0 = n * 8 + 2 * t;
          const float bb0 = b1s[c0], bb1 = b1s[c0 + 1];
          if (p_lo < in_n)
            *reinterpret_cast<float2*>(h1s + s_lo * hs + c0) = make_float2(
                round_to<T>(fmaxf(d[n][0] + bb0, 0.f)), round_to<T>(fmaxf(d[n][1] + bb1, 0.f)));
          if (p_hi < in_n)
            *reinterpret_cast<float2*>(h1s + s_hi * hs + c0) = make_float2(
                round_to<T>(fmaxf(d[n][2] + bb0, 0.f)), round_to<T>(fmaxf(d[n][3] + bb1, 0.f)));
        }
      }
#endif
      __syncthreads();

      // 2. h2 = relu(dw3x3(h1) + b2) on the output region: one channel per
      //    lane; a thread takes kRun pixels of a row down kSeg rows, sliding a
      //    3-row window, so one h1 value read from shared memory feeds up to
      //    nine taps.  Window values outside the image (or past the run) are 0.
#ifndef SKIP_DW
      {
        const int ch = tid % nc;
        float wt[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) wt[i] = to_f(w2s[i * nc + ch]);
        const float bias = b2s[ch];
        const int rpr = (orw + kRun - 1) / kRun;
        const int n_units = rpr * ((orh + kSeg - 1) / kSeg);
        for (int u = tid / nc; u < n_units; u += kThreads / nc) {
          const int r0 = (u / rpr) * kSeg, c0 = (u % rpr) * kRun;
          const int len = min(kRun, orw - c0), rows = min(kSeg, orh - r0);
          const int yy = oy0 + r0, xx = ox0 + c0;  // image coordinates of the unit's start
          // window column v holds image column xx - 1 + v: valid for v in [vlo, vhi]
          const int vlo = xx == 0 ? 1 : 0, vhi = min(len + 1, W - xx);
          const float* col = h1s + (xx - 1 - px0) * hs + ch;
          float win[3][kRun + 2];
          load_window_row(win[0], col, yy - 1, py0, pw, hs, H, vlo, vhi);
          load_window_row(win[1], col, yy, py0, pw, hs, H, vlo, vhi);
          float* dst = h2s + (r0 * orw + c0) * hs2 + ch;
#pragma unroll
          for (int r = 0; r < kSeg; ++r) {
            if (r >= rows) break;
            const float* top = win[r % 3];
            const float* mid = win[(r + 1) % 3];
            float* bot = win[(r + 2) % 3];
            load_window_row(bot, col, yy + r + 1, py0, pw, hs, H, vlo, vhi);
#pragma unroll
            for (int v = 0; v < kRun; ++v) {
              float o = 0.f;
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) o = fmaf(top[v + dx], wt[dx], o);
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) o = fmaf(mid[v + dx], wt[3 + dx], o);
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) o = fmaf(bot[v + dx], wt[6 + dx], o);
              if (v < len) dst[(r * orw + v) * hs2] = round_to<T>(fmaxf(o + bias, 0.f));
            }
          }
        }
      }
#endif
      __syncthreads();

      // 3. y += h2 . W3 for the warp's own output row tiles, in registers.
#ifndef SKIP_PROJ
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const int mt = warp + kWarps * s;
        if (mt >= out_mt) break;
        const float* lo = h2s + min(mt * 16 + g, out_n - 1) * hs2;
        const float* hi = h2s + min(mt * 16 + g + 8, out_n - 1) * hs2;
        for (int k0 = 0; k0 < nc; k0 += F::kK) {
          const typename F::A fa = F::load_a(lo + k0, hi + k0, t);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            F::mma(acc[s][n], fa, F::load_b(w3s + k0 * a.L.ldw3 + n * 8, a.L.ldw3, t, g));
        }
      }
#endif
    }

    // y = (h2 . W3 + b3) + x, rounded to T, over x in place: the next block's
    // input.  The next chunk's barrier orders it before block k+1 reads xs.
    // In a cluster each CTA first writes its partial sums to ps; after a
    // cluster barrier each CTA adds the partials of 1/S of the (pixel,
    // channel group) elements in rank order through distributed shared
    // memory and writes y into every CTA's x plane; a second barrier makes
    // those writes visible and keeps ps until all have read it.
    const float* b3k = a.b3 + (size_t)k * C;
    float* ps = reinterpret_cast<float*>(smem + a.L.off_ps);
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      const int mt = warp + kWarps * s;
      if (mt >= out_mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + 8 * half;
        if (p >= out_n) continue;
        float* xp = xs + (out_base + (p / orw) * pw + p % orw) * cs;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * t + e;
            if (c >= C) continue;
            if (S == 1)
              xp[c] = round_to<T>((acc[s][n][2 * half + e] + b3k[c]) + xp[c]);
            else
              ps[p * C + c] = acc[s][n][2 * half + e];
          }
      }
    }
    if (S > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      reduce_partials<T>(cluster, xs, ps, b3k, C, cs, out_n, orw, out_base, pw, rank, S);
      cluster.sync();
    }
  }
  __syncthreads();

  // After the last block the output region is the tile itself.
  {
    const int rw = tx1 - tx0, n = (ty1 - ty0) * rw;
    if constexpr (kRows) {
      if (a.y_vec) {  // four channels a store
        const int c4 = C / 4;
        for (int idx = tid + rank * kThreads; idx < n * c4; idx += kThreads * S) {
          const int p = idx / c4, c = (idx % c4) * 4;
          const int yy = ty0 + p / rw, xx = tx0 + p % rw;
          const float4 v =
              *reinterpret_cast<const float4*>(xs + ((yy - py0) * pw + (xx - px0)) * cs + c);
          T* d = out + (img0 + (long long)yy * W + xx) * C + c;
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(d) = v;
          } else {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
            *reinterpret_cast<uint2*>(d) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                      *reinterpret_cast<const uint32_t*>(&hi));
          }
        }
        return;
      }
    }
    for (int idx = tid + rank * kThreads; idx < n * C; idx += kThreads * S) {
      const int c = kRows ? idx % C : idx / n;
      const int p = kRows ? idx / C : idx % n;
      const int yy = ty0 + p / rw, xx = tx0 + p % rw;
      const long long gi = (img0 + (long long)yy * W + xx) * a.pix_stride + c * a.ch_stride;
      out[gi] = Cvt<T>::from(xs[((yy - py0) * pw + (xx - px0)) * cs + c]);
    }
  }
}

// Each instance is allowed the whole budget of dynamic shared memory once per
// device (a bit per device), not on every launch.
template <typename T, bool kRows, int NT>
cudaError_t launch(const ChainArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kern = res_chain_kernel<T, kRows, NT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!bit || !(ready.load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.n_tiles * a.B * a.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)a.L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool kRows>
cudaError_t launch_width(const ChainArgs& a, cudaStream_t stream) {
  switch (proj_tiles(a.C)) {
    case 1: return launch<T, kRows, 1>(a, stream);
    case 2: return launch<T, kRows, 2>(a, stream);
    case 3: return launch<T, kRows, 3>(a, stream);
    case 6: return launch<T, kRows, 6>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one block; res_block.py's smem_bytes must agree.
long long yf_res_chain_smem(int itemsize, int H, int W, int C, int K, int tile_h, int tile_w,
                            int nc, int cluster) {
  return make_layout(itemsize, H, W, C, K, tile_h, tile_w, nc, cluster).bytes;
}

// Pixels a block's output region may hold at width C (0: C is too wide).
int yf_res_chain_max_out(int C) { return max_out_pixels(C); }

// Run a K-block chain.  dtype: 0 = float32, 1 = bfloat16.  rows: 1 for the
// row-major (B*H*W, C) layout, 0 for channels-first (C, B*H*W).  nc: inner
// channels per chunk (16 or 32).  cluster: CTAs per tile (1, 2 or 4, at most
// the chunks per block; above 1 only where C is a multiple of 4).  out must not alias x.  Returns a cudaError_t: 0 when
// the launch was accepted.
int yf_res_chain(int dtype, int rows, const void* x, void* out, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3, const void* b3, int B, int H, int W,
                 int C, int I, int K, int tile_h, int tile_w, int nc, int cluster, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || I < 1 || K < 1 || tile_h < 1 || tile_w < 1 ||
      tile_h > H || tile_w > W || (dtype != 0 && dtype != 1) || (nc != 16 && nc != 32) ||
      proj_tiles(C) == 0 || (cluster != 1 && cluster != 2 && cluster != 4) ||
      (cluster > 1 && (cluster > (I + nc - 1) / nc || C % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  ChainArgs a;
  a.L = make_layout(itemsize, H, W, C, K, tile_h, tile_w, nc, cluster);
  if (a.L.bytes > kSmemBudget) return (int)cudaErrorInvalidValue;
  const long long oh = tile_h + 2 * (K - 1) < H ? tile_h + 2 * (K - 1) : H;
  const long long ow = tile_w + 2 * (K - 1) < W ? tile_w + 2 * (K - 1) : W;
  if (oh * ow > max_out_pixels(C)) return (int)cudaErrorInvalidValue;
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
  a.nc = nc;
  a.n_chunks = (I + nc - 1) / nc;
  a.cluster = cluster;
  if ((long long)a.n_tiles * B * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.x_vec = rows && C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * itemsize) == 0;
  a.y_vec = rows && C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * itemsize) == 0;
  const uintptr_t wi = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  const uintptr_t bi = reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(b2);
  a.unit_i = copy_unit(I, wi, itemsize);
  a.unit_c = copy_unit(C, reinterpret_cast<uintptr_t>(w3), itemsize);
  a.unit_b = copy_unit(I, bi, 4);
  a.pix_stride = rows ? C : 1;
  a.ch_stride = rows ? 1 : (long long)B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = rows ? launch_width<float, true>(a, s) : launch_width<float, false>(a, s);
  else
    e = rows ? launch_width<__nv_bfloat16, true>(a, s) : launch_width<__nv_bfloat16, false>(a, s);
  return (int)e;
}

const char* yf_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
