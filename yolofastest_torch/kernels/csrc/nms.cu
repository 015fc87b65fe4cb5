// Class-aware greedy NMS and its kept-first compaction on the card, in one
// launch: one thread block per image.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function (yolofastest_tpu/ops/nms.py, batched_nms) as an XLA fori_loop of
// K steps for the keep mask, then a stable argsort of ~keep and a gather of
// the (x1, y1, x2, y2, conf, cls_score, cls_idx, keep) rows.  The port's
// plain versions (kernels/nms.py) are nms_packed_plain, which follows this
// kernel's formulation, and nms_keep_plain, the greedy loop.
//
// keep[b, j] starts as valid[b, j].  For i = 0, 1, ... in order, a row i
// that is still kept clears keep[b, j] of every later row j of its class
// with iou(i, j) > thr.  Then the rows are written kept first, each group in
// index order, to the first m = min(K, max_det) places of the image.
//
// What bounds it: not the card's rates.  An image is K <= 1024 candidates
// (29 bytes each in, 1 + 32 out per kept place) and at most K^2/2 IOUs of
// ~27 float32 operations: a few microseconds of bytes or operations for the
// whole batch at K = 128.  What costs is the chain of dependent greedy
// steps; the design takes that chain off the block's barriers:
//
// 1. Suppression bits by ballot.  Each warp takes rows i of valid
//    candidates (rows i = warp, warp + warps, ...).  For each 32-wide word
//    w >= i / 32 up to the last word with a valid row, lane l evaluates
//    j = 32 w + l and its bit is set where valid[i], j > i, cls[i] ==
//    cls[j] and iou(i, j) > thr; one __ballot_sync makes the word, stored in
//    a K x ceil(K / 32) uint32 matrix in shared memory (K = 128: 2 KB,
//    K = 256: 8 KB, K = 1024: 128 KB; dynamic shared memory, its limit
//    raised once for each card the process launches on).
// 2. One warp scans, with no block barrier.  Lane w holds word w of the
//    removed set (K <= 1024 is at most 32 words).  A ballot and __ffs find
//    the next row that is valid, not removed and not yet taken; the warp ORs
//    that row's words into the removed set and repeats: one step per kept
//    row.
// 3. Compaction in the same launch.  After one barrier, thread j reads the
//    keep words: r = the kept rows below j (__popc, plus the prefix over the
//    words that the scan warp left), nkept = all kept rows.  A kept row goes
//    to place r, another to nkept + j - r, written where that place is < m,
//    as two 16-byte stores.  keep is written too.
// 4. Inputs are read where they lie: each comes with its batch and row
//    strides, so decode's strided views (rows of 7 floats) and the TTA
//    merge's gathered tensors go in with no copy.
// 5. Grid: one block of 1024 threads (32 warps) per image, whatever K.
//    Phase 1 is a chain of dependent steps per row (shared loads, the IOU's
//    IEEE division, the ballot), so it is as fast as the rows a warp holds
//    are few: on an H100 (tools/torch_nms_timing.py --phases), 1024 threads
//    in place of max(K, 128) took a dense image (113 valid rows, K = 128)
//    from 33.8 to 15.0 us and the golden candidates (3 valid rows) from
//    2.78 to 2.50 us.  A cluster of CTAs would spread the rows further, but
//    on the golden candidates every warp holds at most one valid row
//    already, so none is used.  The work per image is a few thousand IOUs
//    over ~4 KB of data: there is no product for wgmma and a TMA descriptor
//    costs more than the whole tile, so TMA and wgmma do not apply.
//
// Bit equality with the plain versions is the rule, since one flipped
// comparison changes the detections: the IOU is computed with the same
// IEEE operations in the same order as ops/boxes.py (iou_pairwise), each
// rounded to nearest with no fused multiply-add (the __f*_rn intrinsics),
// max/min/clamp propagate NaN as torch does, and the threshold is the
// float32 value torch compares a float32 tensor against.  The packed rows
// are copies of the inputs' bits; cls_idx converts to float32 rounding to
// nearest, as torch's cast does.
//
// NMS_SKIP_MATRIX and NMS_SKIP_SCAN compile phase 1 or 2 out, for timing
// the phases only (tools/torch_nms_timing.py): the outputs are then wrong.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxRows = 1024;
constexpr int kMaxWords = kMaxRows / 32;
constexpr unsigned kFull = 0xffffffffu;
// boxes and classes of the padded rows, and the K x words suppression matrix
constexpr size_t kMaxSmem =
    size_t(kMaxRows) * (sizeof(float4) + sizeof(int)) + size_t(kMaxRows) * kMaxWords * 4;
// The shared memory limit is an attribute of the kernel on one card: set
// once per card, by its device ordinal.
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_allowed[kMaxDevices];

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

__device__ __forceinline__ float clamp_min0(float x) {
  return x != x ? x : (x < 0.0f ? 0.0f : x);
}

// iou_pairwise(a, b, pixel_offset, eps=0) of ops/boxes.py, operation by
// operation: a is the suppressing row i, b the candidate j.
__device__ __forceinline__ float iou(float4 a, float4 b, float po) {
  const float ix1 = max_nan(a.x, b.x);
  const float iy1 = max_nan(a.y, b.y);
  const float ix2 = min_nan(a.z, b.z);
  const float iy2 = min_nan(a.w, b.w);
  const float iw = clamp_min0(__fadd_rn(__fsub_rn(ix2, ix1), po));
  const float ih = clamp_min0(__fadd_rn(__fsub_rn(iy2, iy1), po));
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), po),
                                 __fadd_rn(__fsub_rn(a.w, a.y), po));
  const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), po),
                                 __fadd_rn(__fsub_rn(b.w, b.y), po));
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 0.0f);
  return __fdiv_rn(inter, denom);
}

// Each input with its batch and row strides, in elements.  boxes' four
// corners are neighbours (last stride 1).
struct Inputs {
  const float* boxes;
  long long box_sb, box_sk;
  const float* conf;
  long long conf_sb, conf_sk;
  const float* score;
  long long score_sb, score_sk;
  const int* cls;
  long long cls_sb, cls_sk;
  const unsigned char* valid;
  long long valid_sb, valid_sk;
};

// out: (B, m, 8) float32 rows; keep: (B, K) bool.
__global__ void __launch_bounds__(1024)
    nms_packed_kernel(Inputs in, float4* __restrict__ out, unsigned char* __restrict__ keep,
                      int k, int m, float thr, float po) {
  extern __shared__ float4 smem[];
  __shared__ unsigned s_valid[kMaxWords];
  __shared__ unsigned s_keep[kMaxWords];
  __shared__ int s_rank[kMaxWords];  // kept rows in the words before
  __shared__ int s_nkept;

  const int n_words = (k + 31) >> 5;
  const int padded = n_words << 5;
  float4* s_box = smem;
  int* s_cls = reinterpret_cast<int*>(s_box + padded);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_cls + padded);  // [i * n_words + w]

  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long b = blockIdx.x;

  // Thread j holds row j in registers for the compaction; boxes and classes
  // go to shared memory for the IOUs, the valid bits to words.
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  float conf = 0.f, score = 0.f;
  int c = 0;
  bool valid = false;
  if (j < k) {
    const float* bp = in.boxes + b * in.box_sb + j * in.box_sk;
    box = make_float4(bp[0], bp[1], bp[2], bp[3]);
    c = in.cls[b * in.cls_sb + j * in.cls_sk];
    valid = in.valid[b * in.valid_sb + j * in.valid_sk] != 0;
    conf = in.conf[b * in.conf_sb + j * in.conf_sk];
    score = in.score[b * in.score_sb + j * in.score_sk];
  }
  if (j < padded) {  // blockDim.x >= padded
    s_box[j] = box;
    s_cls[j] = c;
  }
  const unsigned valid_word = __ballot_sync(kFull, valid);
  if (lane == 0 && warp < n_words) s_valid[warp] = valid_word;
  __syncthreads();

  // Words 0 .. n_live - 1 hold every valid row of the image.
  const unsigned live = __ballot_sync(kFull, lane < n_words && s_valid[lane] != 0u);
  const int n_live = 32 - __clz(live);

  // 1. Suppression bits, one ballot per word.  i, its valid bit and w are
  // the same in every lane, so every ballot has the whole warp.
#ifndef NMS_SKIP_MATRIX
  for (int i = warp; i < (n_live << 5); i += n_warps) {
    if (!((s_valid[i >> 5] >> (i & 31)) & 1u)) continue;
    const float4 bi = s_box[i];
    const int ci = s_cls[i];
    for (int w = i >> 5; w < n_live; ++w) {
      const int jj = (w << 5) + lane;
      const bool hit = jj > i && jj < k && s_cls[jj] == ci && iou(bi, s_box[jj], po) > thr;
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0) s_mask[i * n_words + w] = word;
    }
  }
#endif
  __syncthreads();

  // 2. The greedy scan, in warp 0 alone: one step per kept row.  Row i's
  // words below i / 32 are zero (j > i) and were never written.
  if (warp == 0) {
    const unsigned valid_w = lane < n_words ? s_valid[lane] : 0u;
    unsigned removed = 0u;
#ifndef NMS_SKIP_SCAN
    unsigned open = valid_w;  // valid rows not taken yet
    for (;;) {
      const unsigned cand = open & ~removed;
      const unsigned words = __ballot_sync(kFull, cand != 0u);
      if (words == 0u) break;
      const int w = __ffs(words) - 1;
      const int bit = __ffs(__shfl_sync(kFull, cand, w)) - 1;
      const int i = (w << 5) + bit;
      if (lane == w) open &= ~(1u << bit);
      if (lane >= w && lane < n_live) removed |= s_mask[i * n_words + lane];
    }
#endif
    const unsigned kept = valid_w & ~removed;
    const int count = __popc(kept);
    int incl = count;  // inclusive prefix over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane < n_words) {
      s_keep[lane] = kept;
      s_rank[lane] = incl - count;
    }
    if (lane == 31) s_nkept = incl;
  }
  __syncthreads();

  // 3. The keep mask, and each row at its place, kept rows first.
  if (j < k) {
    const unsigned kw = s_keep[j >> 5];
    const bool kept = (kw >> (j & 31)) & 1u;
    keep[b * k + j] = kept;
    const int r = s_rank[j >> 5] + __popc(kw & ((1u << (j & 31)) - 1u));
    const int place = kept ? r : s_nkept + j - r;
    if (place < m) {
      float4* row = out + (b * m + place) * 2;
      row[0] = box;
      row[1] = make_float4(conf, score, static_cast<float>(c), kept ? 1.0f : 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// Packed rows out (B, m, 8) float32 and keep (B, K) bool from boxes
// (B, K, 4) float32, conf and score (B, K) float32, cls (B, K) int32 and
// valid (B, K) bool, each given with its batch and row strides in elements
// (boxes' last stride 1), on `stream`.  Returns a cudaError_t: 0, or why
// the launch was refused.
int yf_nms_packed(const void* boxes, long long box_sb, long long box_sk, const void* conf,
                  long long conf_sb, long long conf_sk, const void* score, long long score_sb,
                  long long score_sk, const void* cls, long long cls_sb, long long cls_sk,
                  const void* valid, long long valid_sb, long long valid_sk, void* out,
                  void* keep, int batch, int k, int m, float thr, float pixel_offset,
                  void* stream) {
  if (k < 1 || k > kMaxRows || batch < 1 || m < 1 || m > k)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block's shared memory must be allowed first: once on each
  // card, for the largest K.
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_smem_allowed[device].load()) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        nms_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    g_smem_allowed[device].store(true);
  }
  const int n_words = (k + 31) / 32;
  const int threads = kMaxRows;
  const size_t smem = size_t(n_words) * 32 * (sizeof(float4) + sizeof(int)) +
                      size_t(k) * n_words * sizeof(unsigned);
  const Inputs in{static_cast<const float*>(boxes), box_sb, box_sk,
                  static_cast<const float*>(conf), conf_sb, conf_sk,
                  static_cast<const float*>(score), score_sb, score_sk,
                  static_cast<const int*>(cls), cls_sb, cls_sk,
                  static_cast<const unsigned char*>(valid), valid_sb, valid_sk};
  nms_packed_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float4*>(out), static_cast<unsigned char*>(keep), k, m, thr, pixel_offset);
  return static_cast<int>(cudaGetLastError());
}

int yf_nms_max_rows() { return kMaxRows; }

const char* yf_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
