// Greedy class-aware NMS keep mask on the card: one thread block per image.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// mask (yolofastest_tpu/ops/nms.py, nms_keep_mask) as an XLA fori_loop of K
// steps on the device.  The port's plain version (ops/nms.py,
// nms_keep_plain) is a Python loop of small launches that first reads a
// row count back to the host; this kernel takes its place on the card, so
// the detect path returns to the host before the card is done.
//
// keep[b, j] starts as valid[b, j].  For i = 0, 1, ... in order, a row i
// that is still kept clears keep[b, j] of every later row j of its class
// with iou(i, j) > thr.  Thread j owns candidate j; the K boxes and classes
// sit in shared memory, and each step is one barrier.  Steps stop at the
// image's last valid row: later rows are invalid and already dropped.
//
// What bounds it: neither bytes (22 a candidate) nor operations (~26 a
// pair), but the K dependent steps, each a barrier; at K = 128 a block does
// a few microseconds of work.  Blocks of different images run in parallel.
//
// Bit equality with the plain version is the rule, since one flipped
// comparison changes the detections: the IOU is computed with the same
// IEEE operations in the same order as ops/boxes.py (iou_pairwise), each
// rounded to nearest with no fused multiply-add (the __f*_rn intrinsics),
// max/min/clamp propagate NaN as torch does, and the threshold is the
// float32 value torch compares a float32 tensor against.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 1024;

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

__global__ void nms_keep_kernel(const float4* __restrict__ boxes, const int* __restrict__ cls,
                                const unsigned char* __restrict__ valid,
                                unsigned char* __restrict__ keep, int k, float thr, float po) {
  __shared__ float4 s_box[kMaxRows];
  __shared__ int s_cls[kMaxRows];
  __shared__ unsigned char s_keep[kMaxRows];
  __shared__ int s_last;

  const int j = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  if (j == 0) s_last = -1;
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  int c = 0;
  bool kept = false;
  if (j < k) {
    box = boxes[base + j];
    c = cls[base + j];
    kept = valid[base + j] != 0;
    s_box[j] = box;
    s_cls[j] = c;
    s_keep[j] = kept;
  }
  __syncthreads();
  if (kept) atomicMax(&s_last, j);

  for (int i = 0;; ++i) {
    __syncthreads();  // row i's keep bit is final: only rows < i clear it
    if (i >= s_last) break;
    if (!s_keep[i]) continue;
    if (kept && j > i && s_cls[i] == c && iou(s_box[i], box, po) > thr) {
      kept = false;
      s_keep[j] = 0;
    }
  }
  if (j < k) keep[base + j] = kept;
}

}  // namespace

extern "C" {

// keep (B, K) uint8 from boxes (B, K, 4) float32, cls (B, K) int32 and
// valid (B, K) uint8, all contiguous on the card, on `stream`.  Returns a
// cudaError_t: 0, or why the launch was refused.
int yf_nms_keep(const void* boxes, const void* cls, const void* valid, void* keep, int batch,
                int k, float thr, float pixel_offset, void* stream) {
  if (k < 1 || k > kMaxRows || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (k + 31) / 32 * 32;
  nms_keep_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(cls),
      static_cast<const unsigned char*>(valid), static_cast<unsigned char*>(keep), k, thr,
      pixel_offset);
  return static_cast<int>(cudaGetLastError());
}

int yf_nms_max_rows() { return kMaxRows; }

const char* yf_nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
