// The standalone Pruner (paper §5.2) for Hopper.
//
// Replaces the TPU kernel repro/kernels/topk_select/kernel.py:
//   topk_select_pallas (kernel.py:57-90), whose body is _pruner_kernel
//   (kernel.py:28-53).
//
// What it computes. For each row of (T, D) float32 scores and a (T, D)
// bool mask, a k-slot retention domain that starts at NEG with id -1. The
// row's D slots stream in order; a masked slot is NEG. Each candidate
// replaces the domain's FIRST minimum slot (the lowest slot among equal
// minima) only if it is STRICTLY greater (Algorithm 1 lines 14-22, the
// reference's min_replace). At the end the domain's values are written as
// they are, in slot order, and its ids, with -1 where the value is at or
// below NEG / 2. The kernel only copies and compares values, so its output
// equals the plain version (ref.py topk_select_plain) bit for bit. It uses
// comparisons and no fminf/fmaxf: -0.0 and +0.0 compare equal and keep
// their bits, and NaN and -inf never enter the domain (nothing is > at or
// below NEG, and no comparison with NaN holds). The TPU kernel pads T to 8
// and D to 128; here the arrays are read unpadded.
//
// What bounds it on an H100. Its bytes are small (5 B a score and mask
// slot read once, 8 B a domain slot written once), and it does no
// arithmetic. What takes the time is the serial chain of each row: every
// insert needs the domain's minimum after the previous one, and a first-
// minimum search over k slots. A row with n valid slots in random order
// makes about k + k ln(n / k) inserts.
//
// What the design does about it. One warp per row, a few rows a block, so
// the card runs many chains at once; the domain's k values and k ids live
// in shared memory (8 B a slot; above 48 KB the block opts into up to
// 227 KB, so k <= 29056). The warp reads each 32-slot chunk of scores and
// mask with one coalesced load each. While the domain has empty slots,
// the rule puts each candidate above NEG into the next empty slot (an
// empty slot holds NEG, below every such candidate, and slots fill in
// order), so a ballot and a prefix count place a whole chunk at once.
// After that, one __ballot_sync drops every lane whose score is not above
// the domain minimum: the minimum only rises, so the filter is exact. The
// survivors go in slot order, each re-checked against the current minimum;
// an insert is one store by lane 0, then a new first-minimum search (a
// per-lane scan of strided slots and a five-step shuffle reduction on
// (value, slot), as the flat K1 of fused_prune_aggregate.cu does). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronize. Making the chain shorter (a domain in registers, several
// warps per row) is later work.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define NEG (-3.0e38f)

static constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can opt into
static constexpr int SLOT_BYTES = 8;     // float value + int slot id
static constexpr int MAX_ROWS_PER_BLOCK = 8;
static constexpr int DEFAULT_SMEM = 48 * 1024;

// The domain's first minimum (lowest slot among equal minima), on every
// lane of the warp. A domain of +inf values leaves mi = k, which no
// candidate can replace (nothing is > +inf).
__device__ __forceinline__ void domain_first_min(const float* rv, int k, int lane, float& mv,
                                                 int& mi) {
  mv = __int_as_float(0x7f800000);  // +inf
  mi = k;
  for (int s = lane; s < k; s += 32) {
    const float v = rv[s];
    if (v < mv) { mv = v; mi = s; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, mv, off);
    const int oi = __shfl_xor_sync(FULL_MASK, mi, off);
    if (ov < mv || (ov == mv && oi < mi)) { mv = ov; mi = oi; }
  }
}

// grid = ceil(T / rows_per_block), block = (32, rows_per_block): warp y owns
// row blockIdx.x * rows_per_block + y. Dynamic shared memory:
// rows_per_block * k * 8 B.
__global__ void topk_select_kernel(const float* __restrict__ scores,       // (T, D)
                                   const unsigned char* __restrict__ mask,  // (T, D) bool
                                   float* __restrict__ out_v,               // (T, k)
                                   int* __restrict__ out_i,                 // (T, k)
                                   int t, int d, int k) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int rpb = blockDim.y;
  const int row = blockIdx.x * rpb + warp;
  if (row >= t) return;  // the whole warp leaves together

  float* rv = reinterpret_cast<float*>(smem) + (size_t)warp * k;
  int* ri = reinterpret_cast<int*>(smem) + (size_t)rpb * k + (size_t)warp * k;
  for (int s = lane; s < k; s += 32) {
    rv[s] = NEG;
    ri[s] = -1;
  }
  __syncwarp();

  const size_t base = (size_t)row * d;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int filled = 0;  // slots [0, filled) hold candidates, the rest NEG (warp-uniform)
  float mv = NEG;  // the domain's first minimum once it is full
  int mi = 0;
  for (int c = 0; c < d; c += 32) {
    const int j = c + lane;
    const float cur = (j < d && mask[base + j]) ? scores[base + j] : NEG;
    unsigned live;
    if (filled < k) {
      // empty slots left: the candidates above NEG take them in slot order
      unsigned fill = __ballot_sync(FULL_MASK, cur > NEG);
      const int room = k - filled;
      const int rank = __popc(fill & below);
      if (((fill >> lane) & 1u) && rank < room) {
        rv[filled + rank] = cur;
        ri[filled + rank] = j;
      }
      const int n = __popc(fill);
      if (n < room) {
        filled += n;
        continue;
      }
      filled = k;  // full: the chunk's candidates past the first `room` go through the chain
      for (int r = 0; r < room; ++r) fill &= fill - 1u;
      live = fill;
      __syncwarp();
      domain_first_min(rv, k, lane, mv, mi);
    } else {
      // exact filter: the minimum only rises, so a candidate at or below
      // it now is never inserted; the rest go in slot order
      live = __ballot_sync(FULL_MASK, cur > mv);
    }
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1u;
      const float v = __shfl_sync(FULL_MASK, cur, src);
      if (v > mv) {  // mv, mi are the same on every lane
        __syncwarp();  // every lane has read the domain before it changes
        if (lane == 0) {
          rv[mi] = v;
          ri[mi] = c + src;
        }
        __syncwarp();
        domain_first_min(rv, k, lane, mv, mi);
      }
    }
  }
  __syncwarp();

  float* ov = out_v + (size_t)row * k;
  int* oi = out_i + (size_t)row * k;
  for (int s = lane; s < k; s += 32) {
    const float v = rv[s];
    ov[s] = v;
    oi[s] = v <= NEG * 0.5f ? -1 : ri[s];
  }
}

extern "C" int ts_max_k() { return MAX_SMEM / SLOT_BYTES; }

extern "C" int ts_topk_select(const void* scores, const void* mask, void* vals, void* ids, int t,
                              int d, int k, void* stream) {
  if (t <= 0 || d <= 0 || k < 1 || k > MAX_SMEM / SLOT_BYTES) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // rows per block: as many as fit in the default 48 KB (at most 8), fewer
  // while that would leave SMs without a block
  const size_t row_bytes = (size_t)k * SLOT_BYTES;
  int rpb = MAX_ROWS_PER_BLOCK;
  while (rpb > 1 && ((size_t)rpb * row_bytes > DEFAULT_SMEM || (t + rpb - 1) / rpb < sms)) rpb >>= 1;
  const size_t shmem = (size_t)rpb * row_bytes;
  if (shmem > DEFAULT_SMEM) {
    e = cudaFuncSetAttribute(topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (t + rpb - 1) / rpb;
  topk_select_kernel<<<grid, dim3(32, rpb), shmem, (cudaStream_t)stream>>>(
      (const float*)scores, (const unsigned char*)mask, (float*)vals, (int*)ids, t, d, k);
  return (int)cudaGetLastError();
}
