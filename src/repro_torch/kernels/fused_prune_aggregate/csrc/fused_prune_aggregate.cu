// ADE fused Neighbor Aggregation over a grouped bucket layout, for Hopper.
//
// Replaces the TPU kernel pair of
// repro/kernels/fused_prune_aggregate/kernel.py:
//   fused_prune_aggregate_grouped_pallas (kernel.py:304), whose bodies are
//   K1 _grouped_prune_kernel (kernel.py:219-298) and
//   K2 _grouped_aggregate_kernel (kernel.py:137-150).
//
// What the pair computes. A GroupedBucketLayout stores every degree bucket
// of one semantic graph as a stack of (t_tile, w) tiles, one row block's
// D-tiles contiguous. For each grouped row (one target), K1 streams the
// row's candidates in slot order, ranks each by the left-to-right head sum
// of theta_src[id] (+ theta_rel[ety]), and keeps a K_s-slot retention
// domain: the candidate replaces the FIRST minimum slot only if it is
// STRICTLY greater (slots >= the row's k_eff are parked at POS and never
// chosen). Rows of a bypass bucket (capacity <= K, paper §4.3) copy
// candidate j of D-tile dt straight into slot dt*w + j. After the last
// D-tile, K1 applies LeakyReLU(theta + theta_dst, slope) and a masked
// softmax over the retained slots (eps 1e-30) and writes alpha
// (rows, K_s, H) and the retained global ids (rows, K_s), -1 = empty. K2
// accumulates alpha[slot, h] * h'[id, h, :] over the row's own k_eff slots,
// in slot order (an empty slot reads id 0 with alpha 0).
//
// What bounds it on an H100. Neither kernel does enough arithmetic to
// matter (K1: H adds per candidate plus a compare; K2: one FMA per loaded
// float). Both are bound by memory traffic and, at the sizes of one
// semantic graph (a few MB), by latency: dependent gathers (tile -> id ->
// theta_src row in K1; ids -> h' row in K2) and the serial insert chain of
// K1, where each candidate needs the domain's minimum after the previous
// insert.
//
// What the design does about it. K1 gives each grouped row one warp and a
// row block one thread block (t_tile warps), so the rows of a block share
// their block-table entry and the card runs thousands of independent rows
// at once to hide gather latency. A lane loads one candidate of the tile
// (w <= 32), so a tile costs one coalesced load per array; the serial
// insert then runs over warp shuffles. The retention domain (rank, id,
// edge type per slot) lives in shared memory, 12 bytes a slot; the
// per-head theta of a retained slot is re-read from theta_src (+ theta_rel)
// at the flush instead of being kept, which keeps the domain small enough
// for K_s = 256 without shared-memory opt-in. The first-minimum search is a
// per-lane scan of strided slots plus a five-step shuffle reduction on
// (value, slot), which yields the lowest slot among equal minima. K2 gives
// each grouped row one block with a thread per (head, dh) output, so every
// retained h' row is read with one coalesced load of H*dh floats and
// accumulated in a register. Both kernels launch on the caller's stream,
// allocate nothing and do not synchronize. Fusing K1 into K2, staging h'
// in shared memory and CUDA graphs across the forward are later work.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

#define NEG (-3.0e38f)
#define POS (3.0e38f)
static constexpr int MAX_KS = 256;               // default max_degree
static constexpr int SLOTS_PER_LANE = MAX_KS / 32;

__device__ __forceinline__ float theta_of(const float* __restrict__ theta_src,
                                          const float* __restrict__ theta_rel,
                                          int id, int ety, int h, int hh) {
  float t = theta_src[(size_t)id * h + hh];
  if (theta_rel != nullptr) t = t + theta_rel[(size_t)ety * h + hh];
  return t;
}

// K1. grid = n_blocks row blocks, block = (32, t_tile): warp y owns grouped
// row blockIdx.x * t_tile + y. Dynamic shared memory: t_tile * k_s * 12 B.
__global__ void grouped_prune_kernel(
    const int* __restrict__ nbr,          // (G, t_tile, w) global source ids
    const unsigned char* __restrict__ msk,  // (G, t_tile, w) bool
    const int* __restrict__ ety,          // (G, t_tile, w) or null
    const float* __restrict__ theta_src,  // (N, H)
    const float* __restrict__ theta_rel,  // (R, H) or null
    const float* __restrict__ theta_dst,  // (T, H)
    const int* __restrict__ row_targets,  // (rows,)
    const int* __restrict__ blk,          // (4, n_blocks) first, n_dt, bypass, k_eff
    float* __restrict__ alpha,            // out (rows, k_s, H)
    int* __restrict__ ids,                // out (rows, k_s)
    int n_blocks, int t_tile, int w, int h, int k_s, float slope) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b = blockIdx.x;
  const int first = blk[b];
  const int n_dt = blk[n_blocks + b];
  const int bypass = blk[2 * n_blocks + b];
  const int k_eff = blk[3 * n_blocks + b];
  const size_t row = (size_t)b * t_tile + warp;

  float* rk = reinterpret_cast<float*>(smem) + (size_t)warp * k_s;
  int* rid = reinterpret_cast<int*>(smem) + (size_t)t_tile * k_s + (size_t)warp * k_s;
  int* rety = reinterpret_cast<int*>(smem) + (size_t)2 * t_tile * k_s + (size_t)warp * k_s;

  for (int s = lane; s < k_s; s += 32) {
    rk[s] = s < k_eff ? NEG : POS;
    rid[s] = -1;
    rety[s] = 0;
  }
  __syncwarp();

  for (int dt = 0; dt < n_dt; ++dt) {
    const size_t base = ((size_t)(first + dt) * t_tile + warp) * w;
    float cr = NEG;
    int cid = -1;
    int ce = 0;
    if (lane < w && msk[base + lane]) {
      cid = nbr[base + lane];
      ce = ety != nullptr ? ety[base + lane] : 0;
      float r = theta_of(theta_src, theta_rel, cid, ce, h, 0);
      for (int hh = 1; hh < h; ++hh) r = r + theta_of(theta_src, theta_rel, cid, ce, h, hh);
      cr = r;
    }
    if (bypass) {
      // §4.3: capacity <= K, every candidate is kept in its own slot
      if (lane < w) {
        const int s = dt * w + lane;
        rk[s] = cr;
        rid[s] = cid;
        rety[s] = ce;
      }
    } else {
      for (int j = 0; j < w; ++j) {
        const float cur = __shfl_sync(FULL_MASK, cr, j);
        const int cur_id = __shfl_sync(FULL_MASK, cid, j);
        const int cur_e = __shfl_sync(FULL_MASK, ce, j);
        // first minimum of the domain: per-lane strided scan keeps the
        // lowest slot of its minima, the reduction breaks ties by slot
        float mv = __int_as_float(0x7f800000);  // +inf, above POS
        int mi = k_s;
        for (int s = lane; s < k_s; s += 32) {
          const float v = rk[s];
          if (v < mv) { mv = v; mi = s; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(FULL_MASK, mv, off);
          const int oi = __shfl_xor_sync(FULL_MASK, mi, off);
          if (ov < mv || (ov == mv && oi < mi)) { mv = ov; mi = oi; }
        }
        if (cur > mv && lane == 0) {
          rk[mi] = cur;
          rid[mi] = cur_id;
          rety[mi] = cur_e;
        }
        __syncwarp();
      }
    }
    __syncwarp();
  }

  // flush: LeakyReLU + masked softmax over the retained slots, per head
  const float* tdst = theta_dst + (size_t)row_targets[row] * h;
  bool ok[SLOTS_PER_LANE];
#pragma unroll
  for (int i = 0; i < SLOTS_PER_LANE; ++i) {
    const int s = lane + 32 * i;
    ok[i] = s < k_s && s < k_eff && rk[s] > NEG * 0.5f;
  }
  for (int hh = 0; hh < h; ++hh) {
    const float td = tdst[hh];
    float tv[SLOTS_PER_LANE];
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < SLOTS_PER_LANE; ++i) {
      tv[i] = 0.f;
      if (ok[i]) {
        const int s = lane + 32 * i;
        float t = theta_of(theta_src, theta_rel, rid[s], rety[s], h, hh) + td;
        t = t >= 0.f ? t : slope * t;
        tv[i] = t;
        mx = fmaxf(mx, t);
      }
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SLOTS_PER_LANE; ++i) {
      if (ok[i]) {
        tv[i] = expf(tv[i] - mx);
        sum += tv[i];
      }
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
    const float denom = sum + 1e-30f;
#pragma unroll
    for (int i = 0; i < SLOTS_PER_LANE; ++i) {
      const int s = lane + 32 * i;
      if (s < k_s) alpha[(row * k_s + s) * h + hh] = ok[i] ? tv[i] / denom : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS_PER_LANE; ++i) {
    const int s = lane + 32 * i;
    if (s < k_s) ids[row * k_s + s] = ok[i] ? rid[s] : -1;
  }
}

// K2. grid = rows grouped rows, block = H * dh threads, one per output.
__global__ void grouped_aggregate_kernel(
    const float* __restrict__ alpha,  // (rows, k_s, H)
    const int* __restrict__ ids,      // (rows, k_s), -1 = empty
    const float* __restrict__ hp,     // (N, H, dh)
    const int* __restrict__ blk,      // (4, n_blocks); row 3 is k_eff
    float* __restrict__ out,          // out (rows, H, dh)
    int n_blocks, int t_tile, int h, int dh, int k_s) {
  const size_t row = blockIdx.x;
  const int t = threadIdx.x;
  const int hd = h * dh;
  const int hh = t / dh;
  const int k_eff = blk[3 * n_blocks + (int)(row / t_tile)];
  float acc = 0.f;
  for (int s = 0; s < k_eff; ++s) {
    int id = ids[row * k_s + s];
    id = id < 0 ? 0 : id;  // alpha is 0 on empty slots
    acc += alpha[(row * k_s + s) * h + hh] * hp[(size_t)id * hd + t];
  }
  out[row * hd + t] = acc;
}

extern "C" int fpa_max_ks() { return MAX_KS; }

extern "C" int fpa_grouped_prune(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, const void* row_targets,
    const void* blk, void* alpha, void* ids, int n_blocks, int t_tile, int w,
    int h, int k_s, float slope, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t shmem = (size_t)t_tile * k_s * 12;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  grouped_prune_kernel<<<n_blocks, dim3(32, t_tile), shmem, (cudaStream_t)stream>>>(
      (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
      (const float*)theta_rel, (const float*)theta_dst, (const int*)row_targets,
      (const int*)blk, (float*)alpha, (int*)ids, n_blocks, t_tile, w, h, k_s, slope);
  return (int)cudaGetLastError();
}

extern "C" int fpa_grouped_aggregate(
    const void* alpha, const void* ids, const void* hp, const void* blk, void* out,
    int n_blocks, int t_tile, int h, int dh, int k_s, void* stream) {
  const int rows = n_blocks * t_tile;
  if (rows == 0) return 0;
  grouped_aggregate_kernel<<<rows, h * dh, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const int*)ids, (const float*)hp, (const int*)blk,
      (float*)out, n_blocks, t_tile, h, dh, k_s);
  return (int)cudaGetLastError();
}
