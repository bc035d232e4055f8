// ADE fused Neighbor Aggregation for Hopper: two kernel pairs.
//
// The grouped pair replaces the TPU kernel pair of
// repro/kernels/fused_prune_aggregate/kernel.py:
//   fused_prune_aggregate_grouped_pallas (kernel.py:304), whose bodies are
//   K1 _grouped_prune_kernel (kernel.py:219-298) and
//   K2 _grouped_aggregate_kernel (kernel.py:137-150).
// The flat pair replaces
//   fused_prune_aggregate_pallas (kernel.py:153-215), whose bodies are
//   K1 _prune_kernel (kernel.py:69-121) and K2 _aggregate_kernel
//   (kernel.py:124-134), together with its wrapper's theta gather
//   (ops.py:47-56), which this K1 does itself.
//
// What the grouped pair computes. A GroupedBucketLayout stores every degree
// bucket of one semantic graph as a stack of (t_tile, w) tiles, one row
// block's D-tiles contiguous. For each grouped row (one target), K1 streams
// the row's candidates in slot order, ranks each by the left-to-right head
// sum of theta_src[id] (+ theta_rel[ety]), and keeps a K_s-slot retention
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
// What the flat pair computes. The same function over one (T, D)
// padded-CSC table: every row streams its D slots in slot order through a
// k-slot domain, k = min(prune_k, D), with the same rank, rule and flush;
// there is no bypass branch (the caller routes D <= K tables around it).
// K2 accumulates over all k slots. The TPU kernel's wrapper gathers a
// (T, D, H) theta tensor into device memory first; this K1 gathers
// theta_src and theta_rel per valid slot itself, which is the same
// function with less traffic. The TPU kernel pads T to 8 and D to 128;
// here the table is read unpadded.
//
// What bounds them on an H100. Neither pair does enough arithmetic to
// matter (K1: H adds per candidate plus a compare; K2: one FMA per loaded
// float). Both are bound by memory traffic and, at the sizes of one
// semantic graph (a few MB), by latency: dependent gathers (table -> id ->
// theta_src row in K1; ids -> h' row in K2) and the serial insert chain of
// K1, where each candidate needs the domain's minimum after the previous
// insert.
//
// What the design does about it. K1 gives each row one warp and a group of
// rows one thread block, so the card runs thousands of independent rows at
// once to hide gather latency. A lane loads one candidate (grouped: one of
// the w <= 32 of a tile; flat: one of 32 consecutive slots), so a step
// costs one coalesced load per array; the serial insert then runs over warp
// shuffles. The retention domain (rank, id, edge type per slot) lives in
// shared memory, 12 bytes a slot; the per-head theta of a retained slot is
// re-read from theta_src (+ theta_rel) at the flush instead of being kept,
// which keeps the domain small enough for K = 256 without shared-memory
// opt-in. The first-minimum search is a per-lane scan of strided slots
// plus a five-step shuffle reduction on (value, slot), which yields the
// lowest slot among equal minima. The flat K1 also filters each 32-slot
// chunk exactly: the domain's minimum only rises, so a candidate at or
// below the minimum at the start of the chunk can never be inserted, and
// a __ballot_sync leaves only the others for the serial insert, which
// recomputes the minimum only after an insert. K2 gives each row one block
// with a thread per (head, dh) output, so every retained h' row is read
// with one coalesced load of H*dh floats and accumulated in a register.
// All kernels launch on the caller's stream, allocate nothing and do not
// synchronize. Fusing K1 into K2, staging h' in shared memory and CUDA
// graphs across the forward are later work.

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

// The domain's first minimum (lowest slot among equal minima), on every
// lane of the warp.
__device__ __forceinline__ void domain_first_min(const float* rk, int k_s, int lane,
                                                 float& mv, int& mi) {
  mv = __int_as_float(0x7f800000);  // +inf, above POS
  mi = k_s;
  for (int s = lane; s < k_s; s += 32) {
    const float v = rk[s];
    if (v < mv) { mv = v; mi = s; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, mv, off);
    const int oi = __shfl_xor_sync(FULL_MASK, mi, off);
    if (ov < mv || (ov == mv && oi < mi)) { mv = ov; mi = oi; }
  }
}

// K1's flush for one row (one warp): LeakyReLU + masked softmax over the
// retained slots s < k_eff, per head; writes alpha_row (k_s, H) and
// ids_row (k_s), 0 and -1 on empty slots.
__device__ __forceinline__ void flush_row(
    const float* rk, const int* rid, const int* rety, int k_s, int k_eff,
    const float* __restrict__ theta_src, const float* __restrict__ theta_rel,
    const float* __restrict__ tdst, int h, float slope, float* __restrict__ alpha_row,
    int* __restrict__ ids_row, int lane) {
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
      if (s < k_s) alpha_row[(size_t)s * h + hh] = ok[i] ? tv[i] / denom : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS_PER_LANE; ++i) {
    const int s = lane + 32 * i;
    if (s < k_s) ids_row[s] = ok[i] ? rid[s] : -1;
  }
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
        float mv;
        int mi;
        domain_first_min(rk, k_s, lane, mv, mi);
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

  flush_row(rk, rid, rety, k_s, k_eff, theta_src, theta_rel,
            theta_dst + (size_t)row_targets[row] * h, h, slope,
            alpha + row * k_s * h, ids + row * k_s, lane);
}

// K2 body: thread t of a row's block accumulates output (head t / dh,
// feature t % dh) as the α-weighted sum of h'[id] over the row's first k
// slots, in slot order.
__device__ __forceinline__ float gather_row(
    const float* __restrict__ alpha_row,  // (k_s, H)
    const int* __restrict__ ids_row,      // (k_s,), -1 = empty
    const float* __restrict__ hp,         // (N, H, dh)
    int h, int dh, int k) {
  const int t = threadIdx.x;
  const int hd = h * dh;
  const int hh = t / dh;
  float acc = 0.f;
  for (int s = 0; s < k; ++s) {
    int id = ids_row[s];
    id = id < 0 ? 0 : id;  // alpha is 0 on empty slots
    acc += alpha_row[s * h + hh] * hp[(size_t)id * hd + t];
  }
  return acc;
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
  const int k_eff = blk[3 * n_blocks + (int)(row / t_tile)];
  out[row * h * dh + threadIdx.x] =
      gather_row(alpha + row * k_s * h, ids + row * k_s, hp, h, dh, k_eff);
}

// Flat K1. grid = ceil(T / rows_per_block), block = (32, rows_per_block):
// warp y owns row blockIdx.x * rows_per_block + y. Dynamic shared memory:
// rows_per_block * k * 12 B.
__global__ void flat_prune_kernel(
    const int* __restrict__ nbr,            // (T, D) global source ids
    const unsigned char* __restrict__ msk,  // (T, D) bool
    const int* __restrict__ ety,            // (T, D) or null
    const float* __restrict__ theta_src,    // (N, H)
    const float* __restrict__ theta_rel,    // (R, H) or null
    const float* __restrict__ theta_dst,    // (T, H)
    float* __restrict__ alpha,              // out (T, k, H)
    int* __restrict__ ids,                  // out (T, k)
    int t, int d, int h, int k, float slope) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int rpb = blockDim.y;
  const int row = blockIdx.x * rpb + warp;
  if (row >= t) return;  // the whole warp leaves together

  float* rk = reinterpret_cast<float*>(smem) + (size_t)warp * k;
  int* rid = reinterpret_cast<int*>(smem) + (size_t)rpb * k + (size_t)warp * k;
  int* rety = reinterpret_cast<int*>(smem) + (size_t)2 * rpb * k + (size_t)warp * k;

  for (int s = lane; s < k; s += 32) {
    rk[s] = NEG;
    rid[s] = -1;
    rety[s] = 0;
  }
  __syncwarp();
  float mv;
  int mi;
  domain_first_min(rk, k, lane, mv, mi);

  const size_t base = (size_t)row * d;
  for (int c = 0; c < d; c += 32) {
    const int j = c + lane;
    const bool valid = j < d && msk[base + j];
    float cr = NEG;
    int cid = -1;
    int ce = 0;
    if (valid) {
      cid = nbr[base + j];
      ce = ety != nullptr ? ety[base + j] : 0;
      float r = theta_of(theta_src, theta_rel, cid, ce, h, 0);
      for (int hh = 1; hh < h; ++hh) r = r + theta_of(theta_src, theta_rel, cid, ce, h, hh);
      cr = r;
    }
    // exact filter: the minimum only rises, so a candidate at or below it
    // now is never inserted; the rest go in slot order
    unsigned live = __ballot_sync(FULL_MASK, valid && cr > mv);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const float cur = __shfl_sync(FULL_MASK, cr, src);
      const int cur_id = __shfl_sync(FULL_MASK, cid, src);
      const int cur_e = __shfl_sync(FULL_MASK, ce, src);
      if (cur > mv) {
        __syncwarp();
        if (lane == 0) {
          rk[mi] = cur;
          rid[mi] = cur_id;
          rety[mi] = cur_e;
        }
        __syncwarp();
        domain_first_min(rk, k, lane, mv, mi);
      }
    }
  }

  flush_row(rk, rid, rety, k, k, theta_src, theta_rel, theta_dst + (size_t)row * h, h,
            slope, alpha + (size_t)row * k * h, ids + (size_t)row * k, lane);
}

// Flat K2. grid = T rows, block = H * dh threads, one per output.
__global__ void flat_aggregate_kernel(
    const float* __restrict__ alpha,  // (T, k, H)
    const int* __restrict__ ids,      // (T, k), -1 = empty
    const float* __restrict__ hp,     // (N, H, dh)
    float* __restrict__ out,          // out (T, H, dh)
    int h, int dh, int k) {
  const size_t row = blockIdx.x;
  out[row * h * dh + threadIdx.x] = gather_row(alpha + row * k * h, ids + row * k, hp, h, dh, k);
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

static constexpr int FLAT_ROWS_PER_BLOCK = 8;

extern "C" int fpa_flat_prune(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, void* alpha, void* ids, int t, int d,
    int h, int k, float slope, void* stream) {
  if (t == 0) return 0;
  const size_t shmem = (size_t)FLAT_ROWS_PER_BLOCK * k * 12;
  const int grid = (t + FLAT_ROWS_PER_BLOCK - 1) / FLAT_ROWS_PER_BLOCK;
  flat_prune_kernel<<<grid, dim3(32, FLAT_ROWS_PER_BLOCK), shmem, (cudaStream_t)stream>>>(
      (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
      (const float*)theta_rel, (const float*)theta_dst, (float*)alpha, (int*)ids, t, d, h, k,
      slope);
  return (int)cudaGetLastError();
}

extern "C" int fpa_flat_aggregate(const void* alpha, const void* ids, const void* hp, void* out,
                                  int t, int h, int dh, int k, void* stream) {
  if (t == 0) return 0;
  flat_aggregate_kernel<<<t, h * dh, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const int*)ids, (const float*)hp, (float*)out, h, dh, k);
  return (int)cudaGetLastError();
}
