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
// What the design does about it. Each K1 gives each row one warp and a
// group of rows one thread block, so the card runs thousands of
// independent rows at once to hide gather latency. A lane loads one
// candidate (grouped: one of the w <= 32 of a tile; flat: one of 32
// consecutive slots), so a step costs one coalesced load per array; the
// per-head theta of a retained slot is re-read from theta_src (+
// theta_rel) at the flush instead of being kept. Both K1s filter each
// tile or 32-slot chunk exactly: the domain's minimum only rises, so a
// candidate at or below it can never be inserted, and a __ballot_sync
// leaves only the others for the serial insert, which finds the first
// minimum again only after an insert.
//  * The grouped K1 (bound at DBLP APA, k_s 8, by 0.77 us of bytes) holds
//    the row's domain (rank, id, edge type) in registers, SPL slots a lane
//    (slot lane + 32 i in element i; SPL 1, 2, 4 or 8 from k_s <= 256). Its
//    first minimum is two __reduce_min_sync: the least order-preserving key
//    of the ranks (-0.0 as +0.0, which compare equal), then the least slot
//    among the lanes that hold it, so the lowest slot among equal minima is
//    evicted, as the rule says; slots past k_s do not take part. The ids of
//    D-tile dt + 2 and the theta gathers of dt + 1 are issued before dt's
//    inserts, so a row's dependent loads overlap its chain. A bypass row
//    moves candidate j of tile dt to slot dt*w + j's lane by shuffles.
//  * The flat K1 keeps the domain in shared memory, 12 bytes a slot, and
//    finds the first minimum by a per-lane scan of strided slots plus a
//    five-step shuffle reduction on (value, slot).
// K2 gives each row one block with a thread per (head, dh) output, so every
// retained h' row is read with one coalesced load of H*dh floats and
// accumulated in a register. All kernels launch on the caller's stream,
// allocate nothing and do not synchronize. Fusing K1 into K2, staging h' in
// shared memory and CUDA graphs across the forward are later work.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

#define NEG (-3.0e38f)
#define POS (3.0e38f)
static constexpr int MAX_KS = 256;               // default max_degree
static constexpr int SLOTS_PER_LANE = MAX_KS / 32;
static constexpr int PREFETCH_H = 8;             // heads whose theta the grouped K1 gathers ahead
static constexpr unsigned NO_KEY = 0xffffffffu;  // above the key of every rank

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

// A row's domain in shared memory (the flat K1's) or in registers, SPL
// slots a lane (the grouped K1's): slot lane + 32 i is element i of a lane.
struct SmemDomain {
  const float* rk;
  const int* rid;
  const int* rety;
  int lane;
  __device__ float rank(int i) const { return rk[lane + 32 * i]; }
  __device__ int id(int i) const { return rid[lane + 32 * i]; }
  __device__ int ety(int i) const { return rety[lane + 32 * i]; }
};
template <int SPL>
struct RegDomain {
  const float (&rk)[SPL];
  const int (&rid)[SPL];
  const int (&rety)[SPL];
  __device__ float rank(int i) const { return rk[i]; }
  __device__ int id(int i) const { return rid[i]; }
  __device__ int ety(int i) const { return rety[i]; }
};

// K1's flush for one row (one warp): LeakyReLU + masked softmax over the
// retained slots s < k_eff, per head; writes alpha_row (k_s, H) and
// ids_row (k_s), 0 and -1 on empty slots. A slot is read only below k_s.
template <int SPL, typename Domain>
__device__ __forceinline__ void flush_row(
    const Domain& dom, int k_s, int k_eff,
    const float* __restrict__ theta_src, const float* __restrict__ theta_rel,
    const float* __restrict__ tdst, int h, float slope, float* __restrict__ alpha_row,
    int* __restrict__ ids_row, int lane) {
  bool ok[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = lane + 32 * i;
    ok[i] = s < k_s && s < k_eff && dom.rank(i) > NEG * 0.5f;
  }
  for (int hh = 0; hh < h; ++hh) {
    const float td = tdst[hh];
    float tv[SPL];
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      tv[i] = 0.f;
      if (ok[i]) {
        float t = theta_of(theta_src, theta_rel, dom.id(i), dom.ety(i), h, hh) + td;
        t = t >= 0.f ? t : slope * t;
        tv[i] = t;
        mx = fmaxf(mx, t);
      }
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if (ok[i]) {
        tv[i] = expf(tv[i] - mx);
        sum += tv[i];
      }
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
    const float denom = sum + 1e-30f;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = lane + 32 * i;
      if (s < k_s) alpha_row[(size_t)s * h + hh] = ok[i] ? tv[i] / denom : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = lane + 32 * i;
    if (s < k_s) ids_row[s] = ok[i] ? dom.id(i) : -1;
  }
}

// A rank as an unsigned key in its order, -0.0 as +0.0 (they compare
// equal), and back (the zero then comes back as +0.0, which compares the
// same).
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_order_key(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The first minimum (lowest slot among equal minima) of a domain held SPL
// slots a lane, on every lane: the least key over the warp, then the least
// slot among the lanes holding it. Slots past k_s do not exist; slots
// parked at POS compare by their value, above every rank.
template <int SPL>
__device__ __forceinline__ void reg_first_min(const float (&rk)[SPL], int k_s, int lane,
                                              float& mv, int& mi) {
  unsigned lk = NO_KEY;
  int ls = MAX_KS;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = lane + 32 * i;
    const unsigned key = s < k_s ? order_key(rk[i]) : NO_KEY;
    if (key < lk) {  // a lane's slots rise with i: the first among equals stays
      lk = key;
      ls = s;
    }
  }
  const unsigned mk = __reduce_min_sync(FULL_MASK, lk);
  mi = (int)__reduce_min_sync(FULL_MASK, lk == mk ? (unsigned)ls : NO_KEY);
  mv = from_order_key(mk);
}

// One D-tile's candidate on a lane (lane < w): its global id, edge type and
// mask, and the theta of its first PREFETCH_H heads, gathered ahead.
struct Cand {
  int id, e;
  bool v;
  float ts[PREFETCH_H], tr[PREFETCH_H];
};

__device__ __forceinline__ void load_ids(Cand& c, const int* __restrict__ nbr,
                                         const unsigned char* __restrict__ msk,
                                         const int* __restrict__ ety, size_t base, bool live,
                                         int lane, int w) {
  c.v = live && lane < w && msk[base + lane];
  c.id = c.v ? nbr[base + lane] : -1;
  c.e = c.v && ety != nullptr ? ety[base + lane] : 0;
}

__device__ __forceinline__ void load_theta(Cand& c, const float* __restrict__ theta_src,
                                           const float* __restrict__ theta_rel, int h) {
#pragma unroll
  for (int hh = 0; hh < PREFETCH_H; ++hh) {
    c.ts[hh] = 0.f;
    c.tr[hh] = 0.f;
    if (c.v && hh < h) {
      c.ts[hh] = theta_src[(size_t)c.id * h + hh];
      if (theta_rel != nullptr) c.tr[hh] = theta_rel[(size_t)c.e * h + hh];
    }
  }
}

// The candidate's rank: the left-to-right head sum of theta_src[id]
// (+ theta_rel[ety]), as theta_of sums it; NEG when masked.
__device__ __forceinline__ float cand_rank(const Cand& c, const float* __restrict__ theta_src,
                                           const float* __restrict__ theta_rel, int h) {
  if (!c.v) return NEG;
  float r = 0.f;
#pragma unroll
  for (int hh = 0; hh < PREFETCH_H; ++hh) {
    if (hh < h) {
      const float t = theta_rel != nullptr ? c.ts[hh] + c.tr[hh] : c.ts[hh];
      r = hh == 0 ? t : r + t;
    }
  }
  for (int hh = PREFETCH_H; hh < h; ++hh) r = r + theta_of(theta_src, theta_rel, c.id, c.e, h, hh);
  return r;
}

// K1. grid = n_blocks row blocks, block = (32, t_tile): warp y owns grouped
// row blockIdx.x * t_tile + y. The row's domain lives in registers, SPL
// slots a lane (slot lane + 32 i in element i), SPL * 32 >= k_s.
template <int SPL>
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
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b = blockIdx.x;
  const int first = blk[b];
  const int n_dt = blk[n_blocks + b];
  const int bypass = blk[2 * n_blocks + b];
  const int k_eff = blk[3 * n_blocks + b];
  const size_t row = (size_t)b * t_tile + warp;
  auto tile_base = [&](int dt) { return ((size_t)(first + dt) * t_tile + warp) * w; };

  float rk[SPL];
  int rid[SPL], rety[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    rk[i] = lane + 32 * i < k_eff ? NEG : POS;
    rid[i] = -1;
    rety[i] = 0;
  }
  float mv = NEG;
  int mi = 0;
  if (!bypass) reg_first_min(rk, k_s, lane, mv, mi);

  // two tiles ahead: the ids of D-tile dt + 2 and the theta of dt + 1 are
  // in flight while dt's candidates go in
  Cand cur, nxt;
  load_ids(cur, nbr, msk, ety, tile_base(0), n_dt > 0, lane, w);
  load_theta(cur, theta_src, theta_rel, h);
  load_ids(nxt, nbr, msk, ety, tile_base(1), n_dt > 1, lane, w);
  for (int dt = 0; dt < n_dt; ++dt) {
    load_theta(nxt, theta_src, theta_rel, h);
    Cand after;
    load_ids(after, nbr, msk, ety, tile_base(dt + 2), dt + 2 < n_dt, lane, w);
    const float cr = cand_rank(cur, theta_src, theta_rel, h);
    if (bypass) {
      // §4.3: capacity <= K, candidate j of D-tile dt is kept in slot dt*w + j
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const int j = lane + 32 * i - dt * w;
        const float v = __shfl_sync(FULL_MASK, cr, j & 31);
        const int id = __shfl_sync(FULL_MASK, cur.id, j & 31);
        const int e = __shfl_sync(FULL_MASK, cur.e, j & 31);
        if (j >= 0 && j < w) {
          rk[i] = v;
          rid[i] = id;
          rety[i] = e;
        }
      }
    } else {
      // exact filter: the minimum only rises, so a candidate at or below
      // it now is never inserted; the rest go in slot order
      unsigned live = __ballot_sync(FULL_MASK, cr > mv);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1u;
        const float v = __shfl_sync(FULL_MASK, cr, src);
        const int id = __shfl_sync(FULL_MASK, cur.id, src);
        const int e = __shfl_sync(FULL_MASK, cur.e, src);
        if (v > mv) {
#pragma unroll
          for (int i = 0; i < SPL; ++i) {
            if (lane + 32 * i == mi) {
              rk[i] = v;
              rid[i] = id;
              rety[i] = e;
            }
          }
          reg_first_min(rk, k_s, lane, mv, mi);
          live &= __ballot_sync(FULL_MASK, cr > mv);
        }
      }
    }
    cur = nxt;
    nxt = after;
  }

  flush_row<SPL>(RegDomain<SPL>{rk, rid, rety}, k_s, k_eff, theta_src, theta_rel,
                 theta_dst + (size_t)row_targets[row] * h, h, slope, alpha + row * k_s * h,
                 ids + row * k_s, lane);
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

  flush_row<SLOTS_PER_LANE>(SmemDomain{rk, rid, rety, lane}, k, k, theta_src, theta_rel,
                            theta_dst + (size_t)row * h, h, slope, alpha + (size_t)row * k * h,
                            ids + (size_t)row * k, lane);
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

template <int SPL>
static int launch_grouped_prune(const void* nbr, const void* msk, const void* ety,
                                const void* theta_src, const void* theta_rel,
                                const void* theta_dst, const void* row_targets, const void* blk,
                                void* alpha, void* ids, int n_blocks, int t_tile, int w, int h,
                                int k_s, float slope, cudaStream_t stream) {
  grouped_prune_kernel<SPL><<<n_blocks, dim3(32, t_tile), 0, stream>>>(
      (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
      (const float*)theta_rel, (const float*)theta_dst, (const int*)row_targets,
      (const int*)blk, (float*)alpha, (int*)ids, n_blocks, t_tile, w, h, k_s, slope);
  return (int)cudaGetLastError();
}

extern "C" int fpa_grouped_prune(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, const void* row_targets,
    const void* blk, void* alpha, void* ids, int n_blocks, int t_tile, int w,
    int h, int k_s, float slope, void* stream) {
  if (n_blocks == 0) return 0;
  if (k_s < 1 || k_s > MAX_KS || w < 1 || w > 32) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the domain's slots a lane, a power of two
  if (k_s <= 32)
    return launch_grouped_prune<1>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets,
                                   blk, alpha, ids, n_blocks, t_tile, w, h, k_s, slope, st);
  if (k_s <= 64)
    return launch_grouped_prune<2>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets,
                                   blk, alpha, ids, n_blocks, t_tile, w, h, k_s, slope, st);
  if (k_s <= 128)
    return launch_grouped_prune<4>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets,
                                   blk, alpha, ids, n_blocks, t_tile, w, h, k_s, slope, st);
  return launch_grouped_prune<8>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets,
                                 blk, alpha, ids, n_blocks, t_tile, w, h, k_s, slope, st);
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
