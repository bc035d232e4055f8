// ADE top-K pruned decode attention for Hopper: a kernel pair.
//
// Replaces the TPU kernel pair of
// repro/kernels/topk_decode_attention/kernel.py:
//   topk_decode_attention_pallas (kernel.py:97), whose bodies are
//   K1 _score_prune_kernel (kernel.py:31-80) and
//   K2 _value_gather_kernel (kernel.py:83-91).
//
// What it computes. One decode token's query q (B, H, dh) against a KV
// cache (B, S, Hkv, dh), q-head h reading kv-head h / (H / Hkv) (GQA). K1
// forms the logits scale * q.k in float32 for every position below the
// row's length and keeps, per (batch, q-head), what the TPU kernel's
// K-slot retention domain keeps: positions stream in order into a domain
// of NEG slots, a position replaces the FIRST minimum slot only if its
// logit is STRICTLY greater (kernels/common.py min_replace). At the flush,
// slots at or below NEG/2 are empty (alpha 0, id -1); the rest get a
// softmax (eps 1e-30). The TPU kernel returns only the attention output
// (kernel.py:164), so the domain's slot order is internal to it; this K1
// writes the retained set in the canonical layout of ref.py: positions
// ascending, alpha alongside, empty slots last. K2 sums alpha * V[id] over
// the slots in float32, in a fixed order; an empty slot adds nothing. q and
// the cache are read as stored, float32 or bfloat16, and converted in
// registers, so no float32 copy of the cache is made (the TPU wrapper casts
// and pads the whole cache first, kernel.py:112 and :158).
//
// What bounds it on an H100. K1 must read the valid keys once: at
// gemma3-4b decode shapes (B 4, Hkv 4, dh 256, S 3104, lengths ~3073, in
// bfloat16) 25.7 MB, 0.0077 ms at 3.35 TB/s. K2 must read the distinct
// retained V rows (23 MB there). Neither does enough arithmetic to matter
// (about 2 FLOP a key byte with 2 q-heads a kv-head: no tensor cores).
//
// What K1's design does about it. The whole card reads the keys, and the
// common path has no serial chain.
//  * Grid: a thread block cluster of K1_CLUSTER blocks per (batch,
//    kv-head) (128 blocks at gemma3-4b), each block scoring for all the
//    group's q-heads, so each key row is read once.
//  * Phase A, logits. The row's keys are cut into tiles of 16 KB; a block
//    claims tiles one at a time from a counter in the cluster's rank-0
//    shared memory (a cluster may share SMs with another when its GPC has
//    fewer than 8 free, and a block on a shared SM then takes fewer), and
//    copies each into shared memory by 16-byte cp.async, K1_STAGES tiles in
//    flight. The dot products are formed from shared memory in one fixed
//    order: lane l sums the products of dims l, l+32, ... (__fmul_rn /
//    __fadd_rn, no FMA; q of its first 8 dims in registers), the lanes
//    combine by an xor butterfly (16, 8, 4, 2, 1), then one multiply by the
//    scale. ref.py score_logits_plain repeats that order, so kernel and
//    plain logits are bit-identical. A warp's butterflies of its rows and
//    q-heads run as one reduce-scatter (the butterfly leaves the same bits
//    on every lane, so the lane that ends with a sum holds lane 0's). The
//    logits go to a float32 scratch (B, H, S) that stays in L2.
//  * Phase B, after one cluster barrier, in every block alike over the
//    whole row (read back into shared memory where it fits), so no block
//    waits on another again. Each valid logit is keyed by its bits made
//    monotone, -0.0 as +0.0 (the chain's > ties them). A radix select of 4
//    passes of 8 bits finds t, the key of the min(K, length)-th largest;
//    after two passes only the positions whose key starts with the 16 bits
//    found are listed for the last two.
//  * The fast path, when exactly min(K, length) valid logits are >= t and
//    no valid logit is NaN or at or below NEG/2. Then the domain keeps
//    exactly {p : logit_p >= t}: when one of those K' logits arrives, the
//    full domain holds at most K' - 1 of the others, so its minimum is
//    below t and the logit enters; an evicted slot is a minimum, and a
//    minimum at or above t would mean all K' are in and nothing can
//    enter, so none of them is ever evicted. Every block counts the kept
//    logits before its eighth of the row, and the softmax's maximum and
//    its sum of expf(v - max) over the row in one fixed order (threads,
//    lanes by butterfly, warps), so all blocks hold the same bits; each
//    writes its eighth's kept positions in order (a ballot and a popcount
//    within a warp, warps through shared memory). The same inputs give the
//    same bits on every run.
//  * The tie path, every other row (ties at t that straddle the last slot,
//    a NaN, a logit at or below NEG/2, length 0). The cluster's rank-0
//    block runs the TPU kernel's chain over that row's logits, read back
//    from the scratch, one warp per q-head with its domain in shared
//    memory: a ballot fill of the empty slots, an exact ballot filter
//    against the domain's minimum, which only rises, and a first-minimum
//    scan after each insert. Then it sorts the domain into the canonical
//    layout (a bitonic sort by position). K1 writes, per (batch, q-head),
//    whether the row took this path.
// One launch per call; K1 launches on the caller's stream, allocates
// nothing and does not synchronize.
//
// K2 splits each (batch, q-head)'s K slots over a thread block cluster of
// K2_CLUSTER blocks of K2_WARPS warps (8 x 8: 256 blocks and 2048 warps at
// gemma3-4b), so the card has enough row loads in flight. A warp takes a
// contiguous run of slots and reads each retained row whole, 16 bytes a
// lane (a 512 B bfloat16 row of dh 256 is one load a lane; a row whose
// bytes are not a multiple of 16, or a cache not 16-byte aligned, is read
// one element a load, and rows narrower than a warp are read several at
// once), K2_LOADS loads a lane in flight. An empty slot (id -1) loads
// nothing and adds nothing. Each lane sums its dims over its slots in slot
// order in float32; the warp's lanes that shared rows combine in a fixed
// butterfly, the block's warps in warp order through shared memory, and
// the cluster's blocks in rank order through distributed shared memory.
// No atomics and a fixed order: the same inputs give the same bits on
// every run. K2 launches on the caller's stream, allocates nothing and
// does not synchronize.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define FULL_MASK 0xffffffffu
#define NEG (-3.0e38f)

static constexpr int K1_CLUSTER = 8;      // K1 blocks of a (batch, kv-head): a portable cluster
static constexpr int K1_WARPS = 8;
static constexpr int K1_THREADS = K1_WARPS * 32;
static constexpr int K1_QPL = 8;          // q dims a lane holds in registers (dh <= 256)
static constexpr int K1_STAGES = 3;       // key tiles in flight
// A cluster's 8 blocks may not find 8 free SMs in a GPC, and then two share
// one: K1's optional buffers (the row's logits, the radix candidates) are
// kept only while a block needs at most half an SM's shared memory.
static constexpr int K1_PAIR_SMEM = 112 * 1024;
static constexpr int K1_STAGE_BYTES = 16384;
static constexpr int MAX_GROUP = 32;      // q-heads of a kv-head (one bit each in the tie mask)
static constexpr int HIST_WORDS = 260;    // 256 digit counts and the count of NaN / NEG-band logits
static constexpr int STATE_WORDS = 8;     // per q-head state of the selection
static constexpr int K2_CLUSTER = 8;      // K2 blocks of a (batch, q-head): a portable cluster
static constexpr int K2_WARPS = 8;        // warps of a K2 block
static constexpr int K2_LOADS = 16;       // row loads a K2 lane has in flight
static constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block can opt into

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The domain's first minimum (lowest slot among equal minima), on every
// lane of the warp.
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

// A logit's bits made monotone in its value, -0.0 mapped onto +0.0.
__device__ __forceinline__ unsigned mono_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// K1's dynamic shared memory: the group's q (float), then either the
// phase-A/B region (key tiles, 16-byte aligned; a histogram and the
// selection's state per q-head; a warp scratch, the tile claims and the
// cluster's tile counter; where they fit, the row's logits and the radix
// candidates) or, in the tie path, the domains (a value and a position per
// slot and q-head), which reuse it.
struct K1Smem {
  size_t stage_off, stage_bytes, hist_off, state_off, scratch_off, row_off, cand_off, total;  // bytes
  int tile_rows;
  bool row, cand;  // the row's logits, and a list of positions a q-head, fit in shared memory
};
__host__ __device__ __forceinline__ K1Smem k1_smem(int group, int dh, int k, int elem, int s) {
  K1Smem L;
  const size_t q_bytes = (size_t)group * dh * 4;
  const size_t row_bytes = (size_t)dh * elem;
  size_t tr = K1_STAGE_BYTES / row_bytes;
  tr = tr < 1 ? 1 : (tr > 64 ? 64 : tr);
  L.tile_rows = (int)tr;
  L.stage_bytes = (tr * row_bytes + 15) & ~(size_t)15;
  L.stage_off = (q_bytes + 15) & ~(size_t)15;
  L.hist_off = L.stage_off + K1_STAGES * L.stage_bytes;
  L.state_off = L.hist_off + (size_t)group * HIST_WORDS * 4;
  L.scratch_off = L.state_off + (size_t)group * STATE_WORDS * 4;
  L.row_off = L.scratch_off + (size_t)(2 * K1_WARPS + K1_STAGES + 3) * 4;
  // phase B reads the row's logits from shared memory where they fit
  L.row = L.row_off + (size_t)group * s * 4 <= (size_t)K1_PAIR_SMEM;
  L.cand_off = L.row_off + (size_t)group * s * 4;
  L.cand = L.row && L.cand_off + (size_t)group * s * 4 <= (size_t)K1_PAIR_SMEM;
  const size_t a_end = L.cand ? L.cand_off + (size_t)group * s * 4 : (L.row ? L.cand_off : L.row_off);
  const size_t dom_end = q_bytes + (size_t)group * k * 8;
  L.total = a_end > dom_end ? a_end : dom_end;
  return L;
}

// per q-head state words
enum { ST_PREFIX, ST_REM, ST_BAD, ST_EQ, ST_FAST, ST_NC };

// A block-wide sum of per-thread floats in a fixed order (lanes by
// butterfly, then warps in order); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = scratch[0];
  for (int w = 1; w < K1_WARPS; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// The tie path of one q-head, by one warp: the TPU kernel's chain over the
// row's logits lg[0 .. len), its flush, and the domain sorted into the
// canonical layout.
__device__ void tie_path_row(const float* lg, int len, int k, float* rv, int* ri,
                             float* a_out, int* i_out, int lane) {
  for (int s = lane; s < k; s += 32) {
    rv[s] = NEG;
    ri[s] = -1;
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  // the fill: logits above NEG take the empty slots in position order
  int filled = 0, c = 0;
  unsigned live = 0;
  float cur = NEG;
  bool full = false;
  for (int c0 = 0; c0 < len && !full; c0 += 32) {
    const int p = c0 + lane;
    const float cand = p < len ? __ldcg(lg + p) : NEG;
    unsigned fill = __ballot_sync(FULL_MASK, cand > NEG);
    const int room = k - filled;
    const int rnk = __popc(fill & below);
    if (((fill >> lane) & 1u) && rnk < room) {
      rv[filled + rnk] = cand;
      ri[filled + rnk] = p;
    }
    const int n = __popc(fill);
    if (n < room) {
      filled += n;
    } else {  // full: the chunk's candidates past the first `room` go through the chain
      for (int r = 0; r < room; ++r) fill &= fill - 1u;
      full = true;
      c = c0;
      live = fill;
      cur = cand;
    }
  }
  __syncwarp();
  if (full) {
    float mv;
    int mi;
    domain_first_min(rv, k, lane, mv, mi);
    // exact filter: the minimum only rises, so a position at or below it
    // now is never inserted; the rest go in position order
    live &= __ballot_sync(FULL_MASK, cur > mv);
    for (;;) {
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1u;
        const float v = __shfl_sync(FULL_MASK, cur, src);
        if (v > mv) {
          __syncwarp();
          if (lane == 0) {
            rv[mi] = v;
            ri[mi] = c + src;
          }
          __syncwarp();
          domain_first_min(rv, k, lane, mv, mi);
        }
      }
      c += 32;
      if (c >= len) break;
      const int p = c + lane;
      cur = p < len ? __ldcg(lg + p) : NEG;
      live = __ballot_sync(FULL_MASK, cur > mv);
    }
  }
  // the flush's softmax over the non-empty slots
  float mx = NEG;
  for (int i = lane; i < k; i += 32) {
    const float v = rv[i];
    if (v > NEG * 0.5f) mx = fmaxf(mx, v);
  }
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
  float sum = 0.f;
  for (int i = lane; i < k; i += 32) {
    const float v = rv[i];
    if (v > NEG * 0.5f) sum += expf(v - mx);
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
  const float denom = sum + 1e-30f;
  // the canonical layout: a bitonic sort by position, empty slots keyed
  // above every position; slots past k act as +inf padding and never move
  for (int i = lane; i < k; i += 32)
    if (!(rv[i] > NEG * 0.5f)) ri[i] = 0x7fffffff;
  int n = 1;
  while (n < k) n <<= 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncwarp();
      for (int i = lane; i < (n >> 1); i += 32) {
        const int a = (i / stride) * 2 * stride + (i % stride);
        const int bb = stride == (size >> 1) ? (a ^ (size - 1)) : a + stride;
        if (bb < k && ri[bb] < ri[a]) {
          const int ti = ri[a];
          ri[a] = ri[bb];
          ri[bb] = ti;
          const float tv = rv[a];
          rv[a] = rv[bb];
          rv[bb] = tv;
        }
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const int id = ri[i];
    const bool ok = id != 0x7fffffff;
    a_out[i] = ok ? expf(rv[i] - mx) / denom : 0.f;
    i_out[i] = ok ? id : -1;
  }
}

// Copies rows [p0, p0 + rows) of a (batch, kv-head)'s keys into a tile of
// shared memory: 16-byte cp.async copies where the rows allow, else one
// element a load. Commits a cp.async group either way.
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* kbase, size_t row_stride, int p0,
                                           int rows, int dh, bool wide, int tid) {
  if (wide) {
    const int cpr = dh * (int)sizeof(T) / 16;
    for (int c = tid; c < rows * cpr; c += K1_THREADS) {
      const int r = c / cpr, j = c - r * cpr;
      cp_async16(reinterpret_cast<unsigned char*>(dst + (size_t)r * dh) + 16 * j,
                 reinterpret_cast<const unsigned char*>(kbase + (size_t)(p0 + r) * row_stride) + 16 * j);
    }
  } else {
    for (int e = tid; e < rows * dh; e += K1_THREADS) {
      const int r = e / dh, d = e - r * dh;
      dst[e] = kbase[(size_t)(p0 + r) * row_stride + d];
    }
  }
  cp_async_commit();
}

// The logits of G q-heads (from g0) for the rows of a key tile: a warp
// takes RB rows at once (RB * G sums in flight); lane l sums the products
// of dims l, l+32, ... (q of its first K1_QPL dims in registers), then an
// xor butterfly, then one multiply by the scale. Lane 0 writes the logits
// to the scratch.
template <typename T, int G>
__device__ __forceinline__ void score_tile(const T* kt, int rows, int dh, int group, int g0,
                                           const float* qs, float* lg0, size_t s, int p0,
                                           float scale, int warp, int lane) {
  constexpr int RB = G <= 2 ? 2 : 1;
  float qr[G][K1_QPL];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < K1_QPL; ++i) {
      const int d = lane + 32 * i;
      qr[j][i] = g0 + j < group && d < dh ? qs[(g0 + j) * dh + d] : 0.f;
    }
  for (int r0 = warp; r0 < rows; r0 += RB * K1_WARPS) {
    const T* kr[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int r = r0 + u * K1_WARPS;
      kr[u] = kt + (size_t)(r < rows ? r : r0) * dh;  // a row past the tile repeats r0, unwritten
    }
    float a[RB][G];
#pragma unroll
    for (int u = 0; u < RB; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) a[u][j] = 0.f;
#pragma unroll
    for (int i = 0; i < K1_QPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) {
        float x[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) x[u] = to_f32(kr[u][d]);
#pragma unroll
        for (int u = 0; u < RB; ++u)
#pragma unroll
          for (int j = 0; j < G; ++j) a[u][j] = __fadd_rn(a[u][j], __fmul_rn(qr[j][i], x[u]));
      }
    }
    for (int d = lane + 32 * K1_QPL; d < dh; d += 32) {  // dims past 256, q from shared memory
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const float x = to_f32(kr[u][d]);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float qv = g0 + j < group ? qs[(g0 + j) * dh + d] : 0.f;
          a[u][j] = __fadd_rn(a[u][j], __fmul_rn(qv, x));
        }
      }
    }
    // the xor butterfly of all RB * G sums as a reduce-scatter: at offset
    // 16, 8, ... a lane keeps half of the sums still shared, adding its
    // partner's copy (own + partner's, as the butterfly adds), so after
    // log2(N) steps lane l holds sum number l >> (5 - log2 N); a butterfly
    // leaves the same bits on every lane, so each is lane 0's
    constexpr int N = RB * G;
    float v[N];
#pragma unroll
    for (int u = 0; u < RB; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) v[u * G + j] = a[u][j];
    int idx = 0;  // which sum this lane holds, once one is left
#pragma unroll
    for (int n = N, off = 16; off > 0; off >>= 1) {
      if (n > 1) {
        const bool upper = (lane & off) != 0;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float keep = upper ? v[i + n / 2] : v[i];
          const float send = upper ? v[i] : v[i + n / 2];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL_MASK, send, off));
        }
        idx += upper ? n / 2 : 0;
        n /= 2;
      } else {
        v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL_MASK, v[0], off));
      }
    }
    if ((lane & (32 / N - 1)) == 0) {  // one lane per sum
      const int u = idx / G, j = idx % G;
      const int r = r0 + u * K1_WARPS;
      if (r < rows && g0 + j < group) lg0[(size_t)(g0 + j) * s + p0 + r] = __fmul_rn(v[0], scale);
    }
  }
}

// q-head g's logit at position p: from the row in shared memory where it
// has room, else from the scratch in L2.
__device__ __forceinline__ float row_logit(const float* rowv, bool in_smem, size_t s, int g, int p) {
  return in_smem ? rowv[(size_t)g * s + p] : __ldcg(rowv + (size_t)g * s + p);
}

// K1. grid = B * Hkv * K1_CLUSTER blocks in clusters of K1_CLUSTER:
// cluster (b, kv-head), block rank r; K1_THREADS threads. G: the q-heads
// scored per pass over a key row (the group, rounded up to a power of two,
// at most 8).
template <typename T, int G>
__global__ void __cluster_dims__(K1_CLUSTER, 1, 1) __launch_bounds__(K1_THREADS, 1)
score_prune_kernel(
    const T* __restrict__ q,            // (B, H, dh)
    const T* __restrict__ kc,           // (B, S, Hkv, dh)
    const int* __restrict__ lengths,    // (B,)
    float* __restrict__ logits,         // scratch (B, H, S)
    float* __restrict__ alpha,          // out (B, H, k)
    int* __restrict__ ids,              // out (B, H, k)
    int* __restrict__ tie,              // out (B, H): 1 where the row took the tie path
    int h, int hkv, int s, int dh, int k, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = h / hkv;
  const int bk = blockIdx.x / K1_CLUSTER;
  const int b = bk / hkv;
  const int kvh = bk % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const int kk = len < k ? len : k;  // the slots the row can fill
  const int lo = (int)((long long)len * rank / K1_CLUSTER);
  const int hi = (int)((long long)len * (rank + 1) / K1_CLUSTER);
  const size_t head0 = (size_t)b * h + (size_t)kvh * group;  // first q-head of the group
  const K1Smem L = k1_smem(group, dh, k, (int)sizeof(T), s);

  float* qs = reinterpret_cast<float*>(smem);  // (group, dh)
  T* stage = reinterpret_cast<T*>(smem + L.stage_off);
  const size_t stage_elems = L.stage_bytes / sizeof(T);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + L.hist_off);  // (group, HIST_WORDS)
  int* st = reinterpret_cast<int*>(smem + L.state_off);              // (group, STATE_WORDS)
  float* scratch = reinterpret_cast<float*>(smem + L.scratch_off);   // (2 * K1_WARPS)
  int* wcnt = reinterpret_cast<int*>(scratch + K1_WARPS);
  float* rowbuf = L.row ? reinterpret_cast<float*>(smem + L.row_off) : nullptr;  // (group, s)
  int* cand = L.cand ? reinterpret_cast<int*>(smem + L.cand_off) : nullptr;      // (group, s)
  int* claims = wcnt + K1_WARPS;          // (K1_STAGES + 2): the tiles this block claimed, a ring
  int* counter = claims + K1_STAGES + 2;  // rank 0's: the cluster's next unclaimed tile
  float* lg0 = logits + head0 * s;  // q-head g at lg0 + g * s

  for (int i = tid; i < group * dh; i += K1_THREADS) qs[i] = to_f32(q[head0 * dh + i]);
  if (rank == 0 && tid == 0) *counter = 0;
  cluster.sync();  // the counter is set before any block claims a tile
  int* next_tile = cluster.map_shared_rank(counter, 0);

  // phase A: the row's key rows in tiles of tile_rows, claimed one at a
  // time from the cluster's counter, so a block that shares its SM takes
  // fewer; K1_STAGES tiles in flight. Claim c is kept in claims[c % RING].
  // Iteration i computes claim i and issues the copy of claim i +
  // K1_STAGES - 1; thread 0 then stores claim i + K1_STAGES + 1, whose
  // atomic it issued an iteration earlier (so no one waits on it), into
  // the slot of claim i - 1, which every thread has read.
  const T* kbase = kc + ((size_t)b * s * hkv + kvh) * dh;
  const size_t row_stride = (size_t)hkv * dh;
  const bool wide = (dh * (int)sizeof(T)) % 16 == 0 && ((size_t)kc & 15) == 0;
  const int tr = L.tile_rows;
  const int n_tiles = (len + tr - 1) / tr;
  constexpr int RING = K1_STAGES + 2;
  int pending = 0;  // thread 0: the claim to store next
  if (tid == 0) {
    for (int c = 0; c <= K1_STAGES; ++c) claims[c] = atomicAdd(next_tile, 1);
    pending = atomicAdd(next_tile, 1);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K1_STAGES - 1; ++c) {
    const int t = claims[c];
    if (t < n_tiles)
      issue_tile(stage + (size_t)c * stage_elems, kbase, row_stride, t * tr, min(tr, len - t * tr),
                 dh, wide, tid);
    else
      cp_async_commit();
  }
  for (int i = 0;; ++i) {
    cp_async_wait<K1_STAGES - 2>();
    __syncthreads();  // claim i landed for every thread; the buffer refilled next was consumed
    const int tile = claims[i % RING];
    if (tile >= n_tiles) break;  // claims rise, so no later one is a tile either
    const int nt = claims[(i + K1_STAGES - 1) % RING];
    if (nt < n_tiles)
      issue_tile(stage + (size_t)((i + K1_STAGES - 1) % K1_STAGES) * stage_elems, kbase, row_stride,
                 nt * tr, min(tr, len - nt * tr), dh, wide, tid);
    else
      cp_async_commit();
    if (tid == 0) {
      claims[(i + K1_STAGES + 1) % RING] = pending;
      pending = atomicAdd(next_tile, 1);
    }
    const T* kt = stage + (size_t)(i % K1_STAGES) * stage_elems;
    const int p0 = tile * tr;
    const int rows = min(tr, len - p0);
    for (int g0 = 0; g0 < group; g0 += G)
      score_tile<T, G>(kt, rows, dh, group, g0, qs, lg0, s, p0, scale, warp, lane);
  }
  cp_async_wait<0>();
  __threadfence();
  cluster.sync();  // the row's logits are written, by whichever block; no block reads
                   // another's shared memory after this
  if (rowbuf) {    // the row's logits, all of them, into shared memory
    for (int g = 0; g < group; ++g)
      for (int p = tid; p < len; p += K1_THREADS) rowbuf[(size_t)g * s + p] = __ldcg(lg0 + (size_t)g * s + p);
  }
  const float* rowv = rowbuf ? rowbuf : lg0;  // q-head g's logit p at rowv[g * s + p]

  // phase B, in every block alike over the whole row: the radix select of
  // each q-head's kk-th largest key; a row of length 0 has nothing to
  // select and takes the tie path
  if (len > 0) {
    for (int g = tid; g < group; g += K1_THREADS) {
      st[g * STATE_WORDS + ST_PREFIX] = 0;
      st[g * STATE_WORDS + ST_REM] = kk;
    }
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      for (int i = tid; i < group * HIST_WORDS; i += K1_THREADS) hist[i] = 0u;
      __syncthreads();  // the row, the state and a clear histogram
      const bool listed = cand != nullptr && pass >= 2;  // only the positions still in the running
      for (int g = 0; g < group; ++g) {
        const unsigned prefix = (unsigned)st[g * STATE_WORDS + ST_PREFIX];
        unsigned* hg = hist + g * HIST_WORDS;
        const int n_items = listed ? st[g * STATE_WORDS + ST_NC] : len;
        for (int c0 = 0; c0 < n_items; c0 += K1_THREADS) {
          const bool in = c0 + tid < n_items;
          const int p = !in ? 0 : (listed ? cand[(size_t)g * s + c0 + tid] : c0 + tid);
          const float v = in ? row_logit(rowv, rowbuf != nullptr, s, g, p) : 0.f;
          const unsigned key = mono_key(v);
          const bool counted = in && (pass == 0 || (key >> (shift + 8)) == prefix);
          const unsigned digit = (key >> shift) & 255u;
          // lane 0's digit is counted once for every lane that shares it
          // (most do in the first passes); the others add their own
          const unsigned d0 = __shfl_sync(FULL_MASK, counted ? digit : 256u, 0);
          const unsigned same = __ballot_sync(FULL_MASK, counted && digit == d0);
          if (lane == 0 && same) atomicAdd(&hg[d0], __popc(same));
          if (counted && digit != d0) atomicAdd(&hg[digit], 1u);
          if (pass == 0) {
            const unsigned bad = __ballot_sync(FULL_MASK, in && !(v > NEG * 0.5f));  // NaN or NEG band
            if (lane == 0 && bad) atomicAdd(&hg[256], __popc(bad));
          }
        }
      }
      __syncthreads();  // the histograms are complete
      // the digit: warp g reads q-head g's histogram, lane l holding the
      // digits 255 - 8l .. 248 - 8l, and finds where the count from the top
      // reaches the rank still sought
      for (int g = warp; g < group; g += K1_WARPS) {
        int* sg = st + g * STATE_WORDS;
        const int rem = sg[ST_REM];
        const uint4* hv = reinterpret_cast<const uint4*>(hist + g * HIST_WORDS + 248 - 8 * lane);
        const uint4 lo4 = hv[0], hi4 = hv[1];
        const unsigned cnt[8] = {hi4.w, hi4.z, hi4.y, hi4.x, lo4.w, lo4.z, lo4.y, lo4.x};  // digit 255 - 8l - j
        unsigned tot = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) tot += cnt[j];
        unsigned incl = tot;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned o = __shfl_up_sync(FULL_MASK, incl, off);
          if (lane >= off) incl += o;
        }
        unsigned before = incl - tot;
        int hit = -1;
        unsigned hit_before = 0, hit_cnt = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (hit < 0 && before < (unsigned)rem && (unsigned)rem <= before + cnt[j]) {
            hit = j;
            hit_before = before;
            hit_cnt = cnt[j];
          }
          before += cnt[j];
        }
        const unsigned who = __ballot_sync(FULL_MASK, hit >= 0);
        if (who) {  // always, as rem <= the keys still sought
          const int src = __ffs(who) - 1;
          const int digit = 255 - 8 * src - __shfl_sync(FULL_MASK, hit, src);
          const unsigned hb0 = __shfl_sync(FULL_MASK, hit_before, src);
          const unsigned hc = __shfl_sync(FULL_MASK, hit_cnt, src);
          if (lane == 0) {
            sg[ST_PREFIX] = (int)(((unsigned)sg[ST_PREFIX] << 8) | (unsigned)digit);
            sg[ST_REM] = rem - (int)hb0;
            sg[ST_EQ] = (int)hc;
            if (pass == 0) sg[ST_BAD] = (int)hist[g * HIST_WORDS + 256];
          }
        }
      }
      __syncthreads();  // the digits are in the state before the next clear
      if (cand != nullptr && pass == 1) {
        // the positions whose key starts with the 16 bits found: the only
        // ones the last two passes count (in any order)
        for (int g = tid; g < group; g += K1_THREADS) st[g * STATE_WORDS + ST_NC] = 0;
        __syncthreads();
        for (int g = 0; g < group; ++g) {
          const unsigned prefix = (unsigned)st[g * STATE_WORDS + ST_PREFIX];
          for (int c0 = 0; c0 < len; c0 += K1_THREADS) {
            const int p = c0 + tid;
            const bool hit = p < len && (mono_key(row_logit(rowv, true, s, g, p)) >> 16) == prefix;
            const unsigned bal = __ballot_sync(FULL_MASK, hit);
            int at = 0;
            if (lane == 0 && bal) at = atomicAdd(&st[g * STATE_WORDS + ST_NC], __popc(bal));
            at = __shfl_sync(FULL_MASK, at, 0);
            if (hit) cand[(size_t)g * s + at + __popc(bal & below)] = p;
          }
        }
        __syncthreads();
      }
    }
    // exactly kk logits >= t, none NaN or in the NEG band: the fast path
    for (int g = tid; g < group; g += K1_THREADS) {
      int* sg = st + g * STATE_WORDS;
      sg[ST_FAST] = sg[ST_BAD] == 0 && sg[ST_EQ] == sg[ST_REM];
    }
    __syncthreads();

    // per q-head on the fast path: the kept logits before this block's
    // positions [lo, hi), the largest kept logit and the softmax's sum, all
    // over the whole row in a fixed order, so every block gets the same
    for (int g = 0; g < group; ++g) {
      int* sg = st + g * STATE_WORDS;
      if (!sg[ST_FAST]) continue;  // block-uniform
      const unsigned t = (unsigned)sg[ST_PREFIX];
      int cnt = 0;
      float mx = NEG;
      for (int p = tid; p < len; p += K1_THREADS) {
        const float v = row_logit(rowv, rowbuf != nullptr, s, g, p);
        if (mono_key(v) >= t) {
          cnt += p < lo;
          mx = fmaxf(mx, v);
        }
      }
      cnt = __reduce_add_sync(FULL_MASK, cnt);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
      if (lane == 0) {
        wcnt[warp] = cnt;
        scratch[warp] = mx;
      }
      __syncthreads();
      int off = 0;
      float gmax = NEG;
      for (int w = 0; w < K1_WARPS; ++w) {
        off += wcnt[w];
        gmax = fmaxf(gmax, scratch[w]);
      }
      __syncthreads();  // wcnt and scratch are read before block_sum reuses scratch
      float sum = 0.f;
      for (int p = tid; p < len; p += K1_THREADS) {
        const float v = row_logit(rowv, rowbuf != nullptr, s, g, p);
        if (mono_key(v) >= t) sum += expf(v - gmax);
      }
      sum = block_sum(sum, scratch);
      const float denom = sum + 1e-30f;
      // this block's kept positions in order, after the `off` kept before lo
      float* a_out = alpha + (head0 + g) * k;
      int* i_out = ids + (head0 + g) * k;
      int base = off;
      for (int c0 = lo; c0 < hi; c0 += K1_THREADS) {
        const int p = c0 + tid;
        const float v = p < hi ? row_logit(rowv, rowbuf != nullptr, s, g, p) : 0.f;
        const bool kept = p < hi && mono_key(v) >= t;
        const unsigned bal = __ballot_sync(FULL_MASK, kept);
        if (lane == 0) wcnt[warp] = __popc(bal);
        __syncthreads();
        int wpre = 0, total = 0;
        for (int w = 0; w < K1_WARPS; ++w) {
          if (w < warp) wpre += wcnt[w];
          total += wcnt[w];
        }
        if (kept) {
          const int slot = base + wpre + __popc(bal & below);
          i_out[slot] = p;
          a_out[slot] = expf(v - gmax) / denom;
        }
        base += total;
        __syncthreads();  // wcnt is read before the next chunk writes it
      }
      if (rank == 0) {
        for (int i = kk + tid; i < k; i += K1_THREADS) {
          i_out[i] = -1;
          a_out[i] = 0.f;
        }
      }
    }
  }
  if (rank != 0) return;

  // the tie path: the chain in this block, one warp per q-head
  unsigned tie_mask = 0;
  for (int g = 0; g < group; ++g)
    if (len == 0 || !st[g * STATE_WORDS + ST_FAST]) tie_mask |= 1u << g;
  for (int g = tid; g < group; g += K1_THREADS) tie[head0 + g] = (int)((tie_mask >> g) & 1u);
  if (!tie_mask) return;
  __syncthreads();  // the state is read before the domains overwrite it
  float* rd_v = qs + (size_t)group * dh;                            // (group, k)
  int* rd_i = reinterpret_cast<int*>(rd_v + (size_t)group * k);     // (group, k)
  for (int g = warp; g < group; g += K1_WARPS) {
    if (!((tie_mask >> g) & 1u)) continue;
    tie_path_row(lg0 + (size_t)g * s, len, k, rd_v + (size_t)g * k, rd_i + (size_t)g * k,
                 alpha + (head0 + g) * k, ids + (head0 + g) * k, lane);
  }
}

// A row of V read VB bytes at a time: E elements of T, as floats.
template <typename T, int VB> struct RowVec;
template <> struct RowVec<float, 16> {
  using raw = uint4;
  static constexpr int E = 4;
  __device__ static void to_f32(raw r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct RowVec<float, 4> {
  using raw = unsigned;
  static constexpr int E = 1;
  __device__ static void to_f32(raw r, float* f) { f[0] = __uint_as_float(r); }
};
// bfloat16 -> float32 is exact: the 16 bits become the high half
template <> struct RowVec<__nv_bfloat16, 16> {
  using raw = uint4;
  static constexpr int E = 8;
  __device__ static void to_f32(raw r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct RowVec<__nv_bfloat16, 2> {
  using raw = unsigned short;
  static constexpr int E = 1;
  __device__ static void to_f32(raw r, float* f) { f[0] = __uint_as_float((unsigned)r << 16); }
};

// K2. grid = B * H * K2_CLUSTER blocks in clusters of K2_CLUSTER: cluster
// (b, q-head), block rank r; K2_WARPS warps a block. Warp w of rank r sums
// the slots [k p / P, k (p+1) / P) with p = r * K2_WARPS + w of P =
// K2_CLUSTER * K2_WARPS parts, in slot order. A row of V is nvec = dh / E
// loads of VB bytes; ts lanes (a power of two, at most 32) share a row,
// lane m of a team taking loads m, m + ts, ... (NV of them at most), and
// 32 / ts teams read that many rows at once. Dynamic shared memory:
// K2_WARPS * dh floats.
template <typename T, int VB, int NV>
__global__ void __cluster_dims__(K2_CLUSTER, 1, 1) __launch_bounds__(K2_WARPS * 32)
value_gather_kernel(const float* __restrict__ alpha,  // (B, H, k)
                    const int* __restrict__ ids,      // (B, H, k), -1 = empty
                    const T* __restrict__ vc,         // (B, S, Hkv, dh)
                    float* __restrict__ out,          // out (B, H, dh)
                    int h, int hkv, int s, int dh, int k) {
  using V = RowVec<T, VB>;
  using raw_t = typename V::raw;
  constexpr int E = V::E;
  constexpr int U = NV >= K2_LOADS ? 1 : K2_LOADS / NV;  // row steps in flight
  extern __shared__ float part[];                        // (K2_WARPS, dh)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t bh = blockIdx.x / K2_CLUSTER;
  const int b = (int)(bh / h);
  const int kvh = (int)(bh % h) / (h / hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = dh / E;
  int ts = 1;
  while (ts < nvec && ts < 32) ts <<= 1;
  const int rows = 32 / ts;  // rows the warp reads at once
  const int team = lane / ts;
  const int m = lane % ts;
  constexpr int PARTS = K2_CLUSTER * K2_WARPS;
  const int p = rank * K2_WARPS + warp;
  const int lo = (int)((long long)k * p / PARTS);
  const int hi = (int)((long long)k * (p + 1) / PARTS);
  const float* a_row = alpha + bh * k;
  const int* i_row = ids + bh * k;
  const T* vbase = vc + ((size_t)b * s * hkv + kvh) * dh;
  const size_t stride = (size_t)hkv * dh;

  float acc[NV][E];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    // 32 slots' (alpha, id), one a lane, then shuffled to the teams
    const int n = min(32, hi - c0);
    const float a_l = lane < n ? a_row[c0 + lane] : 0.f;
    const int id_l = lane < n ? i_row[c0 + lane] : -1;
    for (int r0 = 0; r0 < n; r0 += U * rows) {
      // U rows' loads in flight, then their sums in slot order; an empty
      // slot (id -1) loads nothing and adds nothing
      raw_t r[U][NV];
      int id[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = r0 + u * rows + team;
        const int x = __shfl_sync(FULL_MASK, id_l, j & 31);
        id[u] = j < n ? x : -1;
        const raw_t* row = reinterpret_cast<const raw_t*>(vbase + (size_t)(id[u] < 0 ? 0 : id[u]) * stride);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (id[u] >= 0 && m + v * ts < nvec) r[u][v] = __ldg(row + m + v * ts);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float a = __shfl_sync(FULL_MASK, a_l, (r0 + u * rows + team) & 31);
        if (id[u] >= 0) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            if (m + v * ts < nvec) {
              float f[E];
              V::to_f32(r[u][v], f);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[v][e] = fmaf(a, f[e], acc[v][e]);
            }
          }
        }
      }
    }
  }
  // the teams' sums, in a fixed butterfly order; team 0 writes the warp's
  for (int off = ts; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[v][e] += __shfl_xor_sync(FULL_MASK, acc[v][e], off);
  if (team == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (m + v * ts < nvec)
#pragma unroll
        for (int e = 0; e < E; ++e) part[warp * dh + (m + v * ts) * E + e] = acc[v][e];
  }
  __syncthreads();
  // the block's sum, warps in order, into part[0 .. dh)
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float sum = part[d];
    for (int w = 1; w < K2_WARPS; ++w) sum += part[w * dh + d];
    part[d] = sum;
  }
  cluster.sync();
  // the cluster's sum, ranks in order, read from their shared memory; each
  // rank writes every K2_CLUSTER-th dim
  for (int d = rank + K2_CLUSTER * (int)threadIdx.x; d < dh; d += K2_CLUSTER * blockDim.x) {
    float sum = 0.f;
    for (int q = 0; q < K2_CLUSTER; ++q) sum += cluster.map_shared_rank(part, q)[d];
    out[bh * dh + d] = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

extern "C" int tda_max_k(int group, int dh) {
  const long long free_bytes = (long long)MAX_SMEM - (long long)group * dh * 4;
  return free_bytes <= 0 ? 0 : (int)(free_bytes / (8LL * group));
}

template <typename T, int G>
static int launch_score_prune(const void* q, const void* kc, const void* lengths, void* logits,
                              void* alpha, void* ids, void* tie, int b, int h, int hkv, int s,
                              int dh, int k, float scale, cudaStream_t stream) {
  const size_t shmem = k1_smem(h / hkv, dh, k, (int)sizeof(T), s).total;
  if (shmem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(score_prune_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  score_prune_kernel<T, G><<<b * hkv * K1_CLUSTER, K1_THREADS, shmem, stream>>>(
      (const T*)q, (const T*)kc, (const int*)lengths, (float*)logits, (float*)alpha, (int*)ids,
      (int*)tie, h, hkv, s, dh, k, scale);
  return (int)cudaGetLastError();
}

// G: the group rounded up to a power of two, at most 8
template <typename T>
static int launch_score_prune_g(const void* q, const void* kc, const void* lengths, void* logits,
                                void* alpha, void* ids, void* tie, int b, int h, int hkv, int s,
                                int dh, int k, float scale, cudaStream_t stream) {
  const int group = h / hkv;
  if (group <= 1)
    return launch_score_prune<T, 1>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv, s, dh, k, scale, stream);
  if (group <= 2)
    return launch_score_prune<T, 2>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv, s, dh, k, scale, stream);
  if (group <= 4)
    return launch_score_prune<T, 4>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv, s, dh, k, scale, stream);
  return launch_score_prune<T, 8>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv, s, dh, k, scale, stream);
}

extern "C" int tda_score_prune(const void* q, const void* kc, const void* lengths, void* logits,
                               void* alpha, void* ids, void* tie, int b, int h, int hkv, int s,
                               int dh, int k, float scale, int bf16, void* stream) {
  if (b == 0) return 0;
  if (hkv < 1 || h % hkv || h / hkv > MAX_GROUP || dh < 1 || k < 1 || k > s)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_score_prune_g<__nv_bfloat16>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv,
                                               s, dh, k, scale, (cudaStream_t)stream);
  return launch_score_prune_g<float>(q, kc, lengths, logits, alpha, ids, tie, b, h, hkv, s, dh, k,
                                     scale, (cudaStream_t)stream);
}

template <typename T, int VB, int NV>
static int launch_gather(const void* alpha, const void* ids, const void* vc, void* out, int b,
                         int h, int hkv, int s, int dh, int k, cudaStream_t stream) {
  value_gather_kernel<T, VB, NV><<<b * h * K2_CLUSTER, K2_WARPS * 32,
                                   (size_t)K2_WARPS * dh * sizeof(float), stream>>>(
      (const float*)alpha, (const int*)ids, (const T*)vc, (float*)out, h, hkv, s, dh, k);
  return (int)cudaGetLastError();
}

// NV: the loads of a row a lane takes, rounded up to a power of two
template <typename T, int VB>
static int launch_gather_nv(int nv, const void* alpha, const void* ids, const void* vc, void* out,
                            int b, int h, int hkv, int s, int dh, int k, cudaStream_t stream) {
  switch (nv) {
    case 1: return launch_gather<T, VB, 1>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
    case 2: return launch_gather<T, VB, 2>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
    case 4: return launch_gather<T, VB, 4>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
    case 8: return launch_gather<T, VB, 8>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
  }
  if constexpr (VB == (int)sizeof(T)) {  // one element a load: dh up to 1024 is 32 a lane
    if (nv == 16) return launch_gather<T, VB, 16>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
    if (nv == 32) return launch_gather<T, VB, 32>(alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_value_gather(const void* alpha, const void* ids, const void* vc, void* out,
                               int b, int h, int hkv, int s, int dh, int k, cudaStream_t stream) {
  // 16-byte loads when every row starts on 16 bytes, else one element a load
  const bool wide = ((size_t)dh * sizeof(T)) % 16 == 0 && (size_t)vc % 16 == 0;
  const int e = wide ? 16 / (int)sizeof(T) : 1;
  const int nvec = dh / e;
  const int ts = nvec >= 32 ? 32 : nvec;
  int nv = 1;
  while (nv * ts < nvec) nv <<= 1;
  if (wide)
    return launch_gather_nv<T, 16>(nv, alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
  return launch_gather_nv<T, (int)sizeof(T)>(nv, alpha, ids, vc, out, b, h, hkv, s, dh, k, stream);
}

extern "C" int tda_value_gather(const void* alpha, const void* ids, const void* vc, void* out,
                                int b, int h, int hkv, int s, int dh, int k, int bf16,
                                void* stream) {
  if (b == 0) return 0;
  if (dh < 1 || dh > 1024 || hkv < 1 || h % hkv) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_value_gather<__nv_bfloat16>(alpha, ids, vc, out, b, h, hkv, s, dh, k,
                                              (cudaStream_t)stream);
  return launch_value_gather<float>(alpha, ids, vc, out, b, h, hkv, s, dh, k, (cudaStream_t)stream);
}
