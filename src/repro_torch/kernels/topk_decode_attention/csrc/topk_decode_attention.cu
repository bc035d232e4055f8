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
// row's length (the rest are NEG) and keeps, per (batch, q-head), a K-slot
// retention domain over the positions in stream order: a position replaces
// the FIRST minimum slot only if its logit is STRICTLY greater (the TPU
// kernel's rule, kernels/common.py min_replace). On an empty domain that
// rule puts position j in slot j, so the first K positions are placed at
// once and only the later ones stream through the domain. At the flush,
// slots at or below NEG/2 are empty (alpha 0, id -1); the rest get a
// softmax (eps 1e-30). K2 sums alpha * V[id] over the slots in float32,
// in a fixed order; an empty slot adds nothing. q and the cache are read as
// stored, float32 or bfloat16, and converted in registers, so no float32
// copy of the cache is made (the TPU wrapper casts and pads the whole
// cache first, kernel.py:112 and :158).
//
// What bounds it on an H100. K1 must read the valid keys once (at gemma3-4b
// decode shapes, B 4, Hkv 4, dh 256, S 3104 in bfloat16: 25 MB, 7.6 us at
// 3.35 TB/s); K2 must read the distinct retained V rows (23 MB there).
// Neither does enough arithmetic to matter. But K1 has a serial chain:
// once the domain is full, each insert needs the domain's minimum after
// the previous one, about K ln(S/K) inserts per (batch, q-head), and there
// are only B*H such chains. So K1 is bound by that chain's latency, far
// above its byte bound. K2 has no chain, but its B*H sums are few (32 at
// gemma3-4b) against the card's 132 SMs, and each retained row is a
// dependent load: what bounds it is how many row loads are in flight.
//
// What the design does about it. K1 gives one thread block to each
// (batch, kv-head), so each key row is read once for all the group's
// q-heads: a warp takes a position, its lanes read the row's dims
// l, l+32, ... and the group's dot products are reduced over the warp.
// The logits go to a float32 scratch (B, H, S) that stays in L2. Each
// q-head's domain (value and position, 8 B a slot) lives in shared memory;
// one warp per q-head runs its chain: 32 positions at a time, filtered
// exactly with one __ballot_sync against the current minimum (the minimum
// only rises, so a position at or below it is never inserted), then each
// survivor in order, with the first-minimum search (a strided scan and a
// shuffle reduction on (value, slot)) redone only after an insert. Every
// product and sum of a logit is one rounding (__fmul_rn / __fadd_rn, no
// FMA contraction), in an order the plain version (ref.py) repeats, so
// kernel and plain logits and retained ids are bit-identical. Shortening
// K1's chain (the Pruner's two-level winner tree, topk_select.cu) is later
// work.
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
// every run. Both kernels launch on the caller's stream, allocate nothing
// and do not synchronize.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define FULL_MASK 0xffffffffu
#define NEG (-3.0e38f)

static constexpr int K1_THREADS = 256;
static constexpr int MAX_G = 8;           // q-heads of a group scored per pass over a key row
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

// Dynamic shared memory of K1: the group's q (float) and its domains.
__host__ __device__ __forceinline__ size_t k1_smem_bytes(int group, int dh, int k) {
  return ((size_t)group * dh + (size_t)2 * group * k) * 4;
}

// K1. grid = B * Hkv blocks, block (b, kv-head); K1_THREADS threads.
template <typename T>
__global__ void score_prune_kernel(
    const T* __restrict__ q,            // (B, H, dh)
    const T* __restrict__ kc,           // (B, S, Hkv, dh)
    const int* __restrict__ lengths,    // (B,)
    float* __restrict__ logits,         // scratch (B, H, S)
    float* __restrict__ alpha,          // out (B, H, k)
    int* __restrict__ ids,              // out (B, H, k)
    int h, int hkv, int s, int dh, int k, float scale) {
  extern __shared__ float smem[];
  const int group = h / hkv;
  const int b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const size_t head0 = (size_t)b * h + (size_t)kvh * group;  // first q-head of the group

  float* qs = smem;                                       // (group, dh)
  float* rd_v = qs + (size_t)group * dh;                  // (group, k)
  int* rd_i = reinterpret_cast<int*>(rd_v + (size_t)group * k);  // (group, k)
  float* lg0 = logits + head0 * s;                        // q-head g at lg0 + g * s

  for (int i = threadIdx.x; i < group * dh; i += blockDim.x) qs[i] = to_f32(q[head0 * dh + i]);
  __syncthreads();

  // logits of the valid positions: a warp per position, MAX_G q-heads per
  // pass over the row; lane l sums dims l, l+32, ..., then a butterfly
  for (int p = warp; p < len; p += nwarps) {
    const T* krow = kc + (((size_t)b * s + p) * hkv + kvh) * dh;
    for (int g0 = 0; g0 < group; g0 += MAX_G) {
      float acc[MAX_G];
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) acc[j] = 0.f;
      for (int d = lane; d < dh; d += 32) {
        const float kv = to_f32(krow[d]);
#pragma unroll
        for (int j = 0; j < MAX_G; ++j)
          if (g0 + j < group) acc[j] = __fadd_rn(acc[j], __fmul_rn(qs[(g0 + j) * dh + d], kv));
      }
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (g0 + j < group) {  // warp-uniform
          float v = acc[j];
          for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
          if (lane == 0) lg0[(size_t)(g0 + j) * s + p] = __fmul_rn(v, scale);
        }
      }
    }
  }
  __syncthreads();

  // the first k positions fill slots 0..k-1 (the rule's result on an empty domain)
  for (int i = threadIdx.x; i < group * k; i += blockDim.x) {
    const int g = i / k, slot = i - g * k;
    const bool ok = slot < len;
    rd_v[i] = ok ? lg0[(size_t)g * s + slot] : NEG;
    rd_i[i] = ok ? slot : -1;
  }
  __syncthreads();

  for (int g = warp; g < group; g += nwarps) {
    float* rv = rd_v + (size_t)g * k;
    int* ri = rd_i + (size_t)g * k;
    const float* lg = lg0 + (size_t)g * s;
    if (len > k) {
      float mv;
      int mi;
      domain_first_min(rv, k, lane, mv, mi);
      for (int c = k; c < len; c += 32) {
        const int p = c + lane;
        const float cand = p < len ? lg[p] : NEG;
        // exact filter: the minimum only rises, so a position at or below
        // it now is never inserted; the rest go in stream order
        unsigned live = __ballot_sync(FULL_MASK, cand > mv);
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const float cur = __shfl_sync(FULL_MASK, cand, src);
          if (cur > mv) {
            __syncwarp();
            if (lane == 0) {
              rv[mi] = cur;
              ri[mi] = c + src;
            }
            __syncwarp();
            domain_first_min(rv, k, lane, mv, mi);
          }
        }
      }
    }

    // flush: softmax over the non-empty slots
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
    float* a_out = alpha + (head0 + g) * k;
    int* i_out = ids + (head0 + g) * k;
    for (int i = lane; i < k; i += 32) {
      const float v = rv[i];
      const bool ok = v > NEG * 0.5f;
      a_out[i] = ok ? expf(v - mx) / denom : 0.f;
      i_out[i] = ok ? ri[i] : -1;
    }
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

template <typename T>
static int launch_score_prune(const void* q, const void* kc, const void* lengths, void* logits,
                              void* alpha, void* ids, int b, int h, int hkv, int s, int dh,
                              int k, float scale, cudaStream_t stream) {
  const size_t shmem = k1_smem_bytes(h / hkv, dh, k);
  if (shmem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(score_prune_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  score_prune_kernel<T><<<b * hkv, K1_THREADS, shmem, stream>>>(
      (const T*)q, (const T*)kc, (const int*)lengths, (float*)logits, (float*)alpha, (int*)ids,
      h, hkv, s, dh, k, scale);
  return (int)cudaGetLastError();
}

extern "C" int tda_score_prune(const void* q, const void* kc, const void* lengths, void* logits,
                               void* alpha, void* ids, int b, int h, int hkv, int s, int dh,
                               int k, float scale, int bf16, void* stream) {
  if (b == 0) return 0;
  if (bf16)
    return launch_score_prune<__nv_bfloat16>(q, kc, lengths, logits, alpha, ids, b, h, hkv, s,
                                             dh, k, scale, (cudaStream_t)stream);
  return launch_score_prune<float>(q, kc, lengths, logits, alpha, ids, b, h, hkv, s, dh, k,
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
