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
// softmax (eps 1e-30). K2 sums alpha * V[id] over the slots in slot order,
// in float32; an empty slot adds nothing. q and the cache are read as
// stored, float32 or bfloat16, and converted in registers, so no float32
// copy of the cache is made (the TPU wrapper casts and pads the whole
// cache first, kernel.py:112 and :158).
//
// What bounds it on an H100. K1 must read the valid keys once (at gemma3-4b
// decode shapes, B 4, Hkv 4, dh 256, S 3104 in bfloat16: 25 MB, 7.6 us at
// 3.35 TB/s); K2 must read the distinct retained V rows. Neither does
// enough arithmetic to matter. But K1 has a serial chain: once the domain
// is full, each insert needs the domain's minimum after the previous one,
// about K ln(S/K) inserts per (batch, q-head), and there are only B*H such
// chains. So K1 is bound by that chain's latency, far above its byte bound.
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
// kernel and plain logits and retained ids are bit-identical. K2 gives
// each (batch, q-head) one block with a thread per dim; a chunk of slots
// (alpha, id) is staged in shared memory, and each retained V row is read
// with one coalesced load, K2_BATCH rows in flight before their sums are
// taken in slot order. Both kernels launch on the caller's stream,
// allocate nothing and do not synchronize. Shortening K1's chain (several
// warps per domain, a domain in registers, a threshold found by selection
// instead of a stream) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define NEG (-3.0e38f)

static constexpr int K1_THREADS = 256;
static constexpr int MAX_G = 8;           // q-heads of a group scored per pass over a key row
static constexpr int K2_CHUNK = 1024;     // slots staged in shared memory per K2 step
static constexpr int K2_BATCH = 16;       // V rows a K2 thread has in flight
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

// K2. grid = B * H blocks, block (b, q-head); dh threads, one per output dim.
template <typename T>
__global__ void value_gather_kernel(
    const float* __restrict__ alpha,  // (B, H, k)
    const int* __restrict__ ids,      // (B, H, k), -1 = empty
    const T* __restrict__ vc,         // (B, S, Hkv, dh)
    float* __restrict__ out,          // out (B, H, dh)
    int h, int hkv, int s, int dh, int k) {
  __shared__ float sa[K2_CHUNK];
  __shared__ int si[K2_CHUNK];
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / h);
  const int kvh = (int)(bh % h) / (h / hkv);
  const float* a_row = alpha + bh * k;
  const int* i_row = ids + bh * k;
  const T* vbase = vc + ((size_t)b * s * hkv + kvh) * dh + threadIdx.x;
  const size_t row_stride = (size_t)hkv * dh;
  float acc = 0.f;
  for (int c0 = 0; c0 < k; c0 += K2_CHUNK) {
    const int n = min(K2_CHUNK, k - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sa[i] = a_row[c0 + i];
      si[i] = i_row[c0 + i];
    }
    __syncthreads();
    // K2_BATCH row loads in flight, then their sums in slot order (an
    // empty slot, or one past the chunk, loads row 0 and adds nothing)
    for (int i0 = 0; i0 < n; i0 += K2_BATCH) {
      float v[K2_BATCH];
#pragma unroll
      for (int j = 0; j < K2_BATCH; ++j) {
        const int id = i0 + j < n ? si[i0 + j] : -1;
        v[j] = to_f32(vbase[(size_t)(id < 0 ? 0 : id) * row_stride]);
      }
#pragma unroll
      for (int j = 0; j < K2_BATCH; ++j)
        if (i0 + j < n && si[i0 + j] >= 0) acc = fmaf(sa[i0 + j], v[j], acc);
    }
  }
  out[bh * dh + threadIdx.x] = acc;
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

extern "C" int tda_value_gather(const void* alpha, const void* ids, const void* vc, void* out,
                                int b, int h, int hkv, int s, int dh, int k, int bf16,
                                void* stream) {
  if (b == 0) return 0;
  if (bf16)
    value_gather_kernel<__nv_bfloat16><<<b * h, dh, 0, (cudaStream_t)stream>>>(
        (const float*)alpha, (const int*)ids, (const __nv_bfloat16*)vc, (float*)out, h, hkv, s,
        dh, k);
  else
    value_gather_kernel<float><<<b * h, dh, 0, (cudaStream_t)stream>>>(
        (const float*)alpha, (const int*)ids, (const float*)vc, (float*)out, h, hkv, s, dh, k);
  return (int)cudaGetLastError();
}
