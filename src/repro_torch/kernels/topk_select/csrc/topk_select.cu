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
// insert needs the domain's first minimum after the previous one. A row
// with n valid slots in random order makes about k ln(n / k) inserts after
// the domain fills (~830 at 3073 valid slots and k 2048), and the chain
// cannot be cut short: a selection that first finds the k-th value gives
// the same set but not the domain's slot order, which is the output
// (evicted candidates decide where the survivors land).
//
// What the design does about it. One warp per row, a few rows a block, so
// the card runs many chains at once. The domain lives in shared memory, 8 B
// a slot (above 48 KB the block opts into up to 227 KB, so k <= 29056): an
// id, and the value as an order-preserving unsigned key, a bijection of
// its bits, so the value comes back bit for bit; compared keys map -0.0's
// key onto +0.0's, so the zeros tie. Slot s is read and written by lane
// s % 32 in the chain. The fill: an empty domain takes candidates in slot
// order, so a ballot and a prefix count place 32 at once, with FILL_CHUNKS
// chunks of scores and mask loaded together. Then an exact filter: one
// __ballot_sync drops every lane whose score is not above the domain
// minimum (the minimum only rises). The survivors go through the chain in
// slot order, and each insert costs O(log k), not a scan of the k slots: a
// two-level winner tree owned by the warp keeps the first minimum. The
// domain is cut into 32-slot groups; the first minimum of each group (key,
// then slot) lives in registers, GPL groups a lane, lane l holding groups
// l*GPL .. l*GPL+GPL-1. An insert replaces the root's slot; the new root is
// the first, by key then slot, of three: the candidate at that slot, the
// rest of its group (one shared load a lane, then __reduce_min_sync on the
// key and on the slots of the lanes that hold the least key) and the other
// groups (the same two reductions over the lanes' winners). The last two
// do not depend on the candidate, so their reductions run side by side
// with its shuffle; an insert waits on one shared load and two reductions.
// The chain's next chunk of scores is loaded while the current one is
// inserted. The kernel launches on the caller's stream, allocates nothing
// and does not synchronize.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define NEG (-3.0e38f)

static constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can opt into
static constexpr int SLOT_BYTES = 8;     // float value + int slot id
static constexpr int MAX_ROWS_PER_BLOCK = 8;
static constexpr int DEFAULT_SMEM = 48 * 1024;
static constexpr int FILL_CHUNKS = 16;   // 32-slot chunks loaded at once while the domain fills
static constexpr unsigned NO_KEY = 0xffffffffu;  // above the key of every value a domain holds

// The domain holds each value as an unsigned key in the order of the
// floats ([NEG, +inf], never NaN): a bijection, so the value's bits come
// back at the end. Compared keys map -0.0's onto +0.0's, so the zeros tie.
__device__ __forceinline__ unsigned to_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}
__device__ __forceinline__ unsigned cmp_key(unsigned key) {
  return key == 0x7fffffffu ? 0x80000000u : key;  // -0.0 ties +0.0
}

// Shared memory by 32-bit shared addresses, so the chain does not convert
// a generic pointer at every step; the load and the stores are predicated.
__device__ __forceinline__ unsigned lds_if(bool p, unsigned addr, unsigned other) {
  unsigned v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, %3;\n @q ld.shared.b32 %0, [%1];\n}"
      : "=r"(v) : "r"(addr), "r"((int)p), "r"(other) : "memory");
  return v;
}
__device__ __forceinline__ void sts2_if(bool p, unsigned a0, unsigned v0, unsigned a1, int v1) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n @q st.shared.b32 [%1], %2;\n"
      " @q st.shared.b32 [%3], %4;\n}"
      :: "r"((int)p), "r"(a0), "r"(v0), "r"(a1), "r"(v1) : "memory");
}

// Slot j of the row as a candidate: its score where the mask holds, NEG
// past the row's end or where masked. Both loads are issued together.
__device__ __forceinline__ float candidate(const float* __restrict__ scores,
                                           const unsigned char* __restrict__ mask, size_t base,
                                           int j, int d) {
  if (j >= d) return NEG;
  const float v = __ldg(scores + base + j);
  const unsigned char m = __ldg(mask + base + j);
  return m ? v : NEG;
}

// The first minimum over the lanes of (key, slot) pairs, on every lane:
// the least key, then the least slot among the lanes that hold it.
__device__ __forceinline__ void warp_first_min(unsigned key, int slot, unsigned& mkey, int& mslot) {
  mkey = __reduce_min_sync(FULL_MASK, key);
  mslot = (int)__reduce_min_sync(FULL_MASK, key == mkey ? (unsigned)slot : NO_KEY);
}

// (key, slot) pair a replaced by b when b comes first: a lower key, or the
// same key at a lower slot.
__device__ __forceinline__ void first_of(unsigned& key, int& slot, unsigned bkey, int bslot) {
  if (bkey < key || (bkey == key && bslot < slot)) {
    key = bkey;
    slot = bslot;
  }
}

// grid = ceil(T / rows_per_block), block = (32, rows_per_block): warp y owns
// row blockIdx.x * rows_per_block + y. Dynamic shared memory:
// rows_per_block * k * 8 B. GPL: the 32-slot groups a lane holds, at least
// ceil(ceil(k / 32) / 32).
template <int GPL>
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

  unsigned* rk = reinterpret_cast<unsigned*>(smem) + (size_t)warp * k;  // the domain's keys
  int* ri = reinterpret_cast<int*>(smem) + (size_t)rpb * k + (size_t)warp * k;  // and ids
  const unsigned rk_a = (unsigned)__cvta_generic_to_shared(rk);
  const unsigned ri_a = (unsigned)__cvta_generic_to_shared(ri);
  const unsigned empty = to_key(NEG);
  for (int s = lane; s < k; s += 32) {
    rk[s] = empty;
    ri[s] = -1;
  }
  __syncwarp();  // every slot is empty before the fill writes any

  const size_t base = (size_t)row * d;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  // 1. the fill: candidates above NEG take the empty slots in slot order
  int filled = 0;      // slots [0, filled) hold candidates, the rest NEG (warp-uniform)
  int c = 0;           // the chunk the chain starts at once the domain is full
  unsigned live = 0;   // that chunk's candidates the fill did not place
  float cur = NEG;     // this lane's candidate of chunk c
  bool full = false;
  for (int c0 = 0; c0 < d && !full; c0 += 32 * FILL_CHUNKS) {
    float cand[FILL_CHUNKS];
#pragma unroll
    for (int u = 0; u < FILL_CHUNKS; ++u) cand[u] = candidate(scores, mask, base, c0 + 32 * u + lane, d);
#pragma unroll
    for (int u = 0; u < FILL_CHUNKS; ++u) {
      if (full) break;  // warp-uniform
      unsigned fill = __ballot_sync(FULL_MASK, cand[u] > NEG);
      const int room = k - filled;
      const int rank = __popc(fill & below);
      if (((fill >> lane) & 1u) && rank < room) {
        rk[filled + rank] = to_key(cand[u]);
        ri[filled + rank] = c0 + 32 * u + lane;
      }
      const int n = __popc(fill);
      if (n < room) {
        filled += n;
      } else {  // full: the chunk's candidates past the first `room` go through the chain
        for (int r = 0; r < room; ++r) fill &= fill - 1u;
        full = true;
        c = c0 + 32 * u;
        live = fill;
        cur = cand[u];
      }
    }
  }
  __syncwarp();  // the fill's stores before any lane reads the domain

  if (full) {
    // 2. the winner tree: each group's first minimum, lane l holding groups
    // l*GPL .. l*GPL+GPL-1 (past the last group: NO_KEY). A lane scans its
    // groups' 32 slots starting at slot `lane`, so the lanes read 32
    // different banks at each step.
    const int ng = (k + 31) >> 5;
    unsigned wkey[GPL];
    int wslot[GPL];
#pragma unroll
    for (int j = 0; j < GPL; ++j) {
      wkey[j] = NO_KEY;
      wslot[j] = k;
      const int g = lane * GPL + j;
      if (g < ng) {
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const int s = (g << 5) + ((i + lane) & 31);
          if (s < k) first_of(wkey[j], wslot[j], cmp_key(rk[s]), s);
        }
      }
    }
    __syncwarp();  // the scans' reads before the chain writes any slot
    unsigned lkey = NO_KEY;  // this lane's first group winner
    int lslot = k;
#pragma unroll
    for (int j = 0; j < GPL; ++j) first_of(lkey, lslot, wkey[j], wslot[j]);
    unsigned mkey;
    int mi;
    warp_first_min(lkey, lslot, mkey, mi);
    float mv = from_key(mkey);

    // 3. the chain, chunk by chunk: exact filter, then inserts in slot order.
    // An insert replaces slot mi, the root. The new root is the first of
    // three: the candidate at mi, the rest of mi's group, and the other
    // groups. The last two do not depend on the candidate, so their
    // reductions run while the candidate is shuffled in.
    unsigned sk = to_key(cur);  // this lane's candidate as a key
    live &= __ballot_sync(FULL_MASK, cur > mv);
    for (;;) {
      const float nxt = candidate(scores, mask, base, c + 32 + lane, d);  // in flight meanwhile
      while (live) {
        const int src = __ffs(live) - 1;
        const int g = mi >> 5;
        const int owner = g / GPL;
        const int jj = g - owner * GPL;
        const int s = (g << 5) + lane;
        // mi's group without slot mi
        const unsigned xk_l = cmp_key(lds_if(s < k && s != mi, rk_a + 4u * s, NO_KEY));
        unsigned xk;
        int xs;
        warp_first_min(xk_l, s, xk, xs);
        // the other groups
        unsigned ek = NO_KEY;
        int es = k;
#pragma unroll
        for (int j = 0; j < GPL; ++j)
          if (lane != owner || j != jj) first_of(ek, es, wkey[j], wslot[j]);
        unsigned ok;
        int os;
        warp_first_min(ek, es, ok, os);
        // the candidate takes slot mi
        const unsigned vk = __shfl_sync(FULL_MASK, sk, src);
        sts2_if(s == mi, rk_a + 4u * s, vk, ri_a + 4u * s, c + src);
        unsigned gk = cmp_key(vk);  // mi's group's new first minimum
        int gs = mi;
        first_of(gk, gs, xk, xs);
#pragma unroll
        for (int j = 0; j < GPL; ++j)
          if (lane == owner && j == jj) {
            wkey[j] = gk;
            wslot[j] = gs;
          }
        mkey = gk;
        mi = gs;
        first_of(mkey, mi, ok, os);
        mv = from_key(mkey);
        live &= live - 1u;
        live &= __ballot_sync(FULL_MASK, cur > mv);  // the minimum rose: drop what no longer beats it
      }
      c += 32;
      if (c >= d) break;
      cur = nxt;
      sk = to_key(cur);
      live = __ballot_sync(FULL_MASK, cur > mv);
    }
  }
  __syncwarp();

  float* ov = out_v + (size_t)row * k;
  int* oi = out_i + (size_t)row * k;
  for (int s = lane; s < k; s += 32) {
    const float v = from_key(rk[s]);
    ov[s] = v;
    oi[s] = v <= NEG * 0.5f ? -1 : ri[s];
  }
}

template <int GPL>
static int launch(const void* scores, const void* mask, void* vals, void* ids, int t, int d, int k,
                  int rpb, size_t shmem, cudaStream_t stream) {
  if (shmem > DEFAULT_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_select_kernel<GPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (t + rpb - 1) / rpb;
  topk_select_kernel<GPL><<<grid, dim3(32, rpb), shmem, stream>>>(
      (const float*)scores, (const unsigned char*)mask, (float*)vals, (int*)ids, t, d, k);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = ((k + 31) / 32 + 31) / 32;  // groups a lane holds
  if (per_lane <= 1) return launch<1>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
  if (per_lane <= 2) return launch<2>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
  if (per_lane <= 4) return launch<4>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
  if (per_lane <= 8) return launch<8>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
  if (per_lane <= 16) return launch<16>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
  return launch<32>(scores, mask, vals, ids, t, d, k, rpb, shmem, st);
}
