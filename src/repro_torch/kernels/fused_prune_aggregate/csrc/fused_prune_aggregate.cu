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
// STRICTLY greater (slots >= the row's k_eff are parked at POS; they are
// chosen only when every live slot holds a rank above POS). Rows of a
// bypass bucket (capacity <= K, paper §4.3) copy candidate j of D-tile dt
// straight into slot dt*w + j. After the last D-tile, K1 applies
// LeakyReLU(theta + theta_dst, slope) and a masked softmax over the
// retained slots (eps 1e-30) and writes alpha (rows, K_s, H) and the
// retained global ids (rows, K_s), -1 = empty. K2 accumulates
// alpha[slot, h] * h'[id, h, :] over the row's own k_eff slots, in slot
// order (an empty slot reads id 0 with alpha 0).
//
// What the flat pair computes. The same function over one (T, D)
// padded-CSC table: every row streams its D slots in slot order through a
// k-slot domain, k = min(prune_k, D), with the same rank, rule and flush;
// there is no bypass branch (the caller routes D <= K tables around it).
// K2 accumulates over all k slots. The TPU kernel's wrapper gathers a
// (T, D, H) theta tensor into device memory first; this K1 gathers
// theta_src and theta_rel per valid slot itself, which is the same
// function with less traffic. The TPU kernel pads T to 8 and D to 128;
// here the table is read unpadded. Both TPU K1s size their domain by K,
// so both K1s here take any width up to MAX_KS.
//
// What bounds them on an H100. Neither pair does enough arithmetic to
// matter (K1: H adds per candidate plus a compare; K2: one FMA per loaded
// float). Both are bound by memory traffic and, at the sizes of one
// semantic graph (a few MB), by latency: dependent gathers (table -> id ->
// theta_src row in K1; ids -> h' row in K2) and the serial insert chain of
// K1, where each candidate needs the domain's minimum after the previous
// insert.
//
// What the design does about it. Each K1 gives each row one warp, so the
// card runs thousands of independent rows at once to hide gather latency.
// A lane loads one candidate at a time (grouped: one of the w <= 32 of a
// tile; flat: one of 32 compacted valid slots), so a step costs one
// coalesced load per array; the per-head theta of a retained slot is
// re-read from theta_src (+ theta_rel) at the flush instead of being kept.
// Both K1s filter each batch of candidates exactly: once the domain is
// full its minimum only rises, so a candidate at or below it can never be
// inserted, and a __ballot_sync leaves only the others for the serial
// insert, which finds the first minimum again only after an insert.
//  * The domain. Up to 256 slots it lives in registers, SPL slots a lane
//    (slot lane + 32 i in element i; SPL 1, 2, 4 or 8). Its first minimum
//    is two __reduce_min_sync: the least order-preserving key of the ranks
//    (-0.0 as +0.0, which compare equal), then the least slot among the
//    lanes that hold it, so the lowest slot among equal minima is evicted,
//    as the rule says; slots past k_s do not take part. A wider domain
//    (up to MAX_KS slots, the shared memory one warp can hold beside its
//    compaction list) lives in dynamic shared memory, 12 bytes a slot (rank,
//    id, edge type), one domain a warp. Slot s is read and written only by
//    lane s % 32, which keeps the least (key, slot) of its own slots and
//    rescans them only after an insert into one of them; the same two
//    reductions give the first minimum. Its flush walks the domain in
//    32-slot chunks, eight heads at a time: maximum, then sum, then write.
//  * The grouped K1 issues the ids of D-tile dt + 2 and the theta gathers
//    of dt + 1 before dt's inserts, so a row's dependent loads overlap its
//    chain. A bypass row moves candidate j of tile dt to slot dt*w + j by
//    shuffles. On the shared-memory path it fills an empty domain without
//    a chain (insert_batch, below), and launches a row block's t_tile rows
//    as t_tile / wpb blocks of wpb warps when a block of t_tile domains
//    would not fit in 227 KB.
//  * The flat K1 first issues the mask loads of SEG slots together and
//    compacts the valid ones, in slot order, into a per-warp list in
//    shared memory (__ballot_sync and __popc prefix counts): a row of ACM
//    union:paper holds ~10 valid slots of 256, and the chain never sees
//    the rest. It then takes the listed candidates 32 at a time, with the
//    theta gathers of the next batch and the id gathers of the one after
//    in flight. While the domain has empty slots, the first candidates
//    ranked above NEG fill them in order with no chain (insert_batch):
//    that is what the chain does on empty slots, since nothing at or below
//    NEG, nor NaN, is greater than an empty slot. A row with at most k
//    such candidates runs no chain. Its register flush takes eight values
//    a lane a step (8 / SPL heads), so their gathers and reductions overlap.
//  * A slot's heads leave a flush together where they can, as 16-byte
//    stores (store_heads).
// K2 gives each row one block with a thread per (head, dh) output, so every
// retained h' row is read with one coalesced load of H*dh floats and
// accumulated in a register.
//
// The fused launch: K1, then K2's aggregation in the same warp. Both K1
// bodies (grouped_launch_row, flat_launch_row) take a template flag AGG;
// the K1 kernels run them with it off (the step wrappers prune and
// flat_prune launch those, and the standalone K2s stay beside them), and
// grouped_prune_aggregate_kernel and flat_prune_aggregate_kernel with it
// on. Then the warp that flushed row `row` computes out[row, hd] = sum over
// s < k_row of alpha[row, s, hd / dh] * h'[id_s, hd] (k_row = k_eff for the
// grouped kernel, k for the flat one) with gather_row's arithmetic: one
// chain of acc += a * b from 0 in slot order for each output, an empty slot
// adding alpha 0 times h'[0], so the output equals K2's on K1's alpha and
// ids bit for bit (aggregate_row). Lane l owns outputs hd0 + l + 32 j, so
// each slot's h' row is read coalesced; the ids come 32 at a time in one
// load, and the loads of AGG_SLOTS slots are issued before their FMAs. A
// fused block holds at most 8 warps, and with one domain slot a lane the
// kernel keeps to 64 registers (__launch_bounds__), as K1 does: at 72 an
// SM held 3 blocks instead of 4, and DBLP APA's 509 row blocks took two
// waves on 132 SMs instead of one.
// Where the row's alpha and ids come from:
//  * on the register path (k <= 256), when the caller keeps neither and one
//    warp's staging (k * (H + 1) floats) fits in shared memory beside a
//    flat list, the flush writes them into the warp's staging in dynamic
//    shared memory: the serving path writes no alpha and no ids to device
//    memory;
//  * otherwise (the shared-memory domain past 256 slots, whose budget the
//    domain takes, a staging too large, or a caller that asked for them)
//    the flush writes them to device memory (the caller's buffers or a
//    scratch the wrapper allocates), and the warp reads them back after
//    __syncwarp(). The read-back goes through ordinary loads of the pointer
//    the kernel wrote (never __ldg nor a const __restrict__ pointer, whose
//    non-coherent path could return lines from before the write).
// fpa_fused_needs_buffers says which of the two a launch takes. No atomics:
// two calls give the same bits.
//
// All kernels launch on the caller's stream, allocate nothing and do not
// synchronize. Staging h' in shared memory and CUDA graphs across the
// forward are later work.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

#define NEG (-3.0e38f)
#define POS (3.0e38f)
static constexpr int REG_KS = 256;              // widest domain held in registers (SPL 8)
static constexpr int MAX_SMEM = 232448;         // dynamic shared memory a block can opt into
static constexpr int DEFAULT_SMEM = 48 * 1024;  // above it a kernel must opt in
static constexpr int SLOT_BYTES = 12;           // a shared-memory domain slot: rank, id, edge type
static constexpr int SEG = 256;                 // slots of a flat row compacted at once
static constexpr int LIST_BYTES = SEG * 4;      // a flat warp's compaction list
// the widest domain either K1 takes: one warp's, beside its list
static constexpr int MAX_KS = (MAX_SMEM - LIST_BYTES) / SLOT_BYTES;
static constexpr int FLAT_ROWS_PER_BLOCK = 8;
static constexpr int PREFETCH_H = 8;             // heads whose theta a K1 gathers ahead
static constexpr unsigned NO_KEY = 0xffffffffu;  // above the key of every rank
static constexpr int MAX_HD = 1024;              // widest H * dh an aggregation takes
static constexpr int AGG_SLOTS = 8;              // slots whose h' loads a lane issues together
static constexpr int AGG_OUT = 2;                // outputs a lane accumulates in one pass
static constexpr int FUSED_THREADS = 256;        // a fused launch's widest block: 8 warps

// Blocks of FUSED_THREADS a fused launch asks each SM to hold: 4 (at most
// 64 registers a thread, as K1's own launch takes) where the domain is one
// slot a lane, so the fusion costs no occupancy on the serving path (k 8).
__host__ __device__ constexpr int fused_min_blocks(int spl) { return spl == 1 ? 4 : 1; }

// Heads a flat K1's register flush takes a step: eight values a lane.
__host__ __device__ constexpr int flat_heads(int spl) { return spl >= 8 ? 1 : 8 / spl; }

// Floats of one warp's staging of a row in shared memory: alpha (k, H),
// then ids (k), rounded up to 16 bytes.
__host__ __device__ constexpr size_t stage_floats(int k, int h) {
  return ((size_t)k * (h + 1) + 3) & ~(size_t)3;
}

__device__ __forceinline__ float theta_of(const float* __restrict__ theta_src,
                                          const float* __restrict__ theta_rel,
                                          int id, int ety, int h, int hh) {
  float t = theta_src[(size_t)id * h + hh];
  if (theta_rel != nullptr) t = t + theta_rel[(size_t)ety * h + hh];
  return t;
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

// The first minimum (lowest slot among equal minima) on every lane, from
// each lane's least key and its slot: the least key over the warp, then
// the least slot among the lanes holding it.
__device__ __forceinline__ void warp_first_min(unsigned lk, int ls, float& mv, int& mi) {
  const unsigned mk = __reduce_min_sync(FULL_MASK, lk);
  mi = (int)__reduce_min_sync(FULL_MASK, lk == mk ? (unsigned)ls : NO_KEY);
  mv = from_order_key(mk);
}

// The position of the n-th (from 0) set bit of m; n < __popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = (1u << w) - 1u;
    const int c = __popc(m & low);
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    } else {
      m &= low;
    }
  }
  return pos;
}

// Heads h0 .. h0 + n - 1 (n <= N) of one slot of an alpha row, at p: as
// 16-byte stores where all N lie in the row and p is aligned to them (a
// slot's heads then leave in whole 32-byte sectors, not a sector a float),
// else one by one.
template <int N>
__device__ __forceinline__ void store_heads(float* __restrict__ p, const float (&v)[N], int n) {
  if (N % 4 == 0 && n == N && ((size_t)p & 15) == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) p[j] = v[j];
  }
}

// n floats at p set to 0 by the warp: consecutive lanes on consecutive 16
// bytes where aligned (p is 4-byte aligned), one float at a time at the
// ends.
__device__ __forceinline__ void zero_floats(float* __restrict__ p, size_t n, int lane) {
  const size_t head = min(n, (size_t)(((16 - ((size_t)p & 15)) & 15) / 4));
  const size_t n4 = (n - head) / 4;
  for (size_t i = lane; i < head; i += 32) p[i] = 0.f;
  float4* q = reinterpret_cast<float4*>(p + head);
  for (size_t i = lane; i < n4; i += 32) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + lane; i < n; i += 32) p[i] = 0.f;
}

// A row's retention domain of k_s slots, held by its warp. Both kinds give
// the same interface, all lanes calling:
//   init(k_eff)      slots < k_eff empty (NEG), the rest parked (POS);
//   refresh()        bring the first minimum up to date after take();
//   first_min(v, s)  the first minimum's value and slot, on every lane;
//   put(s, ...)      write slot s (first_min is current after it);
//   take(lo, hi, src, ...)  slots [lo, hi) take the candidate of lane
//                    src(slot);
//   flush(...)       LeakyReLU + masked softmax over the retained slots
//                    s < k_eff -> alpha_row (k_s, H) and ids_row (k_s), 0
//                    and -1 on empty slots.
// kShared says which kind it is.

// In registers: SPL slots a lane, slot lane + 32 i in element i. Its flush
// takes HB heads a step: their theta gathers and warp reductions are in
// flight together, each head's arithmetic the same as one at a time.
template <int SPL, int HB>
struct RegDomain {
  static constexpr bool kShared = false;
  float rk[SPL];
  int rid[SPL], rety[SPL];
  int lane, k_s;

  __device__ __forceinline__ RegDomain(int lane_, int k_s_) : lane(lane_), k_s(k_s_) {}

  __device__ __forceinline__ void init(int k_eff) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      rk[i] = lane + 32 * i < k_eff ? NEG : POS;
      rid[i] = -1;
      rety[i] = 0;
    }
  }

  __device__ __forceinline__ void refresh() {}

  // slots past k_s do not exist; slots parked at POS compare by their
  // value, above every rank
  __device__ __forceinline__ void first_min(float& mv, int& mi) const {
    unsigned lk = NO_KEY;
    int ls = REG_KS;
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = lane + 32 * i;
      const unsigned key = s < k_s ? order_key(rk[i]) : NO_KEY;
      if (key < lk) {  // a lane's slots rise with i: the first among equals stays
        lk = key;
        ls = s;
      }
    }
    warp_first_min(lk, ls, mv, mi);
  }

  __device__ __forceinline__ void put(int slot, float v, int id, int e) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if (lane + 32 * i == slot) {
        rk[i] = v;
        rid[i] = id;
        rety[i] = e;
      }
    }
  }

  template <class Src>
  __device__ __forceinline__ void take(int lo, int hi, Src src, float cr, int cid, int ce) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if (32 * i + 32 <= lo || 32 * i >= hi) continue;  // the same on every lane
      const int s = lane + 32 * i;
      const bool in = s >= lo && s < hi;
      const int j = in ? src(s) : 0;
      const float v = __shfl_sync(FULL_MASK, cr, j);
      const int id = __shfl_sync(FULL_MASK, cid, j);
      const int e = __shfl_sync(FULL_MASK, ce, j);
      if (in) {
        rk[i] = v;
        rid[i] = id;
        rety[i] = e;
      }
    }
  }

  __device__ __forceinline__ void flush(int k_eff, const float* __restrict__ theta_src,
                                        const float* __restrict__ theta_rel,
                                        const float* __restrict__ tdst, int h, float slope,
                                        float* __restrict__ alpha_row,
                                        int* __restrict__ ids_row) const {
    bool ok[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = lane + 32 * i;
      ok[i] = s < k_s && s < k_eff && rk[i] > NEG * 0.5f;
    }
    for (int h0 = 0; h0 < h; h0 += HB) {
      float tv[HB][SPL], mx[HB], sum[HB];
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        const int hh = h0 + j;
        const float td = hh < h ? tdst[hh] : 0.f;
        mx[j] = NEG;
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
          tv[j][i] = 0.f;
          if (hh < h && ok[i]) {
            float t = theta_of(theta_src, theta_rel, rid[i], rety[i], h, hh) + td;
            t = t >= 0.f ? t : slope * t;
            tv[j][i] = t;
            mx[j] = fmaxf(mx[j], t);
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < HB; ++j) mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL_MASK, mx[j], off));
      }
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        sum[j] = 0.f;
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
          if (ok[i]) {
            tv[j][i] = expf(tv[j][i] - mx[j]);
            sum[j] += tv[j][i];
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < HB; ++j) sum[j] += __shfl_xor_sync(FULL_MASK, sum[j], off);
      }
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const int s = lane + 32 * i;
        if (s < k_s) {
          float a[HB];
#pragma unroll
          for (int j = 0; j < HB; ++j) a[j] = ok[i] ? tv[j][i] / (sum[j] + 1e-30f) : 0.f;
          store_heads(alpha_row + (size_t)s * h + h0, a, min(HB, h - h0));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = lane + 32 * i;
      if (s < k_s) ids_row[s] = ok[i] ? rid[i] : -1;
    }
  }
};

// In shared memory: k_s ranks, then k_s ids, then k_s edge types. Slot s
// is read and written only by lane s % 32, which keeps the least (key,
// slot) of its own slots (lk, ls), so no slot is shared between lanes.
struct SmemDomain {
  static constexpr bool kShared = true;
  float* rk;
  int* rid;
  int* rety;
  int lane, k_s;
  unsigned lk;
  int ls;

  __device__ __forceinline__ SmemDomain(float* base, int lane_, int k_s_)
      : rk(base), rid(reinterpret_cast<int*>(base + k_s_)),
        rety(reinterpret_cast<int*>(base + 2 * k_s_)), lane(lane_), k_s(k_s_), lk(NO_KEY), ls(0) {}

  __device__ __forceinline__ void init(int k_eff) {
    for (int s = lane; s < k_s; s += 32) {
      rk[s] = s < k_eff ? NEG : POS;
      rid[s] = -1;
      rety[s] = 0;
    }
  }

  __device__ __forceinline__ void refresh() {
    lk = NO_KEY;
    ls = 0;
    for (int s = lane; s < k_s; s += 32) {
      const unsigned key = order_key(rk[s]);
      if (key < lk) {  // a lane's slots rise: the first among equals stays
        lk = key;
        ls = s;
      }
    }
  }

  __device__ __forceinline__ void first_min(float& mv, int& mi) const {
    warp_first_min(lk, ls, mv, mi);
  }

  __device__ __forceinline__ void put(int slot, float v, int id, int e) {
    if ((slot & 31) == lane) {
      rk[slot] = v;
      rid[slot] = id;
      rety[slot] = e;
      refresh();
    }
  }

  template <class Src>
  __device__ __forceinline__ void take(int lo, int hi, Src src, float cr, int cid, int ce) {
    hi = min(hi, k_s);
    for (int c = lo >> 5; 32 * c < hi; ++c) {  // the same bounds on every lane
      const int s = 32 * c + lane;
      const bool in = s >= lo && s < hi;
      const int j = in ? src(s) : 0;
      const float v = __shfl_sync(FULL_MASK, cr, j);
      const int id = __shfl_sync(FULL_MASK, cid, j);
      const int e = __shfl_sync(FULL_MASK, ce, j);
      if (in) {
        rk[s] = v;
        rid[s] = id;
        rety[s] = e;
      }
    }
  }

  // The register flush's arithmetic, PREFETCH_H heads at a time, in three
  // walks over a lane's slots below k_eff (the maximum, the sum of exp,
  // the alpha rows; the slots past k_eff then get zeros, as one run), each
  // recomputing the same logits from theta (an L1 hit after the first); a
  // head's maximum and sum are taken in the same order as one head at a
  // time. A slot that is not retained gets id -1 first.
  __device__ __forceinline__ void flush(int k_eff, const float* __restrict__ theta_src,
                                        const float* __restrict__ theta_rel,
                                        const float* __restrict__ tdst, int h, float slope,
                                        float* __restrict__ alpha_row,
                                        int* __restrict__ ids_row) {
    const int live = min(k_eff, k_s);
    for (int s = lane; s < live; s += 32)
      if (!(rk[s] > NEG * 0.5f)) rid[s] = -1;
    for (int h0 = 0; h0 < h; h0 += PREFETCH_H) {
      float td[PREFETCH_H], mx[PREFETCH_H], sum[PREFETCH_H];
#pragma unroll
      for (int j = 0; j < PREFETCH_H; ++j) {
        td[j] = h0 + j < h ? tdst[h0 + j] : 0.f;
        mx[j] = NEG;
        sum[j] = 0.f;
      }
      auto logit = [&](int s, int j) {
        const float t = theta_of(theta_src, theta_rel, rid[s], rety[s], h, h0 + j) + td[j];
        return t >= 0.f ? t : slope * t;
      };
      for (int s = lane; s < live; s += 32) {
        if (rid[s] < 0) continue;
#pragma unroll
        for (int j = 0; j < PREFETCH_H; ++j)
          if (h0 + j < h) mx[j] = fmaxf(mx[j], logit(s, j));
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < PREFETCH_H; ++j) mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL_MASK, mx[j], off));
      }
      for (int s = lane; s < live; s += 32) {
        if (rid[s] < 0) continue;
#pragma unroll
        for (int j = 0; j < PREFETCH_H; ++j)
          if (h0 + j < h) sum[j] += expf(logit(s, j) - mx[j]);
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < PREFETCH_H; ++j) sum[j] += __shfl_xor_sync(FULL_MASK, sum[j], off);
      }
      for (int s = lane; s < live; s += 32) {
        float a[PREFETCH_H] = {};
        if (rid[s] >= 0) {
#pragma unroll
          for (int j = 0; j < PREFETCH_H; ++j)
            if (h0 + j < h) a[j] = expf(logit(s, j) - mx[j]) / (sum[j] + 1e-30f);
        }
        store_heads(alpha_row + (size_t)s * h + h0, a, min(PREFETCH_H, h - h0));
      }
    }
    zero_floats(alpha_row + (size_t)live * h, (size_t)(k_s - live) * h, lane);
    for (int s = lane; s < k_s; s += 32) ids_row[s] = s < live ? rid[s] : -1;
  }
};

// One candidate a lane: its global id, edge type and validity, and the
// theta of its first PREFETCH_H heads, gathered ahead.
struct Cand {
  int id, e;
  bool v;
  float ts[PREFETCH_H], tr[PREFETCH_H];
};

// Candidate lane of a grouped D-tile (lane < w).
__device__ __forceinline__ void load_ids(Cand& c, const int* __restrict__ nbr,
                                         const unsigned char* __restrict__ msk,
                                         const int* __restrict__ ety, size_t base, bool live,
                                         int lane, int w) {
  c.v = live && lane < w && msk[base + lane];
  c.id = c.v ? nbr[base + lane] : -1;
  c.e = c.v && ety != nullptr ? ety[base + lane] : 0;
}

// Candidate q + lane of a flat row's compacted list of n valid slots.
__device__ __forceinline__ void load_listed(Cand& c, const int* list, int q, int n,
                                            const int* __restrict__ nbr,
                                            const int* __restrict__ ety, size_t base, int lane) {
  c.v = q + lane < n;
  const int j = c.v ? list[q + lane] : 0;
  c.id = c.v ? nbr[base + j] : -1;
  c.e = c.v && ety != nullptr ? ety[base + j] : 0;
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
// (+ theta_rel[ety]), as theta_of sums it; NEG when it is not valid.
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

// The insert chain over the lanes in `live`, in lane (slot) order, with
// the exact filter: the minimum only rises, so a candidate at or below it
// now is never inserted.
template <class Dom>
__device__ __forceinline__ void chain(Dom& dom, unsigned live, float cr, int cid, int ce,
                                      float& mv, int& mi) {
  live &= __ballot_sync(FULL_MASK, cr > mv);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1u;
    const float v = __shfl_sync(FULL_MASK, cr, src);
    const int id = __shfl_sync(FULL_MASK, cid, src);
    const int e = __shfl_sync(FULL_MASK, ce, src);
    if (v > mv) {
      dom.put(mi, v, id, e);
      dom.first_min(mv, mi);
      live &= __ballot_sync(FULL_MASK, cr > mv);
    }
  }
}

// 32 candidates (one a lane) into a domain whose slots [filled, k) are
// empty (NEG; any slot past k is parked at POS): the first ranked above
// NEG fill those slots in lane order, the rest go through the chain. This
// is what the chain alone does: nothing at or below NEG, nor NaN, is
// greater than an empty slot, and while a slot is empty the first minimum
// is the lowest empty slot (every held or parked rank is above NEG).
template <class Dom>
__device__ __forceinline__ void insert_batch(Dom& dom, int k, int& filled, float& mv, int& mi,
                                             float cr, int cid, int ce) {
  unsigned ins = __ballot_sync(FULL_MASK, cr > NEG);
  if (filled < k && ins) {
    const int cnt = __popc(ins);
    const int fit = min(cnt, k - filled);
    const int lo = filled;
    dom.take(lo, lo + fit, [&](int s) { return nth_set_bit(ins, s - lo); }, cr, cid, ce);
    ins = fit == cnt ? 0u : ins & ~((2u << nth_set_bit(ins, fit - 1)) - 1u);
    filled += fit;
    if (filled == k) {
      dom.refresh();
      dom.first_min(mv, mi);
    }
  }
  if (ins) chain(dom, ins, cr, cid, ce, mv, mi);
}

// One grouped row (one warp): its D-tiles through the domain, then the
// flush into the row's alpha (k_s, H) and ids (k_s). The ids of D-tile dt + 2 and the
// theta of dt + 1 are in flight while dt's candidates go in.
template <class Dom>
__device__ __forceinline__ void grouped_row(
    Dom& dom, const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    const int* __restrict__ row_targets, float* __restrict__ alpha_row, int* __restrict__ ids_row,
    size_t row, int first, int n_dt, int bypass, int k_eff, int t_tile, int sub, int w, int h,
    float slope, int lane) {
  auto tile_base = [&](int dt) { return ((size_t)(first + dt) * t_tile + sub) * w; };
  dom.init(k_eff);
  float mv = NEG;
  int mi = 0;
  // The shared-memory path fills the empty domain first (slots 0 .. filled
  // - 1 hold a candidate), as the flat K1 does: there the chain would
  // rescan a lane's slots after every insert. In registers an insert costs
  // two reductions, and the chain runs from the start.
  int filled = 0;
  if (!bypass && !Dom::kShared) dom.first_min(mv, mi);
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
      const int lo = dt * w;
      dom.take(lo, lo + w, [&](int s) { return s - lo; }, cr, cur.id, cur.e);
    } else if constexpr (Dom::kShared) {
      insert_batch(dom, k_eff, filled, mv, mi, cr, cur.id, cur.e);
    } else {
      chain(dom, FULL_MASK, cr, cur.id, cur.e, mv, mi);
    }
    cur = nxt;
    nxt = after;
  }
  dom.flush(k_eff, theta_src, theta_rel, theta_dst + (size_t)row_targets[row] * h, h, slope,
            alpha_row, ids_row);
}

// The aggregation stage of a fused launch, one warp a row: out_row[hd] =
// sum over s < k of a_row[s * H + hd / dh] * hp[id_s, hd], gather_row's
// arithmetic (one chain of acc += a * b from 0 in slot order an output; an
// empty slot, id -1, adds alpha 0 times h'[0]). Lane l owns outputs hd0 + l
// + 32 j, j < AGG_OUT, in passes of 32 * AGG_OUT outputs. The ids come 32
// slots at a time, one coalesced load a lane (the next 32 in flight), and
// reach the lanes by shuffles; the h' and alpha loads of AGG_SLOTS slots
// are issued before their FMAs. An empty slot loads nothing: the flush
// wrote its alpha as +0.0, and h'[0]'s outputs are held in registers, so it
// adds what K2 adds. a_row and i_row are what this warp's flush wrote, in
// shared or device memory, read after __syncwarp() with ordinary loads (no
// __restrict__: see the header).
__device__ __forceinline__ void aggregate_row(const float* a_row, const int* i_row, int k,
                                              const float* __restrict__ hp, int h, int dh,
                                              float* __restrict__ out_row, int lane) {
  const int hdim = h * dh;
  for (int hd0 = 0; hd0 < hdim; hd0 += 32 * AGG_OUT) {
    int hd[AGG_OUT], hh[AGG_OUT];
    bool on[AGG_OUT];
    float acc[AGG_OUT], x0[AGG_OUT];
#pragma unroll
    for (int j = 0; j < AGG_OUT; ++j) {
      hd[j] = hd0 + lane + 32 * j;
      on[j] = hd[j] < hdim;
      hh[j] = on[j] ? hd[j] / dh : 0;
      x0[j] = on[j] ? hp[hd[j]] : 0.f;  // h'[0]: what an empty slot reads
      acc[j] = 0.f;
    }
    int lid = lane < k ? i_row[lane] : -1;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int next = c0 + 32 + lane < k ? i_row[c0 + 32 + lane] : -1;
      const int n = min(32, k - c0);
      for (int b0 = 0; b0 < n; b0 += AGG_SLOTS) {
        float a[AGG_SLOTS][AGG_OUT], x[AGG_SLOTS][AGG_OUT];
#pragma unroll
        for (int b = 0; b < AGG_SLOTS; ++b) {
          const int id = __shfl_sync(FULL_MASK, lid, b0 + b);
          const int s = c0 + b0 + b;
#pragma unroll
          for (int j = 0; j < AGG_OUT; ++j) {
            a[b][j] = 0.f;
            x[b][j] = x0[j];
            if (id >= 0 && on[j]) {
              a[b][j] = a_row[s * h + hh[j]];
              x[b][j] = hp[(size_t)id * hdim + hd[j]];
            }
          }
        }
#pragma unroll
        for (int b = 0; b < AGG_SLOTS; ++b) {
          if (b0 + b < n) {
#pragma unroll
            for (int j = 0; j < AGG_OUT; ++j) acc[j] += a[b][j] * x[b][j];
          }
        }
      }
      lid = next;
    }
#pragma unroll
    for (int j = 0; j < AGG_OUT; ++j)
      if (on[j]) out_row[hd[j]] = acc[j];
  }
}

// The launch of a grouped K1 (and with AGG of the fused launch): grid =
// n_blocks * (t_tile / wpb), block = (32, wpb): warp y of launch block x
// owns grouped row (x / parts) * t_tile + (x % parts) * wpb + y, parts =
// t_tile / wpb. SPL 1-8: the domain in registers, SPL * 32 >= k_s; SPL 0: in
// dynamic shared memory, k_s * 12 B a warp. With AGG and no alpha buffer
// (register path only), each warp stages its row's alpha and ids in dynamic
// shared memory, stage_floats a warp; otherwise the flush writes rows of
// alpha and ids.
template <int SPL, bool AGG>
__device__ __forceinline__ void grouped_launch_row(
    const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    const int* __restrict__ row_targets, const int* __restrict__ blk, float* __restrict__ alpha,
    int* __restrict__ ids, const float* __restrict__ hp, float* __restrict__ out,
    float* grouped_smem, int n_blocks, int t_tile, int w, int h, int dh, int k_s, float slope) {
  const int lane = threadIdx.x;
  const int parts = t_tile / blockDim.y;
  const int b = blockIdx.x / parts;
  const int sub = (blockIdx.x % parts) * blockDim.y + threadIdx.y;
  const int first = blk[b];
  const int n_dt = blk[n_blocks + b];
  const int bypass = blk[2 * n_blocks + b];
  const int k_eff = blk[3 * n_blocks + b];
  const size_t row = (size_t)b * t_tile + sub;
  float* a_row;
  int* i_row;
  if (!AGG || alpha != nullptr) {
    a_row = alpha + row * k_s * h;
    i_row = ids + row * k_s;
  } else {
    a_row = grouped_smem + threadIdx.y * stage_floats(k_s, h);
    i_row = reinterpret_cast<int*>(a_row + (size_t)k_s * h);
  }
  if constexpr (SPL > 0) {
    RegDomain<SPL, 1> dom(lane, k_s);
    grouped_row(dom, nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, a_row, i_row,
                row, first, n_dt, bypass, k_eff, t_tile, sub, w, h, slope, lane);
  } else {
    SmemDomain dom(grouped_smem + (size_t)threadIdx.y * 3 * k_s, lane, k_s);
    grouped_row(dom, nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, a_row, i_row,
                row, first, n_dt, bypass, k_eff, t_tile, sub, w, h, slope, lane);
  }
  if constexpr (AGG) {
    __syncwarp();
    aggregate_row(a_row, i_row, k_eff, hp, h, dh, out + row * h * dh, lane);
  }
}

// K1.
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
  extern __shared__ float grouped_smem[];
  grouped_launch_row<SPL, false>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk,
                                 alpha, ids, nullptr, nullptr, grouped_smem, n_blocks, t_tile, w,
                                 h, 0, k_s, slope);
}

// The fused grouped launch: K1, then each warp aggregates its row. At most
// FUSED_THREADS a block, so that the register path keeps the occupancy of
// K1's launch (fused_min_blocks).
template <int SPL>
__global__ void __launch_bounds__(FUSED_THREADS, fused_min_blocks(SPL)) grouped_prune_aggregate_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    const int* __restrict__ row_targets, const int* __restrict__ blk,
    float* __restrict__ alpha,            // out (rows, k_s, H), or null to stage
    int* __restrict__ ids,                // out (rows, k_s), or null to stage
    const float* __restrict__ hp,         // (N, H, dh)
    float* __restrict__ out,              // out (rows, H, dh)
    int n_blocks, int t_tile, int w, int h, int dh, int k_s, float slope) {
  extern __shared__ float grouped_smem[];
  grouped_launch_row<SPL, true>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk,
                                alpha, ids, hp, out, grouped_smem, n_blocks, t_tile, w, h, dh, k_s,
                                slope);
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

// One flat row (one warp) through its k-slot domain, then the flush.
// Segment by segment (SEG slots): every mask load in flight at once, the
// valid slots compacted in slot order into `list`, then the listed
// candidates 32 at a time (insert_batch), the next batch's theta and the
// one after's ids gathered ahead.
template <class Dom>
__device__ __forceinline__ void flat_row(
    Dom& dom, int* list, const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    float* __restrict__ alpha_row, int* __restrict__ ids_row, int row, int d, int k, int h,
    float slope, int lane) {
  const size_t base = (size_t)row * d;
  dom.init(k);
  int filled = 0;  // slots 0 .. filled - 1 hold a candidate (the same on every lane)
  float mv = NEG;
  int mi = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int seg = 0; seg < d; seg += SEG) {
    bool m[SEG / 32];
#pragma unroll
    for (int c = 0; c < SEG / 32; ++c) {
      const int j = seg + 32 * c + lane;
      m[c] = j < d && msk[base + j];
    }
    int n = 0;
#pragma unroll
    for (int c = 0; c < SEG / 32; ++c) {
      const unsigned b = __ballot_sync(FULL_MASK, m[c]);
      if (m[c]) list[n + __popc(b & below)] = seg + 32 * c + lane;
      n += __popc(b);
    }
    __syncwarp();
    Cand cur, nxt;
    load_listed(cur, list, 0, n, nbr, ety, base, lane);
    load_theta(cur, theta_src, theta_rel, h);
    load_listed(nxt, list, 32, n, nbr, ety, base, lane);
    for (int q = 0; q < n; q += 32) {
      load_theta(nxt, theta_src, theta_rel, h);
      Cand after;
      load_listed(after, list, q + 64, n, nbr, ety, base, lane);
      insert_batch(dom, k, filled, mv, mi, cand_rank(cur, theta_src, theta_rel, h), cur.id, cur.e);
      cur = nxt;
      nxt = after;
    }
    __syncwarp();  // the next segment rewrites the list
  }
  // slots past `filled` are empty: the flush computes only below it
  dom.flush(filled, theta_src, theta_rel, theta_dst + (size_t)row * h, h, slope, alpha_row,
            ids_row);
}

// The launch of a flat K1 (and with AGG of the fused launch): grid =
// ceil(T / rpb), block = (32, rpb): warp y owns row blockIdx.x * rpb + y.
// Dynamic shared memory: rpb compaction lists of SEG ints, then rpb warp
// regions: the domain of k * 12 B (SPL 0), or with AGG and no alpha buffer
// (register path only) the row's staging of alpha and ids (stage_floats).
template <int SPL, bool AGG>
__device__ __forceinline__ void flat_launch_row(
    const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    float* __restrict__ alpha, int* __restrict__ ids, const float* __restrict__ hp,
    float* __restrict__ out, int* flat_smem, int t, int d, int h, int dh, int k, float slope) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int rpb = blockDim.y;
  const int row = blockIdx.x * rpb + warp;
  if (row >= t) return;  // the whole warp leaves together
  int* list = flat_smem + (size_t)warp * SEG;
  float* region = reinterpret_cast<float*>(flat_smem + (size_t)rpb * SEG);
  float* a_row;
  int* i_row;
  if (!AGG || alpha != nullptr) {
    a_row = alpha + (size_t)row * k * h;
    i_row = ids + (size_t)row * k;
  } else {
    a_row = region + warp * stage_floats(k, h);
    i_row = reinterpret_cast<int*>(a_row + (size_t)k * h);
  }
  if constexpr (SPL > 0) {
    RegDomain<SPL, flat_heads(SPL)> dom(lane, k);
    flat_row(dom, list, nbr, msk, ety, theta_src, theta_rel, theta_dst, a_row, i_row, row, d, k,
             h, slope, lane);
  } else {
    SmemDomain dom(region + (size_t)warp * 3 * k, lane, k);
    flat_row(dom, list, nbr, msk, ety, theta_src, theta_rel, theta_dst, a_row, i_row, row, d, k,
             h, slope, lane);
  }
  if constexpr (AGG) {
    __syncwarp();
    aggregate_row(a_row, i_row, k, hp, h, dh, out + (size_t)row * h * dh, lane);
  }
}

// Flat K1.
template <int SPL>
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
  extern __shared__ int flat_smem[];
  flat_launch_row<SPL, false>(nbr, msk, ety, theta_src, theta_rel, theta_dst, alpha, ids, nullptr,
                              nullptr, flat_smem, t, d, h, 0, k, slope);
}

// The fused flat launch: flat K1, then each warp aggregates its row.
template <int SPL>
__global__ void __launch_bounds__(FUSED_THREADS, fused_min_blocks(SPL)) flat_prune_aggregate_kernel(
    const int* __restrict__ nbr, const unsigned char* __restrict__ msk,
    const int* __restrict__ ety, const float* __restrict__ theta_src,
    const float* __restrict__ theta_rel, const float* __restrict__ theta_dst,
    float* __restrict__ alpha,              // out (T, k, H), or null to stage
    int* __restrict__ ids,                  // out (T, k), or null to stage
    const float* __restrict__ hp,           // (N, H, dh)
    float* __restrict__ out,                // out (T, H, dh)
    int t, int d, int h, int dh, int k, float slope) {
  extern __shared__ int flat_smem[];
  flat_launch_row<SPL, true>(nbr, msk, ety, theta_src, theta_rel, theta_dst, alpha, ids, hp, out,
                             flat_smem, t, d, h, dh, k, slope);
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

// Opt a kernel into `bytes` of dynamic shared memory where that is above
// the default 48 KB.
static int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= (size_t)DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The domain's slots a lane on the register path (1, 2, 4, 8), or 0 for
// the shared-memory path.
static int slots_per_lane(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : k <= REG_KS ? 8 : 0;
}

// Whether a fused launch of a k-slot domain over h heads stages each row's
// alpha and ids in its warp's shared memory (the register path, one warp's
// staging beside a flat list fitting); if not, it needs buffers for them in
// device memory.
static bool stages_in_smem(int k, int h) {
  return slots_per_lane(k) > 0 && (size_t)LIST_BYTES + stage_floats(k, h) * 4 <= (size_t)MAX_SMEM;
}

extern "C" int fpa_fused_needs_buffers(int k, int h) { return stages_in_smem(k, h) ? 0 : 1; }

// The arguments of a fused launch that K1 does not take, checked: H * dh
// in [1, MAX_HD]; alpha and ids both given, or both null where the launch
// stages them.
static bool fused_args_ok(const void* alpha, const void* ids, int k, int h, int dh) {
  if (dh < 1 || (long long)h * dh > MAX_HD || (alpha == nullptr) != (ids == nullptr)) return false;
  return alpha != nullptr || stages_in_smem(k, h);
}

template <int SPL, bool AGG>
static int launch_grouped(const void* nbr, const void* msk, const void* ety, const void* theta_src,
                          const void* theta_rel, const void* theta_dst, const void* row_targets,
                          const void* blk, const void* hp, void* alpha, void* ids, void* out,
                          int n_blocks, int t_tile, int w, int h, int dh, int k_s, float slope,
                          cudaStream_t stream) {
  const size_t per_warp = SPL == 0 ? (size_t)k_s * SLOT_BYTES
                          : AGG && alpha == nullptr ? stage_floats(k_s, h) * 4
                                                    : 0;
  // warps a launch block: the widest divisor of t_tile whose regions fit in
  // one block (one region always does)
  const int most = AGG ? FUSED_THREADS / 32 : t_tile;
  int wpb = t_tile;
  while ((size_t)wpb * per_warp > (size_t)MAX_SMEM || t_tile % wpb || wpb > most) --wpb;
  const size_t shmem = wpb * per_warp;
  const dim3 grid(n_blocks * (t_tile / wpb)), block(32, wpb);
  if constexpr (AGG) {
    const int err = allow_smem((const void*)grouped_prune_aggregate_kernel<SPL>, shmem);
    if (err) return err;
    grouped_prune_aggregate_kernel<SPL><<<grid, block, shmem, stream>>>(
        (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
        (const float*)theta_rel, (const float*)theta_dst, (const int*)row_targets,
        (const int*)blk, (float*)alpha, (int*)ids, (const float*)hp, (float*)out, n_blocks,
        t_tile, w, h, dh, k_s, slope);
  } else {
    const int err = allow_smem((const void*)grouped_prune_kernel<SPL>, shmem);
    if (err) return err;
    grouped_prune_kernel<SPL><<<grid, block, shmem, stream>>>(
        (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
        (const float*)theta_rel, (const float*)theta_dst, (const int*)row_targets,
        (const int*)blk, (float*)alpha, (int*)ids, n_blocks, t_tile, w, h, k_s, slope);
  }
  return (int)cudaGetLastError();
}

template <bool AGG>
static int grouped(const void* nbr, const void* msk, const void* ety, const void* theta_src,
                   const void* theta_rel, const void* theta_dst, const void* row_targets,
                   const void* blk, const void* hp, void* alpha, void* ids, void* out,
                   int n_blocks, int t_tile, int w, int h, int dh, int k_s, float slope,
                   void* stream) {
  if (n_blocks == 0) return 0;
  if (k_s < 1 || k_s > MAX_KS || w < 1 || w > 32 || t_tile < 1 || t_tile > 32)
    return (int)cudaErrorInvalidValue;
  if (AGG && !fused_args_ok(alpha, ids, k_s, h, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FPA_GROUPED(SPL)                                                                        \
  launch_grouped<SPL, AGG>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, hp, \
                           alpha, ids, out, n_blocks, t_tile, w, h, dh, k_s, slope, st)
  switch (slots_per_lane(k_s)) {
    case 1: return FPA_GROUPED(1);
    case 2: return FPA_GROUPED(2);
    case 4: return FPA_GROUPED(4);
    case 8: return FPA_GROUPED(8);
  }
  return FPA_GROUPED(0);
#undef FPA_GROUPED
}

extern "C" int fpa_grouped_prune(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, const void* row_targets,
    const void* blk, void* alpha, void* ids, int n_blocks, int t_tile, int w,
    int h, int k_s, float slope, void* stream) {
  return grouped<false>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, nullptr,
                        alpha, ids, nullptr, n_blocks, t_tile, w, h, 0, k_s, slope, stream);
}

// The fused grouped launch: K1, then the aggregation of each row's k_eff
// slots into out (rows, H, dh). alpha and ids: buffers (rows, k_s, H) and
// (rows, k_s) the flush writes, or both null to stage them in shared
// memory where fpa_fused_needs_buffers(k_s, h) is 0.
extern "C" int fpa_grouped_prune_aggregate(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, const void* row_targets,
    const void* blk, const void* hp, void* alpha, void* ids, void* out, int n_blocks,
    int t_tile, int w, int h, int dh, int k_s, float slope, void* stream) {
  return grouped<true>(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, hp,
                       alpha, ids, out, n_blocks, t_tile, w, h, dh, k_s, slope, stream);
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

template <int SPL, bool AGG>
static int launch_flat(const void* nbr, const void* msk, const void* ety, const void* theta_src,
                       const void* theta_rel, const void* theta_dst, const void* hp, void* alpha,
                       void* ids, void* out, int t, int d, int h, int dh, int k, float slope,
                       cudaStream_t stream) {
  const size_t region = SPL == 0 ? (size_t)k * SLOT_BYTES
                        : AGG && alpha == nullptr ? stage_floats(k, h) * 4
                                                  : 0;
  const size_t per_row = (size_t)LIST_BYTES + region;
  int rpb = FLAT_ROWS_PER_BLOCK;
  while (rpb > 1 && rpb * per_row > (size_t)MAX_SMEM) rpb >>= 1;
  const size_t shmem = rpb * per_row;
  const dim3 grid((t + rpb - 1) / rpb), block(32, rpb);
  if constexpr (AGG) {
    const int err = allow_smem((const void*)flat_prune_aggregate_kernel<SPL>, shmem);
    if (err) return err;
    flat_prune_aggregate_kernel<SPL><<<grid, block, shmem, stream>>>(
        (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
        (const float*)theta_rel, (const float*)theta_dst, (float*)alpha, (int*)ids,
        (const float*)hp, (float*)out, t, d, h, dh, k, slope);
  } else {
    const int err = allow_smem((const void*)flat_prune_kernel<SPL>, shmem);
    if (err) return err;
    flat_prune_kernel<SPL><<<grid, block, shmem, stream>>>(
        (const int*)nbr, (const unsigned char*)msk, (const int*)ety, (const float*)theta_src,
        (const float*)theta_rel, (const float*)theta_dst, (float*)alpha, (int*)ids, t, d, h, k,
        slope);
  }
  return (int)cudaGetLastError();
}

template <bool AGG>
static int flat(const void* nbr, const void* msk, const void* ety, const void* theta_src,
                const void* theta_rel, const void* theta_dst, const void* hp, void* alpha,
                void* ids, void* out, int t, int d, int h, int dh, int k, float slope,
                void* stream) {
  if (t == 0) return 0;
  if (k < 1 || k > MAX_KS || d < 1) return (int)cudaErrorInvalidValue;
  if (AGG && !fused_args_ok(alpha, ids, k, h, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FPA_FLAT(SPL)                                                                        \
  launch_flat<SPL, AGG>(nbr, msk, ety, theta_src, theta_rel, theta_dst, hp, alpha, ids, out, t, \
                        d, h, dh, k, slope, st)
  switch (slots_per_lane(k)) {
    case 1: return FPA_FLAT(1);
    case 2: return FPA_FLAT(2);
    case 4: return FPA_FLAT(4);
    case 8: return FPA_FLAT(8);
  }
  return FPA_FLAT(0);
#undef FPA_FLAT
}

extern "C" int fpa_flat_prune(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, void* alpha, void* ids, int t, int d,
    int h, int k, float slope, void* stream) {
  return flat<false>(nbr, msk, ety, theta_src, theta_rel, theta_dst, nullptr, alpha, ids, nullptr,
                     t, d, h, 0, k, slope, stream);
}

// The fused flat launch: K1, then the aggregation of each row's k slots
// into out (T, H, dh). alpha and ids: buffers (T, k, H) and (T, k) the
// flush writes, or both null to stage them in shared memory where
// fpa_fused_needs_buffers(k, h) is 0.
extern "C" int fpa_flat_prune_aggregate(
    const void* nbr, const void* msk, const void* ety, const void* theta_src,
    const void* theta_rel, const void* theta_dst, const void* hp, void* alpha, void* ids,
    void* out, int t, int d, int h, int dh, int k, float slope, void* stream) {
  return flat<true>(nbr, msk, ety, theta_src, theta_rel, theta_dst, hp, alpha, ids, out, t, d, h,
                    dh, k, slope, stream);
}

extern "C" int fpa_flat_aggregate(const void* alpha, const void* ids, const void* hp, void* out,
                                  int t, int h, int dh, int k, void* stream) {
  if (t == 0) return 0;
  flat_aggregate_kernel<<<t, h * dh, 0, (cudaStream_t)stream>>>(
      (const float*)alpha, (const int*)ids, (const float*)hp, (float*)out, h, dh, k);
  return (int)cudaGetLastError();
}
