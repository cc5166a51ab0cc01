// Inclusive 1-D int32 prefix scans for sm_90a: op in {max, min, sum},
// direction in {forward, reverse}, as one single-pass kernel with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA, 2016).
//
// Replaces the Pallas TPU kernel `_scan_kernel` of
// pangaea_tpu/kernels/scan.py (body :72-98, launched by `_scan1d_pallas`
// at :115 and exposed as cummax / cummin_reverse / cumsum at :153-162).
// On the port's main path the two run-boundary fills of the sort-join
// (kernels/features.py: run_start = cummax, run_end = cummin_reverse) go
// through it once each per step-1 run.
//
// Semantics, bit for bit those of the plain versions in
// pangaea_tpu_torch/kernels/scan.py:
//   max: identity INT32_MIN;  min: identity INT32_MAX;
//   sum: identity 0, wrapping like int32 (added as uint32, cast back, so
//        there is no signed-overflow undefined behaviour).
// All three ops are associative and commutative, so partial results may
// be folded in any order and the answer is still exact.
//
// Bound: the scan must read each int32 once and write it once, 8 bytes
// per element, and does one operation per element, so it is bound by
// memory bandwidth: 2^28 elements = 2 GiB, 0.641 ms at 3.35 TB/s. The
// earlier three-pass design (reduce tiles, scan the aggregates
// recursively, rescan the tiles) moved 12 bytes per element in five
// launches at 2^28 and took 1.10 ms (max), 1.25 ms (reverse min) and
// 1.14 ms (sum) there on an H100 80GB HBM3 at 700 W, 51-58 % of the bound.
// Times of this design: PERF.md.
//
// Design, point by point:
//  1. One pass. Each tile of kTile ints is read from device memory once
//     (into shared memory, then registers) and written once. The only
//     other traffic is the tile descriptors: 8 bytes per tile, zeroed by
//     one cudaMemsetAsync before the one launch, written twice and read by
//     the look-backs, a few hundred bytes against a tile's 96 KiB.
//  2. 16-byte, coalesced accesses, scanned in striped order. Word j of
//     worker lane l in worker warp w is word (w * 32 * kVecs + 32 j + l) of
//     the tile, so each warp instruction covers 512 consecutive bytes. The
//     workers copy their words with 16-byte cp.async into their own slots
//     of a two-tile shared-memory ring (each thread reads back only what
//     it copied, so no block barrier guards the copies), then scan in
//     registers: per word a serial scan of its 4 ints, a warp-shuffle scan
//     of the 32 word totals, a carry across the warp's kVecs chunks of 128
//     ints, and the totals of the warps before. Stores use the same int4
//     pattern. No transpose, no bank-conflict padding; ~7 shuffles per 128
//     ints, far below the shuffle rate. kTile = 8 warps x 32 x 12 words
//     x 4 = 12288 ints; a block is 288 threads, 96 registers each, 96 KiB
//     of shared memory, and 2 stay resident per SM (pgs_scan_resources).
//  3. Dynamic tile order, persistent blocks. The grid is as many blocks as
//     stay resident. A block takes logical tile ids from an atomicAdd on a
//     counter in the scratch, one tile ahead of the one it scans, and
//     processes them in the order it took them. It publishes a tile's
//     aggregate without waiting on any other block, so the lowest tile
//     without an inclusive prefix always has every tile before it
//     published, and the look-back cannot deadlock in any schedule.
//  4. Descriptors that cannot tear. One 64-bit word per tile: the status
//     (0 not ready, 1 aggregate, 2 inclusive prefix) in the high half and
//     the value in the low half, written with st.release.gpu and read with
//     ld.acquire.gpu. Tile 0 publishes its prefix at once.
//  5. Warp-wide look-back, in a warp of its own. A tile's look-back waits
//     for every earlier tile's aggregate, and a block that waits moves no
//     bytes: with one block per tile, that wait kept the scan well behind
//     a copy. So each block has a ninth warp that only
//     looks back: it reads the 32 preceding descriptors at once, waits
//     with __nanosleep back-off while any of them up to the nearest
//     inclusive prefix is not ready, folds the values up to that prefix,
//     slides back by 32 when the window holds none, and publishes the
//     tile's inclusive prefix. Meanwhile the workers scan the tile and
//     load the next one, and publish the next tile's aggregate as soon as
//     its words land.
//  6. Reverse without per-element index reversal. Tiles are cut in
//     physical address space at 16-byte boundaries; the reverse scan gives
//     logical tile t the physical tile T-1-t, loads it with the same
//     forward int4 pattern and scans it from high address to low in
//     registers (words, lanes, chunks and warps taken in reverse). The
//     ragged tile is the first one processed in reverse and the last
//     forward, and every access stays aligned.
//  7. Any contiguous int32 input. Tiles are cut on the 16-byte grid that
//     holds the input: `phase` ints of padding stand before element 0.
//     Words that straddle either end of the array are read and written
//     one int at a time from device memory; when the output's phase
//     differs from the input's, every store is scalar. Padding reads as
//     the identity.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWorkers = 256;               // threads that load, scan and store
constexpr int kWarps = kWorkers / 32;        // worker warps
constexpr int kThreads = kWorkers + 32;      // and one look-back warp
constexpr int kVecs = 12;                    // int4 words per worker
constexpr int kWarpElems = 32 * kVecs * 4;   // 1536
constexpr int kTile = kWarps * kWarpElems;   // 12288 ints per tile
constexpr int kSmemBytes = 2 * kTile * 4;    // the two-tile ring
constexpr int kMinBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kNotReady = 0, kAggregate = 1, kPrefix = 2;
// the scratch: one counter word, then one descriptor per tile
constexpr long long kCounterBytes = 8;

struct OpMax {
  static __device__ __forceinline__ int ident() { return INT_MIN; }
  static __device__ __forceinline__ int apply(int a, int b) { return a > b ? a : b; }
};

struct OpMin {
  static __device__ __forceinline__ int ident() { return INT_MAX; }
  static __device__ __forceinline__ int apply(int a, int b) { return a < b ? a : b; }
};

struct OpSum {
  static __device__ __forceinline__ int ident() { return 0; }
  static __device__ __forceinline__ int apply(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long descriptor(unsigned long long status, int value) {
  return (status << 32) | static_cast<unsigned>(value);
}

template <class Op>
__device__ __forceinline__ int warp_allreduce(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = Op::apply(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// inclusive scan over the warp's lanes in scan order: ascending lanes
// forward, descending lanes in reverse
template <class Op, bool REV>
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = REV ? __shfl_down_sync(kFull, v, d) : __shfl_up_sync(kFull, v, d);
    if (REV ? lane + d < 32 : lane >= d) v = Op::apply(t, v);
  }
  return v;
}

// Exclusive prefix of logical tile t > 0: the fold of every tile before
// it, read from their descriptors. Run by one whole warp; every lane
// returns the same value.
template <class Op>
__device__ int look_back(const unsigned long long* desc, long long t, int lane) {
  int excl = Op::ident();
  for (long long base = t - 1;; base -= 32) {
    const long long idx = base - lane;  // lane 0 is the nearest tile
    unsigned long long d;
    unsigned upto;  // lanes up to the nearest inclusive prefix
    unsigned prefix;
    for (unsigned ns = 16;; ns = ns < 512 ? 2 * ns : ns) {
      d = idx >= 0 ? ld_acquire(desc + idx) : descriptor(kPrefix, Op::ident());
      const unsigned long long status = d >> 32;
      prefix = __ballot_sync(kFull, status == kPrefix);
      upto = prefix ? prefix ^ (prefix - 1) : kFull;
      if ((__ballot_sync(kFull, status == kNotReady) & upto) == 0) break;
      __nanosleep(ns);
    }
    const int v = (upto >> lane) & 1 ? static_cast<int>(static_cast<unsigned>(d)) : Op::ident();
    excl = Op::apply(excl, warp_allreduce<Op>(v));
    if (prefix) return excl;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until every copy this thread started has landed
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// barrier of the worker warps only (barrier 0 is __syncthreads)
__device__ __forceinline__ void workers_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kWorkers) : "memory"); }

// This worker's words of logical tile t: q0 is its first word on the
// 16-byte grid (word j is 32 j further); `whole` when no word of the
// tile crosses an end of the array.
struct TileWords {
  long long q0;
  bool whole;
  __device__ __forceinline__ TileWords(long long tiles, long long t, bool rev, int slot, long long n,
                                       int phase) {
    const long long pt = rev ? tiles - 1 - t : t;  // physical tile
    q0 = pt * (kTile / 4) + slot;
    const long long e_tile = pt * kTile - phase;  // element of the tile's first int
    whole = e_tile >= 0 && e_tile + kTile <= n;
  }
};

// Start copying this worker's words of a tile into its slots of `buf`.
// Words across either end of the array are not copied: `word` reads
// their ints from device memory.
__device__ __forceinline__ void load_words(int4* buf, const int4* in4, const TileWords& tw, long long n,
                                           int phase) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long e = 4 * (tw.q0 + j * 32) - phase;
    if (tw.whole || (e >= 0 && e + 4 <= n)) cp_async16(buf + j * 32, in4 + tw.q0 + j * 32);
  }
}

// Word j of this worker's part of a copied tile; padding reads as the identity.
template <class Op>
__device__ __forceinline__ int4 word(const int4* buf, const int* in, const TileWords& tw, long long n,
                                     int phase, int j) {
  const long long e = 4 * (tw.q0 + j * 32) - phase;
  if (tw.whole || (e >= 0 && e + 4 <= n)) return buf[j * 32];
  int c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = e + k >= 0 && e + k < n ? in[e + k] : Op::ident();
  return make_int4(c[0], c[1], c[2], c[3]);
}

// Fold this worker's part of a copied tile into the warp's total in
// wtot[warp]; then one worker publishes the tile's aggregate (its
// inclusive prefix for tile 0) and keeps it in *agg. Workers only.
template <class Op>
__device__ __forceinline__ void publish_aggregate(const int4* buf, const int* in, const TileWords& tw,
                                                  long long n, int phase, long long t, int tid,
                                                  int* wtot, int* agg, unsigned long long* desc) {
  int tot = Op::ident();
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int4 w = word<Op>(buf, in, tw, n, phase, j);
    tot = Op::apply(Op::apply(tot, w.x), Op::apply(Op::apply(w.y, w.z), w.w));
  }
  tot = warp_allreduce<Op>(tot);
  if ((tid & 31) == 0) wtot[tid >> 5] = tot;
  workers_sync();
  if (tid == 0) {
    int a = Op::ident();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = Op::apply(a, wtot[w]);
    *agg = a;
    st_release(desc + t, descriptor(t == 0 ? kPrefix : kAggregate, a));
  }
}

template <class Op, bool REV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const int* in, int* out, long long n, int phase, bool vec_out,
            unsigned* counter, unsigned long long* desc, long long tiles) {
  extern __shared__ int4 s_buf[];  // two tiles: the one scanned, the one landing
  __shared__ long long s_next;  // a tile id handed to the block
  __shared__ int s_wtot[2][kWarps];  // worker-warp totals of each copied tile
  __shared__ int s_agg[2];
  __shared__ int s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool looker = warp == kWarps;
  // int4 words on the 16-byte grid that holds element 0 at `phase`
  const int4* in4 = reinterpret_cast<const int4*>(reinterpret_cast<uintptr_t>(in) - 4 * phase);
  int4* out4 = reinterpret_cast<int4*>(reinterpret_cast<uintptr_t>(out) - 4 * phase);
  const int slot = warp * (kWarpElems / 4) + lane;  // a worker's first word in a tile

  if (tid == 0) s_next = atomicAdd(counter, 1u);
  __syncthreads();
  long long t = s_next;  // logical tile
  if (t >= tiles) return;
  if (!looker) {
    const TileWords tw(tiles, t, REV, slot, n, phase);
    load_words(s_buf + slot, in4, tw, n, phase);
    cp_async_commit();
    cp_async_wait_all();
    publish_aggregate<Op>(s_buf + slot, in, tw, n, phase, t, tid, s_wtot[0], &s_agg[0], desc);
  }

  for (int stage = 0;; stage ^= 1) {
    __syncthreads();
    long long next = 0;
    int v[kVecs][4];
    int wex = Op::ident();
    const TileWords tw(tiles, t, REV, slot, n, phase);
    if (looker) {
      // the look-back of tile t, while the workers load the next tile
      int excl = Op::ident();
      if (t > 0) {
        excl = look_back<Op>(desc, t, lane);
        if (lane == 0) st_release(desc + t, descriptor(kPrefix, Op::apply(excl, s_agg[stage])));
      }
      if (lane == 0) s_excl = excl;
    } else {
      if (tid == 0) s_next = atomicAdd(counter, 1u);
      workers_sync();
      next = s_next;
      const TileWords nw(tiles, next, REV, slot, n, phase);
      int4* nbuf = s_buf + (stage ^ 1) * (kTile / 4) + slot;
      if (next < tiles) load_words(nbuf, in4, nw, n, phase);
      cp_async_commit();

      // scan tile t in striped order; `run` carries the warp's chunks before
      const int4* buf = s_buf + stage * (kTile / 4) + slot;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int4 w = word<Op>(buf, in, tw, n, phase, j);
        v[j][0] = w.x; v[j][1] = w.y; v[j][2] = w.z; v[j][3] = w.w;
      }
      int run = Op::ident();
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int j = REV ? kVecs - 1 - k : k;
        int s = Op::ident();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = REV ? 3 - m : m;
          s = Op::apply(s, v[j][c]);
          v[j][c] = s;
        }
        const int incl = warp_scan<Op, REV>(s, lane);
        int ex = REV ? __shfl_down_sync(kFull, incl, 1) : __shfl_up_sync(kFull, incl, 1);
        if (lane == (REV ? 31 : 0)) ex = Op::ident();
        const int pre = Op::apply(run, ex);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c] = Op::apply(pre, v[j][c]);
        run = Op::apply(run, __shfl_sync(kFull, incl, REV ? 0 : 31));
      }
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (REV ? w > warp : w < warp) wex = Op::apply(wex, s_wtot[stage][w]);

      // the next tile's aggregate goes out as soon as its words land
      if (next < tiles) {
        cp_async_wait_all();
        publish_aggregate<Op>(nbuf, in, nw, n, phase, next, tid, s_wtot[stage ^ 1], &s_agg[stage ^ 1], desc);
      }
    }
    __syncthreads();
    if (!looker) {
      const int pre = Op::apply(s_excl, wex);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[j][c] = Op::apply(pre, v[j][c]);
        const long long e = 4 * (tw.q0 + j * 32) - phase;
        if (vec_out && (tw.whole || (e >= 0 && e + 4 <= n))) {
          out4[tw.q0 + j * 32] = make_int4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (e + c >= 0 && e + c < n) out[e + c] = v[j][c];
        }
      }
    }
    next = s_next;
    if (next >= tiles) return;
    t = next;
  }
}

using Kernel = void (*)(const int*, int*, long long, int, bool, unsigned*,
                        unsigned long long*, long long);

Kernel kernel_for(int op, int reverse) {
  switch (op * 2 + (reverse ? 1 : 0)) {
    case 0: return scan_kernel<OpMax, false>;
    case 1: return scan_kernel<OpMax, true>;
    case 2: return scan_kernel<OpMin, false>;
    case 3: return scan_kernel<OpMin, true>;
    case 4: return scan_kernel<OpSum, false>;
    case 5: return scan_kernel<OpSum, true>;
    default: return nullptr;
  }
}

// Resident blocks per SM of a variant on the current device, after
// allowing it the dynamic shared memory it asks for.
cudaError_t blocks_per_sm(Kernel k, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, kSmemBytes);
}

// blocks of the persistent grid: as many as stay resident on the device
cudaError_t grid_blocks(int op, int reverse, Kernel k, long long* grid) {
  static int cache[6][64];  // [variant][device]: SMs x blocks per SM, 0 = not yet known
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& known = cache[op * 2 + (reverse ? 1 : 0)][dev & 63];
  if (known == 0) {
    int sms = 0, blocks = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = blocks_per_sm(k, &blocks);
    if (e != cudaSuccess) return e;
    known = sms * (blocks > 0 ? blocks : 1);
  }
  *grid = known;
  return cudaSuccess;
}

// int32 element phase of a pointer within its 16-byte word
int phase_of(const void* p) { return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2); }

long long tiles_for(long long n, int phase) { return (n + phase + kTile - 1) / kTile; }

// bytes of scratch for n elements at the worst phase
long long scratch_bytes(long long n) { return kCounterBytes + 8 * tiles_for(n, 3); }

}  // namespace

extern "C" {

// bytes of scratch (8-byte aligned) that pgs_scan needs for n elements
long long pgs_scan_scratch_bytes(long long n) { return scratch_bytes(n); }

// elements per tile
int pgs_scan_tile_elems() { return kTile; }

// Resources of one variant's kernel on the current device: res[0]
// registers per thread, res[1] local (spill) bytes per thread, res[2]
// shared bytes per block (static and dynamic), res[3] resident blocks per
// SM. Returns a cudaError_t, or -2 for an unknown op.
int pgs_scan_resources(int op, int reverse, int* res) {
  const Kernel k = kernel_for(op, reverse);
  if (k == nullptr) return -2;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = blocks_per_sm(k, &blocks);
  if (e != cudaSuccess) return e;
  res[0] = a.numRegs;
  res[1] = static_cast<int>(a.localSizeBytes);
  res[2] = static_cast<int>(a.sharedSizeBytes) + kSmemBytes;
  res[3] = blocks;
  return 0;
}

// op: 0 = max, 1 = min, 2 = sum; reverse: 0 or 1. `in` and `out` are
// contiguous int32 arrays of n elements (4-byte aligned, any 16-byte
// phase; they may be the same array). Zeroes the scratch with one
// cudaMemsetAsync and launches one kernel, both on `stream`, and does not
// synchronise. Returns 0, a cudaError_t from the memset or the launch,
// -1 when the scratch is too small or not 8-byte aligned, or -2 for an
// unknown op.
int pgs_scan(int op, int reverse, const int* in, int* out, long long n,
             void* scratch, long long scratch_len, void* stream) {
  if (n <= 0) return 0;
  if (scratch_len < scratch_bytes(n) || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) return -1;
  const Kernel k = kernel_for(op, reverse);
  if (k == nullptr) return -2;
  const int phase = phase_of(in);
  const long long tiles = tiles_for(n, phase);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  long long grid = 0;
  cudaError_t e = grid_blocks(op, reverse, k, &grid);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  e = cudaMemsetAsync(base, 0, kCounterBytes + 8 * tiles, s);
  if (e != cudaSuccess) return e;
  k<<<static_cast<unsigned>(grid < tiles ? grid : tiles), kThreads, kSmemBytes, s>>>(
      in, out, n, phase, phase_of(out) == phase, reinterpret_cast<unsigned*>(base),
      reinterpret_cast<unsigned long long*>(base + kCounterBytes), tiles);
  return cudaGetLastError();
}

}  // extern "C"
