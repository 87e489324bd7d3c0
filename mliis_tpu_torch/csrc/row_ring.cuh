// The row-staged pipeline shared by the port's row-split augmentation
// kernels (cheap_pass.cu, light_augment.cu), for Hopper (sm_90a).
//
// The work is a list of units, one output line each (an output row of one
// plane for cheap_pass, an output row of image and labels for the joint
// kernel), that reads one source line (or none, when a fill covers it).
// The blocks are persistent: block j takes the run [j N / G, (j + 1) N / G)
// of the N units in a sample-interleaved order (`UnitAt`). In a block, the
// last warp produces and the others consume, through a ring of `stages`
// shared-memory stages with a `full` and an `empty` mbarrier each:
//   - the producer stages the run's units in order, each as soon as its
//     stage is free: kBulk, a lane a unit, up to 32 at once, with 1D TMA bulk
//     copies (cp.async.bulk ... mbarrier::complete_tx::bytes), one a source
//     line piece (16-byte aligned lines of a multiple of 16 bytes: W % 4 ==
//     0); kAsync, the warp a unit with 4-byte cp.async, each lane arriving
//     on `full` when its copies land (cp.async.mbarrier.arrive.noinc), for
//     any W;
//   - each consumer warp takes the next unit from a counter in shared
//     memory, waits for the producer to post that unit in its stage and
//     for the stage to fill, computes it, writes it and frees the stage. So the copies run up to `stages` units ahead of the slowest
//     consumer whatever the consumers compute, and a warp that finishes a
//     plain unit takes the next while another adds noise;
//   - kDirect: no ring; the consumers read the source from device memory
//     (lines too wide for shared memory).
// The order: the samples go in groups of up to kGroup, and within a group
// of n samples row k is row k / n of sample k % n, its `planes` units in
// a row; so each run holds units of every sample of its group in turn and
// each block, and each SM, gets about the same share of the noised samples
// (the Philox work of a noised line is several times its memory time). A
// block draws its group's samples once (their head and Philox words a
// thread each; then a thread a sample for the draws that place the source
// lines, beside a thread a normal of the value draws) and builds their
// column tables once. `row_pass_plan` in
// mliis_tpu_torch/ops/augment_kernels.py picks the grid, the stages and
// the mode and sizes the shared memory as `row_smem_layout` does here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirect = 0, kAsync = 1, kBulk = 2;
constexpr int kRowThreads = 256;
constexpr int kConsumers = kRowThreads / 32 - 1;  // the last warp produces
constexpr int kMaxStages = 32;                   // stages of a block's ring
constexpr int kBarBytes = 2 * kMaxStages * 8;    // a full, an empty a stage
constexpr int kGroup = 32;          // samples a group (a warp's lanes)
// A kernel's static shared memory (its group's samples) stays within this
// (the plan reserves it beside the dynamic part).
constexpr int kStateBytes = 10240;

// Built with -DROW_TRACE (experiments/torch_row_kernels_trace.py), thread 0
// of each of the first kTraceBlocks blocks writes the global timer (ns) at
// `row_pass`'s trace points, for its first sample group: 0 entry, 1 the
// words drawn, 2 the layout and normals drawn, 3 its value draws done, 4
// its share of the tables built, 5 every consumer's share built, 6 its
// first unit landed, 7 exit; its first unit at 9 and its SM's id at 10. `row_trace_read` copies them out. Without it the trace points
// compile to nothing.
#ifdef ROW_TRACE
constexpr int kTraceBlocks = 4096, kTracePoints = 11;
__device__ unsigned long long g_row_trace[kTraceBlocks][kTracePoints];
__device__ __forceinline__ void row_trace(int k) {
  if (threadIdx.x != 0 || blockIdx.x >= kTraceBlocks) return;
  unsigned long long t;
  unsigned int sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  g_row_trace[blockIdx.x][k] = t;
  g_row_trace[blockIdx.x][kTracePoints - 1] = sm;
}
#define ROW_TRACE_AT(k) row_trace(k)
#define ROW_TRACE_VALUE(k, v)                                   \
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks)            \
    g_row_trace[blockIdx.x][k] = static_cast<unsigned long long>(v)
#define ROW_TRACE_READER                                                 \
  extern "C" int row_trace_read(void* dst) {                             \
    return static_cast<int>(                                             \
        cudaMemcpyFromSymbol(dst, g_row_trace, sizeof(g_row_trace)));    \
  }
#else
#define ROW_TRACE_AT(k)
#define ROW_TRACE_VALUE(k, v)
#define ROW_TRACE_READER
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Copies `floats` floats from the warp's output line in shared memory to
// `dst`: 16-byte loads and stores in kBulk (a multiple of 4 floats, both
// ends 16-byte aligned), 4-byte ones otherwise. The warp's lanes wrote
// `src` before and write it again after.
template <int kMode>
__device__ __forceinline__ void store_line(float* dst, const float* src,
                                           int floats, int lane) {
  __syncwarp();
  if constexpr (kMode == kBulk) {
    for (int i = 4 * lane; i < floats; i += 128)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(src + i);
  } else {
    for (int i = lane; i < floats; i += 32) dst[i] = src[i];
  }
  __syncwarp();
}

// Spins until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 1D TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asks L2 to fetch `bytes` (a multiple of 16, 16-byte aligned) of device
// memory.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Arrives on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Orders the shared-memory accesses before it (the consumers' reads of a
// stage, which the `empty` mbarrier's phase brings before it) ahead of a
// later bulk copy (the async proxy) that overwrites the stage.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages a source line of `floats` floats (none when `filled`) into
// `stage`, completing `bar`'s phase: kBulk, the calling thread alone with
// one bulk copy a piece (up to two pieces: `floats0` floats from src0, the
// rest from src1); kAsync, every lane of the calling warp with 4-byte
// copies.
template <int kMode>
__device__ __forceinline__ void stage_line(float* stage, const float* src0,
                                           int floats0, const float* src1,
                                           int floats, bool filled,
                                           uint64_t* bar, int lane) {
  if constexpr (kMode == kBulk) {
    if (filled) {
      mbar_arrive(bar);
      return;
    }
    fence_proxy_async();
    mbar_arrive_tx(bar, static_cast<uint32_t>(4 * floats));
    bulk_copy(stage, src0, 4 * floats0, bar);
    if (floats > floats0)
      bulk_copy(stage + floats0, src1, 4 * (floats - floats0), bar);
  } else if constexpr (kMode == kAsync) {
    if (!filled)
      for (int i = lane; i < floats; i += 32)
        async_copy4(stage + i, i < floats0 ? src0 + i : src1 + (i - floats0));
    async_arrive(bar);
  }
}

// Shared memory of a row pass: kBarBytes of mbarriers, the group's column
// tables (n_tab ints), then the ring's `stages` stages and each consumer
// warp's output line, of `stage_floats` floats each (each part rounded up
// to 4 entries).
struct RowSmem {
  int tab4, stage4, bytes;
};

__host__ __device__ inline RowSmem row_smem_layout(int n_tab,
                                                   int stage_floats,
                                                   int stages) {
  const int tab4 = (n_tab + 3) / 4 * 4;
  const int stage4 = (stage_floats + 3) / 4 * 4;
  return {tab4, stage4,
          kBarBytes + 4 * (tab4 + (stages + kConsumers) * stage4)};
}

// Before a row kernel's launch: its dynamic shared memory, the whole
// carveout for shared memory, and a grid no larger than the card holds at
// once (a larger one means the plan's shared-memory count is off, and its
// last blocks would run as a second wave).
inline cudaError_t row_launch_check(const void* kernel, int grid, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kRowThreads, smem);
  if (err == cudaSuccess && grid > sms * per_sm)
    err = cudaErrorInvalidConfiguration;
  return err;
}

// floor(i / d) as a multiply, for i * d < 2^32 (m = row_magic(d); d = 1
// gives m = 0, taken as the identity).
__host__ __device__ inline uint32_t row_magic(uint32_t d) {
  return static_cast<uint32_t>(0xFFFFFFFFull / d + 1);
}
__device__ __forceinline__ int magic_div(int i, uint32_t m) {
  return m ? static_cast<int>(__umulhi(static_cast<uint32_t>(i), m)) : i;
}

// A coordinate map of a line of n, x -> (sg x + b) mod n with sg in {-1,
// 0, 1} and b in [0, n): a line's walk through flips and rolls, each op
// at most once, is one such map at every stage.
struct Affine {
  int sg, b;
  __device__ __forceinline__ int at(int x, int n) const {
    const int t = sg * x + b;
    return t < 0 ? t + n : t >= n ? t - n : t;
  }
  __device__ __forceinline__ Affine flipped(int n) const {
    return {-sg, n - 1 - b};
  }
  // After a roll by `shift`: position t then reads t - shift.
  __device__ __forceinline__ Affine rolled(int shift, int n) const {
    const int from = (b - shift) % n;
    return {sg, from < 0 ? from + n : from};
  }
};

// A unit of the interleaved order: its sample's slot in the group, its
// sample, its row and its plane.
struct UnitAt {
  int slot, b, y, c;
};

// A unit's source line: `floats0` floats from p0, then the rest of the
// line's floats from p1 (the kernel's two counts); none when `filled`.
struct SrcLine {
  const float* p0;
  const float* p1;
  int filled;
};

// One row pass, shared by the row kernels. K is the kernel's side, for the
// group of samples [g0, g0 + n) the block is at:
//   draw_words(g0, n): every thread; the samples' indices, seeds and
//     scalar Philox words;
//   draw_layout(s): thread s < n, sample s's draws that place its lines;
//   draw_normal(s, i): a thread each, normal i < 3 of sample s's value
//     draws (Box-Muller), beside the layout draws;
//   draw_values(s): thread s < n, the rest of sample s's value draws;
//   SrcLine source(unit): a unit's source line; floats0, floats its
//     counts; SrcLine own(unit): the line at the unit's own place (its
//     source unless a vertical translate moves it);
//   build_tables(n, t, stride): the consumer threads; the samples' column
//     tables;
//   Line line(unit): a unit's walk and its sample's value rules;
//   run<kMode>(line, stage, out, lane): the calling warp computes a unit
//     from its staged source line and writes it (through `out`, the warp's
//     output line in shared memory: 16-byte stores in kBulk).
template <int kMode, class K>
__device__ __forceinline__ void row_pass(K& k, unsigned char* smem,
                                         const RowSmem& lay, int batch,
                                         int h, int planes, int stages_arg) {
  __shared__ int next;                // the group's next unit to take
  __shared__ int staged[kMaxStages];  // the unit each stage was last given
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int stages = kMode == kDirect ? 1 : stages_arg;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes) + lay.tab4;
  float* out = ring + (stages + warp) * lay.stage4;  // a consumer warp's
  ROW_TRACE_AT(0);
  if (kMode != kDirect && t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kMode == kBulk ? 1 : 32);
      mbar_init(empty + s, 1);
      staged[s] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const long long units = static_cast<long long>(batch) * h * planes;
  const int first = static_cast<int>(blockIdx.x * units / gridDim.x);
  const int last = static_cast<int>((blockIdx.x + 1) * units / gridDim.x);
  const int group_units = kGroup * h * planes;
  const uint32_t planes_m = row_magic(planes);
  ROW_TRACE_VALUE(9, first);
  int q0 = 0;  // units of the run staged before this group: unit q of the
               // group goes to stage (q0 + q) % stages
  for (int i0 = first; i0 < last;) {
    const int g0 = i0 / group_units * kGroup, n_s = min(kGroup, batch - g0);
    const int n = min(last, (g0 + n_s) * h * planes) - i0;  // run's units
    // unit q < n of the group's run: within the group, unit u is plane
    // u % planes of row r = u / planes, row r / n_s of sample r % n_s
    const uint32_t n_m = row_magic(n_s);
    const int u0 = i0 - g0 * h * planes;
    const auto unit_of = [&](int q) {
      const int u = u0 + q, r = magic_div(u, planes_m);
      const int y = magic_div(r, n_m), slot = r - y * n_s;
      return UnitAt{slot, g0 + slot, y, u - r * planes};
    };
    if (t == 0) next = 0;
    if constexpr (kMode == kBulk) {
      // Before any draw, L2 starts fetching the lines at the first units'
      // own places, which their copies read unless a vertical translate
      // moves them (then mostly a neighbour unit's).
      if (warp == kConsumers)
        for (int q = lane; q < min(n, stages); q += 32) {
          const SrcLine o = k.own(unit_of(q));
          prefetch_l2(o.p0, 4 * k.floats0);
          if (k.floats > k.floats0)
            prefetch_l2(o.p1, 4 * (k.floats - k.floats0));
        }
    }
    k.draw_words(g0, n_s);
    __syncthreads();
    if (i0 == first) ROW_TRACE_AT(1);
    if (warp == kConsumers) {
      // The producer, in order: batches of up to min(32, stages) units, a
      // lane's walk each; kBulk, each lane stages its unit; kAsync, the
      // warp stages them one by one. A unit waits for its stage's last
      // occupant to be consumed, then posts its number in `staged`. The
      // producer starts once warp 0 has drawn the layout.
      asm volatile("bar.sync 2, 64;\n" ::: "memory");
      const int batch_units = min(32, stages);
      for (int b0 = 0; kMode != kDirect && b0 < n; b0 += batch_units) {
        const int q = b0 + lane;
        const bool mine = lane < batch_units && q < n;
        const SrcLine src = mine ? k.source(unit_of(q)) : SrcLine{};
        if constexpr (kMode == kBulk) {
          if (mine) {
            const int it = q0 + q, slot = it % stages;
            if (it >= stages) mbar_wait(empty + slot, (it / stages - 1) & 1);
            staged[slot] = it;
            stage_line<kMode>(ring + slot * lay.stage4, src.p0, k.floats0,
                              src.p1, k.floats, src.filled, full + slot,
                              lane);
          }
        } else {
          for (int j = 0; j < min(batch_units, n - b0); ++j) {
            const int it = q0 + b0 + j, slot = it % stages;
            const SrcLine sj{
                reinterpret_cast<const float*>(__shfl_sync(
                    0xFFFFFFFFu, reinterpret_cast<uintptr_t>(src.p0), j)),
                reinterpret_cast<const float*>(__shfl_sync(
                    0xFFFFFFFFu, reinterpret_cast<uintptr_t>(src.p1), j)),
                __shfl_sync(0xFFFFFFFFu, src.filled, j)};
            if (it >= stages) mbar_wait(empty + slot, (it / stages - 1) & 1);
            if (lane == 0) staged[slot] = it;
            stage_line<kMode>(ring + slot * lay.stage4, sj.p0, k.floats0,
                              sj.p1, k.floats, sj.filled, full + slot, lane);
          }
        }
        __syncwarp();
      }
    } else {
      if (t < n_s)
        k.draw_layout(t);
      else if (t >= 32 && t < 32 + 3 * n_s)
        k.draw_normal((t - 32) / 3, (t - 32) % 3);
      if (warp == 0) asm volatile("bar.arrive 2, 64;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
      if (i0 == first) ROW_TRACE_AT(2);
      if (t < n_s) k.draw_values(t);
      if (i0 == first) ROW_TRACE_AT(3);
      if (kMode != kDirect) k.build_tables(n_s, t, 32 * kConsumers);
      if (i0 == first) ROW_TRACE_AT(4);
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
      if (i0 == first) ROW_TRACE_AT(5);
      for (bool at_first = i0 == first;; at_first = false) {
        int q = 0;
        if (lane == 0) q = atomicAdd(&next, 1);
        q = __shfl_sync(0xFFFFFFFFu, q, 0);
        if (q >= n) break;
        const int it = q0 + q, slot = it % stages;
        float* stage = ring + slot * lay.stage4;
        const typename K::Line line = k.line(unit_of(q));
        if (kMode != kDirect) {
          // Once the producer has posted unit `it` in its stage, the stage's
          // `full` mbarrier is in the phase that unit completes: its parity
          // names it (without the post, a stage two phases behind would
          // pass the parity test).
          while (*static_cast<volatile int*>(staged + slot) != it) {
          }
          mbar_wait(full + slot, (it / stages) & 1);
        }
        if (at_first) ROW_TRACE_AT(6);
        k.template run<kMode>(line, stage, out, lane);
        if (kMode != kDirect) {
          __syncwarp();  // the warp's reads of the stage are done
          if (lane == 0) mbar_arrive(empty + slot);
        }
      }
    }
    q0 += n;
    __syncthreads();  // the ring is drained; the samples may change
    i0 += n;
  }
  ROW_TRACE_AT(7);
}

}  // namespace
