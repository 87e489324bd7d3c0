// resized_ce: the joint step's loss head, for Hopper (sm_90a): the
// decoder's logits [N, C, h, w] resized (align corners, bilinear) to the
// labels' [N, H, W] and their mean cross entropy, smoothed as
//   (1 - eps) CE(label) + eps / C sum_c CE(c),
// one launch forward and one backward. Neither writes the resized logits,
// their probabilities or their gradient to device memory.
//
// It replaces no TPU kernel: the JAX package's head is XLA's product of the
// logits with the interpolation matrices and its softmax cross entropy
// (mliis_tpu/joint/trainer.py). It was added because the port's head,
// PyTorch's upsample and softmax kernels on the [N, C, H, W] logits
// (12.86 GB at N = 64, C = 1001, 224^2, past 2^31 elements, so in batch
// chunks), wrote and read that tensor and its gradient about eight times a
// step. The plain
// PyTorch version is `resized_ce_forward_reference` and
// `resized_ce_backward_reference` in mliis_tpu_torch/ops/resized_ce.py.
//
// The taps are PyTorch's upsample_bilinear2d's for float32: along an axis of
// `in` to `out` points, src = float((in - 1) / (out - 1)) * dst in float32,
// lo = trunc(src), hi = lo + (lo < in - 1), weight src - lo. The host
// computes them once per shape (`resized_ce_plan`): per output point its
// lo and weight, per input point the first output point whose lo reaches it
// (`start`). Output rows (columns) with one lo are a "cell" row (column):
// they share the two input rows (columns) they interpolate.
//
// What bounds it (N = 64, C = 1001, 56^2 -> 224^2): the exponentials,
// 3.2e9 each way (one a resized logit: 0.84 ms each way at 16 a clock on
// each of the 132 SMs at 1.755 GHz), and about as many float32 operations
// for the interpolation, the online softmax and the gathers (0.5-1 ms at
// 67 TFLOP/s); the bytes, the 0.80 GB logits read once each way and their
// 0.80 GB gradient written once, plus 25.7 MB of per-pixel statistics
// (2.5 GB in all: 0.75 ms at 3.35 TB/s), come to less.
//
// Design. A thread owns one output column x (lanes run along x) and the
// rows of its block's unit; the block stages the unit's two input rows of
// a chunk of channels in shared memory with cp.async, the next chunk (or
// row) while it computes on the current one, coalesced along the memory's
// contiguous axis (columns for NCHW, channels for channels-last: both are
// taken as they come, and the gradient is written in the input's format),
// and each thread reads its four taps from there. The two taps along x are
// interpolated once a channel (with the x weights times log2 e) and shared
// by the unit's rows, so a staged value is read from device memory once a
// unit, not once an output pixel.
//   Forward: one block a (cell row, up to 8 of its output rows, column
//   tile, image). Each thread keeps an online max and sum of exp2 per row
//   over all C channels (log2 domain: one ex2.approx a logit, a second
//   where the running max rises) and the channel sums of its two x-taps for
//   the smoothing term; the label's logit is read from the staged chunk
//   that holds it. It writes each output pixel's log-sum-exp (times log2 e)
//   and its label as an integer, 8 bytes a pixel, and the block's loss sum
//   in float64. The last block to finish (by an integer counter of the
//   call's own, zeroed on the stream before the launch) adds the blocks'
//   sums in a fixed order: no float atomics, the same loss every run. A
//   label outside [0, C) makes its pixel's log-sum-exp NaN, so the loss and
//   the gradient of its taps are NaN.
//   Backward: one block a (band of kBand input rows, column tile, chunk of
//   kBwdChunk channels, image), in gather form: each input pixel sums the
//   weighted softmax - target of the output pixels whose taps include it,
//   and no two blocks write one element. The block walks the cell rows
//   from the one above its band (a halo, also taken by the band above) to
//   its last, its input rows in a ring of three; for each, a thread
//   recomputes softmax - target for its column, its rows and the chunk's
//   channels from the staged taps and the saved log-sum-exp, and reduces
//   along y into the cell row's two input rows; the block then reduces
//   along x in shared memory, in a fixed order, into the tile's input
//   columns, adds the contribution carried from the cell row above, writes
//   the finished input row and carries the other.
//   The constant eps / C of every channel enters as the weights' sums.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM: at most 85 registers a thread
constexpr int kMaxRows = 8;    // output rows of a forward unit or row pass
constexpr int kFwdChunk = 32;  // channels the forward stages at a time
constexpr int kBwdChunk = 16;  // channels of a backward block: a half-warp
constexpr int kBand = 16;      // input rows of a backward block
constexpr int kMaxSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A column tile: output columns [x_begin, x_begin + x_count), whose taps lie
// in input columns [j_lo, j_lo + span); the backward's tile owns input
// columns [j_begin, j_end). Host: `forward_tiles`, `backward_tiles`.
struct Tile {
  int x_begin, x_count, j_lo, span, j_begin, j_end, pad0, pad1;
};

// The low-resolution logits (or their gradient): [N, C, h, w], NCHW or
// channels-last in memory.
struct Low {
  const float* x;
  int64_t sn, sc, sh, sw;
  int c, h, w;
  bool channels_last;
};

__host__ Low make_low(const float* x, int channels_last, int c, int h,
                      int w) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  Low l{x, hw * c, hw, w, 1, c, h, w, channels_last != 0};
  if (l.channels_last) {
    l.sc = 1;
    l.sw = c;
    l.sh = static_cast<int64_t>(w) * c;
  }
  return l;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for every committed group but the newest.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Starts copying channels [c0, c0 + kc) of input rows r0 (and r1, with two
// rows), columns [j_lo, j_lo + span), of one image to dst[k * kstride + r *
// span + jj], a warp a contiguous line of memory. kstride is odd, so that
// the channels-last lanes (one a channel) meet no bank twice.
__device__ __forceinline__ void stage(const Low& l, const float* xn, int c0,
                                      int kc, int r0, int r1, int rows,
                                      int j_lo, int span, int kstride,
                                      float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (l.channels_last) {
    for (int p = warp; p < rows * span; p += kWarps) {
      const int r = p >= span, jj = p - r * span;
      const float* src = xn + (r ? r1 : r0) * l.sh + (j_lo + jj) * l.sw + c0;
      for (int k = lane; k < kc; k += 32)
        cp_async4(dst + k * kstride + r * span + jj, src + k);
    }
  } else {
    for (int p = warp; p < rows * kc; p += kWarps) {
      const int k = p / rows, r = p - k * rows;
      const float* src = xn + (c0 + k) * l.sc + (r ? r1 : r0) * l.sh + j_lo;
      for (int jj = lane; jj < span; jj += 32)
        cp_async4(dst + k * kstride + r * span + jj, src + jj);
    }
  }
}

// A thread's output column: its two input columns in the staged tile and
// their weights, plain and times log2 e.
struct Column {
  bool active;
  int x, j0, j1;
  float hx, lx, hx2, lx2;
};

__device__ __forceinline__ Column column_of(const Tile& t, const int* xlo,
                                            const float* xfrac, int w) {
  Column col{static_cast<int>(threadIdx.x) < t.x_count, 0, 0, 0,
             0.f, 0.f, 0.f, 0.f};
  if (col.active) {
    col.x = t.x_begin + threadIdx.x;
    const int jg = xlo[col.x];
    col.j0 = jg - t.j_lo;
    col.j1 = col.j0 + (jg < w - 1);
    col.lx = xfrac[col.x];
    col.hx = 1.f - col.lx;
    col.hx2 = col.hx * kLog2e;
    col.lx2 = col.lx * kLog2e;
  }
  return col;
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

// A label as a class id, truncated as `.long()` does; -1 (out of range) for
// a float label that is NaN or has no int value.
__device__ __forceinline__ int label_of(int v) { return v; }
__device__ __forceinline__ int label_of(float v) {
  return v > -1.f && v < 2147483648.f ? static_cast<int>(v) : -1;
}

template <typename Label>
struct FwdArgs {
  Low low;
  const Label* __restrict__ labels;  // [N, H, W]
  const int4* __restrict__ units;    // (cell row, first output row, rows, 0)
  const Tile* __restrict__ tiles;
  const float* __restrict__ yfrac;
  const int* __restrict__ xlo;
  const float* __restrict__ xfrac;
  float2* __restrict__ stats;        // [N, H, W]: (lse * log2 e, label bits)
  double* __restrict__ partials;     // a loss sum a block
  unsigned* __restrict__ done;       // blocks finished; 0 at the launch
  float* __restrict__ loss;
  int out_h, out_w;
  float eps, eps_c;                  // eps, eps / C
  double inv_count;                  // 1 / (N H W)
};

// The loss sum of one unit's R rows at the thread's column. The channels
// come in chunks of kFwdChunk through two buffers of s: the next chunk is
// copied while this one is read.
template <int R, typename Label>
__device__ __forceinline__ double forward_rows(const FwdArgs<Label>& a,
                                               const Tile& t, int n, int i,
                                               int y_begin, float* s) {
  const Low& l = a.low;
  const int i1 = i + (i < l.h - 1);
  const Column col = column_of(t, a.xlo, a.xfrac, l.w);
  const int64_t pix = (static_cast<int64_t>(n) * a.out_h + y_begin)
      * a.out_w + col.x;
  float ly[R], m[R], sum[R], zl[R];
  int lab[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ly[r] = a.yfrac[y_begin + r];
    m[r] = -INFINITY;
    sum[r] = 0.f;
    zl[r] = 0.f;
    lab[r] = col.active ? label_of(a.labels[pix + r * a.out_w]) : -1;
  }
  float su0 = 0.f, su1 = 0.f;  // channel sums of the x-interpolations
  const bool smooth = a.eps != 0.f;
  const float* xn = l.x + n * l.sn;
  const int span = t.span, ks = (2 * span) | 1;
  const int chunks = (l.c + kFwdChunk - 1) / kFwdChunk;
  stage(l, xn, 0, min(kFwdChunk, l.c), i, i1, 2, t.j_lo, span, ks, s);
  cp_async_commit();
  for (int q = 0; q < chunks; ++q) {
    const int c0 = q * kFwdChunk, kc = min(kFwdChunk, l.c - c0);
    const float* sq = s + (q & 1) * kFwdChunk * ks;
    if (q + 1 < chunks)
      stage(l, xn, c0 + kFwdChunk, min(kFwdChunk, l.c - c0 - kFwdChunk), i,
            i1, 2, t.j_lo, span, ks, s + ((q + 1) & 1) * kFwdChunk * ks);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    if (col.active) {
#pragma unroll 2
      for (int k = 0; k < kc; ++k) {
        const float* sk = sq + k * ks;
        const float v0 = fmaf(col.lx2, sk[col.j1], col.hx2 * sk[col.j0]);
        const float v1 = fmaf(col.lx2, sk[span + col.j1],
                              col.hx2 * sk[span + col.j0]);
        if (smooth) {
          su0 += v0;
          su1 += v1;
        }
        const float dv = v1 - v0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float z = fmaf(ly[r], dv, v0);
          if (z > m[r]) {
            sum[r] *= ex2(m[r] - z);
            m[r] = z;
          }
          sum[r] += ex2(z - m[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned k = static_cast<unsigned>(lab[r] - c0);
        if (k < static_cast<unsigned>(kc)) {
          const float* sk = sq + k * ks;
          const float u0 = fmaf(col.lx, sk[col.j1], col.hx * sk[col.j0]);
          const float u1 = fmaf(col.lx, sk[span + col.j1],
                                col.hx * sk[span + col.j0]);
          zl[r] = fmaf(ly[r], u1 - u0, u0);
        }
      }
    }
    __syncthreads();
  }
  double acc = 0.0;
  if (col.active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool bad = static_cast<unsigned>(lab[r])
          >= static_cast<unsigned>(l.c);  // poisons the loss and gradient
      const float lse2 = bad ? __int_as_float(0x7fc00000)
                             : m[r] + lg2(sum[r]);
      const float zsum = fmaf(ly[r], su1 - su0, su0) * kLn2;
      acc += static_cast<double>(lse2 * kLn2 - (1.f - a.eps) * zl[r]
                                 - a.eps_c * zsum);
      a.stats[pix + r * a.out_w] = make_float2(lse2, __int_as_float(lab[r]));
    }
  }
  return acc;
}

// Lane 0 of each warp holds its warp's sum, added in a fixed tree.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename Label>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resized_ce_forward_kernel(FwdArgs<Label> a) {
  extern __shared__ float s[];
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  const Tile t = a.tiles[blockIdx.x];
  const int4 u = a.units[blockIdx.y];
  const int n = blockIdx.z;
  double acc = 0.0;
  switch (u.z) {
    case 1: acc = forward_rows<1>(a, t, n, u.x, u.y, s); break;
    case 2: acc = forward_rows<2>(a, t, n, u.x, u.y, s); break;
    case 3: acc = forward_rows<3>(a, t, n, u.x, u.y, s); break;
    case 4: acc = forward_rows<4>(a, t, n, u.x, u.y, s); break;
    case 5: acc = forward_rows<5>(a, t, n, u.x, u.y, s); break;
    case 6: acc = forward_rows<6>(a, t, n, u.x, u.y, s); break;
    case 7: acc = forward_rows<7>(a, t, n, u.x, u.y, s); break;
    case 8: acc = forward_rows<8>(a, t, n, u.x, u.y, s); break;
    default: break;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
    a.partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
               + blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(a.done, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double part = 0.0;
  for (unsigned b = threadIdx.x; b < blocks; b += kThreads)
    part += __ldcg(a.partials + b);
  part = warp_sum(part);
  __syncthreads();
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
    *a.loss = static_cast<float>(total * a.inv_count);
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

struct BwdArgs {
  Low low;
  const float2* __restrict__ stats;
  const float* __restrict__ grad_loss;  // the loss's gradient, a scalar
  float* __restrict__ grad;             // strided as `low`
  const Tile* __restrict__ tiles;
  const int* __restrict__ ystart;       // [h + 1]
  const float* __restrict__ yfrac;
  const int* __restrict__ xlo;
  const int* __restrict__ xstart;       // [w + 1]
  const float* __restrict__ xfrac;
  int out_h, out_w, chunks;
  float eps, eps_c, inv_count;
};

// Adds the weighted softmax - target of R output rows at the thread's
// column, for the chunk's channels, to its cell row's upper input row
// (`cur`, read and written) and its lower one (`next`, written on the cell
// row's first pass, then added to); up and down are the two rows' staged
// taps.
template <int R>
__device__ __forceinline__ void backward_rows(const BwdArgs& a,
                                              const Column& col, int n,
                                              int y_begin, bool fold,
                                              bool first, int c0, int kc,
                                              const float* up,
                                              const float* down, int ss,
                                              float* cur, float* next,
                                              int xs) {
  float ly[R], w0[R], w1[R], lse2[R];
  int lab[R];
  float sum0 = 0.f, sum1 = 0.f;
  const int64_t pix = (static_cast<int64_t>(n) * a.out_h + y_begin)
      * a.out_w + col.x;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ly[r] = a.yfrac[y_begin + r];
    const float hy = 1.f - ly[r];
    w0[r] = fold ? hy + ly[r] : hy;
    w1[r] = fold ? 0.f : ly[r];
    sum0 += w0[r];
    sum1 += w1[r];
    const float2 st = a.stats[pix + r * a.out_w];
    lse2[r] = st.x;
    lab[r] = __float_as_int(st.y) - c0;
  }
  // The constant eps / C of every channel, through the rows' weights.
  const float base0 = -a.eps_c * sum0, base1 = -a.eps_c * sum1;
  const int tid = threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    const float* su = up + k * ss;
    const float* sd = down + k * ss;
    const float v0 = fmaf(col.lx2, su[col.j1], col.hx2 * su[col.j0]);
    const float v1 = fmaf(col.lx2, sd[col.j1], col.hx2 * sd[col.j0]);
    const float dv = v1 - v0;
    float g0 = base0, g1 = base1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = ex2(fmaf(ly[r], dv, v0) - lse2[r]);
      g0 = fmaf(w0[r], p, g0);
      g1 = fmaf(w1[r], p, g1);
    }
    cur[k * xs + tid] += g0;
    if (first)
      next[k * xs + tid] = g1;
    else
      next[k * xs + tid] += g1;
  }
  // The target: 1 - eps at each row's label.
  const float drop = 1.f - a.eps;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (static_cast<unsigned>(lab[r]) < static_cast<unsigned>(kc)) {
      cur[lab[r] * xs + tid] -= w0[r] * drop;
      next[lab[r] * xs + tid] -= w1[r] * drop;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    resized_ce_backward_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const Low& l = a.low;
  const int chunk = blockIdx.x % a.chunks, n = blockIdx.z;
  const Tile t = a.tiles[blockIdx.x / a.chunks];
  const int i0 = blockIdx.y * kBand, i_end = min(i0 + kBand, l.h);
  const int c0 = chunk * kBwdChunk, kc = min(kBwdChunk, l.c - c0);
  const int ss = t.span | 1, xs = t.x_count | 1;
  const int nj = t.j_end - t.j_begin, cs = nj | 1;
  float* ring = smem;                       // [3][kBwdChunk][ss]: input rows
  float* sums = ring + 3 * kBwdChunk * ss;  // [2][kBwdChunk][xs]: along y
  float* wx = sums + 2 * kBwdChunk * xs;    // [2][xs]: x weights to j0, j1
  float* out = wx + 2 * xs;                 // [kBwdChunk][cs]: a finished row
  // [nj + 2]: the tile's first output column of input columns j_begin - 1
  // to j_end, relative to x_begin.
  int* xb = reinterpret_cast<int*>(out + kBwdChunk * cs);
  const Column col = column_of(t, a.xlo, a.xfrac, l.w);
  const int tid = threadIdx.x;
  if (col.active) {
    const bool edge = a.xlo[col.x] == l.w - 1;  // both taps on the last
    wx[tid] = edge ? col.hx + col.lx : col.hx;
    wx[xs + tid] = edge ? 0.f : col.lx;
    for (int k = 0; k < kc; ++k) sums[k * xs + tid] = 0.f;
  }
  for (int q = tid; q < nj + 2; q += kThreads) {
    const int j = t.j_begin - 1 + q;
    xb[q] = (j < 0 ? t.x_begin : a.xstart[j]) - t.x_begin;
  }
  const float scale = *a.grad_loss * a.inv_count;
  const float* xn = l.x + n * l.sn;
  float* gn = a.grad + n * l.sn;
  const int r_first = max(i0 - 1, 0), r_last = min(i_end, l.h - 1);
  const int slot = kBwdChunk * ss;
  stage(l, xn, c0, kc, r_first, r_first, 1, t.j_lo, t.span, ss, ring);
  if (r_first < r_last)
    stage(l, xn, c0, kc, r_first + 1, r_first + 1, 1, t.j_lo, t.span, ss,
          ring + slot);
  cp_async_commit();
  for (int ic = r_first; ic < i_end; ++ic) {
    const int i1 = ic + (ic < l.h - 1);
    const bool fold = i1 == ic;  // both taps on the last input row
    // y-sums of input row ic (cur; it holds cell row ic - 1's part) and
    // of row ic + 1 (next).
    float* cur = sums + ((ic - r_first) & 1) * kBwdChunk * xs;
    float* next = sums + ((ic - r_first + 1) & 1) * kBwdChunk * xs;
    if (ic + 2 <= r_last)
      stage(l, xn, c0, kc, ic + 2, ic + 2, 1, t.j_lo, t.span, ss,
            ring + (ic + 2 - r_first) % 3 * slot);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* up = ring + (ic - r_first) % 3 * slot;
    const float* down = ring + (i1 - r_first) % 3 * slot;
    const int y_begin = a.ystart[ic], y_end = a.ystart[ic + 1];
    if (col.active) {
      for (int y = y_begin; y < y_end; y += kMaxRows) {
        switch (min(kMaxRows, y_end - y)) {
#define RESIZED_CE_ROWS(R)                                                 \
  case R:                                                                  \
    backward_rows<R>(a, col, n, y, fold, y == y_begin, c0, kc, up, down,   \
                     ss, cur, next, xs);                                   \
    break;
          RESIZED_CE_ROWS(1) RESIZED_CE_ROWS(2) RESIZED_CE_ROWS(3)
          RESIZED_CE_ROWS(4) RESIZED_CE_ROWS(5) RESIZED_CE_ROWS(6)
          RESIZED_CE_ROWS(7) RESIZED_CE_ROWS(8)
#undef RESIZED_CE_ROWS
          default: break;
        }
      }
      if (y_begin == y_end)
        for (int k = 0; k < kc; ++k) next[k * xs + tid] = 0.f;
    }
    __syncthreads();
    if (ic < i0) continue;  // the halo row: only its lower part is ours
    // Row ic along x, into the tile's input columns: column j takes the
    // output columns whose lower tap is j and, with their upper weight,
    // those whose lower tap is j - 1. A half-warp a column, a lane a
    // channel.
    const int warp = tid >> 5, k = tid & (kBwdChunk - 1);
    const int half = (tid >> 4) & 1;
    for (int jj = 2 * warp + half; jj < nj; jj += 2 * kWarps) {
      if (k >= kc) continue;
      const float* row = cur + k * xs;
      float g = 0.f;
      for (int x = xb[jj + 1]; x < xb[jj + 2]; ++x)
        g = fmaf(wx[x], row[x], g);
      for (int x = xb[jj]; x < xb[jj + 1]; ++x)
        g = fmaf(wx[xs + x], row[x], g);
      out[k * cs + jj] = g * scale;
    }
    __syncthreads();
    // The finished row, a warp along the memory's contiguous axis.
    if (l.channels_last) {
      for (int jj = 2 * warp + half; jj < nj; jj += 2 * kWarps)
        if (k < kc)
          gn[(c0 + k) + ic * l.sh + (t.j_begin + jj) * l.sw] =
              out[k * cs + jj];
    } else {
      for (int kk = warp; kk < kc; kk += kWarps)
        for (int jj = tid & 31; jj < nj; jj += 32)
          gn[(c0 + kk) * l.sc + ic * l.sh + t.j_begin + jj] =
              out[kk * cs + jj];
    }
    // The next iteration writes `cur` (as its `next`) and `out` only after
    // its first barrier.
  }
}

cudaError_t check(int n, int c, int h, int w, int out_h, int out_w,
                  int n_tiles, int rows, int smem) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || out_h < 1 || out_w < 1
      || n_tiles < 1 || rows < 1 || n > 65535 || rows > 65535 || smem < 0
      || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch
// (0 = success). labels: float32 (labels_float) or int32 [N, H, W];
// units [n_units][4], tiles [n_tiles][8], partials n_tiles x n_units x N
// doubles, done one unsigned (zeroed here), smem the tiles' largest
// 2 x 4 x kFwdChunk x (2 span | 1) bytes.
int resized_ce_forward_launch(const float* x, int channels_last,
                              const void* labels, int labels_float,
                              const int* units, int n_units,
                              const int* tiles, int n_tiles,
                              const float* yfrac, const int* xlo,
                              const float* xfrac, float* stats,
                              double* partials, unsigned* done, float* loss,
                              int n, int c, int h, int w, int out_h,
                              int out_w, float eps, int smem, void* stream) {
  const cudaError_t err = check(n, c, h, w, out_h, out_w, n_tiles, n_units,
                                smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Low low = make_low(x, channels_last, c, h, w);
  const dim3 grid(n_tiles, n_units, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const float eps_c = eps / static_cast<float>(c);
  const double inv = 1.0 / (static_cast<double>(n) * out_h * out_w);
  const int4* u = reinterpret_cast<const int4*>(units);
  const Tile* t = reinterpret_cast<const Tile*>(tiles);
  if (labels_float) {
    const FwdArgs<float> a{low, static_cast<const float*>(labels), u, t,
                           yfrac, xlo, xfrac, reinterpret_cast<float2*>(stats),
                           partials, done, loss, out_h, out_w, eps, eps_c,
                           inv};
    resized_ce_forward_kernel<float><<<grid, kThreads, smem, s>>>(a);
  } else {
    const FwdArgs<int> a{low, static_cast<const int*>(labels), u, t, yfrac,
                         xlo, xfrac, reinterpret_cast<float2*>(stats),
                         partials, done, loss, out_h, out_w, eps, eps_c, inv};
    resized_ce_forward_kernel<int><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on `stream`; returns the cudaError_t of the launch.
// grad is strided as x; stats the forward's; grad_loss one float; tiles
// [n_tiles][8]; smem the tiles' largest shared memory (`_backward_tiles`).
int resized_ce_backward_launch(const float* x, int channels_last,
                               const float* stats, const float* grad_loss,
                               float* grad, const int* tiles, int n_tiles,
                               const int* ystart, const float* yfrac,
                               const int* xlo, const int* xstart,
                               const float* xfrac, int n, int c, int h,
                               int w, int out_h, int out_w, float eps,
                               int smem, void* stream) {
  const int bands = (h + kBand - 1) / kBand;
  const int chunks = (c + kBwdChunk - 1) / kBwdChunk;
  const cudaError_t err = check(n, c, h, w, out_h, out_w, n_tiles, bands,
                                smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{make_low(x, channels_last, c, h, w),
                  reinterpret_cast<const float2*>(stats), grad_loss, grad,
                  reinterpret_cast<const Tile*>(tiles), ystart, yfrac, xlo,
                  xstart, xfrac, out_h, out_w, chunks, eps,
                  eps / static_cast<float>(c),
                  static_cast<float>(1.0 / (static_cast<double>(n) * out_h
                                            * out_w))};
  const dim3 grid(chunks * n_tiles, bands, n);
  resized_ce_backward_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
