// batch_norm_act: the model's batch norm (models/layers.FusedBatchNorm, by
// the batch's moments) with the swish beside it, for Hopper (sm_90a): two
// launches forward and two backward.
//
// Per channel, over the count = N H W values of the norm's input u (u = x,
// or u = swish(x) where the swish comes before the norm):
//   m = sum u / count, v = sum u^2 / count - m^2 (biased, E[u^2] - E[u]^2),
//   rstd = rsqrt(v + eps), inv = rstd scale, a = bias - m inv,
//   z = u inv + a, y = swish(z) (swish after) or z;
// the running stats, when updated, become momentum old + (1 - momentum)
// batch for m and v (flax's momentum). The backward is the exact gradient
// of that formula: with gz = g swish'(z) (swish after) or g,
//   S1 = sum gz, S2 = sum gz (u - m), d_bias = S1, d_scale = S2 rstd,
//   d_v = -S2 inv rstd^2 / 2, du = gz inv - inv S1 / count
//   + 2 d_v (u - m) / count, and dx = du swish'(x) (swish before) or du
// (the centred form of gz inv + d_m / count + 2 u d_v / count with d_m =
// -inv S1 - 2 m d_v). swish(t) = t / (1 + exp(-t)) and swish'(t) = s (1 +
// t (1 - s)), s = 1 / (1 + exp(-t)), as PyTorch's silu computes them.
//
// It replaces no TPU kernel: the JAX package leaves the norm and the swish
// to XLA, which fuses them. It was added because the port's eager
// composition (mean, square-mean, a broadcast multiply-add and silu, and
// autograd's transpose of each) made about 25 passes over every norm's
// input a training step, a third of the device time of b3's joint step.
// The plain PyTorch version is `batch_norm_act_forward_reference` and
// `batch_norm_act_backward_reference` in mliis_tpu_torch/ops/
// batch_norm_act.py.
//
// What bounds it: the bytes. A step reads the input three times forward
// (once for the moments, once to write y) and writes y; backward reads the
// input and the gradient twice (once for the sums, once for dx) and writes
// dx: 8 passes of 4 bytes a value, at a handful of float32 operations and
// at most two exponentials a value, far below the card's rates.
//
// Design. Each layout is taken as it is: channels-last ([N H W, C] rows,
// channels contiguous) and NCHW (N planes of C x H W). All four passes walk
// the map with the same grid and per-thread assignment, in 16-byte vector
// loads along the contiguous axis where it holds whole vectors (4 channels
// of a row, or 4 positions of a plane) and 4-byte loads otherwise:
//   channels-last: blockIdx.y a tile of up to 32 channel vectors, blockIdx.x
//   a split of rows; a thread keeps its vector's channels for the whole
//   walk and strides over rows by the block's row groups;
//   NCHW: blockIdx.y a channel, blockIdx.x a split of the planes; the
//   block's threads walk its planes' positions flat.
// The two reducing passes (the moments; S1 and S2) keep float32 sums in
// registers, reduce the block in a fixed order into double, and write the
// block's partials to the call's scratch. The last block of a channel tile
// to finish (a ticket: an unsigned counter a tile, left at 0 by the last
// block, so that the wrapper zeroes it once a stream) combines the splits'
// partials in a fixed order in double and finishes the channel: m, v, rstd,
// inv, a and the running stats, or d_scale, d_bias and dx's two
// coefficients. No float atomics: the result repeats bit for bit. The two
// mapping passes (y; dx) read those [C] vectors once a thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent loads a thread keeps in flight
constexpr int kMaxVec = 4;

enum Act { kNone = 0, kAfter = 1, kBefore = 2 };
enum Pass { kStats = 0, kApply = 1, kReduce = 2, kGrad = 3 };
// The rows of `stats` [kStatRows][C] and `coef` [2][C].
enum Stat { kMean = 0, kVar = 1, kRstd = 2, kInv = 3, kAdd = 4, kStatRows };

struct Args {
  const float* x;     // the input (before the swish, where it comes first)
  const float* g;     // the output's gradient (kReduce, kGrad)
  float* out;         // y (kApply) or dx (kGrad), in x's layout
  const float* scale;  // [C]
  const float* bias;   // [C]
  float* run_mean;    // [C], or null: no update
  float* run_var;     // [C]
  float* stats;       // [kStatRows][C]: written by kStats
  float* coef;        // [2][C]: dx's k0, k1, written by kReduce
  float* d_scale;     // [C], written by kReduce
  float* d_bias;      // [C]
  double* partials;   // [splits][2][C]
  unsigned* tickets;  // [tiles] (channels-last) or [C] (NCHW)
  long long rows;     // channels-last: N H W rows of C
  int planes, hw;     // NCHW: N planes of C x hw
  int c;
  int tile_vecs;      // channels-last: channel vectors of a tile
  int groups;         // channels-last: row groups of a block
  long long split_len;  // rows (channels-last) or planes (NCHW) of a split
  int splits;
  float momentum, one_minus, eps;
  double count;       // values a channel
};

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
    *p = r.v[0];
  }
}

__device__ __forceinline__ float swish(float t) {
  return t / (1.0f + expf(-t));
}

__device__ __forceinline__ float swish_grad(float t) {
  const float s = 1.0f / (1.0f + expf(-t));
  return s * (1.0f + t * (1.0f - s));
}

// A channel's constants, as a pass needs them.
struct Chan {
  float m, inv, add, k0, k1;
};

template <int P>
__device__ __forceinline__ Chan load_chan(const Args& a, int c) {
  Chan k{0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (P != kStats) {
    k.m = a.stats[kMean * a.c + c];
    k.inv = a.stats[kInv * a.c + c];
    k.add = a.stats[kAdd * a.c + c];
  }
  if constexpr (P == kGrad) {
    k.k0 = a.coef[c];
    k.k1 = a.coef[a.c + c];
  }
  return k;
}

// One value of a pass: adds to the sums (kStats, kReduce) or returns the
// output (kApply, kGrad).
template <int P, int A>
__device__ __forceinline__ float visit(float x, float g, const Chan& k,
                                       float& s, float& q) {
  const float u = A == kBefore ? swish(x) : x;
  if constexpr (P == kStats) {
    s += u;
    q += u * u;
    return 0.f;
  }
  const float z = u * k.inv + k.add;
  if constexpr (P == kApply) return A == kAfter ? swish(z) : z;
  const float gz = A == kAfter ? g * swish_grad(z) : g;
  if constexpr (P == kReduce) {
    s += gz;
    q += gz * (u - k.m);
    return 0.f;
  }
  const float du = gz * k.inv + k.k0 + k.k1 * (u - k.m);
  return A == kBefore ? du * swish_grad(x) : du;
}

// The channel's finish from its two sums over the whole batch.
template <int P>
__device__ void finish(const Args& a, int c, double s, double q) {
  const int C = a.c;
  if constexpr (P == kStats) {
    const double md = s / a.count;
    const float m = static_cast<float>(md);
    const float v = static_cast<float>(q / a.count - md * md);
    const float rstd = rsqrtf(v + a.eps);
    const float inv = rstd * a.scale[c];
    a.stats[kMean * C + c] = m;
    a.stats[kVar * C + c] = v;
    a.stats[kRstd * C + c] = rstd;
    a.stats[kInv * C + c] = inv;
    a.stats[kAdd * C + c] = a.bias[c] - m * inv;
    if (a.run_mean != nullptr) {  // as the composition rounds it
      a.run_mean[c] = __fadd_rn(__fmul_rn(a.run_mean[c], a.momentum),
                                __fmul_rn(a.one_minus, m));
      a.run_var[c] = __fadd_rn(__fmul_rn(a.run_var[c], a.momentum),
                               __fmul_rn(a.one_minus, v));
    }
  } else {  // kReduce: s = S1, q = S2
    const double rstd = a.stats[kRstd * C + c];
    const double inv = a.stats[kInv * C + c];
    const double d_v = -0.5 * q * inv * rstd * rstd;
    a.d_bias[c] = static_cast<float>(s);
    a.d_scale[c] = static_cast<float>(q * rstd);
    a.coef[c] = static_cast<float>(-inv * s / a.count);
    a.coef[C + c] = static_cast<float>(2.0 * d_v / a.count);
  }
}

// Whether this block is the last of its ticket's `blocks` to finish; its
// partials are written before. The last block finds every other block's
// partials written, and leaves the ticket at 0 for the next launch.
__device__ __forceinline__ bool last_block(unsigned* ticket,
                                           unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == blocks - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Channels-last: grid (splits, tiles).
template <int P, int A, int V>
__global__ void __launch_bounds__(kThreads)
bn_cl_kernel(const Args a) {
  __shared__ double red[2][kThreads * kMaxVec];
  const int lane = threadIdx.x % a.tile_vecs;
  const int group = threadIdx.x / a.tile_vecs;
  const int c0 = (blockIdx.y * a.tile_vecs + lane) * V;
  const bool active = group < a.groups && c0 < a.c;
  float s[V], q[V];
  Chan k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = 0.f;
    q[j] = 0.f;
    k[j] = load_chan<P>(a, active ? c0 + j : 0);
  }
  if (active) {
    const long long r0 = blockIdx.x * a.split_len;
    const long long r1 = min(a.rows, r0 + a.split_len);
    const long long step = a.groups;
    long long r = r0 + group;
    for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
      Vec<V> xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + u * step) * a.c + c0;
        xv[u] = load<V>(a.x + off);
        if constexpr (P >= kReduce) gv[u] = load<V>(a.g + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Vec<V> ov;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gj = P >= kReduce ? gv[u].v[j] : 0.f;
          ov.v[j] = visit<P, A>(xv[u].v[j], gj, k[j], s[j], q[j]);
        }
        if constexpr (P == kApply || P == kGrad)
          store<V>(a.out + (r + u * step) * a.c + c0, ov);
      }
    }
    for (; r < r1; r += step) {
      const long long off = r * a.c + c0;
      const Vec<V> xv = load<V>(a.x + off);
      Vec<V> gv, ov;
      if constexpr (P >= kReduce) gv = load<V>(a.g + off);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gj = P >= kReduce ? gv.v[j] : 0.f;
        ov.v[j] = visit<P, A>(xv.v[j], gj, k[j], s[j], q[j]);
      }
      if constexpr (P == kApply || P == kGrad) store<V>(a.out + off, ov);
    }
  }
  if constexpr (P == kStats || P == kReduce) {
    // The block's sums, group by group in order, into its partials.
    const int slot = (group * a.tile_vecs + lane) * V;
    if (active) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][slot + j] = s[j];
        red[1][slot + j] = q[j];
      }
    }
    __syncthreads();
    double* part = a.partials + 2LL * a.c * blockIdx.x;
    if (group == 0 && c0 < a.c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        double ss = 0.0, qq = 0.0;
        for (int gi = 0; gi < a.groups; ++gi) {
          ss += red[0][(gi * a.tile_vecs + lane) * V + j];
          qq += red[1][(gi * a.tile_vecs + lane) * V + j];
        }
        part[c0 + j] = ss;
        part[a.c + c0 + j] = qq;
      }
    }
    if (!last_block(a.tickets + blockIdx.y, gridDim.x)) return;
    // The tile's finish: splits gi = group, group + groups, ... a thread,
    // then the groups in order.
    double ss[V], qq[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ss[j] = 0.0;
      qq[j] = 0.0;
    }
    if (active) {
      for (int gi = group; gi < a.splits; gi += a.groups) {
        const double* p = a.partials + 2LL * a.c * gi;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ss[j] += __ldcg(p + c0 + j);
          qq[j] += __ldcg(p + a.c + c0 + j);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][slot + j] = ss[j];
        red[1][slot + j] = qq[j];
      }
    }
    __syncthreads();
    if (group == 0 && c0 < a.c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        double st = 0.0, qt = 0.0;
        for (int gi = 0; gi < a.groups; ++gi) {
          st += red[0][(gi * a.tile_vecs + lane) * V + j];
          qt += red[1][(gi * a.tile_vecs + lane) * V + j];
        }
        finish<P>(a, c0 + j, st, qt);
      }
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// NCHW: grid (splits, C).
template <int P, int A, int V>
__global__ void __launch_bounds__(kThreads)
bn_nchw_kernel(const Args a) {
  __shared__ double red[2][kThreads / 32];
  const int c = blockIdx.y;
  const Chan k = load_chan<P>(a, c);
  const long long n0 = blockIdx.x * a.split_len;
  const int n_planes = static_cast<int>(min(static_cast<long long>(a.planes),
                                            n0 + a.split_len) - n0);
  const unsigned hwv = a.hw / V;
  const unsigned total = n_planes * hwv;
  const long long plane_step = static_cast<long long>(a.c) * a.hw;
  const float* xb = a.x + (n0 * a.c + c) * a.hw;
  const float* gb = P >= kReduce ? a.g + (n0 * a.c + c) * a.hw : nullptr;
  float* ob = (P == kApply || P == kGrad) ? a.out + (n0 * a.c + c) * a.hw
                                          : nullptr;
  float s = 0.f, q = 0.f;
  auto offset = [&](unsigned e) {
    return (e / hwv) * plane_step + static_cast<long long>(e % hwv) * V;
  };
  unsigned e = threadIdx.x;
  for (; e + (kUnroll - 1) * kThreads < total; e += kUnroll * kThreads) {
    Vec<V> xv[kUnroll], gv[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      off[u] = offset(e + u * kThreads);
      xv[u] = load<V>(xb + off[u]);
      if constexpr (P >= kReduce) gv[u] = load<V>(gb + off[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Vec<V> ov;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gj = P >= kReduce ? gv[u].v[j] : 0.f;
        ov.v[j] = visit<P, A>(xv[u].v[j], gj, k, s, q);
      }
      if constexpr (P == kApply || P == kGrad) store<V>(ob + off[u], ov);
    }
  }
  for (; e < total; e += kThreads) {
    const long long off = offset(e);
    const Vec<V> xv = load<V>(xb + off);
    Vec<V> gv, ov;
    if constexpr (P >= kReduce) gv = load<V>(gb + off);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gj = P >= kReduce ? gv.v[j] : 0.f;
      ov.v[j] = visit<P, A>(xv.v[j], gj, k, s, q);
    }
    if constexpr (P == kApply || P == kGrad) store<V>(ob + off, ov);
  }
  if constexpr (P == kStats || P == kReduce) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double ws = warp_sum(s), wq = warp_sum(q);
    if (lane == 0) {
      red[0][warp] = ws;
      red[1][warp] = wq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double ss = 0.0, qq = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) {
        ss += red[0][w];
        qq += red[1][w];
      }
      double* part = a.partials + 2LL * a.c * blockIdx.x;
      part[c] = ss;
      part[a.c + c] = qq;
    }
    if (!last_block(a.tickets + c, gridDim.x)) return;
    if (warp == 0) {
      double ss = 0.0, qq = 0.0;
      for (int gi = lane; gi < a.splits; gi += 32) {
        const double* p = a.partials + 2LL * a.c * gi;
        ss += __ldcg(p + c);
        qq += __ldcg(p + a.c + c);
      }
      ss = warp_sum(ss);
      qq = warp_sum(qq);
      if (lane == 0) finish<P>(a, c, ss, qq);
    }
  }
}

template <int P, int A, int V>
void launch_kernel(const Args& a, bool channels_last, dim3 grid,
                   cudaStream_t s) {
  if (channels_last)
    bn_cl_kernel<P, A, V><<<grid, kThreads, 0, s>>>(a);
  else
    bn_nchw_kernel<P, A, V><<<grid, kThreads, 0, s>>>(a);
}

template <int P, int A>
void launch_vec(const Args& a, bool channels_last, int vec, dim3 grid,
                cudaStream_t s) {
  if (vec == 4)
    launch_kernel<P, A, 4>(a, channels_last, grid, s);
  else
    launch_kernel<P, A, 1>(a, channels_last, grid, s);
}

template <int P>
void launch_act(const Args& a, bool channels_last, int act, int vec,
                dim3 grid, cudaStream_t s) {
  if (act == kAfter)
    launch_vec<P, kAfter>(a, channels_last, vec, grid, s);
  else if (act == kBefore)
    launch_vec<P, kBefore>(a, channels_last, vec, grid, s);
  else
    launch_vec<P, kNone>(a, channels_last, vec, grid, s);
}

}  // namespace

extern "C" {

// Launches pass `pass` (0 moments, 1 y, 2 the gradient's sums, 3 dx) on
// `stream`; returns the cudaError_t of the launch (0 = success). act: 0
// none, 1 swish after the norm, 2 swish before it. Channels-last: grid
// (splits, tiles) over rows of c, tiles of tile_vecs vectors of vec
// channels, groups row groups a block; NCHW: grid (splits, c) over planes x
// hw. The pointers a pass does not use may be null; tickets hold at least
// tiles (channels-last) or c (NCHW) zeros.
int batch_norm_act_launch(int pass, int act, int channels_last, int vec,
                          const float* x, const float* g, float* out,
                          const float* scale, const float* bias,
                          float* run_mean, float* run_var, float* stats,
                          float* coef, float* d_scale, float* d_bias,
                          double* partials, unsigned* tickets,
                          long long rows, int planes, int hw, int c,
                          int tile_vecs, int groups, long long split_len,
                          int splits, int tiles, float momentum,
                          float one_minus, float eps, void* stream) {
  const bool cl = channels_last != 0;
  const long long per_channel = cl ? rows : static_cast<long long>(planes)
                                                * hw;
  if (pass < kStats || pass > kGrad || act < kNone || act > kBefore
      || (vec != 1 && vec != 4) || c < 1 || per_channel < 1 || splits < 1
      || split_len < 1 || splits > 65535
      || (cl && (tile_vecs < 1 || groups < 1 || tile_vecs * groups > kThreads
                 || tiles < 1 || tiles > 65535 || c % vec != 0
                 || static_cast<long long>(tiles) * tile_vecs * vec < c))
      || (!cl && (c > 65535 || hw % vec != 0
                  || static_cast<long long>(planes) * hw > 0xffffffffLL)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, g, out, scale, bias, run_mean, run_var, stats, coef, d_scale,
         d_bias, partials, tickets, rows, planes, hw, c, tile_vecs, groups,
         split_len, splits, momentum, one_minus, eps,
         static_cast<double>(per_channel)};
  const dim3 grid(splits, cl ? tiles : c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pass) {
    case kStats: launch_act<kStats>(a, cl, act, vec, grid, s); break;
    case kApply: launch_act<kApply>(a, cl, act, vec, grid, s); break;
    case kReduce: launch_act<kReduce>(a, cl, act, vec, grid, s); break;
    default: launch_act<kGrad>(a, cl, act, vec, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
