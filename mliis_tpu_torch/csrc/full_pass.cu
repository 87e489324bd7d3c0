// full_pass: the meta path's whole six-op augmentation composition in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel mliis_tpu/ops/pallas_augment.py `full_pass` /
// `_full_pass_kernel`. Per sample it applies a random prefix (`num`) of a
// per-sample permutation of six ops to the planar [C_img+2, n, n] image +
// one-hot-mask stack: 0 eraser, 1 translate (roll or stripe fill), 2
// fliplr, 3 gaussian noise, 4 exposure, 5 rotation (Paeth three-shear W,
// H, W, each shear of a length-n line a real DFT, a per-line phase
// exp(-2 pi i k_f s / n) and the inverse DFT; then the one-hot snap and,
// in constant mode, the fill outside the exact inverse-rotation
// coordinates). The plain PyTorch version is `full_pass_reference` in
// mliis_tpu_torch/ops/augment_kernels.py; the two share the Philox
// counter map of cheap_ops.cuh, so on the card they see the same numbers.
//
// What bounds it: the bytes, one read and one write of the batch
// (2 * B * C * n^2 * 4: 4.8 us at B=8, 5 x 224^2 at 3.35 TB/s); the least
// operations, an FFT count of the shears, come to less.
//
// Design.
// - One read and one write a pixel. Every cheap op only moves pixels or
//   fills them, so an output pixel is walked back to its source
//   (`walk_back`, `walk_value`, shared with cheap_pass.cu). A sample whose
//   prefix holds no rotation is that walk from device memory to device
//   memory. A rotated sample at stage r: the walk over the ops before r
//   reads x once into shared memory, the rotation runs there, and the walk
//   over the ops after r reads the rotated plane over distributed shared
//   memory and writes each output pixel once.
// - One mask plane. The masks are one-hot (bg = 1 - fg) and every op before
//   the rotation keeps them so; the shears are linear and map the constant
//   plane to itself, so R(bg) = 1 - R(fg) up to rounding. The kernel
//   rotates the C_img image planes and the fg plane, snaps fg' >= 1 - fg',
//   and writes bg as 1 - fg.
// - A rotated plane is split over a thread-block cluster of `cs` blocks,
//   one (sample, plane) a cluster; block q keeps rows [qR, qR + R) (R =
//   ceil(n / cs)) in shared memory. A row shear is local. For the column
//   shear block q gathers the columns it owns from every block's rows over
//   distributed shared memory, shears them, and writes them back in
//   place: the blocks own disjoint columns, so a cluster barrier before
//   and after the column pass is all the pass needs.
// - Each shear is two matrix products over the half spectrum (the lines
//   are real): X = V[lines x n] . F[n x 2(n/2+1)] against cos and -sin, the
//   phase per (line, bin), then out = [Xr Xi] . G with G holding the
//   Hermitian weights (1 at DC and at the Nyquist bin of even n, 2 inside)
//   and 1/n. The Nyquist bin's frequency is folded to -n/2 and its
//   imaginary part drops with sin(pi p) = 0, as the reference's real part
//   of the full inverse. About 2n^2 multiply-adds a line where a full
//   complex DFT pair takes 4n^2, and every table tile serves every line of
//   a group.
// - The products run on the tensor cores: mma.sync m16n8k8 TF32 with FP32
//   accumulate, in the 3xTF32 split (a = a_hi + a_lo; a_lo.b_hi +
//   a_hi.b_lo + a_hi.b_hi), which keeps FP32 accuracy: in a CPU emulation
//   of three shears at 224^2 (tests/test_torch_full_pass_design.py)
//   one-pass TF32 misses the 1e-2 bar on 0..255 and 3xTF32 stays within
//   5e-3 of the FP32 plain version; on an H100 the rotated image planes
//   stay within 4e-3 (224^2), 6e-3 (320^2) and 8e-3 (512^2) of the plain
//   version (chip_smoke.py), against the 1e-2 bar. The tables' hi and lo
//   parts are rounded to TF32 on the host from float64 and laid out in the
//   mma's B-fragment order (a float4 a lane a k-step: hi b0, hi b1, lo b0,
//   lo b1), so a warp reads 512 contiguous bytes a k-step from L2, three
//   k-steps ahead; the data's hi part is its top 19 bits (a mask: the
//   tensor core ignores the low 13 bits of an operand anyway). Lines are
//   padded to 16 and bins and samples to 8 with zeros, so any n works.
//   Shared-memory rows have a stride of 4 mod 8 floats, so the A fragments
//   load without bank conflicts.
// - 16 warps a block (at most 128 registers a thread): a block fills an
//   SM's shared memory, so its own warps must hide the latency of the
//   products and the pixel loops. Warp w takes n-tiles w, w + 16, ...; a
//   thread walks 4 pixels at once so their loads overlap.
// - Cluster table (the host's `full_pass_plan`): cs is the least power of
//   two with R <= 64; a group of up to 64 lines is sheared at once.
//     n      cs  R   group  shared memory a block
//     224    4   56  64     171,008 B
//     225    4   57  64     174,180 B
//     320    8   40  48     178,688 B
//     512    8   64  16     198,144 B
//   The grid is (cs, C_img + 1, B): 128 blocks at B=8, 5 x 224^2, one
//   block an SM. With 6 of 8 samples rotated, their 24 clusters take 96
//   blocks at 224^2, which run at once on 132 SMs, and 192 blocks at 320^2
//   and 512^2: two waves. Blocks of an unrotated sample take a share of
//   its pixels instead.
//
// Arithmetic that decides discrete outcomes (eraser box, shifts, the
// out-of-bounds test) uses __fmul_rn/__fadd_rn so nvcc cannot contract it
// into FMAs: it then rounds exactly as the PyTorch version's separate ops.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cheap_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // 16 warps, at most 128 registers each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;  // lines sheared at once: 4 m-tiles of 16
constexpr int kMaxCluster = 8;
constexpr int kAhead = 3;  // k-steps of table fragments loaded ahead
constexpr int kBatch = 4;  // pixels a thread walks at once
constexpr int kMaxSmem = 232448 - 1024;  // less the static shared memory

struct Args {
  const float* x;
  float* out;
  const int* seeds;
  const int* perm;
  const int* num;
  const int* rot;
  const float* trig;   // [B, 4]: alpha, beta, cos_t, sin_t
  const float4* fwd;   // forward table, B-fragment order
  const float4* inv;   // inverse table, B-fragment order
  CheapConsts k;       // h == w == n
  int c_img, rows, group;
};

__device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// The TF32 high part of v: its top 19 bits (the tensor core ignores the
// low 13 of an operand). v - hi is exact in FP32.
__device__ __forceinline__ uint32_t tf32_hi(float v) {
  return __float_as_uint(v) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C = A . B in 3xTF32 for m-tiles [0, mtiles) of A (shared memory, row
// stride lda), k-steps [0, ksteps) and n-tiles [0, ntiles) of B (device
// memory, fragment order). Warp w takes n-tiles w, w + 16, ...; each result
// goes to store(row, col, value). The three products of 3xTF32 (a_lo.b_hi,
// a_hi.b_lo, a_hi.b_hi) go over every accumulator in turn, so no product
// waits on the one before it.
template <typename Store>
__device__ __forceinline__ void mma_3xtf32(const float* A, int lda,
                                           int mtiles, int ksteps,
                                           int ntiles, const float4* B,
                                           Store store) {
  constexpr int kM = kMaxGroup / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int nt = threadIdx.x >> 5; nt < ntiles; nt += kWarps) {
    float acc[kM][4] = {};
    const float4* bp = B + static_cast<size_t>(nt) * ksteps * 32 + lane;
    // kAhead k-steps of fragments in flight, so L2's latency overlaps the
    // products.
    float4 ahead[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (u < ksteps) ahead[u] = __ldg(bp + u * 32);
    for (int k0 = 0; k0 < ksteps; k0 += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int ks = k0 + u;
        if (ks >= ksteps) break;
        const uint32_t bh[2] = {__float_as_uint(ahead[u].x),
                                __float_as_uint(ahead[u].y)};
        const uint32_t bl[2] = {__float_as_uint(ahead[u].z),
                                __float_as_uint(ahead[u].w)};
        if (ks + kAhead < ksteps) ahead[u] = __ldg(bp + (ks + kAhead) * 32);
        uint32_t hi[kM][4], lo[kM][4];
#pragma unroll
        for (int mt = 0; mt < kM; ++mt) {
          if (mt < mtiles) {
            const float* a = A + (mt * 16 + g) * lda + ks * 8 + t;
            const float v[4] = {a[0], a[8 * lda], a[4], a[8 * lda + 4]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              hi[mt][i] = tf32_hi(v[i]);
              lo[mt][i] = __float_as_uint(v[i] - __uint_as_float(hi[mt][i]));
            }
          }
        }
#pragma unroll
        for (int step = 0; step < 3; ++step)
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
            if (mt < mtiles)
              mma_tf32(acc[mt], step == 0 ? lo[mt] : hi[mt],
                       step == 1 ? bl : bh);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      if (mt < mtiles) {
        const int r = mt * 16 + g, c = nt * 8 + 2 * t;
        store(r, c, acc[mt][0]);
        store(r, c + 1, acc[mt][1]);
        store(r + 8, c, acc[mt][2]);
        store(r + 8, c + 1, acc[mt][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) full_pass_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ float draws[kMaxDraws];
  __shared__ CheapParams prm;
  __shared__ int pre[kNumStages], post[kNumStages];
  __shared__ int n_pre, n_post, rot_stage;
  __shared__ float* peers[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.k.w, hw = n * n, c_tot = a.k.c_tot, c_img = a.c_img;
  const int q = blockIdx.x, cs = gridDim.x, b = blockIdx.z;
  const uint32_t key = static_cast<uint32_t>(a.seeds[b]);
  if (threadIdx.x == 0) {
    const int* row = a.perm + b * kNumStages;
    const int num = min(a.num[b], kNumStages);
    int r = num;
    for (int s = 0; s < num; ++s)
      if (row[s] == kRotate) { r = s; break; }
    rot_stage = r < num ? r : -1;
    n_pre = list_ops(row, 0, r, pre);
    n_post = r < num ? list_ops(row, r + 1, num, post) : 0;
  }
  block_draw_params(a.k, key, draws, &prm);
  const CheapParams p = prm;
  const size_t sample = static_cast<size_t>(b) * c_tot * hw;

  if (rot_stage < 0) {  // no rotation: the cluster row shares the pixels
    const int blocks = cs * gridDim.y, t = blockIdx.y * cs + q, m = n_pre;
    for (int pix = t * kThreads + threadIdx.x; pix < hw;
         pix += blocks * kThreads) {
      const int y = pix / n;
      const Walk walk = walk_back(p, pre, m, n, n, y, pix - y * n);
      const float* src = a.x + sample + walk.y * n + walk.x;
      float v[kMaxImg + 2];  // every plane's load in flight at once
#pragma unroll
      for (int c = 0; c < kMaxImg + 2; ++c)
        if (c < c_tot) v[c] = src[static_cast<size_t>(c) * hw];
#pragma unroll
      for (int c = 0; c < kMaxImg + 2; ++c)
        if (c < c_tot)
          a.out[sample + static_cast<size_t>(c) * hw + pix] = walk_value(
              walk, p, draws, c, c_img, key, [&] { return v[c]; });
    }
    return;
  }

  // A rotated sample: this cluster holds one plane, image plane c or fg.
  const int c = blockIdx.y < c_img ? blockIdx.y : c_img + 1;
  const bool is_img = c < c_img;
  const int R = a.rows, row0 = q * R, nrows = max(0, min(R, n - row0));
  const int ld = round8(n) + 4, nhp = round8(n / 2 + 1), ld2 = 2 * nhp + 4;
  const int k1 = round8(n), k2 = 2 * nhp;
  float* slab = reinterpret_cast<float*>(smem4);  // [R][n]
  float* buf = slab + R * n;                      // [group][ld]
  float* spec = buf + a.group * ld;               // [group][ld2]
  if (threadIdx.x < cs)
    peers[threadIdx.x] = cluster.map_shared_rank(slab, threadIdx.x);
  // The rotated plane's pixel (y, x), wherever its row lives.
  const auto at = [&](int y, int x) -> float& {
    const int owner = y / R;
    return peers[owner][(y - owner * R) * n + x];
  };

  // The ops before the rotation: x read once, into this block's rows,
  // kBatch pixels a thread at a time so that their loads overlap.
  const float* xc = a.x + sample + static_cast<size_t>(c) * hw;
  for (int i0 = threadIdx.x; i0 < nrows * n; i0 += kBatch * kThreads) {
    Walk walk[kBatch];
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nrows * n) {
        walk[u] = walk_back(p, pre, n_pre, n, n, row0 + i / n, i % n);
        v[u] = xc[walk[u].y * n + walk[u].x];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nrows * n)
        slab[i] = walk_value(walk[u], p, draws, c, c_img, key,
                             [&] { return v[u]; });
    }
  }
  __syncthreads();

  // Three shears: rows (alpha), columns (beta), rows (alpha).
  const float* trig = a.trig + b * 4;
  const float ctr = (n - 1) / 2.0f;
  const float c0 = static_cast<float>(-2.0 * 3.14159265358979323846 / n);
  const int nh = n / 2 + 1;
  for (int pass = 0; pass < 3; ++pass) {
    const bool rows = pass != 1;
    const float coef = rows ? trig[0] : trig[1];
    if (!rows) cluster.sync();  // every block's rows sheared
    for (int g0 = 0; g0 < nrows; g0 += a.group) {
      const int L = min(a.group, nrows - g0), mtiles = (L + 15) / 16;
      const int lines = mtiles * 16;
      // Lines g0.. (this block's rows, or the columns it owns gathered
      // over the cluster) into buf, zero-padded to 16 lines and k1 samples.
      for (int i = threadIdx.x; i < lines * k1; i += kThreads) {
        const int l = rows ? i / k1 : i % lines;
        const int e = rows ? i % k1 : i / lines;
        float v = 0.0f;
        if (l < L && e < n)
          v = rows ? slab[(g0 + l) * n + e] : at(e, row0 + g0 + l);
        buf[l * ld + e] = v;
      }
      __syncthreads();
      mma_3xtf32(buf, ld, mtiles, k1 / 8, k2 / 8, a.fwd,
                 [&](int r, int col, float v) { spec[r * ld2 + col] = v; });
      __syncthreads();
      // The phase exp(-2 pi i k_f s / n), the Nyquist bin folded to -n/2.
      for (int i = threadIdx.x; i < L * nh; i += kThreads) {
        const int l = i / nh, k = i % nh;
        const float kf = static_cast<float>(k < (n + 1) / 2 ? k : k - n);
        const float s = __fmul_rn(coef, static_cast<float>(row0 + g0 + l)
                                            - ctr);
        float ps, pc;
        sincosf(__fmul_rn(__fmul_rn(c0, kf), s), &ps, &pc);
        float* X = spec + l * ld2;
        const float xr = X[k], xi = X[nhp + k];
        X[k] = xr * pc - xi * ps;
        X[nhp + k] = xr * ps + xi * pc;
      }
      __syncthreads();
      mma_3xtf32(spec, ld2, mtiles, k2 / 8, k1 / 8, a.inv,
                 [&](int r, int col, float v) {
                   if (r < L && col < n) {
                     if (rows) slab[(g0 + r) * n + col] = v;
                     else at(col, row0 + g0 + r) = v;
                   }
                 });
      __syncthreads();
    }
    if (!rows) cluster.sync();  // every owned column written back
  }

  // The one-hot snap fg' >= 1 - fg', and in constant mode the fill
  // outside the exact inverse-rotation coordinates.
  const int* rp = a.rot + b * 4;
  const bool constant = rp[1] == 1, noise_fill = rp[2] == 1;
  const float cval = static_cast<float>(rp[3]);
  const float cos_r = trig[2], sin_r = trig[3], lim = n - 0.5f;
  for (int i = threadIdx.x; i < nrows * n; i += kThreads) {
    const int y = row0 + i / n, x = i % n;
    float v = slab[i];
    if (!is_img) v = v >= 1.0f - v ? 1.0f : 0.0f;
    if (constant) {
      const float ys = static_cast<float>(y) - ctr;
      const float xs = static_cast<float>(x) - ctr;
      const float sy = __fadd_rn(
          __fsub_rn(__fmul_rn(cos_r, ys), __fmul_rn(sin_r, xs)), ctr);
      const float sx = __fadd_rn(
          __fadd_rn(__fmul_rn(sin_r, ys), __fmul_rn(cos_r, xs)), ctr);
      if (sy < -0.5f || sy > lim || sx < -0.5f || sx > lim) {
        v = 0.0f;  // fg background
        if (is_img)
          v = noise_fill
                  ? floorf(__fmul_rn(
                        uniform(philox(static_cast<uint32_t>(y * n + x),
                                       kRotNoiseStream + c, key)
                                    .w0),
                        256.0f))
                  : cval;
      }
    }
    slab[i] = v;
  }
  cluster.sync();

  // The ops after the rotation: the rotated plane read over the cluster,
  // kBatch pixels a thread at a time, each output pixel written once (and
  // bg = 1 - fg).
  float* out_c = a.out + sample + static_cast<size_t>(c) * hw;
  float* out_bg = a.out + sample + static_cast<size_t>(c_img) * hw;
  for (int i0 = threadIdx.x; i0 < nrows * n; i0 += kBatch * kThreads) {
    Walk walk[kBatch];
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nrows * n) {
        walk[u] = walk_back(p, post, n_post, n, n, row0 + i / n, i % n);
        v[u] = at(walk[u].y, walk[u].x);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nrows * n) {
        const float o = walk_value(walk[u], p, draws, c, c_img, key,
                                   [&] { return v[u]; });
        out_c[row0 * n + i] = o;
        if (!is_img) out_bg[row0 * n + i] = 1.0f - o;
      }
    }
  }
  cluster.sync();  // no block leaves while its rows may still be read
}

}  // namespace

extern "C" {

// Launches on `stream` a grid of (cs, c_img + 1, batch) blocks in clusters
// of cs; `group` and `smem` come from the host's plan (full_pass_plan).
// Returns the cudaError_t of the launch (0 = success).
int full_pass_launch(const float* x, float* out, const int* seeds,
                     const int* perm, const int* num, const int* rot,
                     const float* trig, const float* fwd, const float* inv,
                     int batch, int c_tot, int n, int c_img, int max_shift,
                     int cs, int group, int smem, float noise_mean_sd,
                     float exposure_mean_sd, float er_s_l, float er_s_range,
                     float er_r_1, float er_r_range, void* stream) {
  if (c_img > kMaxImg || c_tot != c_img + 2 || cs < 1 || cs > kMaxCluster ||
      group < 16 || group > kMaxGroup || group % 16 != 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, out, seeds, perm, num, rot, trig,
               reinterpret_cast<const float4*>(fwd),
               reinterpret_cast<const float4*>(inv),
               CheapConsts{c_tot, n, n, max_shift, noise_mean_sd,
                           exposure_mean_sd, er_s_l, er_s_range, er_r_1,
                           er_r_range},
               c_img, (n + cs - 1) / cs, group};
  cudaError_t err = cudaFuncSetAttribute(
      full_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, c_img + 1, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, full_pass_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
