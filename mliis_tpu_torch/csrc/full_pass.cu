// full_pass: the meta path's whole six-op augmentation composition in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel mliis_tpu/ops/pallas_augment.py `full_pass` /
// `_full_pass_kernel`. Per sample it applies a random prefix (`num`) of a
// per-sample permutation of six ops to the planar [C_img+2, H, W] image +
// one-hot-mask stack:
//   0 eraser, 1 translate (roll or stripe fill), 2 fliplr, 3 gaussian noise,
//   4 exposure, 5 rotation (Paeth three-shear W, H, W; each shear a length-n
//   real DFT against cos/sin tables, a per-row or per-column phase, and the
//   inverse DFT), then the one-hot snap fg >= bg and, in constant mode, the
//   fill outside the exact inverse-rotation coordinates.
// The plain PyTorch version is `full_pass_reference` in
// mliis_tpu_torch/ops/augment_kernels.py; the two share the Philox stream
// below, so on the card they see the same random numbers.
//
// Design (a): one block per (sample, plane), the plane resident in shared
// memory. A whole sample (5 x 224^2 f32 = 1,003,520 B) cannot fit in a
// block's 232,448 B, but one plane (200,704 B) can, and every op except the
// snap acts on each plane alone: rolls, flips and stripe fills are index
// remaps, and a shear transforms each row or column of a plane on its own.
// The snap couples the two mask planes: they form one thread-block cluster
// of two, and after the shears the fg-plane block reads the bg plane through
// distributed shared memory and writes both. (Design (b), a per-sample
// global scratch in L2, would have one block per sample and so 8 busy SMs
// of 132 on the main path, against 5 x 8 = 40 here.) The sample is read once
// and written once; nothing is staged in device memory between ops, the
// noise planes included: they are drawn in-kernel from Philox counters.
//
// What bounds it: a rotated sample costs 3 shears x 4 products x 2*C*H*W^2
// operations (1.35 GFLOP at C=5, 224^2), done here in FP32 on CUDA cores
// (no TF32, no tensor cores: a simple kernel that is right first); an
// unrotated sample costs only its 2*C*H*W*4 bytes of traffic.
//
// Arithmetic that decides discrete outcomes (eraser box, shifts, the
// out-of-bounds test) uses __fmul_rn/__fadd_rn so nvcc cannot contract it
// into FMAs: it then rounds exactly as the PyTorch version's separate ops.
// The Philox stream, the uniform and Box-Muller live in philox.cuh, shared
// with light_augment.cu.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // 16 warps: the most the plane leaves room for
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;  // ceil(n / 32) for n <= 256

// Philox counter word 1 ("stream"): 0 for the scalar draws, 1 + c for the
// gaussian noise plane of channel c, 64 + c for the rotation border noise.
constexpr uint32_t kNoiseStream = 1, kRotNoiseStream = 64;

struct Params {
  int er_w, er_h, er_top, er_left;
  float er_c;
  int vert, shift, do_roll;
  float fill;  // this plane's translate stripe fill (image planes)
  float noise_sd, exp_shift;
};

struct Args {
  const float* x;
  float* out;
  const int* seeds;
  const int* perm;
  const int* num;
  const int* rot;
  const float* trig;     // [B, 4]: alpha, beta, cos_t, sin_t
  const float* cos_tab;  // [n]: cos(2 pi m / n)
  const float* sin_tab;  // [n]: sin(2 pi m / n)
  int c_tot, n, c_img, max_shift;
  float noise_mean_sd, exposure_mean_sd;
  float er_s_l, er_s_range, er_r_1, er_r_range;
};

// The scalar draws, in the TPU kernel's _draw_cheap_params order, each at a
// fixed counter.
__device__ void draw_params(const Args& a, uint32_t key, int plane,
                            Params* p) {
  const int n = a.n;
  const float er_s = __fmul_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(scalar_uniform(key, 0), a.er_s_range),
                          a.er_s_l),
                static_cast<float>(n)),
      static_cast<float>(n));
  const float er_r = __fadd_rn(__fmul_rn(scalar_uniform(key, 1),
                                         a.er_r_range), a.er_r_1);
  p->er_w = static_cast<int>(floorf(__fsqrt_rn(__fdiv_rn(er_s, er_r))));
  p->er_h = static_cast<int>(floorf(__fsqrt_rn(__fmul_rn(er_s, er_r))));
  p->er_top = randint(scalar_uniform(key, 2), 0, n);
  p->er_left = randint(scalar_uniform(key, 3), 0, n);
  p->er_c = __fmul_rn(scalar_uniform(key, 4), 255.0f);
  p->vert = scalar_uniform(key, 5) < 0.5f;
  const bool direction = scalar_uniform(key, 6) < 0.5f;
  const int shift = randint(scalar_uniform(key, 7), 1, a.max_shift + 1);
  p->shift = direction ? shift : -shift;
  p->do_roll = scalar_uniform(key, 8) < 0.5f;
  p->fill = __fmul_rn(scalar_uniform(key, 9 + plane), 255.0f);
  const int g = 9 + a.c_tot;
  p->noise_sd = fabsf(__fadd_rn(a.noise_mean_sd,
                                box_muller(scalar_uniform(key, g),
                                           scalar_uniform(key, g + 1))));
  const float exp_sd = fabsf(__fadd_rn(
      a.exposure_mean_sd,
      box_muller(scalar_uniform(key, g + 2), scalar_uniform(key, g + 3))));
  p->exp_shift = __fmul_rn(exp_sd, box_muller(scalar_uniform(key, g + 4),
                                              scalar_uniform(key, g + 5)));
}

// One spectral shear of a length-n line (a row: stride 1, or a column:
// stride n) held in shared memory, done by one warp: out(p) = in(p - s)
// circularly, as real DFT -> phase exp(-2 pi i k s / n) -> inverse DFT.
// scratch holds 2n floats.
__device__ void shear_line(float* line, int stride, int n, float s,
                           float c0, const float* cos_t, const float* sin_t,
                           float* scratch) {
  const int lane = threadIdx.x & 31;
  float* yr = scratch;
  float* yi = scratch + n;
  float ar[kMaxPerLane], ai[kMaxPerLane];
  int idx[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    ar[j] = 0.0f;
    ai[j] = 0.0f;
    idx[j] = 0;
  }
  // Forward DFT: X[k] = sum_w v[w] (cos - i sin)(2 pi w k / n), the table
  // index w*k mod n kept incrementally.
  for (int w = 0; w < n; ++w) {
    const float v = line[w * stride];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int k = lane + 32 * j;
      if (k < n) {
        ar[j] += v * cos_t[idx[j]];
        ai[j] -= v * sin_t[idx[j]];
        idx[j] += k;
        if (idx[j] >= n) idx[j] -= n;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int k = lane + 32 * j;
    if (k < n) {
      const float kf = static_cast<float>(k < (n + 1) / 2 ? k : k - n);
      float ps, pc;
      sincosf(__fmul_rn(__fmul_rn(c0, kf), s), &ps, &pc);
      yr[k] = ar[j] * pc - ai[j] * ps;
      yi[k] = ar[j] * ps + ai[j] * pc;
    }
  }
  __syncwarp();
  // Inverse DFT, real part: out[p] = sum_k (yr cos - yi sin)(2 pi k p / n) / n.
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    ar[j] = 0.0f;
    idx[j] = 0;
  }
  for (int k = 0; k < n; ++k) {
    const float r = yr[k], i = yi[k];
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int p = lane + 32 * j;
      if (p < n) {
        ar[j] += r * cos_t[idx[j]] - i * sin_t[idx[j]];
        idx[j] += p;
        if (idx[j] >= n) idx[j] -= n;
      }
    }
  }
  const float nf = static_cast<float>(n);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int p = lane + 32 * j;
    if (p < n) line[p * stride] = ar[j] / nf;
  }
  __syncwarp();
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
full_pass_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ Params prm;
  const int n = a.n, hw = n * n;
  const int b = blockIdx.y;
  // Block x -> plane: the cluster pair (0, 1) holds the bg and fg mask
  // planes, then the image planes; a padding block (odd C_tot) exits.
  const int x_idx = blockIdx.x;
  const int plane = x_idx < 2 ? a.c_img + x_idx : x_idx - 2;
  if (x_idx >= 2 && plane >= a.c_img) return;
  const bool is_img = plane < a.c_img;
  const bool is_mask_pair = x_idx < 2;
  const float bgv = plane == a.c_img ? 1.0f : 0.0f;  // background one-hot

  float* P = smem;
  float* cos_t = smem + hw;
  float* sin_t = cos_t + n;
  const int warp = threadIdx.x >> 5;
  float* scratch = sin_t + n + warp * 2 * n;

  const float* src = a.x + (static_cast<size_t>(b) * a.c_tot + plane) * hw;
  for (int i = threadIdx.x; i < hw; i += kThreads) P[i] = src[i];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cos_t[i] = a.cos_tab[i];
    sin_t[i] = a.sin_tab[i];
  }
  const uint32_t key = static_cast<uint32_t>(a.seeds[b]);
  if (threadIdx.x == 0) draw_params(a, key, plane, &prm);
  __syncthreads();
  const Params p = prm;
  const int num = a.num[b];

  for (int stage = 0; stage < 6 && stage < num; ++stage) {
    const int op = a.perm[b * 6 + stage];
    if (op == 0) {  // eraser
      const float fill = is_img ? p.er_c : bgv;
      for (int i = threadIdx.x; i < hw; i += kThreads) {
        const int r = i / n, c = i - r * n;
        if (r >= p.er_top && r < p.er_top + p.er_h && c >= p.er_left &&
            c < p.er_left + p.er_w)
          P[i] = fill;
      }
    } else if (op == 1) {  // translate: roll, or roll + stripe fill
      const float fill = is_img ? p.fill : bgv;
      const int shift = ((p.shift % n) + n) % n;
      for (int line = warp; line < n; line += kWarps) {
        const int stride = p.vert ? n : 1;
        float* base = p.vert ? P + line : P + line * n;
        for (int t = threadIdx.x & 31; t < n; t += 32)
          scratch[t] = base[t * stride];
        __syncwarp();
        for (int t = threadIdx.x & 31; t < n; t += 32) {
          int from = t - shift;
          if (from < 0) from += n;
          const bool stripe = p.shift >= 0 ? t < p.shift : t >= n + p.shift;
          base[t * stride] = (!p.do_roll && stripe) ? fill : scratch[from];
        }
        __syncwarp();
      }
    } else if (op == 2) {  // fliplr
      const int half = n / 2;
      for (int i = threadIdx.x; i < n * half; i += kThreads) {
        const int r = i / half, c = i - r * half;
        const float t = P[r * n + c];
        P[r * n + c] = P[r * n + n - 1 - c];
        P[r * n + n - 1 - c] = t;
      }
    } else if (op == 3) {  // gaussian noise on the image planes
      if (is_img) {
        const uint32_t stream = kNoiseStream + plane;
        for (int i = threadIdx.x; i < hw; i += kThreads) {
          const Words w = philox(static_cast<uint32_t>(i), stream, key);
          const float noise = __fmul_rn(
              p.noise_sd, box_muller(uniform(w.w0), uniform(w.w1)));
          P[i] = fminf(fmaxf(__fadd_rn(P[i], noise), 0.0f), 255.0f);
        }
      }
    } else if (op == 4) {  // exposure on the image planes
      if (is_img) {
        for (int i = threadIdx.x; i < hw; i += kThreads)
          P[i] = fminf(fmaxf(__fadd_rn(P[i], p.exp_shift), 0.0f), 255.0f);
      }
    } else if (op == 5) {  // rotation
      const float alpha = a.trig[b * 4 + 0], beta = a.trig[b * 4 + 1];
      const float cos_r = a.trig[b * 4 + 2], sin_r = a.trig[b * 4 + 3];
      const float ctr = (n - 1) / 2.0f;
      const float c0 = static_cast<float>(-2.0 * 3.14159265358979323846 / n);
      for (int pass = 0; pass < 3; ++pass) {
        const bool rows = pass != 1;  // W, H, W
        for (int line = warp; line < n; line += kWarps) {
          const float s = __fmul_rn(rows ? alpha : beta,
                                    static_cast<float>(line) - ctr);
          shear_line(rows ? P + line * n : P + line, rows ? 1 : n, n, s, c0,
                     cos_t, sin_t, scratch);
        }
        __syncthreads();
      }
      if (is_mask_pair) {
        // One-hot snap: the fg block reads the bg plane of its cluster
        // partner and writes both planes, so no pixel is read after it is
        // overwritten.
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        if (plane == a.c_img + 1) {
          float* bg = cluster.map_shared_rank(P, 0);
          for (int i = threadIdx.x; i < hw; i += kThreads) {
            const float fg = P[i] >= bg[i] ? 1.0f : 0.0f;
            P[i] = fg;
            bg[i] = 1.0f - fg;
          }
        }
        cluster.sync();
      }
      const int* rp = a.rot + b * 4;
      if (rp[1] == 1) {  // constant mode: fill outside the rotated frame
        const bool noise_fill = rp[2] == 1;
        const float cval = static_cast<float>(rp[3]);
        const float lim = n - 0.5f;
        for (int i = threadIdx.x; i < hw; i += kThreads) {
          const int r = i / n, c = i - r * n;
          const float ys = static_cast<float>(r) - ctr;
          const float xs = static_cast<float>(c) - ctr;
          const float sy = __fadd_rn(
              __fsub_rn(__fmul_rn(cos_r, ys), __fmul_rn(sin_r, xs)), ctr);
          const float sx = __fadd_rn(
              __fadd_rn(__fmul_rn(sin_r, ys), __fmul_rn(cos_r, xs)), ctr);
          if (sy < -0.5f || sy > lim || sx < -0.5f || sx > lim) {
            float v = bgv;
            if (is_img) {
              v = noise_fill
                      ? floorf(__fmul_rn(
                            uniform(philox(static_cast<uint32_t>(i),
                                           kRotNoiseStream + plane, key)
                                        .w0),
                            256.0f))
                      : cval;
            }
            P[i] = v;
          }
        }
      }
    }
    __syncthreads();
  }

  float* dst = a.out + (static_cast<size_t>(b) * a.c_tot + plane) * hw;
  for (int i = threadIdx.x; i < hw; i += kThreads) dst[i] = P[i];
}

// Shared memory one block needs: the plane, two tables, 2n floats a warp
// (mirrored by `smem_bytes` in ops/augment_kernels.py).
int smem_bytes(int n) {
  return static_cast<int>(sizeof(float)) * (n * n + 2 * n + kWarps * 2 * n);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int full_pass_launch(const float* x, float* out, const int* seeds,
                     const int* perm, const int* num, const int* rot,
                     const float* trig, const float* cos_tab,
                     const float* sin_tab, int batch, int c_tot, int n,
                     int c_img, int max_shift, float noise_mean_sd,
                     float exposure_mean_sd, float er_s_l, float er_s_range,
                     float er_r_1, float er_r_range, void* stream) {
  const int smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      full_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, out, seeds, perm, num, rot, trig, cos_tab, sin_tab, c_tot, n,
         c_img, max_shift, noise_mean_sd, exposure_mean_sd, er_s_l,
         er_s_range, er_r_1, er_r_range};
  const dim3 grid(c_tot + (c_tot & 1), batch);
  full_pass_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
