// The scalar draws and the cheap ops shared by the port's meta-path
// augmentation kernels (full_pass.cu, cheap_pass.cu), so that both hold one
// counter map. They follow the TPU kernels' _draw_cheap_params and
// _make_cheap_branches (mliis_tpu/ops/pallas_augment.py:262-336); the
// plain PyTorch versions are `_draw_cheap_params` and `_compose_reference`
// in mliis_tpu_torch/ops/augment_kernels.py. full_pass takes an output
// pixel back through the applied cheap ops with `walk_back` and computes
// its value with `walk_value`; cheap_pass splits the same walk into a row
// part and a column part (its note) over the same ops and fills.
//
// Ops, by their code in the permutation: 0 eraser, 1 translate, 2 fliplr,
// 3 gaussian noise, 4 exposure, 5 rotation (full_pass only).
//
// Counter map (Philox counter words (c0, c1), key the per-sample seed):
//   (i, 0) for the scalar draws: 0, 1 the eraser's area and aspect, 2 its
//   top, 3 its left, 4 its fill, 5 vertical, 6 direction, 7 shift, 8 roll,
//   9 + c the translate fill of plane c (c < C_tot; the image planes' are
//   used), then from g = 9 + C_tot the normals of the noise sd (g, g+1),
//   the exposure sd (g+2, g+3) and the exposure shift (g+4, g+5);
//   (y * W + x, 1 + c) for the noise of image plane c at pixel (y, x) of
//   the frame the noise stage sees;
//   (y * W + x, 64 + c) for the rotation's border noise (full_pass).
#pragma once

#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kEraser = 0, kTranslate = 1, kFliplr = 2, kNoise = 3,
              kExposure = 4, kRotate = 5;
constexpr int kNumStages = 6;
constexpr uint32_t kNoiseStream = 1, kRotNoiseStream = 64;

// The op constants, as the wrappers pass them.
struct CheapConsts {
  int c_tot, h, w, max_shift;
  float noise_mean_sd, exposure_mean_sd;
  float er_s_l, er_s_range, er_r_1, er_r_range;
};

// One sample's scalar parameters (the translate fills apart).
struct CheapParams {
  int er_w, er_h, er_top, er_left;
  float er_c;
  int vert, shift, do_roll;
  float noise_sd, exp_shift;
};

// The draws that place a sample's lines: the eraser's box (its area is
// s * H * W, its top in [0, H), its left in [0, W)) and the translate
// (vertical, shift, roll); u(i) is the uniform at counter (i, 0).
template <typename Uniform>
__device__ __forceinline__ void draw_placement(const CheapConsts& a,
                                               Uniform u, CheapParams* p) {
  const float er_s = __fmul_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(u(0), a.er_s_range), a.er_s_l),
                static_cast<float>(a.h)),
      static_cast<float>(a.w));
  const float er_r = __fadd_rn(__fmul_rn(u(1), a.er_r_range), a.er_r_1);
  p->er_w = static_cast<int>(floorf(__fsqrt_rn(__fdiv_rn(er_s, er_r))));
  p->er_h = static_cast<int>(floorf(__fsqrt_rn(__fmul_rn(er_s, er_r))));
  p->er_top = randint(u(2), 0, a.h);
  p->er_left = randint(u(3), 0, a.w);
  p->vert = u(5) < 0.5f;
  const bool direction = u(6) < 0.5f;
  const int shift = randint(u(7), 1, a.max_shift + 1);
  p->shift = direction ? shift : -shift;
  p->do_roll = u(8) < 0.5f;
}

// The value draws from their three normals: the eraser's fill, the noise
// sd |noise_mean_sd + n0| and the exposure shift |exposure_mean_sd + n1| *
// n2.
template <typename Uniform>
__device__ __forceinline__ void values_from_normals(const CheapConsts& a,
                                                    Uniform u, float n0,
                                                    float n1, float n2,
                                                    CheapParams* p) {
  p->er_c = __fmul_rn(u(4), 255.0f);
  p->noise_sd = fabsf(__fadd_rn(a.noise_mean_sd, n0));
  p->exp_shift = __fmul_rn(fabsf(__fadd_rn(a.exposure_mean_sd, n1)), n2);
}

// Normal i < 3 of the value draws: Box-Muller on the uniforms at
// 9 + C_tot + 2i and the next.
template <typename Uniform>
__device__ __forceinline__ float value_normal(const CheapConsts& a,
                                              Uniform u, int i) {
  const int g = 9 + a.c_tot + 2 * i;
  return box_muller(u(g), u(g + 1));
}

// The scalar draws in the TPU kernel's _draw_cheap_params order.
template <typename Uniform>
__device__ void draw_cheap_params(const CheapConsts& a, Uniform u,
                                  CheapParams* p) {
  draw_placement(a, u, p);
  values_from_normals(a, u, value_normal(a, u, 0), value_normal(a, u, 1),
                      value_normal(a, u, 2), p);
}

// The translate stripe fill of image plane c.
template <typename Uniform>
__device__ __forceinline__ float image_fill(Uniform u, int c) {
  return __fmul_rn(u(9 + c), 255.0f);
}

__device__ __forceinline__ bool in_eraser(const CheapParams& p, int r,
                                          int c) {
  return r >= p.er_top && r < p.er_top + p.er_h && c >= p.er_left &&
         c < p.er_left + p.er_w;
}

// The wrapped-in stripe of a roll by `shift` along a line of n.
__device__ __forceinline__ bool in_stripe(int t, int shift, int n) {
  return shift >= 0 ? t < shift : t >= n + shift;
}

// The source of position t of a line of n rolled by `shift`.
__device__ __forceinline__ int roll_source(int t, int shift, int n) {
  const int from = (t - shift) % n;
  return from < 0 ? from + n : from;
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// Gaussian noise of image plane c at `pixel`, added and clipped.
__device__ __forceinline__ float add_noise(float v, float sd, uint32_t key,
                                           uint32_t pixel, int c) {
  const Words w = philox(pixel, kNoiseStream + c, key);
  return clip255(
      __fadd_rn(v, __fmul_rn(sd, box_muller(uniform(w.w0), uniform(w.w1)))));
}

__device__ __forceinline__ float add_exposure(float v, float shift) {
  return clip255(__fadd_rn(v, shift));
}

constexpr int kMaxImg = 8;  // image planes (_MAX_IMG_PLANES in the wrapper)
constexpr int kMaxDraws = 9 + (kMaxImg + 2) + 6;

// Block-wide, every thread calls it: the sample's scalar uniforms into
// `draws` (one thread a Philox word), then thread 0 turns them into the
// parameters. Ends with a __syncthreads().
__device__ void block_draw_params(const CheapConsts& k, uint32_t key,
                                  float* draws, CheapParams* prm) {
  for (int i = threadIdx.x; i < 9 + k.c_tot + 6; i += blockDim.x)
    draws[i] = scalar_uniform(key, i);
  __syncthreads();
  if (threadIdx.x == 0)
    draw_cheap_params(k, [draws](int i) { return draws[i]; }, prm);
  __syncthreads();
}

// The applied cheap ops of perm row `perm` at stages [lo, hi), rotation
// excluded, into ops; returns their count.
__device__ __forceinline__ int list_ops(const int* perm, int lo, int hi,
                                        int* ops) {
  int m = 0;
  for (int s = lo; s < hi; ++s)
    if (perm[s] != kRotate) ops[m++] = perm[s];
  return m;
}

// One output pixel's walk through the cheap ops ops[0, m) of an h x w
// frame, backward from the pixel: a flip or roll remaps, an eraser box or a
// stripe fill that covers the pixel ends the walk (the ops before it then
// do not reach the pixel). Each op appears at most once in a permutation,
// so the walk keeps only the source (y, x), the coordinates entering the
// noise op and the order of noise and exposure.
struct Walk {
  int y, x;        // the source pixel (where the fill hit, if filled)
  int filled;      // the op whose fill covers the pixel, or -1
  int noise_pix;   // y * w + x entering the noise op, or -1: no noise
  bool exposure;   // exposure applies
  bool exp_last;   // ... after the noise
};

__device__ __forceinline__ Walk walk_back(const CheapParams& p,
                                          const int* ops, int m, int h,
                                          int w, int y, int x) {
  Walk k{y, x, -1, -1, false, false};
  for (int s = m - 1; s >= 0; --s) {
    const int op = ops[s];
    if (op == kEraser) {
      if (in_eraser(p, k.y, k.x)) {
        k.filled = kEraser;
        break;
      }
    } else if (op == kTranslate) {
      const int n = p.vert ? h : w;
      const int t = p.vert ? k.y : k.x;
      if (!p.do_roll && in_stripe(t, p.shift, n)) {
        k.filled = kTranslate;
        break;
      }
      const int from = roll_source(t, p.shift, n);
      if (p.vert) k.y = from; else k.x = from;
    } else if (op == kFliplr) {
      k.x = w - 1 - k.x;
    } else if (op == kNoise) {
      k.noise_pix = k.y * w + k.x;
      k.exp_last = k.exposure;
    } else if (op == kExposure) {
      k.exposure = true;
    }
  }
  return k;
}

// Plane c's value at the end of the walk: the fill that covers the pixel
// (the image fill, or the one-hot background on the mask planes c_img
// (bg, 1) and c_img + 1 (fg, 0)), else source(), the value at the source
// pixel; then, forward on the image planes, noise and exposure in their
// stages' order (a clip after each).
template <typename Source>
__device__ __forceinline__ float walk_value(const Walk& k,
                                            const CheapParams& p,
                                            const float* draws, int c,
                                            int c_img, uint32_t key,
                                            Source source) {
  const bool is_img = c < c_img;
  const float bgv = c == c_img ? 1.0f : 0.0f;
  float v;
  if (k.filled == kEraser)
    v = is_img ? p.er_c : bgv;
  else if (k.filled == kTranslate)
    v = is_img ? image_fill([draws](int i) { return draws[i]; }, c) : bgv;
  else
    v = source();
  if (is_img) {
    if (k.exposure && !k.exp_last) v = add_exposure(v, p.exp_shift);
    if (k.noise_pix >= 0)
      v = add_noise(v, p.noise_sd, key, static_cast<uint32_t>(k.noise_pix),
                    c);
    if (k.exposure && k.exp_last) v = add_exposure(v, p.exp_shift);
  }
  return v;
}

}  // namespace
