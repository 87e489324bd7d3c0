// The scalar draws and the cheap ops shared by the port's meta-path
// augmentation kernels (full_pass.cu, cheap_pass.cu), so that both hold one
// counter map. They follow the TPU kernels' _draw_cheap_params and
// _make_cheap_branches (mliis_tpu/ops/pallas_augment.py:262-336); the
// plain PyTorch versions are `_draw_cheap_params` and `_compose_reference`
// in mliis_tpu_torch/ops/augment_kernels.py.
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

// The scalar draws in the TPU kernel's _draw_cheap_params order; u(i) is
// the uniform at counter (i, 0). The eraser's area is s * H * W, its top
// in [0, H), its left in [0, W).
template <typename Uniform>
__device__ void draw_cheap_params(const CheapConsts& a, Uniform u,
                                  CheapParams* p) {
  const float er_s = __fmul_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(u(0), a.er_s_range), a.er_s_l),
                static_cast<float>(a.h)),
      static_cast<float>(a.w));
  const float er_r = __fadd_rn(__fmul_rn(u(1), a.er_r_range), a.er_r_1);
  p->er_w = static_cast<int>(floorf(__fsqrt_rn(__fdiv_rn(er_s, er_r))));
  p->er_h = static_cast<int>(floorf(__fsqrt_rn(__fmul_rn(er_s, er_r))));
  p->er_top = randint(u(2), 0, a.h);
  p->er_left = randint(u(3), 0, a.w);
  p->er_c = __fmul_rn(u(4), 255.0f);
  p->vert = u(5) < 0.5f;
  const bool direction = u(6) < 0.5f;
  const int shift = randint(u(7), 1, a.max_shift + 1);
  p->shift = direction ? shift : -shift;
  p->do_roll = u(8) < 0.5f;
  const int g = 9 + a.c_tot;
  p->noise_sd =
      fabsf(__fadd_rn(a.noise_mean_sd, box_muller(u(g), u(g + 1))));
  const float exp_sd =
      fabsf(__fadd_rn(a.exposure_mean_sd, box_muller(u(g + 2), u(g + 3))));
  p->exp_shift = __fmul_rn(exp_sd, box_muller(u(g + 4), u(g + 5)));
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

}  // namespace
