// cheap_pass: the meta path's five cheap augmentation ops at the stages of a
// window, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel mliis_tpu/ops/pallas_augment.py `cheap_pass` /
// `_cheap_pass_kernel`. Per sample it applies, to the planar [C_img+2, H, W]
// image + one-hot-mask stack (any H x W), the ops of a per-sample
// permutation of six at the stages s with lo <= s < hi and s < num; the
// rotation stage (op 5) is skipped: on the split route the rotation runs in
// plain PyTorch between two such passes (`rotate_shear_planar`). The ops:
//   0 eraser (a box filled with U[0,255) on the image, background on the
//     mask), 1 translate (roll, or roll + stripe fill: +-1..max_shift,
//     vertical or horizontal, a per-plane image fill, background on the
//     mask), 2 fliplr, 3 gaussian noise (sd |noise_mean_sd + N|, clipped to
//     0..255), 4 exposure (a shift |exposure_mean_sd + N| * N, clipped).
// The plain PyTorch version is `cheap_pass_reference` in
// mliis_tpu_torch/ops/augment_kernels.py. The scalar draws, the cheap ops
// and the counter map are those of full_pass.cu (cheap_ops.cuh), so the
// two kernels and their plain versions see the same random numbers.
//
// Design: no op couples pixels except by moving them, so no plane needs to
// be resident and any H x W works. The grid is (pixel tiles, B). The
// block's lanes draw the sample's scalar uniforms into shared memory (one
// lane a Philox word), then thread 0 turns them into the parameters and
// lists the ops the window applies. Each thread takes output pixels (y, x)
// and walks those ops backward to the source pixel: a flip or roll is an
// index remap; an eraser box or a stripe fill that covers the pixel ends
// the walk with its fill (the image fill, or the one-hot background on the
// mask planes). It keeps each stage's coordinates, then reads each plane
// once, applies noise and exposure forward on the image planes at their
// stages' coordinates (a clip after each), and writes each plane once.
// Planar in, planar out, neighbouring threads on neighbouring pixels.
//
// What bounds it: the bytes, 2 * C * H * W * 4 a sample (16.1 MB at B=8,
// 5 x 224^2: 4.8 us at 3.35 TB/s); a noise value costs about 117
// operations (Philox 100, two uniforms, Box-Muller, scale, add, clip) where
// noise runs, which comes to less.
//
// Arithmetic that decides a discrete outcome uses __fmul_rn/__fadd_rn (no
// --use_fast_math), as in the other kernels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cheap_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kTile = kThreads * kPixelsPerThread;
constexpr int kMaxImg = 8;  // image planes (_MAX_IMG_PLANES in the wrapper)
constexpr int kMaxDraws = 9 + (kMaxImg + 2) + 6;

struct Args {
  const float* x;    // [B, C_tot, H, W]
  float* out;        // [B, C_tot, H, W]
  const int* seeds;  // [B]
  const int* perm;   // [B, 6]
  const int* num;    // [B]
  const int* window; // [B, 2]: lo, hi
  CheapConsts k;
  int c_img;
};

__global__ void __launch_bounds__(kThreads) cheap_pass_kernel(Args a) {
  __shared__ float draws[kMaxDraws];
  __shared__ CheapParams prm;
  __shared__ float img_fill[kMaxImg];
  __shared__ int ops[kNumStages];
  __shared__ int num_ops;
  const int b = blockIdx.y;
  const uint32_t key = static_cast<uint32_t>(a.seeds[b]);
  const int c_tot = a.k.c_tot, c_img = a.c_img;
  if (threadIdx.x < 9 + c_tot + 6)
    draws[threadIdx.x] = scalar_uniform(key, threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    const auto u = [&](int i) { return draws[i]; };
    draw_cheap_params(a.k, u, &prm);
    for (int c = 0; c < c_img; ++c) img_fill[c] = image_fill(u, c);
    const int lo = a.window[2 * b], hi = a.window[2 * b + 1];
    const int num = a.num[b];
    int m = 0;
    for (int s = 0; s < kNumStages; ++s) {
      const int op = a.perm[b * kNumStages + s];
      if (s >= lo && s < hi && s < num && op != kRotate) ops[m++] = op;
    }
    num_ops = m;
  }
  __syncthreads();
  const CheapParams p = prm;
  const int m = num_ops;
  const int h = a.k.h, w = a.k.w, hw = h * w;
  const size_t sample = static_cast<size_t>(b) * c_tot * hw;

  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int pix = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (pix >= hw) return;
    // Backward: ys[s], xs[s] are the coordinates in the frame entering
    // applied op s; a fill at op s makes the forward pass start after it.
    int ys[kNumStages + 1], xs[kNumStages + 1];
    ys[m] = pix / w;
    xs[m] = pix - ys[m] * w;
    int start = 0;
    int filled = -1;  // the op whose fill covers the pixel, if any
    for (int s = m - 1; s >= 0; --s) {
      int y = ys[s + 1], x = xs[s + 1];
      const int op = ops[s];
      if (op == kEraser) {
        if (in_eraser(p, y, x)) {
          filled = kEraser;
          start = s + 1;
          break;
        }
      } else if (op == kTranslate) {
        const int n = p.vert ? h : w;
        const int t = p.vert ? y : x;
        if (!p.do_roll && in_stripe(t, p.shift, n)) {
          filled = kTranslate;
          start = s + 1;
          break;
        }
        const int from = roll_source(t, p.shift, n);
        if (p.vert) y = from; else x = from;
      } else if (op == kFliplr) {
        x = w - 1 - x;
      }
      ys[s] = y;
      xs[s] = x;
    }
    const size_t in_at = sample + (filled < 0 ? ys[0] * w + xs[0] : 0);
    for (int c = 0; c < c_tot; ++c) {
      const bool is_img = c < c_img;
      float v;
      if (filled == kEraser)
        v = is_img ? p.er_c : (c == c_img ? 1.0f : 0.0f);
      else if (filled == kTranslate)
        v = is_img ? img_fill[c] : (c == c_img ? 1.0f : 0.0f);
      else
        v = a.x[in_at + static_cast<size_t>(c) * hw];
      if (is_img) {  // forward: the value ops at their stages' coordinates
        for (int s = start; s < m; ++s) {
          if (ops[s] == kNoise)
            v = add_noise(v, p.noise_sd, key,
                          static_cast<uint32_t>(ys[s] * w + xs[s]), c);
          else if (ops[s] == kExposure)
            v = add_exposure(v, p.exp_shift);
        }
      }
      a.out[sample + static_cast<size_t>(c) * hw + pix] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int cheap_pass_launch(const float* x, float* out, const int* seeds,
                      const int* perm, const int* num, const int* window,
                      int batch, int c_tot, int h, int w, int c_img,
                      int max_shift, float noise_mean_sd,
                      float exposure_mean_sd, float er_s_l, float er_s_range,
                      float er_r_1, float er_r_range, void* stream) {
  if (c_img > kMaxImg || c_tot != c_img + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, out, seeds, perm, num, window,
               CheapConsts{c_tot, h, w, max_shift, noise_mean_sd,
                           exposure_mean_sd, er_s_l, er_s_range, er_r_1,
                           er_r_range},
               c_img};
  const dim3 grid((h * w + kTile - 1) / kTile, batch);
  cheap_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
