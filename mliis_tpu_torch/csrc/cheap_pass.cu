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
// and walks those ops backward to the source pixel (`walk_back` in
// cheap_ops.cuh, shared with full_pass.cu): a flip or roll is an index
// remap; an eraser box or a stripe fill that covers the pixel ends the
// walk with its fill (the image fill, or the one-hot background on the
// mask planes). It keeps each stage's coordinates, then reads each plane
// once, applies noise and exposure forward on the image planes at their
// stages' coordinates (a clip after each; `walk_value`), and writes each
// plane once. Planar in, planar out, neighbouring threads on neighbouring
// pixels.
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
  __shared__ int ops[kNumStages];
  __shared__ int num_ops;
  const int b = blockIdx.y;
  const uint32_t key = static_cast<uint32_t>(a.seeds[b]);
  if (threadIdx.x == 0) {
    const int lo = max(a.window[2 * b], 0);
    const int hi = min(min(a.window[2 * b + 1], a.num[b]), kNumStages);
    num_ops = list_ops(a.perm + b * kNumStages, lo, hi, ops);
  }
  block_draw_params(a.k, key, draws, &prm);
  const CheapParams p = prm;
  const int m = num_ops;
  const int c_tot = a.k.c_tot, h = a.k.h, w = a.k.w, hw = h * w;
  const size_t sample = static_cast<size_t>(b) * c_tot * hw;

  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int pix = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (pix >= hw) return;
    const int y = pix / w;
    const Walk walk = walk_back(p, ops, m, h, w, y, pix - y * w);
    const int src = walk.y * w + walk.x;
    for (int c = 0; c < c_tot; ++c) {
      const size_t plane = sample + static_cast<size_t>(c) * hw;
      a.out[plane + pix] = walk_value(walk, p, draws, c, a.c_img,
                                      key, [&] { return a.x[plane + src]; });
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
