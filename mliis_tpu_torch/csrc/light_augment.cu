// fused_light_augment: the joint path's four-op augmentation in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mliis_tpu/ops/pallas_augment.py
// `fused_light_augment` / `_augment_kernel`. Per sample, with probability
// `prob_original` the sample passes through (gate u <= prob_original);
// otherwise a prefix of 1..4 ops, in a random order, from
//   0 translate (roll, or roll + stripe fill: +-1..max_shift, vertical or
//     horizontal, a per-channel image fill, label fill 0),
//   1 fliplr,
//   2 gaussian noise (sd |noise_mean_sd + N|, clipped to 0..255),
//   3 exposure (a shift |exposure_mean_sd + N| * N, clipped to 0..255),
// is applied to an NHWC [H, W, 3] image and its [H, W] class-id label; the
// label comes back rounded to integers. The plain PyTorch version is
// `fused_light_augment_reference` in mliis_tpu_torch/ops/augment_kernels.py;
// both draw from the Philox stream of philox.cuh, so on the card they see
// the same random numbers.
//
// Counter map (Philox counter words (c0, c1), key the per-sample seed):
//   (i, 0) for the scalar draws: 0 gate, 1..4 the four rank words (exact
//   uint32; the op at stage s is the one with rank s, rank = number of
//   larger words plus equal words at a lower index), 5 the prefix length
//   1..4, 6 vertical, 7 direction, 8 shift 1..max_shift, 9 roll, 10..12
//   the image fill of channel c (u * 255), 13, 14 the noise sd's normal,
//   15, 16 the exposure sd's normal, 17, 18 the exposure shift's normal;
//   (y * W + x, 1 + c) for the noise of channel c at pixel (y, x) of the
//   frame the noise stage sees, drawn only where that stage runs.
//
// Design: no cross-pixel arithmetic, so no sample needs to be resident (a
// sample, 4 x 224^2 f32 = 802,816 B, would not fit a block's 232,448 B
// anyway). The grid is (pixel tiles, B). The block draws its sample's
// scalars into shared memory (one lane per Philox word). Each thread takes
// output pixels (y, x), walks the applied ops backward to the source pixel
// (stopping at a stripe fill that covers it), keeping each stage's
// coordinates, then applies the value ops forward at those coordinates.
// Each output pixel reads its image and label once and writes them once,
// NHWC to NHWC, with no transposes and nothing staged in device memory.
//
// What bounds it: the bytes, (3 + 1) x H x W x 4 in and out per sample
// (1,605,632 B at 224^2, 102.8 MB at B = 64: 30.7 us at 3.35 TB/s); the
// Philox and Box-Muller work of the noise planes (about 110 operations a
// pixel and channel where noise runs) comes to less.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kTile = kThreads * kPixelsPerThread;
constexpr int kNumOps = 4;
constexpr int kTranslate = 0, kFliplr = 1, kNoise = 2, kExposure = 3;
constexpr uint32_t kNoiseStream = 1;

// Scalar draws (stream 0), by counter.
constexpr int kGate = 0, kRank = 1, kNum = 5, kVert = 6, kDirection = 7,
              kShift = 8, kRoll = 9, kFill = 10, kNoiseSd = 13, kExpSd = 15,
              kExpShift = 17, kDraws = 19;

struct Params {
  int gate;            // 1: the sample passes through
  int num;             // ops applied, 1..4
  int ops[kNumOps];    // the op at each stage
  int vert, shift, do_roll;
  float fill[3];       // translate stripe fill, per image channel
  float noise_sd, exp_shift;
};

struct Args {
  const float* images;  // [B, H, W, 3]
  const float* masks;   // [B, H, W]
  float* out_images;
  float* out_masks;
  const int* seeds;     // [B]
  int h, w, max_shift;
  float prob_original, noise_mean_sd, exposure_mean_sd;
};

// Thread 0 turns the sample's Philox words into its parameters.
__device__ void draw_params(const Args& a, const uint32_t* words,
                            Params* p) {
  const auto u = [&](int i) { return uniform(words[i]); };
  p->gate = u(kGate) <= a.prob_original;
  for (int i = 0; i < kNumOps; ++i) {
    int rank = 0;
    for (int j = 0; j < kNumOps; ++j) {
      const uint32_t wi = words[kRank + i], wj = words[kRank + j];
      rank += (wj > wi) || (wj == wi && j < i);
    }
    p->ops[rank] = i;
  }
  p->num = randint(u(kNum), 1, kNumOps + 1);
  p->vert = u(kVert) < 0.5f;
  const bool direction = u(kDirection) < 0.5f;
  const int shift = randint(u(kShift), 1, a.max_shift + 1);
  p->shift = direction ? shift : -shift;
  p->do_roll = u(kRoll) < 0.5f;
  for (int c = 0; c < 3; ++c) p->fill[c] = __fmul_rn(u(kFill + c), 255.0f);
  p->noise_sd = fabsf(__fadd_rn(a.noise_mean_sd,
                                box_muller(u(kNoiseSd), u(kNoiseSd + 1))));
  const float exp_sd = fabsf(__fadd_rn(
      a.exposure_mean_sd, box_muller(u(kExpSd), u(kExpSd + 1))));
  p->exp_shift = __fmul_rn(exp_sd, box_muller(u(kExpShift), u(kExpShift + 1)));
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads) light_augment_kernel(Args a) {
  __shared__ uint32_t words[kDraws];
  __shared__ Params prm;
  const int b = blockIdx.y;
  const uint32_t key = static_cast<uint32_t>(a.seeds[b]);
  if (threadIdx.x < kDraws)
    words[threadIdx.x] = philox(threadIdx.x, 0u, key).w0;
  __syncthreads();
  if (threadIdx.x == 0) draw_params(a, words, &prm);
  __syncthreads();
  const Params p = prm;
  const int h = a.h, w = a.w, hw = h * w;
  const size_t sample = static_cast<size_t>(b) * hw;

  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int pix = blockIdx.x * kTile + k * kThreads + threadIdx.x;
    if (pix >= hw) return;
    const size_t out_at = sample + pix;
    if (p.gate) {
      for (int c = 0; c < 3; ++c)
        a.out_images[3 * out_at + c] = a.images[3 * out_at + c];
      a.out_masks[out_at] = rintf(a.masks[out_at]);
      continue;
    }
    // Backward: ys[s], xs[s] are the coordinates in the frame entering
    // stage s; a stripe fill at stage s makes the walk start after it.
    int ys[kNumOps + 1], xs[kNumOps + 1];
    ys[p.num] = pix / w;
    xs[p.num] = pix - ys[p.num] * w;
    int start = 0;
    bool filled = false;
    for (int s = p.num - 1; s >= 0; --s) {
      int y = ys[s + 1], x = xs[s + 1];
      if (p.ops[s] == kTranslate) {
        const int n = p.vert ? h : w;
        const int t = p.vert ? y : x;
        const bool stripe = p.shift >= 0 ? t < p.shift : t >= n + p.shift;
        if (!p.do_roll && stripe) {
          start = s + 1;
          filled = true;
          break;
        }
        int from = (t - p.shift) % n;
        if (from < 0) from += n;
        if (p.vert) y = from; else x = from;
      } else if (p.ops[s] == kFliplr) {
        x = w - 1 - x;
      }
      ys[s] = y;
      xs[s] = x;
    }
    float v[3], label;
    if (filled) {
      for (int c = 0; c < 3; ++c) v[c] = p.fill[c];
      label = 0.0f;
    } else {
      const size_t in_at = sample + static_cast<size_t>(ys[0]) * w + xs[0];
      for (int c = 0; c < 3; ++c) v[c] = a.images[3 * in_at + c];
      label = a.masks[in_at];
    }
    // Forward: the value ops at their stages' coordinates.
    for (int s = start; s < p.num; ++s) {
      if (p.ops[s] == kNoise) {
        const uint32_t counter = static_cast<uint32_t>(ys[s] * w + xs[s]);
        for (int c = 0; c < 3; ++c) {
          const Words wd = philox(counter, kNoiseStream + c, key);
          const float noise = __fmul_rn(
              p.noise_sd, box_muller(uniform(wd.w0), uniform(wd.w1)));
          v[c] = clip255(__fadd_rn(v[c], noise));
        }
      } else if (p.ops[s] == kExposure) {
        for (int c = 0; c < 3; ++c) v[c] = clip255(__fadd_rn(v[c], p.exp_shift));
      }
    }
    for (int c = 0; c < 3; ++c) a.out_images[3 * out_at + c] = v[c];
    a.out_masks[out_at] = rintf(label);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int light_augment_launch(const float* images, const float* masks,
                         float* out_images, float* out_masks,
                         const int* seeds, int batch, int h, int w,
                         int max_shift, float prob_original,
                         float noise_mean_sd, float exposure_mean_sd,
                         void* stream) {
  Args a{images, masks, out_images, out_masks, seeds, h, w, max_shift,
         prob_original, noise_mean_sd, exposure_mean_sd};
  const dim3 grid((h * w + kTile - 1) / kTile, batch);
  light_augment_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
