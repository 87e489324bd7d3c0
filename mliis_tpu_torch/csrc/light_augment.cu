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
// What bounds it: the bytes, (3 + 1) x H x W x 4 in and out per sample
// (1,605,632 B at 224^2, 102.8 MB at B = 64: 30.7 us at 3.35 TB/s); the
// Philox and Box-Muller work of the noise planes (about 117 operations a
// pixel and channel where noise runs) comes to less.
//
// Design: as cheap_pass.cu's, whose note has the row / column split, on
// row_ring.cuh's pipeline with a unit an output row (image and labels).
// The only fill is the translate's stripe, so a pixel is filled when its
// row or its column is in the stripe; noise and exposure apply at the
// stages after the translate (all of them when no stripe covers the
// pixel), in their order, at counter noise_y * W + noise_x. The gate is
// the empty op list: a copy, the label rounded. The producer stages a
// row's source image row (3W floats, contiguous in NHWC) and label row (W
// floats), one bulk copy each; a consumer warp's lane l computes the
// pixels l, l + 32, ... (two pixels' six Philox chains at once), their
// three channels and label into the warp's output line (a lane's floats
// three words apart: no bank conflicts), and the warp writes the line's
// 3W + W floats with 16-byte stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "row_ring.cuh"

namespace {

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
  const float* __restrict__ images;  // [B, H, W, 3]
  const float* __restrict__ masks;   // [B, H, W]
  float* __restrict__ out_images;
  float* __restrict__ out_masks;
  const int* __restrict__ seeds;     // [B]
  int batch, h, w, max_shift;
  float prob_original, noise_mean_sd, exposure_mean_sd;
  int stages;
};

// The draws that place the ops and the translate: the gate, the op order,
// the prefix length, vertical, shift and roll.
__device__ void draw_layout_params(const Args& a, const uint32_t* words,
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
}

// Normal i < 3 of the value draws: Box-Muller on the words at kNoiseSd +
// 2i and the next (the noise sd's, the exposure sd's, the exposure
// shift's).
__device__ __forceinline__ float value_normal(const uint32_t* words, int i) {
  const int g = kNoiseSd + 2 * i;
  return box_muller(uniform(words[g]), uniform(words[g + 1]));
}

// The value draws from their normals: the stripe fill, the noise sd
// |noise_mean_sd + n0| and the exposure shift |exposure_mean_sd + n1| * n2.
__device__ void draw_value_params(const Args& a, const uint32_t* words,
                                  const float* normal, Params* p) {
  for (int c = 0; c < 3; ++c)
    p->fill[c] = __fmul_rn(uniform(words[kFill + c]), 255.0f);
  p->noise_sd = fabsf(__fadd_rn(a.noise_mean_sd, normal[0]));
  const float exp_sd = fabsf(__fadd_rn(a.exposure_mean_sd, normal[1]));
  p->exp_shift = __fmul_rn(exp_sd, normal[2]);
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// What a sample's ops do to a value taken from the source (index 0) or the
// stripe's fill (1): bits of `rules` and of a unit's flags.
constexpr int kNoised = 1, kExpLast = 2, kRowSt = 4, kNoiseOn = 4,
              kExpOn = 6;  // noise_on, exp_on: bit kNoiseOn + k, kExpOn + k

// What places a sample's lines, compact so that a walk runs from a copy in
// registers: the applied ops (none through the gate; the op at stage i in
// bits 2i, 2i+1) and the translate.
struct LightWalk {
  int m, ops, vert, shift, roll;
};

// A sample's column walk in closed form (a flip and a roll at most):
// column x's source, its column at the noise stage, and its column at the
// translate's stage, where the stripe tests it (when the translate is
// horizontal).
struct LightCols {
  Affine src, noise, st;
  int has_st;
};

// One sample: its walk, its column walk, its rules and its value draws.
struct Sample {
  LightWalk wk;
  LightCols cols;
  int rules;
  float fill[3], noise_sd, exp_shift;
};

// Two blocks an SM (__launch_bounds__): up to 128 registers a thread, for
// the six Philox chains of two pixels in flight.
constexpr int kLightBlocksPerSm = 2;

struct State {
  Sample smp[kGroup];
  uint32_t words[kGroup][kDraws];  // the samples' Philox words
  float normal[kGroup][3];         // their value draws' normals
  int seed[kGroup];
};
static_assert(sizeof(State) <= kStateBytes, "the plan reserves kStateBytes");

// A line (a row, or a column) taken back through the applied ops: its
// source line, whether the stripe holds it, its coordinate at the noise
// stage.
struct LightLine {
  int src, st, noise;
};

// A column table entry: source x (15 bits), x at the noise stage (15
// bits), the stripe flag.
constexpr uint32_t kXBits = 0x7FFF;
constexpr int kNoiseShift = 15, kStBit = 30;

__device__ __forceinline__ LightLine walk_line(const LightWalk& k, int n,
                                               bool vertical, int t) {
  LightLine l{0, 0, 0};
#pragma unroll
  for (int i = kNumOps - 1; i >= 0; --i) {
    if (i >= k.m) continue;
    const int op = (k.ops >> (2 * i)) & 3;
    if (op == kTranslate) {
      if ((k.vert != 0) == vertical) {
        const bool stripe = k.shift >= 0 ? t < k.shift : t >= n + k.shift;
        l.st = !k.roll && stripe;
        const int from = (t - k.shift) % n;
        t = from < 0 ? from + n : from;
      }
    } else if (op == kFliplr) {
      if (!vertical) t = n - 1 - t;
    } else if (op == kNoise) {
      l.noise = t;
    }
  }
  l.src = t;
  return l;
}

// A unit: an output row; its walk and what its sample does to its values,
// in registers.
struct LightUnit {
  float* dst_img;        // the output image row (3W floats)
  float* dst_lab;        // the output label row (W)
  const float* src_img;  // the source rows (direct mode)
  const float* src_lab;
  int slot, flags;       // flags: the sample's rules, kRowSt
  uint32_t noise_row, key;  // Philox counter base and key
  float fill[3], noise_sd, exp_shift;
};

// The row pass's kernel side (row_ring.cuh `row_pass`) for a group of up
// to kGroup samples. A stage holds the source image row (3W floats) then
// the label row (W floats).
struct Light {
  using Line = LightUnit;
  const Args& a;
  State& grp;
  uint32_t* tab;  // [kGroup][w4] the samples' column tables
  int w4;
  uint32_t w_magic;
  int floats0, floats;  // a source line: 3W image floats, then W labels

  // The samples' seeds and Philox words, a thread a word.
  __device__ void draw_words(int g0, int n) const {
    constexpr int per = 1 + kDraws;
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int s = i / per, j = i - s * per;
      const int seed = a.seeds[g0 + s];
      if (j == 0)
        grp.seed[s] = seed;
      else
        grp.words[s][j - 1] = philox(j - 1, 0u, static_cast<uint32_t>(seed)).w0;
    }
  }

  __device__ void draw_normal(int s, int i) const {
    grp.normal[s][i] = value_normal(grp.words[s], i);
  }

  __device__ void draw_layout(int s) const {
    Params p;
    draw_layout_params(a, grp.words[s], &p);
    const int m = p.gate ? 0 : p.num;
    int packed = 0;
    for (int i = 0; i < m; ++i) packed |= p.ops[i] << (2 * i);
    grp.smp[s].wk = {m, packed, p.vert, p.shift, p.do_roll};
    // The column walk, backward from the output column, as `walk_line`.
    const int w = a.w;
    Affine t{1, 0}, noise{0, 0}, st{0, 0};
    int has_st = 0;
    for (int i = m - 1; i >= 0; --i) {
      if (p.ops[i] == kTranslate && !p.vert) {
        st = t, has_st = !p.do_roll;
        t = t.rolled(p.shift, w);
      } else if (p.ops[i] == kFliplr) {
        t = t.flipped(w);
      } else if (p.ops[i] == kNoise) {
        noise = t;
      }
    }
    grp.smp[s].cols = {t, noise, st, has_st};
  }

  // Sample s's value draws and rules.
  __device__ void draw_values(int s) const {
    Sample& sm = grp.smp[s];
    Params p;
    draw_value_params(a, grp.words[s], grp.normal[s], &p);
    for (int c = 0; c < 3; ++c) sm.fill[c] = p.fill[c];
    sm.noise_sd = p.noise_sd, sm.exp_shift = p.exp_shift;
    int stage[kNumOps] = {-1, -1, -1, -1};
    for (int i = 0; i < sm.wk.m; ++i) stage[(sm.wk.ops >> (2 * i)) & 3] = i;
    int rules = (stage[kExposure] > stage[kNoise] ? kExpLast : 0) |
                (stage[kNoise] >= 0 ? kNoised : 0);
    for (int k = 0; k < 2; ++k) {
      const int from = k ? stage[kTranslate] : -1;
      rules |= (stage[kNoise] > from) << (kNoiseOn + k) |
               (stage[kExposure] > from) << (kExpOn + k);
    }
    sm.rules = rules;
  }

  // Unit r's source image and label rows (none when the stripe fills the
  // row).
  __device__ SrcLine source(UnitAt r) const {
    const int h = a.h, w = a.w;
    const LightWalk wk = grp.smp[r.slot].wk;
    const LightLine row = walk_line(wk, h, true, r.y);
    const size_t line = static_cast<size_t>(r.b) * h + row.src;
    return {a.images + line * 3 * w, a.masks + line * w, row.st};
  }

  __device__ SrcLine own(UnitAt r) const {
    const size_t line = static_cast<size_t>(r.b) * a.h + r.y;
    return {a.images + line * 3 * a.w, a.masks + line * a.w, 0};
  }

  __device__ void build_tables(int n, int t, int stride) const {
    const int w = a.w;
#pragma unroll 4
    for (int i = t; i < n * w; i += stride) {
      const int s = magic_div(i, w_magic), x = i - s * w;
      const LightCols cm = grp.smp[s].cols;
      const int shift = grp.smp[s].wk.shift, ts = cm.st.at(x, w);
      const bool st =
          cm.has_st && (shift >= 0 ? ts < shift : ts >= w + shift);
      tab[s * w4 + x] = static_cast<uint32_t>(cm.src.at(x, w)) |
                        (static_cast<uint32_t>(cm.noise.at(x, w))
                         << kNoiseShift) |
                        (static_cast<uint32_t>(st) << kStBit);
    }
  }

  __device__ LightUnit line(UnitAt r) const {
    const int h = a.h, w = a.w;
    const Sample& sm = grp.smp[r.slot];
    const LightWalk wk = sm.wk;
    const LightLine row = walk_line(wk, h, true, r.y);
    const size_t out = static_cast<size_t>(r.b) * h + r.y;
    const size_t in = static_cast<size_t>(r.b) * h + row.src;
    return {a.out_images + out * 3 * w, a.out_masks + out * w,
            a.images + in * 3 * w, a.masks + in * w, r.slot,
            sm.rules | (row.st ? kRowSt : 0),
            static_cast<uint32_t>(row.noise * w),
            static_cast<uint32_t>(grp.seed[r.slot]),
            {sm.fill[0], sm.fill[1], sm.fill[2]}, sm.noise_sd, sm.exp_shift};
  }

  // A unit, by the calling warp: lane l takes the pixels l, l + 32, ...,
  // kPix at a time. Each value is the source's, or the stripe's fill;
  // then, on the image, noise (the kPix pixels' three channels' Philox
  // chains at once) and exposure in their order where they apply after it;
  // labels are rounded. The row goes out through the warp's output line
  // (16-byte stores in kBulk), or straight in kDirect.
  template <int kMode>
  __device__ void run(const LightUnit& u, const float* stage, float* out,
                      int lane) const {
    constexpr int kPix = 2;
    const int w = a.w, f = u.flags;
    float* dimg = kMode == kDirect ? u.dst_img : out;
    float* dlab = kMode == kDirect ? u.dst_lab : out + 3 * w;
    LightWalk wk{};
    if constexpr (kMode == kDirect) wk = grp.smp[u.slot].wk;
    const uint32_t* cols = tab + u.slot * w4;
    for (int x0 = lane; x0 < w; x0 += 32 * kPix) {
      float v[kPix][3], lab[kPix];
      int st[kPix], nx[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int x = min(x0 + 32 * j, w - 1);  // past the row: not written
        LightLine col;
        if constexpr (kMode == kDirect) {
          col = walk_line(wk, w, false, x);
        } else {
          const uint32_t e = cols[x];
          col = {static_cast<int>(e & kXBits),
                 static_cast<int>((e >> kStBit) & 1),
                 static_cast<int>((e >> kNoiseShift) & kXBits)};
        }
        nx[j] = col.noise;
        st[j] = (f & kRowSt) || col.st;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float s = kMode == kDirect
                              ? __ldg(u.src_img + 3 * col.src + c)
                              : stage[3 * col.src + c];
          v[j][c] = st[j] ? u.fill[c] : s;
        }
        const float l = kMode == kDirect ? __ldg(u.src_lab + col.src)
                                         : stage[3 * w + col.src];
        lab[j] = rintf(st[j] ? 0.0f : l);
      }
      float g[kPix][3];
      if (f & kNoised) {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const Words wd = philox(u.noise_row + nx[j], kNoiseStream + c,
                                    u.key);
            g[j][c] = __fmul_rn(u.noise_sd,
                                box_muller(uniform(wd.w0), uniform(wd.w1)));
          }
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const bool expo = (f >> (kExpOn + st[j])) & 1;
        const bool noise = (f >> (kNoiseOn + st[j])) & 1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (expo && !(f & kExpLast))
            v[j][c] = clip255(__fadd_rn(v[j][c], u.exp_shift));
          if (noise) v[j][c] = clip255(__fadd_rn(v[j][c], g[j][c]));
          if (expo && (f & kExpLast))
            v[j][c] = clip255(__fadd_rn(v[j][c], u.exp_shift));
        }
        const int x = x0 + 32 * j;
        if (x < w) {
#pragma unroll
          for (int c = 0; c < 3; ++c) dimg[3 * x + c] = v[j][c];
          dlab[x] = lab[j];
        }
      }
    }
    if constexpr (kMode != kDirect) {
      store_line<kMode>(u.dst_img, out, 3 * w, lane);
      store_line<kMode>(u.dst_lab, out + 3 * w, w, lane);
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kRowThreads, kLightBlocksPerSm)
    light_augment_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ State state;
  const int w4 = (a.w + 3) / 4 * 4;
  const RowSmem lay = row_smem_layout(
      kMode == kDirect ? 0 : min(a.batch, kGroup) * w4,
      kMode == kDirect ? 0 : 4 * a.w, kMode == kDirect ? 0 : a.stages);
  Light k{a, state, reinterpret_cast<uint32_t*>(smem + kBarBytes), w4,
          row_magic(a.w), 3 * a.w, 4 * a.w};
  row_pass<kMode>(k, smem, lay, a.batch, a.h, 1, a.stages);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// grid, stages, mode and smem are `light_plan`'s; a grid larger than the
// card holds at once is refused (cudaErrorInvalidConfiguration).
int light_augment_launch(const float* images, const float* masks,
                         float* out_images, float* out_masks,
                         const int* seeds, int batch, int h, int w,
                         int max_shift, float prob_original,
                         float noise_mean_sd, float exposure_mean_sd,
                         int grid, int stages, int mode, int smem,
                         void* stream) {
  const bool ring = mode != kDirect;
  const RowSmem lay =
      row_smem_layout(ring ? min(batch, kGroup) * ((w + 3) / 4 * 4) : 0,
                      ring ? 4 * w : 0, ring ? stages : 0);
  if (mode < kDirect || mode > kBulk ||
      (ring && (stages < 1 || stages > kMaxStages ||
                w > static_cast<int>(kXBits))) ||
      (mode == kBulk && w % 4 != 0) || grid < 1 || smem != lay.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{images, masks, out_images, out_masks, seeds, batch, h, w,
               max_shift, prob_original, noise_mean_sd, exposure_mean_sd,
               ring ? stages : 0};
  void (*kernel)(Args) = mode == kBulk    ? light_augment_kernel<kBulk>
                         : mode == kAsync ? light_augment_kernel<kAsync>
                                          : light_augment_kernel<kDirect>;
  const cudaError_t err = row_launch_check(
      reinterpret_cast<const void*>(kernel), grid, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ROW_TRACE_READER

}  // extern "C"
