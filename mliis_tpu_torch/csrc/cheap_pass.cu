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
// What bounds it: the bytes, 2 * C * H * W * 4 a sample (16.1 MB at B=8,
// 5 x 224^2: 4.8 us at 3.35 TB/s); a noise value costs about 117
// operations (Philox 100, two uniforms, Box-Muller, scale, add, clip) where
// noise runs, which comes to less.
//
// Design: the walk splits into a row part and a column part. No cheap op
// couples the axes but through a fill: rolls and the vertical stripe move
// rows, flips, horizontal rolls and the horizontal stripe move columns, so
// at every stage a pixel sits at (fy_s(y), fx_s(x)); the eraser box is
// rows(s) x cols(s) and a stripe a set of rows or of columns. `walk_line`
// takes one line back through the applied ops and keeps its source, its
// eraser and stripe flags and its coordinate at the noise stage. A pixel
// is filled by the later of the eraser (both flags) and the stripe (either
// flag) that covers it; noise and exposure apply at the stages after that
// fill, in their order, at counter noise_y * W + noise_x: what the
// backward walk of full_pass.cu (`walk_back`, `walk_value`) computes.
//
// The work is the B x H x C output plane rows, on row_ring.cuh's
// pipeline: persistent blocks, a producer warp that stages each plane
// row's source row (none when a vertical stripe fills the row) in a ring
// of shared-memory stages, with one 1D TMA bulk copy when W % 4 == 0
// (4-byte cp.async otherwise), and consumer warps that take the staged
// rows as they come. A block draws its group's samples once and builds
// their column tables once in shared memory (an int a column: source x,
// noise x and the two flags); a warp walks each of its rows once (from a
// register copy of the sample's walk), then lane l computes the columns
// l, l + 32, ... (gathers through the column table, free of bank
// conflicts; four columns' Philox chains at once), writes them to the
// warp's output line and the warp copies the line out with 16-byte
// stores (4-byte ones when W % 4 != 0). Rows too wide for shared memory
// take the direct mode: no ring and no tables, columns walked per pixel,
// sources read from device memory.
//
// Arithmetic that decides a discrete outcome uses __fmul_rn/__fadd_rn (no
// --use_fast_math), as in the other kernels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cheap_ops.cuh"
#include "row_ring.cuh"

namespace {

struct Args {
  const float* __restrict__ x;     // [B, C_tot, H, W]
  float* __restrict__ out;         // [B, C_tot, H, W]
  const int* __restrict__ seeds;   // [B]
  const int* __restrict__ perm;    // [B, 6]
  const int* __restrict__ num;     // [B]
  const int* __restrict__ window;  // [B, 2]: lo, hi
  CheapConsts k;
  int c_img, batch, stages;
};

// A line (a row, or a column) taken back through the applied ops: its
// source line, whether the eraser's rows (columns) and the translate's
// stripe hold it at their stages, and its coordinate at the noise stage.
struct CheapLine {
  int src, er, st, noise;
};

// A column table entry: source x (15 bits), x at the noise stage (15
// bits), the eraser flag, the stripe flag.
constexpr uint32_t kXBits = 0x7FFF;
constexpr int kNoiseShift = 15, kErBit = 30, kStBit = 31;
constexpr int kFromSrc = 0, kFromEraser = 1, kFromStripe = 2;  // a value's

// What places a sample's lines, compact so that a walk runs from a copy in
// registers: the applied ops (the op at stage i in bits 3i..3i+2), the
// translate and the eraser's box.
struct CheapWalk {
  int m, ops, vert, shift, roll, er_top, er_h, er_left, er_w;
};

// A sample's column walk in closed form (its ops move columns by a flip
// and a roll only): column x's source, its column at the noise stage, and
// its column at the translate's and at the eraser's stage, where the
// stripe and the box test it (when those ops apply to columns).
struct CheapCols {
  Affine src, noise, st, er;
  int has_st, has_er;
};

// One sample: its walk, its column walk, what its ops do to a value taken
// from the source, the eraser's fill or the stripe's fill (`rules`,
// CheapUnit's bits), and its value draws; the stripe's fill of each plane.
struct Sample {
  CheapWalk wk;
  CheapCols cols;
  int rules;
  float er_c, noise_sd, exp_shift;
  float fill[kMaxImg + 2];
};

constexpr int kHead = 10;  // a sample's perm row, num, lo, hi, seed
constexpr int kCheapBlocksPerSm = 3;  // __launch_bounds__: <= 80 registers

struct State {
  Sample smp[kGroup];
  float draws[kGroup][kMaxDraws];  // the samples' scalar uniforms
  float normal[kGroup][3];         // their value draws' normals
  int head[kGroup][kHead];
};
static_assert(sizeof(State) <= kStateBytes, "the plan reserves kStateBytes");

__device__ __forceinline__ CheapLine walk_line(const CheapWalk& k, int n,
                                               bool vertical, int t) {
  CheapLine l{0, 0, 0, 0};
#pragma unroll
  for (int i = kNumStages - 1; i >= 0; --i) {
    if (i >= k.m) continue;
    const int op = (k.ops >> (3 * i)) & 7;
    if (op == kEraser) {
      const int lo = vertical ? k.er_top : k.er_left;
      l.er = t >= lo && t < lo + (vertical ? k.er_h : k.er_w);
    } else if (op == kTranslate) {
      if ((k.vert != 0) == vertical) {
        l.st = !k.roll && in_stripe(t, k.shift, n);
        t = roll_source(t, k.shift, n);
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

__device__ __forceinline__ uint32_t pack_column(const CheapLine& l) {
  return static_cast<uint32_t>(l.src) |
         (static_cast<uint32_t>(l.noise) << kNoiseShift) |
         (static_cast<uint32_t>(l.er) << kErBit) |
         (static_cast<uint32_t>(l.st) << kStBit);
}

__device__ __forceinline__ CheapLine unpack_column(uint32_t e) {
  return {static_cast<int>(e & kXBits),
          static_cast<int>((e >> kErBit) & 1), static_cast<int>(e >> kStBit),
          static_cast<int>((e >> kNoiseShift) & kXBits)};
}

// A unit: an output row of one plane; its row's walk and what its sample
// does to its values, in registers.
constexpr int kImg = 1, kNoised = 2, kErLate = 4, kExpLast = 8,
              kRowSt = 16, kRowEr = 32, kNoiseOn = 8, kExpOn = 12;  // bits
struct CheapUnit {
  float* dst;          // the output row
  const float* src;    // the source row (direct mode)
  int slot, flags;     // flags: the k* bits; noise_on, exp_on from bit
                       // kNoiseOn, kExpOn, bit k for a value from kFrom k
  uint32_t noise_row, stream, key;  // Philox counter base, stream and key
  float fill_er, fill_st, noise_sd, exp_shift;
};

// The row pass's kernel side (row_ring.cuh `row_pass`) for a group of up
// to kGroup samples.
struct Cheap {
  using Line = CheapUnit;
  const Args& a;
  State& grp;
  uint32_t* tab;  // [kGroup][w4] the samples' column tables
  int w4;
  uint32_t w_magic;
  int floats0, floats;  // a source line: W floats

  // The samples' heads (perm row, num, window, seed) and their scalar
  // uniforms, a thread a word.
  __device__ void draw_words(int g0, int n) const {
    const int nd = 9 + a.k.c_tot + 6, per = kHead + nd;
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int s = i / per, j = i - s * per, b = g0 + s;
      if (j < kHead)
        grp.head[s][j] = j < kNumStages ? a.perm[b * kNumStages + j]
                         : j == 6       ? a.num[b]
                         : j < 9        ? a.window[2 * b + j - 7]
                                        : a.seeds[b];
      else
        grp.draws[s][j - kHead] =
            scalar_uniform(static_cast<uint32_t>(a.seeds[b]), j - kHead);
    }
  }

  __device__ void draw_normal(int s, int i) const {
    const float* d = grp.draws[s];
    grp.normal[s][i] = value_normal(a.k, [d](int j) { return d[j]; }, i);
  }

  // Sample s's ops in its window, its translate and its eraser's box: all
  // its walks need.
  __device__ void draw_layout(int s) const {
    const int* hd = grp.head[s];
    const int lo = max(hd[7], 0), hi = min(min(hd[8], hd[6]), kNumStages);
    int ops[kNumStages];
    const int m = list_ops(hd, lo, hi, ops);
    const float* d = grp.draws[s];
    CheapParams p;
    draw_placement(a.k, [d](int i) { return d[i]; }, &p);
    int packed = 0;
    for (int i = 0; i < m; ++i) packed |= ops[i] << (3 * i);
    grp.smp[s].wk = {m,        packed,  p.vert,  p.shift, p.do_roll,
                     p.er_top, p.er_h,  p.er_left, p.er_w};
    // The column walk, backward from the output column, as `walk_line`.
    const int w = a.k.w;
    Affine t{1, 0}, noise{0, 0}, st{0, 0}, er{0, 0};
    int has_st = 0, has_er = 0;
    for (int i = m - 1; i >= 0; --i) {
      if (ops[i] == kEraser) {
        er = t, has_er = 1;
      } else if (ops[i] == kTranslate && !p.vert) {
        st = t, has_st = !p.do_roll;
        t = t.rolled(p.shift, w);
      } else if (ops[i] == kFliplr) {
        t = t.flipped(w);
      } else if (ops[i] == kNoise) {
        noise = t;
      }
    }
    grp.smp[s].cols = {t, noise, st, er, has_st, has_er};
  }

  // Sample s's value draws (from its normals) and its value rules.
  __device__ void draw_values(int s) const {
    const float* d = grp.draws[s];
    const auto u = [d](int i) { return d[i]; };
    CheapParams p;
    values_from_normals(a.k, u, grp.normal[s][0], grp.normal[s][1],
                        grp.normal[s][2], &p);
    Sample& sm = grp.smp[s];
    sm.er_c = p.er_c, sm.noise_sd = p.noise_sd, sm.exp_shift = p.exp_shift;
    int stage[kNumStages] = {-1, -1, -1, -1, -1, -1};
    for (int i = 0; i < sm.wk.m; ++i) stage[(sm.wk.ops >> (3 * i)) & 7] = i;
    const int from[3] = {-1, stage[kEraser], stage[kTranslate]};
    int rules = (stage[kEraser] > stage[kTranslate] ? kErLate : 0) |
                (stage[kExposure] > stage[kNoise] ? kExpLast : 0) |
                (stage[kNoise] >= 0 ? kNoised : 0);
    for (int k = 0; k < 3; ++k)
      rules |= (stage[kNoise] > from[k]) << (kNoiseOn + k) |
               (stage[kExposure] > from[k]) << (kExpOn + k);
    sm.rules = rules;
    for (int c = 0; c < a.k.c_tot; ++c)
      sm.fill[c] = c < a.c_img ? image_fill(u, c)
                               : (c == a.c_img ? 1.0f : 0.0f);
  }

  // Unit r's source row of its plane (none when a vertical stripe fills
  // the row).
  __device__ SrcLine source(UnitAt r) const {
    const int c_tot = a.k.c_tot, h = a.k.h, w = a.k.w;
    const CheapWalk wk = grp.smp[r.slot].wk;
    const CheapLine row = walk_line(wk, h, true, r.y);
    const float* src =
        a.x + ((static_cast<size_t>(r.b) * c_tot + r.c) * h + row.src) * w;
    return {src, src, row.st};
  }

  __device__ SrcLine own(UnitAt r) const {
    const int c_tot = a.k.c_tot, h = a.k.h, w = a.k.w;
    const float* src =
        a.x + ((static_cast<size_t>(r.b) * c_tot + r.c) * h + r.y) * w;
    return {src, src, 0};
  }

  __device__ void build_tables(int n, int t, int stride) const {
    const int w = a.k.w;
#pragma unroll 4
    for (int i = t; i < n * w; i += stride) {
      const int s = magic_div(i, w_magic), x = i - s * w;
      const CheapCols cm = grp.smp[s].cols;
      const CheapWalk wk = grp.smp[s].wk;
      const int ex = cm.er.at(x, w);
      tab[s * w4 + x] = pack_column(
          {cm.src.at(x, w),
           cm.has_er && ex >= wk.er_left && ex < wk.er_left + wk.er_w,
           cm.has_st && in_stripe(cm.st.at(x, w), wk.shift, w),
           cm.noise.at(x, w)});
    }
  }

  __device__ CheapUnit line(UnitAt r) const {
    const int h = a.k.h, w = a.k.w;
    const Sample& sm = grp.smp[r.slot];
    const CheapWalk wk = sm.wk;
    const CheapLine row = walk_line(wk, h, true, r.y);
    const size_t plane = (static_cast<size_t>(r.b) * a.k.c_tot + r.c) * h;
    const bool img = r.c < a.c_img;
    return {a.out + (plane + r.y) * w, a.x + (plane + row.src) * w, r.slot,
            sm.rules | (img ? kImg : 0) | (row.st ? kRowSt : 0) |
                (row.er ? kRowEr : 0),
            static_cast<uint32_t>(row.noise * w),
            kNoiseStream + static_cast<uint32_t>(r.c),
            static_cast<uint32_t>(grp.head[r.slot][9]),
            img ? sm.er_c : (r.c == a.c_img ? 1.0f : 0.0f), sm.fill[r.c],
            sm.noise_sd, sm.exp_shift};
  }

  // A unit, by the calling warp: lane l takes the columns l, l + 32, ...,
  // kCols at a time. Each value is taken from the source row, the eraser's
  // fill or the stripe's (the later of the two that cover it); then noise
  // (the kCols values' Philox chains at once) and exposure in their order
  // where they apply after it. The row goes out through the warp's output
  // line (16-byte stores in kBulk), or straight in kDirect.
  template <int kMode>
  __device__ void run(const CheapUnit& u, const float* stage, float* out,
                      int lane) const {
    constexpr int kCols = 4;
    const int w = a.k.w, f = u.flags;
    const float* src = kMode == kDirect ? u.src : stage;
    float* dst = kMode == kDirect ? u.dst : out;
    CheapWalk wk{};
    if constexpr (kMode == kDirect) wk = grp.smp[u.slot].wk;
    const uint32_t* cols = tab + u.slot * w4;
    for (int x0 = lane; x0 < w; x0 += 32 * kCols) {
      float v[kCols];
      int from[kCols];
      CheapLine col[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int x = min(x0 + 32 * j, w - 1);  // past the row: not written
        if constexpr (kMode == kDirect)
          col[j] = walk_line(wk, w, false, x);
        else
          col[j] = unpack_column(cols[x]);
        const bool st = (f & kRowSt) || col[j].st;
        const bool er = (f & kRowEr) && col[j].er && (!st || (f & kErLate));
        from[j] = er ? kFromEraser : st ? kFromStripe : kFromSrc;
        const float s =
            kMode == kDirect ? __ldg(src + col[j].src) : src[col[j].src];
        v[j] = er ? u.fill_er : st ? u.fill_st : s;
      }
      if (f & kImg) {
        float g[kCols];
        if (f & kNoised) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const Words wd = philox(u.noise_row + col[j].noise, u.stream,
                                    u.key);
            g[j] = box_muller(uniform(wd.w0), uniform(wd.w1));
          }
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const bool expo = (f >> (kExpOn + from[j])) & 1;
          if (expo && !(f & kExpLast)) v[j] = add_exposure(v[j], u.exp_shift);
          if ((f >> (kNoiseOn + from[j])) & 1)
            v[j] = clip255(__fadd_rn(v[j], __fmul_rn(u.noise_sd, g[j])));
          if (expo && (f & kExpLast)) v[j] = add_exposure(v[j], u.exp_shift);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (x0 + 32 * j < w) dst[x0 + 32 * j] = v[j];
    }
    if constexpr (kMode != kDirect) store_line<kMode>(u.dst, out, w, lane);
  }
};

template <int kMode>
__global__ void __launch_bounds__(kRowThreads, kCheapBlocksPerSm)
    cheap_pass_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ State state;
  const int w = a.k.w, w4 = (w + 3) / 4 * 4;
  const RowSmem lay = row_smem_layout(
      kMode == kDirect ? 0 : min(a.batch, kGroup) * w4,
      kMode == kDirect ? 0 : w, kMode == kDirect ? 0 : a.stages);
  Cheap k{a, state, reinterpret_cast<uint32_t*>(smem + kBarBytes), w4,
          row_magic(w), w, w};
  row_pass<kMode>(k, smem, lay, a.batch, a.k.h, a.k.c_tot, a.stages);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// grid, stages, mode and smem are `cheap_pass_plan`'s; a grid larger than
// the card holds at once is refused (cudaErrorInvalidConfiguration).
int cheap_pass_launch(const float* x, float* out, const int* seeds,
                      const int* perm, const int* num, const int* window,
                      int batch, int c_tot, int h, int w, int c_img,
                      int max_shift, float noise_mean_sd,
                      float exposure_mean_sd, float er_s_l, float er_s_range,
                      float er_r_1, float er_r_range, int grid, int stages,
                      int mode, int smem, void* stream) {
  const bool ring = mode != kDirect;
  const RowSmem lay =
      row_smem_layout(ring ? min(batch, kGroup) * ((w + 3) / 4 * 4) : 0,
                      ring ? w : 0, ring ? stages : 0);
  if (c_img > kMaxImg || c_tot != c_img + 2 || mode < kDirect ||
      mode > kBulk ||
      (ring && (stages < 1 || stages > kMaxStages ||
                w > static_cast<int>(kXBits))) ||
      (mode == kBulk && w % 4 != 0) || grid < 1 || smem != lay.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, out, seeds, perm, num, window,
               CheapConsts{c_tot, h, w, max_shift, noise_mean_sd,
                           exposure_mean_sd, er_s_l, er_s_range, er_r_1,
                           er_r_range},
               c_img, batch, ring ? stages : 0};
  void (*kernel)(Args) = mode == kBulk    ? cheap_pass_kernel<kBulk>
                         : mode == kAsync ? cheap_pass_kernel<kAsync>
                                          : cheap_pass_kernel<kDirect>;
  const cudaError_t err = row_launch_check(
      reinterpret_cast<const void*>(kernel), grid, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ROW_TRACE_READER

}  // extern "C"
