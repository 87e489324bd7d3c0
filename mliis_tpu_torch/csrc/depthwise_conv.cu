// depthwise_conv: EfficientLab's depthwise convolution (models/layers.Conv2d
// with groups == in == out channels) with flax's SAME padding, for Hopper
// (sm_90a): one launch forward, one backward.
//
// Over channels-last float32 maps x [N, H, W, C] (NCHW tensors whose memory
// is NHWC) and taps w [C, K, K], K 3 or 5, stride S 1 or 2, and the SAME
// padding (pt, pl) before the first row and column (layers.same_padding):
//   y[n, oh, ow, c] = sum_{i, j < K} x[n, oh S - pt + i, ow S - pl + j, c]
//                     w[c, i, j],   oh < Ho = ceil(H / S), ow < Wo,
// x read as 0 outside [0, H) x [0, W): the padding is never written. The
// backward, from dy [N, Ho, Wo, C]:
//   dx[n, ih, iw, c] = sum over the (oh, ow, i, j) with oh S - pt + i = ih
//                      and ow S - pl + j = iw of dy[n, oh, ow, c] w[c, i, j]
//                      (a gather over the outputs that read (ih, iw));
//   dw[c, i, j] = sum_{n, oh, ow} dy[n, oh, ow, c] x[n, oh S - pt + i,
//                                                 ow S - pl + j, c].
//
// It replaces no TPU kernel: the JAX package leaves the depthwise conv to
// XLA (mliis_tpu/models/efficientnet.py, `nn.Conv(feature_group_count=
// filters)`). It was added because cuDNN's float32 depthwise kernels and
// the explicit pad in front of them took about 31 of the 181 device ms of
// b3's joint step (forward 8.1, input gradient 8.9, weight gradient 7.9,
// layout transforms 2.3, the pads' copies and fills 3.5, and the pads'
// backward besides), for work whose bytes take 3.8 ms. The plain PyTorch
// version is
// `depthwise_conv_reference` and `depthwise_conv_backward_reference` in
// mliis_tpu_torch/ops/depthwise_conv.py.
//
// What bounds it: the bytes. K^2 (9 or 25) multiply-adds a value against 4
// bytes read and 4 written: about 2 FLOPs a byte, far below the card's 20.
// Forward: x read once, y written once. Backward: x and dy read once, dx
// written once.
//
// Design.
//   Tiles. A block takes a slice of CS channels (8, 16 or 32, as the
//   launch plan finds cheapest for the shape; the last slice masked where
//   C is no multiple of 8) and walks a run of spatial tiles of one image
//   after another, TH x TW outputs each. Each tile's input rows and columns, with
//   their halo (and dy's, backward), are copied into shared memory by
//   cp.async, 16 bytes a copy where the channels allow (4 else); a copy
//   that falls outside the map writes zeros (src-size 0), which is the
//   SAME padding read in place. Two stages: the next tile's copies are in
//   flight while the threads compute the current one. Columns are padded
//   by one position every unit width, so that the 32/CS units of a warp
//   read distinct banks.
//   Threads. A thread keeps one channel (CS consecutive threads the slice's
//   channels) and its K x K taps in registers, and computes units of RH x
//   RW outputs (4 x 4 at stride 1, 2 x 2 at stride 2): it reads each input
//   row of the unit's window from shared memory once into registers and
//   adds each value into every output that reads it, all indices fixed at
//   compile time.
//   Backward, one launch. dx is owned in blocks of S RH x S RW inputs, each
//   beside the RH x RW outputs whose windows start in it (for S = 2 the
//   tiles cover ceil((H + pt) / 2) rows of outputs, the ones past Ho read
//   as 0, so that every input row has an owner); a unit gathers its dx
//   block from the dy window that reaches it (dy's halo: (K - 1) / S rows
//   and columns), then adds its outputs' x * dy products into K x K float32
//   sums that the thread keeps across all its tiles. Fusing dx and dw
//   reads x and dy once: the two sets of K^2 registers (taps and sums) fit
//   because a thread holds one channel.
//   dw across threads and blocks. At the end the block sums its threads'
//   float32 sums for each channel (the warp by xor shuffles, the warps in
//   double, in a fixed order) into double partials; the last block of the
//   channel slice to finish (a ticket, as csrc/batch_norm_act.cu takes it)
//   adds the partials of every block in block order in double. No float
//   atomics: the result repeats bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const float* x;     // [N, H, W, C]
  const float* w;     // [C, K, K]
  const float* g;     // dy [N, Ho, Wo, C] (backward)
  float* out;         // y [N, Ho, Wo, C], or dx [N, H, W, C] (null: no dx)
  float* dw;          // [C, K, K] (backward)
  double* partials;   // [blocks along y][C][K K] (backward)
  unsigned* tickets;  // [channel slices] (backward)
  int n, c, h, wd, ho, wo;  // wd: W
  int pad_top, pad_left;
  int vec;               // 4: 16-byte copies, 1: 4-byte copies
  int tile_h, tile_w;    // outputs of a tile
  int tiles_h, tiles_w;  // tiles of an image
  int tiles_per_block;
  int x_rows, x_cols, x_pitch;  // the x tile: rows, columns, floats a row
  int d_rows, d_cols, d_pitch;  // the dy tile (backward)
  int stage;                    // floats of one stage
};

// The unit and its windows at kernel size K and stride S.
template <int K, int S>
struct Geo {
  static constexpr int RH = S == 1 ? 4 : 2;  // a unit's output rows
  static constexpr int RW = RH;              // and columns
  static constexpr int XW = (RW - 1) * S + K;  // x window columns
  static constexpr int XH = (RH - 1) * S + K;  // x window rows
  static constexpr int KH = (K - 1) / S;       // dy's halo (backward)
  static constexpr int H0 = (K - 1) / 2;       // dy tile row of output 0
  static constexpr int GX = RW * S;  // x tile columns from unit to unit
  static constexpr int GD = RW;      // dy tile columns from unit to unit
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copies rows x cols positions of src [N, Hs, Ws, C] from (r0, c0) of image
// n, channels [ch0, ch0 + CS), into the tile at `dst` (column `col` at
// col + col / G, `pitch` floats a row); zeros outside the map. Each thread
// keeps one copy's channels and walks the positions a pass apart.
template <int CS, int G>
__device__ __forceinline__ void load_tile(const Args& a, float* dst,
                                          const float* src, int n, int hs,
                                          int ws, int r0, int c0, int rows,
                                          int cols, int pitch, int ch0) {
  const int per_pos = CS / a.vec;          // copies a position
  const int step = kThreads / per_pos;     // positions a pass
  const int ch = (threadIdx.x % per_pos) * a.vec;
  const int cc = ch0 + ch;
  const int step_rows = step / cols, step_cols = step % cols;
  const int total = rows * cols;
  const float* base = src + static_cast<long long>(n) * hs * ws * a.c + cc;
  int p = threadIdx.x / per_pos;
  int row = p / cols, col = p % cols;
  for (; p < total; p += step) {
    const int gr = r0 + row, gc = c0 + col;
    const bool ok = gr >= 0 && gr < hs && gc >= 0 && gc < ws && cc < a.c;
    const float* q = ok ? base + (static_cast<long long>(gr) * ws + gc) * a.c
                        : src;
    float* d = dst + row * pitch + (col + col / G) * CS + ch;
    if (a.vec == 4)
      cp_async16(d, q, ok ? 16 : 0);
    else
      cp_async4(d, q, ok ? 4 : 0);
    row += step_rows;
    col += step_cols;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
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

// One unit's RH x RW outputs from the x tile (`xs`: the unit's first
// window row, its channel).
template <int K, int S, int CS>
__device__ __forceinline__ void forward_unit(const float* xs, int pitch,
                                             const float (&wt)[K][K],
                                             float (&acc)[Geo<K, S>::RH]
                                                         [Geo<K, S>::RW]) {
  using G = Geo<K, S>;
#pragma unroll
  for (int a = 0; a < G::RH; ++a)
#pragma unroll
    for (int b = 0; b < G::RW; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int r = 0; r < G::XH; ++r) {
    float xr[G::XW];
#pragma unroll
    for (int q = 0; q < G::XW; ++q)
      xr[q] = xs[r * pitch + (q + q / G::GX) * CS];
#pragma unroll
    for (int a = 0; a < G::RH; ++a) {
      const int i = r - a * S;
      if (i < 0 || i >= K) continue;
#pragma unroll
      for (int b = 0; b < G::RW; ++b)
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc[a][b] = fmaf(xr[b * S + j], wt[i][j], acc[a][b]);
    }
  }
}

// One unit of the backward: its dx block (S RH x S RW inputs) from the dy
// window (`ds`: the window's first row, its channel), into dxa when
// `want_dx`; then its outputs' x * dy products into dwa.
template <int K, int S, int CS>
__device__ __forceinline__ void backward_unit(
    const float* xs, int x_pitch, const float* ds, int d_pitch,
    bool want_dx, const float (&wt)[K][K], float (&dwa)[K][K],
    float (&dxa)[S * Geo<K, S>::RH][S * Geo<K, S>::RW]) {
  using G = Geo<K, S>;
  constexpr int DW = G::RW + G::KH;  // dy window columns
  float dyb[G::RH][G::RW];
#pragma unroll
  for (int p = 0; p < S * G::RH; ++p)
#pragma unroll
    for (int q = 0; q < S * G::RW; ++q) dxa[p][q] = 0.f;
#pragma unroll
  for (int r = 0; r < G::RH + G::KH; ++r) {
    float dr[DW];
#pragma unroll
    for (int q = 0; q < DW; ++q)
      dr[q] = ds[r * d_pitch + (q + q / G::GD) * CS];
    if (r >= G::H0 && r < G::H0 + G::RH) {
#pragma unroll
      for (int b = 0; b < G::RW; ++b) dyb[r - G::H0][b] = dr[b + G::H0];
    }
    if (!want_dx) continue;
    // dx row p reads dy window row r through tap i = p + K - 1 - r S.
#pragma unroll
    for (int p = 0; p < S * G::RH; ++p) {
      const int i = p + K - 1 - r * S;
      if (i < 0 || i >= K) continue;
#pragma unroll
      for (int bq = 0; bq < DW; ++bq)
#pragma unroll
        for (int q = 0; q < S * G::RW; ++q) {
          const int j = q + K - 1 - bq * S;
          if (j < 0 || j >= K) continue;
          dxa[p][q] = fmaf(dr[bq], wt[i][j], dxa[p][q]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < G::XH; ++r) {
    float xr[G::XW];
#pragma unroll
    for (int q = 0; q < G::XW; ++q)
      xr[q] = xs[r * x_pitch + (q + q / G::GX) * CS];
#pragma unroll
    for (int a = 0; a < G::RH; ++a) {
      const int i = r - a * S;
      if (i < 0 || i >= K) continue;
#pragma unroll
      for (int b = 0; b < G::RW; ++b)
#pragma unroll
        for (int j = 0; j < K; ++j)
          dwa[i][j] = fmaf(dyb[a][b], xr[b * S + j], dwa[i][j]);
    }
  }
}

// Grid (channel slices, blocks of tiles): block y takes tiles
// [y tiles_per_block, (y + 1) tiles_per_block) of the N tiles_h tiles_w,
// image by image, rows of tiles in order. The slices vary fastest, so that
// the blocks that run together read every channel of the same positions
// and each of x's lines comes from device memory once.
template <int K, int S, bool BWD, int CS>
__global__ void __launch_bounds__(kThreads, 2)
depthwise_conv_kernel(const Args a) {
  using G = Geo<K, S>;
  constexpr int KK = K * K;
  extern __shared__ __align__(16) float smem[];
  const int ch0 = blockIdx.x * CS;
  const int lane_c = threadIdx.x % CS;
  const int c = ch0 + lane_c;
  const bool live = c < a.c;
  constexpr int kUnitsAPass = kThreads / CS;
  const int first_unit = threadIdx.x / CS;

  float wt[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      wt[i][j] = live ? a.w[(static_cast<long long>(c) * K + i) * K + j]
                      : 0.f;
  float dwa[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) dwa[i][j] = 0.f;

  const int units_w = a.tile_w / G::RW;
  const int units = (a.tile_h / G::RH) * units_w;
  const int per_image = a.tiles_h * a.tiles_w;
  const int total = per_image * a.n;  // under 2^31: the launch checks it
  const int t0 = blockIdx.y * a.tiles_per_block;
  const int t1 = min(total, t0 + a.tiles_per_block);
  const int x_floats = a.x_rows * a.x_pitch;

  // Tile t: image n, first output row orow and column ocol.
  auto where = [&](int t, int& n, int& orow, int& ocol) {
    n = t / per_image;
    const int r = t - n * per_image;
    const int tr = r / a.tiles_w;
    orow = tr * a.tile_h;
    ocol = (r - tr * a.tiles_w) * a.tile_w;
  };
  auto issue = [&](int t, float* stage) {
    int n, orow, ocol;
    where(t, n, orow, ocol);
    load_tile<CS, G::GX>(a, stage, a.x, n, a.h, a.wd, orow * S - a.pad_top,
                         ocol * S - a.pad_left, a.x_rows, a.x_cols,
                         a.x_pitch, ch0);
    if constexpr (BWD)
      load_tile<CS, G::GD>(a, stage + x_floats, a.g, n, a.ho, a.wo,
                           orow - G::H0, ocol - G::H0, a.d_rows, a.d_cols,
                           a.d_pitch, ch0);
    cp_async_commit();
  };

  if (t0 < t1) issue(t0, smem);
  for (int t = t0; t < t1; ++t) {
    float* stage = smem + ((t - t0) & 1) * a.stage;
    if (t + 1 < t1) {
      issue(t + 1, smem + ((t + 1 - t0) & 1) * a.stage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int n, orow, ocol;
    where(t, n, orow, ocol);
    for (int u = first_unit; u < units; u += kUnitsAPass) {
      const int uh = u / units_w, uw = u % units_w;
      const float* xs = stage + uh * G::RH * S * a.x_pitch
                        + uw * (G::GX + 1) * CS + lane_c;
      if constexpr (!BWD) {
        float acc[G::RH][G::RW];
        forward_unit<K, S, CS>(xs, a.x_pitch, wt, acc);
        const int oh0 = orow + uh * G::RH, ow0 = ocol + uw * G::RW;
        float* row = a.out + ((static_cast<long long>(n) * a.ho + oh0)
                              * a.wo + ow0) * a.c + c;
#pragma unroll
        for (int r = 0; r < G::RH; ++r, row += a.wo * a.c)
#pragma unroll
          for (int b = 0; b < G::RW; ++b)
            if (live && oh0 + r < a.ho && ow0 + b < a.wo)
              row[b * a.c] = acc[r][b];
      } else {
        const float* ds = stage + x_floats + uh * G::RH * a.d_pitch
                          + uw * (G::GD + 1) * CS + lane_c;
        float dxa[S * G::RH][S * G::RW];
        const bool want_dx = a.out != nullptr;
        backward_unit<K, S, CS>(xs, a.x_pitch, ds, a.d_pitch, want_dx, wt,
                                dwa, dxa);
        if (want_dx) {
          // The dx block's first input: S = 1 owns the inputs under its
          // outputs, S = 2 those from its first window's first row.
          const int ih0 = (S == 1 ? orow : orow * S - a.pad_top)
                          + uh * G::RH * S;
          const int iw0 = (S == 1 ? ocol : ocol * S - a.pad_left)
                          + uw * G::RW * S;
          // (ih0, iw0) may lie before the map (stride 2): the stores
          // there are masked, and the pointer only offset from.
          float* row = a.out + ((static_cast<long long>(n) * a.h + ih0)
                                * a.wd + iw0) * a.c + c;
#pragma unroll
          for (int p = 0; p < S * G::RH; ++p, row += a.wd * a.c)
#pragma unroll
            for (int q = 0; q < S * G::RW; ++q) {
              const int ih = ih0 + p, iw = iw0 + q;
              if (live && ih >= 0 && ih < a.h && iw >= 0 && iw < a.wd)
                row[q * a.c] = dxa[p][q];
            }
        }
      }
    }
    __syncthreads();
  }

  if constexpr (BWD) {
    // The block's sums: the warp's lanes of a channel by xor shuffles, the
    // warps in double, in order, into the block's partials.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* red = smem;  // [kWarps][CS][KK], after the loop's last barrier
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float v = dwa[i][j];
#pragma unroll
        for (int off = CS; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < CS) red[(warp * CS + lane) * KK + i * K + j] = v;
      }
    __syncthreads();
    double* part = a.partials + static_cast<long long>(blockIdx.y) * a.c * KK;
    for (int e = threadIdx.x; e < CS * KK; e += kThreads) {
      if (ch0 + e / KK >= a.c) continue;
      double s = 0.0;
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * CS * KK + e];
      part[ch0 * KK + e] = s;
    }
    if (!last_block(a.tickets + blockIdx.x, gridDim.y)) return;
    for (int e = threadIdx.x; e < CS * KK; e += kThreads) {
      if (ch0 + e / KK >= a.c) continue;
      double s = 0.0;
      for (int b = 0; b < static_cast<int>(gridDim.y); ++b)
        s += __ldcg(a.partials + static_cast<long long>(b) * a.c * KK
                    + ch0 * KK + e);
      a.dw[ch0 * KK + e] = static_cast<float>(s);
    }
  }
}

template <int K, int S, bool BWD, int CS>
int launch_kernel(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  auto kernel = depthwise_conv_kernel<K, S, BWD, CS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S, bool BWD>
int launch_cs(const Args& a, int cs, dim3 grid, int smem, cudaStream_t s) {
  switch (cs) {
    case 8: return launch_kernel<K, S, BWD, 8>(a, grid, smem, s);
    case 16: return launch_kernel<K, S, BWD, 16>(a, grid, smem, s);
    default: return launch_kernel<K, S, BWD, 32>(a, grid, smem, s);
  }
}

template <bool BWD>
int launch_shape(const Args& a, int k, int stride, int cs, dim3 grid,
                 int smem, cudaStream_t s) {
  if (k == 3)
    return stride == 1 ? launch_cs<3, 1, BWD>(a, cs, grid, smem, s)
                       : launch_cs<3, 2, BWD>(a, cs, grid, smem, s);
  return stride == 1 ? launch_cs<5, 1, BWD>(a, cs, grid, smem, s)
                     : launch_cs<5, 2, BWD>(a, cs, grid, smem, s);
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace

extern "C" {

// The forward (backward = 0: x, w -> out = y) or the backward (backward =
// 1: x, w, g = dy -> out = dx, or no dx where out is null; dw through the
// partials, [blocks][C][k k] doubles, and the tickets, one a channel slice,
// all 0) on `stream`; returns the cudaError_t of the launch (0 = success).
// Maps are channels-last [N, H, W, C]; the SAME padding's first row and
// column are pad_top and pad_left. cs channels a block (4 or 8), tiles of
// tile_h x tile_w outputs (multiples of the unit, 4 at stride 1 and 2 at
// stride 2; backward at stride 2 over ceil((H + pad_top) / 2) rows and
// ceil((W + pad_left) / 2) columns of outputs), tiles_per_block tiles a
// block. `smem_bytes` is the dynamic shared memory the wrapper counted; it
// must equal this launch's.
int depthwise_conv_launch(int backward, const float* x, const float* w,
                          const float* g, float* out, float* dw,
                          double* partials, unsigned* tickets, int n, int c,
                          int h, int wd, int k, int stride, int pad_top,
                          int pad_left, int cs, int vec, int tile_h,
                          int tile_w, int tiles_per_block, int smem_bytes,
                          void* stream) {
  const int unit = stride == 1 ? 4 : 2;
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2)
      || (cs != 8 && cs != 16 && cs != 32)
      || (vec != 1 && vec != 4)
      || (vec == 4 && c % 4 != 0) || n < 1 || c < 1 || h < 1 || wd < 1
      || pad_top < 0 || pad_left < 0 || pad_top >= k || pad_left >= k
      || (stride == 1 && (pad_top != (k - 1) / 2 || pad_left != (k - 1) / 2))
      || tile_h < unit || tile_w < unit || tile_h % unit != 0
      || tile_w % unit != 0 || tiles_per_block < 1
      || (backward && (g == nullptr || dw == nullptr || partials == nullptr
                       || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = ceil_div(h, stride), wo = ceil_div(wd, stride);
  const bool virt = backward && stride == 2;
  const int grid_h = virt ? ceil_div(h + pad_top, 2) : ho;
  const int grid_w = virt ? ceil_div(wd + pad_left, 2) : wo;
  const int tiles_h = ceil_div(grid_h, tile_h);
  const int tiles_w = ceil_div(grid_w, tile_w);
  const long long tiles = static_cast<long long>(n) * tiles_h * tiles_w;
  const long long blocks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int slices = ceil_div(c, cs);
  const int gx = unit * stride, gd = unit;
  const int x_rows = (tile_h - 1) * stride + k;
  const int x_cols = (tile_w - 1) * stride + k;
  const int x_pitch = (x_cols + (x_cols - 1) / gx) * cs;
  const int d_rows = backward ? tile_h + (k - 1) / stride : 0;
  const int d_cols = backward ? tile_w + (k - 1) / stride : 0;
  const int d_pitch = backward ? (d_cols + (d_cols - 1) / gd) * cs : 0;
  const long long stage = static_cast<long long>(x_rows) * x_pitch
                          + static_cast<long long>(d_rows) * d_pitch;
  long long smem = 2 * stage * 4;
  const long long red = static_cast<long long>(kWarps) * cs * k * k * 4;
  if (backward && red > smem) smem = red;
  if (smem != smem_bytes || smem > kMaxSmem || blocks > 65535
      || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, g, out, dw, partials, tickets, n, c, h, wd, ho, wo, pad_top,
         pad_left, vec, tile_h, tile_w, tiles_h, tiles_w, tiles_per_block,
         x_rows, x_cols, x_pitch, d_rows, d_cols, d_pitch,
         static_cast<int>(stage)};
  const dim3 grid(slices, static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return backward ? launch_shape<true>(a, k, stride, cs, grid, smem, s)
                  : launch_shape<false>(a, k, stride, cs, grid, smem, s);
}

}  // extern "C"
