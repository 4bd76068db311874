// Separable Gaussian blur with a constant fill boundary, for sm_90a.
//
// Replaces the Pallas TPU kernel gaussian_blur_pallas
// (dask_geomodeling_tpu/ops/pallas_stencils.py:55).  Same contract as the
// plain torch version gaussian_blur_reference
// (dask_geomodeling_tpu_torch/ops/stencils.py), bit for bit: each 1-D
// pass starts with x[c]*w[0] and adds (x[c-j] + x[c+j])*w[j] for j = r..1
// (scipy.ndimage.correlate1d's symmetric order), accumulates in double
// with separately rounded multiplies and adds (__dmul_rn / __dadd_rn: no
// fused multiply-add), and rounds to T between the passes, y first.
// Taps outside the plane read the double `fill`, as scipy pads with cval;
// the x pass reads `fill`, not a blurred value, left and right of the
// plane.
//
// What bounds it.  At the headline path's radius 3 a float32 plane is read
// once and written once, 8 bytes a pixel: 41 us for (64, 516, 516) at
// 3.35 TB/s.  The arithmetic is 2 x (1 + 3r) float64 instructions a pixel
// (no FMA), 20 at r = 3 and 44 at the stencils path's r = 7, where it
// overtakes the bytes (about 46 us at 17e12 a second against 42 us).
// Converting between float and double runs at a quarter of that rate on
// this card, so conversions count like arithmetic.  The design therefore
// aims at instructions per output:
//
// - The fused launch (both radii <= FUSED_MAX_RADIUS, every exact-mode
//   Smooth) is one launch over all N planes; the intermediate between the
//   passes stays in shared memory.  For the common radii (ry == rx, 1..8)
//   the radius is a template constant, the loops unroll, the weights are
//   kernel arguments (constant-bank operands), and each thread slides a
//   register window: in the y pass down one window column for a strip of
//   rows, reading each input from device memory once (coalesced: a warp
//   reads 32 neighbouring columns) and widening it once; in the x pass
//   along one tile row (a warp's lanes are 32 rows; the intermediate's
//   odd pitch keeps their shared-memory reads free of bank conflicts).
//   The y pass stores each intermediate once, as the double that holds its
//   T-rounded value, and `fill` in the columns outside the plane, so no
//   tap is tested.  The x pass stages its outputs in shared memory and the
//   block writes the tile coalesced.  No index is divided at run time
//   within a tile.  The grid is persistent (as many blocks as fit on the
//   card, each walking over tiles), and a block issues the loads of its
//   next tile before the x pass of the current one, so device memory
//   stays busy while the card computes.
// - Other radii up to the limit (ry != rx, a radius of 0) take a generic
//   fused kernel: the tile's window staged once as double with `fill` in
//   the out-of-plane slots, then both passes from shared memory.
// - Above FUSED_MAX_RADIUS (zoom-mode Smooth, sigma of tens of pixels) the
//   halo would crowd out the tile, so the passes run as two launches
//   through a scratch buffer that the caller allocates, each staging its
//   window along the pass axis as double with `fill` slots; a radius too
//   large for shared memory reads the taps from device memory instead.
//
// Integer frames.  scipy.ndimage.gaussian_filter with an integer `output`
// stores each pass in that integer type before the next pass reads it, and
// its C cast truncates toward zero.  The entry gaussian_blur_trunc_f64
// takes the integer frame widened to double (exact for every int32, and
// as C widens an int64 or uint64) and stores through TruncDouble: a double
// whose conversion from the accumulator truncates.  Its intermediate and
// its output are therefore the integers scipy stores, held as doubles, and
// the caller's cast back to the integer type is exact.
//
// Layout: N contiguous planes of H x W.  Weights: w[0..r] per axis (the
// kernel is symmetric), [wy(ry+1), wx(rx+1)]; the fused launch takes them
// from the host by value, the two-pass launch from a device buffer.

#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace {

constexpr int FUSED_MAX_RADIUS = 8;  // sigma <= 2: every exact-mode Smooth
constexpr int MAX_GRID_YZ = 65535;
constexpr int SMALL_SMEM = 48 * 1024;  // dynamic shared memory without opt-in

// the fused launch with a constant radius
constexpr int THREADS = 256;
constexpr int WIN_COLS = 128;  // y-pass window columns: one thread each
constexpr int TILE_H = 32;     // output rows of a tile: one lane each in the x pass
constexpr int STRIP_Y = 16;    // rows a thread computes in the y pass
constexpr int STRIP_X = 16;    // columns a thread computes in the x pass

// the generic fused launch
constexpr int GEN_TILE = 32;
constexpr int GEN_THREADS_Y = 8;

struct Weights {
  double y[FUSED_MAX_RADIUS + 1];  // y[j]: the weight of the taps at +-j
  double x[FUSED_MAX_RADIUS + 1];
};

__device__ __forceinline__ double tap_pair(double a, double b, double w) {
  return __dmul_rn(__dadd_rn(a, b), w);
}

// The storage of the integer entry: a double that takes a value
// truncated toward zero, as C's cast of a double to an integer type does.
struct TruncDouble {
  double v;
  TruncDouble() = default;
  __device__ __forceinline__ explicit TruncDouble(double x) : v(trunc(x)) {}
  __device__ __forceinline__ explicit operator double() const { return v; }
};
static_assert(sizeof(TruncDouble) == sizeof(double), "stored as a double");

// the y pass's result as the next pass reads it: rounded to T
template <typename T>
__device__ __forceinline__ double round_to(double v) {
  return (double)(T)v;
}

// A persistent block walks over (WIN_COLS - 2R) x TILE_H output tiles of
// all planes, tile = blockIdx.x + k * gridDim.x.  While it runs the x pass
// and writes out one tile, the loads of its next tile's window column are
// in flight.  Shared memory: the y pass's result over the tile's rows and
// the window's columns, TILE_H x PITCH doubles; reused to stage the
// outputs.
// Three blocks a multiprocessor up to radius 3 (85 registers a thread),
// two above, where the longer register windows need more.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS, R <= 3 ? 3 : 2)
blur_fused_fixed(const T* __restrict__ in, T* __restrict__ out,
                 const Weights wt, int h, int w, double fill, int tiles_x,
                 int tiles_per_plane, int64_t tiles) {
  constexpr int TW = WIN_COLS - 2 * R;  // output columns of a tile
  constexpr int SPAN = STRIP_Y + 2 * R;  // window rows of a y-pass strip
  // the x pass's last strip reads up to column WIN_COLS + 2R - 1; an odd
  // pitch puts 16 lanes' rows on 16 distinct bank pairs
  constexpr int PITCH = (WIN_COLS + 2 * R) | 1;
  constexpr int STAGE_PITCH = WIN_COLS + 1;  // of T, odd
  extern __shared__ double mid[];
  static_assert(TILE_H * STAGE_PITCH * sizeof(T) <=
                    TILE_H * PITCH * sizeof(double),
                "the output stage must fit in the intermediate's space");
  static_assert((WIN_COLS / STRIP_X) * 32 == THREADS, "x-pass strips");
  static_assert((TILE_H / STRIP_Y) * WIN_COLS == THREADS, "y-pass strips");
  static_assert(SPAN <= 32, "one bit a window row");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t plane_size = (int64_t)h * w;
  // y pass: this thread's window column and first row within a tile
  const int col = tid % WIN_COLS;
  const int row0 = (tid / WIN_COLS) * STRIP_Y;

  // the fetched tile: its origin, this thread's window column strip (raw)
  // and which of its rows lie in the plane (bit i: row i)
  int64_t base = 0;
  int x0 = 0, y0 = 0;
  T raw[SPAN];
  uint32_t in_plane = 0;
  auto fetch = [&](int64_t tile) {
    const int64_t plane = tile / tiles_per_plane;
    const int rest = (int)(tile - plane * tiles_per_plane);
    const int ty = rest / tiles_x;
    y0 = ty * TILE_H;
    x0 = (rest - ty * tiles_x) * TW;
    base = plane * plane_size;
    const int gx = x0 - R + col;
    const int gy0 = y0 + row0 - R;
    const T* p = in + base + (int64_t)gy0 * w + gx;
    in_plane = 0;
    if (gx >= 0 && gx < w && y0 + row0 < h) {
#pragma unroll
      for (int i = 0; i < SPAN; ++i) {
        const int gy = gy0 + i;
        if (gy >= 0 && gy < h) {
          raw[i] = p[(int64_t)i * w];
          in_plane |= 1u << i;
        }
      }
    }
  };

  int64_t tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t dst_base = base;
    const int tx0 = x0, ty0 = y0;
    const int gx = tx0 - R + col;
    __syncthreads();  // the previous tile's stage has been written out

    // y pass: each input widened once; `fill` where the plane ends
    double* mcol = mid + row0 * PITCH + col;
    if (gx < 0 || gx >= w) {
#pragma unroll
      for (int i = 0; i < STRIP_Y; ++i) mcol[i * PITCH] = fill;
    } else if (ty0 + row0 < h) {
      double v[SPAN];
#pragma unroll
      for (int i = 0; i < SPAN; ++i)
        v[i] = (in_plane >> i) & 1u ? (double)raw[i] : fill;
#pragma unroll
      for (int i = 0; i < STRIP_Y; ++i) {
        double acc = __dmul_rn(v[i + R], wt.y[0]);
#pragma unroll
        for (int j = R; j >= 1; --j)
          acc = __dadd_rn(acc, tap_pair(v[i + R - j], v[i + R + j], wt.y[j]));
        mcol[i * PITCH] = round_to<T>(acc);
      }
    }
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    __syncthreads();

    // x pass: lane = tile row, warp = a strip of STRIP_X output columns
    const double* mrow = mid + lane * PITCH + warp * STRIP_X;
    T res[STRIP_X];
    {
      double u[STRIP_X + 2 * R];
#pragma unroll
      for (int k = 0; k < STRIP_X + 2 * R; ++k) u[k] = mrow[k];
#pragma unroll
      for (int i = 0; i < STRIP_X; ++i) {
        double acc = __dmul_rn(u[i + R], wt.x[0]);
#pragma unroll
        for (int j = R; j >= 1; --j)
          acc = __dadd_rn(acc, tap_pair(u[i + R - j], u[i + R + j], wt.x[j]));
        res[i] = (T)acc;
      }
    }
    __syncthreads();  // every intermediate has been read

    T* stage = reinterpret_cast<T*>(mid);
#pragma unroll
    for (int i = 0; i < STRIP_X; ++i)
      stage[lane * STAGE_PITCH + warp * STRIP_X + i] = res[i];
    __syncthreads();

    // write the tile out: warps over rows, lanes over columns
#pragma unroll
    for (int r = warp; r < TILE_H; r += THREADS / 32) {
      const int gy = ty0 + r;
      if (gy >= h) break;
      T* drow = out + dst_base + (int64_t)gy * w + tx0;
#pragma unroll
      for (int c = lane; c < TW; c += 32)
        if (tx0 + c < w) drow[c] = stage[r * STAGE_PITCH + c];
    }
  }
}

// One block: one GEN_TILE x GEN_TILE output tile of one plane, radii given
// at run time.  Shared memory: the weights, the input window with its halo
// (fill in the out-of-plane slots), then the y pass's result over the
// tile's rows and the window's columns, all double.
template <typename T>
__global__ void blur_fused_generic(const T* __restrict__ in,
                                   T* __restrict__ out, const Weights wt,
                                   int64_t n, int h, int w, int ry, int rx,
                                   double fill) {
  extern __shared__ double smem[];
  const int win_w = GEN_TILE + 2 * rx;
  const int win_h = GEN_TILE + 2 * ry;
  double* wy = smem;
  double* wx = wy + FUSED_MAX_RADIUS + 1;
  double* win = wx + FUSED_MAX_RADIUS + 1;
  double* mid = win + win_h * win_w;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  if (tx == 0 && ty == 0) {
#pragma unroll
    for (int j = 0; j <= FUSED_MAX_RADIUS; ++j) {
      wy[j] = wt.y[j];
      wx[j] = wt.x[j];
    }
  }
  const int y0 = blockIdx.y * GEN_TILE;
  const int x0 = blockIdx.x * GEN_TILE;
  const int64_t plane_size = (int64_t)h * w;

  for (int64_t plane = blockIdx.z; plane < n; plane += gridDim.z) {
    const T* src = in + plane * plane_size;
    T* dst = out + plane * plane_size;
    __syncthreads();  // weights stored; the previous plane's window consumed
    for (int r = ty; r < win_h; r += GEN_THREADS_Y) {
      const int gy = y0 - ry + r;
      for (int c = tx; c < win_w; c += GEN_TILE) {
        const int gx = x0 - rx + c;
        win[r * win_w + c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                                 ? (double)src[(int64_t)gy * w + gx]
                                 : fill;
      }
    }
    __syncthreads();
    for (int r = ty; r < GEN_TILE; r += GEN_THREADS_Y) {
      for (int c = tx; c < win_w; c += GEN_TILE) {
        const int gx = x0 - rx + c;
        double v = fill;
        if (gx >= 0 && gx < w) {
          const double* colp = win + (r + ry) * win_w + c;
          double acc = __dmul_rn(colp[0], wy[0]);
          for (int j = ry; j >= 1; --j)
            acc = __dadd_rn(acc, tap_pair(colp[-j * win_w], colp[j * win_w], wy[j]));
          v = round_to<T>(acc);
        }
        mid[r * win_w + c] = v;
      }
    }
    __syncthreads();
    const int gx = x0 + tx;
    for (int r = ty; r < GEN_TILE; r += GEN_THREADS_Y) {
      const int gy = y0 + r;
      if (gy >= h || gx >= w) continue;
      const double* rowp = mid + r * win_w + tx + rx;
      double acc = __dmul_rn(rowp[0], wx[0]);
      for (int j = rx; j >= 1; --j)
        acc = __dadd_rn(acc, tap_pair(rowp[-j], rowp[j], wx[j]));
      dst[(int64_t)gy * w + gx] = (T)acc;
    }
  }
}

// The large-radius shape: one 1-D pass per launch.  A block of 32 x 8
// threads computes `chunk` outputs along the pass axis for 32 (y pass) or
// 8 (x pass) lines across it.  With `staged`, the window (the chunk and
// its 2r halo) is first copied into shared memory as double with `fill`
// in the out-of-plane slots, and the taps read it untested; without (a
// radius too large for shared memory), the taps read device memory, each
// tested against the plane.  No index is divided at run time.
template <typename T, bool ALONG_Y>
__global__ void blur_pass(const T* __restrict__ in, T* __restrict__ out,
                          const double* __restrict__ weights, int64_t n,
                          int h, int w, int radius, int chunk, int staged,
                          double fill) {
  extern __shared__ double win[];
  // along: the pass axis; across: the other one
  const int extent = ALONG_Y ? h : w;
  const int across_extent = ALONG_Y ? w : h;
  const int64_t along_step = ALONG_Y ? w : 1;
  const int64_t across_step = ALONG_Y ? 1 : w;
  const int lane_along = ALONG_Y ? threadIdx.y : threadIdx.x;
  const int lanes_along = ALONG_Y ? blockDim.y : blockDim.x;
  const int lane_across = ALONG_Y ? threadIdx.x : threadIdx.y;
  const int p0 = (ALONG_Y ? blockIdx.y : blockIdx.x) * chunk;
  const int q = (ALONG_Y ? blockIdx.x * blockDim.x : blockIdx.y * blockDim.y) +
                lane_across;
  const int span = chunk + 2 * radius;
  // the window of this thread's line: element k is position p0 - r + k
  const int64_t win_step = ALONG_Y ? blockDim.x : 1;
  double* line = win + (ALONG_Y ? lane_across : (int64_t)lane_across * span);
  const int64_t plane_size = (int64_t)h * w;
  const bool q_in = q < across_extent;

  for (int64_t plane = blockIdx.z; plane < n; plane += gridDim.z) {
    const T* src = in + plane * plane_size + (int64_t)q * across_step;
    T* dst = out + plane * plane_size + (int64_t)q * across_step;
    if (staged) {
      __syncthreads();  // the previous plane's window consumed
      for (int k = lane_along; k < span; k += lanes_along) {
        const int p = p0 - radius + k;
        line[k * win_step] = (q_in && p >= 0 && p < extent)
                                 ? (double)src[(int64_t)p * along_step]
                                 : fill;
      }
      __syncthreads();
    }
    if (!q_in) continue;
    for (int k = lane_along; k < chunk; k += lanes_along) {
      const int p = p0 + k;
      if (p >= extent) break;
      double acc;
      if (staged) {
        const double* c = line + (int64_t)(k + radius) * win_step;
        acc = __dmul_rn(c[0], weights[0]);
        for (int j = radius; j >= 1; --j)
          acc = __dadd_rn(acc, tap_pair(c[-j * win_step], c[j * win_step],
                                        weights[j]));
      } else {
        const T* c = src + (int64_t)p * along_step;
        acc = __dmul_rn((double)c[0], weights[0]);
        for (int j = radius; j >= 1; --j) {
          const double a = p - j >= 0 ? (double)c[-j * along_step] : fill;
          const double b = p + j < extent ? (double)c[j * along_step] : fill;
          acc = __dadd_rn(acc, tap_pair(a, b, weights[j]));
        }
      }
      dst[(int64_t)p * along_step] = (T)acc;
    }
  }
}

int max_shared_bytes() {
  // cached as resident is in launch_fixed: safe on a first call from two
  // threads at once
  static std::atomic<int> cached{0};
  int bytes = cached.load(std::memory_order_relaxed);
  if (bytes == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess)
      bytes = SMALL_SMEM;
    cached.store(bytes, std::memory_order_relaxed);
  }
  return bytes;
}

template <typename KernelT>
int allow_shared(KernelT kernel, size_t bytes) {
  if (bytes <= (size_t)SMALL_SMEM) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

unsigned planes_in_grid(int64_t n) {
  return (unsigned)(n < MAX_GRID_YZ ? n : MAX_GRID_YZ);
}

template <typename T, int R>
int launch_fixed(const T* src, T* dst, const Weights& wt, int64_t n, int h,
                 int w, double fill, cudaStream_t s) {
  constexpr int TW = WIN_COLS - 2 * R;
  constexpr size_t smem = sizeof(double) * TILE_H * ((WIN_COLS + 2 * R) | 1);
  static_assert(smem <= (size_t)SMALL_SMEM, "fixed-radius tile fits 48 KB");
  const int64_t tiles_x = ((int64_t)w + TW - 1) / TW;
  const int64_t tiles_per_plane = tiles_x * (((int64_t)h + TILE_H - 1) / TILE_H);
  if (tiles_per_plane >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int64_t tiles = n * tiles_per_plane;
  // as many blocks as fit on the card at once, each walking over tiles;
  // the count is cached in an atomic: two threads that launch first at
  // the same time both compute it and store the same value
  static std::atomic<int> cached_resident{0};
  int resident = cached_resident.load(std::memory_order_relaxed);
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, blur_fused_fixed<T, R>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_resident.store(resident, std::memory_order_relaxed);
  }
  const int64_t blocks = tiles < resident ? tiles : resident;
  blur_fused_fixed<T, R><<<(unsigned)blocks, THREADS, smem, s>>>(
      src, dst, wt, h, w, fill, (int)tiles_x, (int)tiles_per_plane, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const T* src, T* dst, const Weights& wt, int64_t n, int h,
                 int w, int ry, int rx, double fill, cudaStream_t s) {
  if (ry == rx) {
    switch (ry) {
      case 1: return launch_fixed<T, 1>(src, dst, wt, n, h, w, fill, s);
      case 2: return launch_fixed<T, 2>(src, dst, wt, n, h, w, fill, s);
      case 3: return launch_fixed<T, 3>(src, dst, wt, n, h, w, fill, s);
      case 4: return launch_fixed<T, 4>(src, dst, wt, n, h, w, fill, s);
      case 5: return launch_fixed<T, 5>(src, dst, wt, n, h, w, fill, s);
      case 6: return launch_fixed<T, 6>(src, dst, wt, n, h, w, fill, s);
      case 7: return launch_fixed<T, 7>(src, dst, wt, n, h, w, fill, s);
      case 8: return launch_fixed<T, 8>(src, dst, wt, n, h, w, fill, s);
      default: break;  // radius 0: the generic kernel
    }
  }
  const int64_t tiles_y = ((int64_t)h + GEN_TILE - 1) / GEN_TILE;
  if (tiles_y > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(double) * (2 * (FUSED_MAX_RADIUS + 1) +
                        (size_t)(GEN_TILE + 2 * ry) * (GEN_TILE + 2 * rx) +
                        (size_t)GEN_TILE * (GEN_TILE + 2 * rx));
  int err = allow_shared(blur_fused_generic<T>, smem);
  if (err != (int)cudaSuccess) return err;
  dim3 block(GEN_TILE, GEN_THREADS_Y);
  dim3 grid((w + GEN_TILE - 1) / GEN_TILE, (unsigned)tiles_y,
            planes_in_grid(n));
  blur_fused_generic<T><<<grid, block, smem, s>>>(src, dst, wt, n, h, w, ry,
                                                  rx, fill);
  return (int)cudaGetLastError();
}

// One pass of the large-radius shape: 32 x 8 threads; the chunk along the
// pass axis shrinks until the staged window fits in shared memory, and a
// window that does not fit even then is not staged.
template <typename T, bool ALONG_Y>
int launch_pass(const T* src, T* dst, const double* weights, int64_t n,
                int h, int w, int radius, double fill, cudaStream_t s) {
  const int lines = ALONG_Y ? 32 : 8;  // lines across the pass per block
  int chunk = ALONG_Y ? 64 : 128;
  const size_t limit = (size_t)max_shared_bytes();
  size_t smem = 0;
  int staged = 0;
  for (; chunk >= 8; chunk /= 2) {
    smem = sizeof(double) * (size_t)lines * (chunk + 2 * (size_t)radius);
    if (smem <= limit) {
      staged = 1;
      break;
    }
  }
  if (!staged) {
    chunk = ALONG_Y ? 64 : 128;
    smem = 0;
  }
  const int along = ALONG_Y ? h : w;
  const int across = ALONG_Y ? w : h;
  const int64_t chunks = ((int64_t)along + chunk - 1) / chunk;
  const int64_t groups = ((int64_t)across + lines - 1) / lines;
  if ((ALONG_Y ? chunks : groups) > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  int err = allow_shared(blur_pass<T, ALONG_Y>, smem);
  if (err != (int)cudaSuccess) return err;
  dim3 block(32, 8);
  dim3 grid(ALONG_Y ? (unsigned)groups : (unsigned)chunks,
            ALONG_Y ? (unsigned)chunks : (unsigned)groups, planes_in_grid(n));
  blur_pass<T, ALONG_Y><<<grid, block, smem, s>>>(src, dst, weights, n, h, w,
                                                  radius, chunk, staged, fill);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, void* scratch, const double* host_weights,
           const void* device_weights, int64_t n, int h, int w, int ry, int rx,
           double fill, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (ry < 0 || rx < 0) return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (ry <= FUSED_MAX_RADIUS && rx <= FUSED_MAX_RADIUS) {
    if (host_weights == nullptr) return (int)cudaErrorInvalidValue;
    Weights wt = {};
    for (int j = 0; j <= ry; ++j) wt.y[j] = host_weights[j];
    for (int j = 0; j <= rx; ++j) wt.x[j] = host_weights[ry + 1 + j];
    return launch_fused<T>(src, dst, wt, n, h, w, ry, rx, fill, s);
  }
  if (scratch == nullptr || device_weights == nullptr)
    return (int)cudaErrorInvalidValue;
  const double* wts = static_cast<const double*>(device_weights);
  T* mid = static_cast<T*>(scratch);
  int err = launch_pass<T, true>(src, mid, wts, n, h, w, ry, fill, s);
  if (err != (int)cudaSuccess) return err;
  return launch_pass<T, false>(mid, dst, wts + ry + 1, n, h, w, rx, fill, s);
}

}  // namespace

extern "C" {

// The largest radius the fused launch takes; above it the caller must
// pass an N x H x W scratch buffer of the data type and the weights on
// the device.
int gaussian_blur_fused_max_radius() { return FUSED_MAX_RADIUS; }

const char* gaussian_blur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// weights: [wy(ry+1), wx(rx+1)], w[j] the weight of the taps at +-j;
// `host_weights` in host memory (read by the fused launch, passed to the
// kernel by value), `device_weights` the same values on the device (read
// by the two-pass launch; may be NULL when both radii take the fused one).
int gaussian_blur_f32(const void* in, void* out, void* scratch,
                      const double* host_weights, const void* device_weights,
                      int64_t n, int h, int w, int ry, int rx, double fill,
                      void* stream) {
  return launch<float>(in, out, scratch, host_weights, device_weights, n, h, w,
                       ry, rx, fill, stream);
}

int gaussian_blur_f64(const void* in, void* out, void* scratch,
                      const double* host_weights, const void* device_weights,
                      int64_t n, int h, int w, int ry, int rx, double fill,
                      void* stream) {
  return launch<double>(in, out, scratch, host_weights, device_weights, n, h,
                        w, ry, rx, fill, stream);
}

// An integer frame as double (see TruncDouble): each pass's result is
// truncated toward zero, so `out` holds the integers scipy stores.
int gaussian_blur_trunc_f64(const void* in, void* out, void* scratch,
                            const double* host_weights,
                            const void* device_weights, int64_t n, int h,
                            int w, int ry, int rx, double fill, void* stream) {
  return launch<TruncDouble>(in, out, scratch, host_weights, device_weights, n,
                             h, w, ry, rx, fill, stream);
}

}  // extern "C"
