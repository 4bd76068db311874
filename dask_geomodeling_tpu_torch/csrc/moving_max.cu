// Circular-footprint moving maximum, for sm_90a.
//
// Replaces the Pallas TPU kernel moving_max_pallas
// (dask_geomodeling_tpu/ops/pallas_stencils.py:136).  Same contract as the
// plain torch version moving_max_reference
// (dask_geomodeling_tpu_torch/ops/stencils.py), bit for bit: over N
// contiguous H x W planes, each output pixel is the maximum of the input
// over the circular footprint of diameter `size` (odd) centred on it, the
// taps (dx, dy) with 4 (dx^2 + dy^2) < size^2, which is get_footprint's
// (x^2 + y^2) < (size / 2)^2 in integers.  Taps outside the plane are the
// type's lowest value, as in the reference.  A NaN in a window gives NaN,
// as torch.maximum and jnp.maximum do (take_max below); NaN-propagating
// maximum is associative and commutative, so the order in which the taps
// are combined does not change the result.  The maximum of values of one
// type is one of them, so the kernel works in the input's own type, every
// integer and float width, where the TPU kernel widened to f32 or i32.
//
// What bounds it: device memory.  Each plane is read once and written
// once: at the stencils path's shape, (64, 526, 526) float32, that is
// 2 x 70.8 MB per launch, 42 us at 3.35 TB/s; the comparisons are far
// below the card's rate.  Design, for the sizes 3, 5 and 7 (template
// constants, so loops unroll and the footprint folds into the code):
//
// - A block stages its output tile and a radius-wide halo in shared memory
//   from one coalesced pass of loads (scalar loads: a 526-wide float32 row is only
//   8-byte aligned), with the type's lowest value in the out-of-plane
//   slots, so no tap is tested.
// - The footprint is a set of row runs (ops/stencils.py:footprint_runs),
//   each of half-width k(dy).  Each thread owns one window column and a
//   strip of rows.  For every window row it takes the horizontal maxima
//   over [-k, k] for each distinct k, growing k by one pair at a time,
//   and keeps them in registers; each output is then the maximum of one
//   such value per footprint row down its column.  At size 3 that is 2 + 2
//   comparisons an output instead of 8.  The horizontal maxima never leave
//   registers.
// - A thread computes 16 outputs, and a tile is 32 x 128.  The grid is
//   persistent (as many blocks as fit on the card, each walking over
//   tiles), and a block loads its next tile's window into registers while
//   it computes the current one, so device memory stays busy.
//
// Other sizes take a generic kernel: one thread per output reading its
// taps through the cache, one row run per footprint row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_GRID_YZ = 65535;

// the fixed-size launch
constexpr int THREADS = 256;
constexpr int TILE_W = 128;  // output columns of a tile: one thread each
constexpr int STRIP = 16;    // output rows a thread computes
constexpr int TILE_H = STRIP * THREADS / TILE_W;

// the generic launch
constexpr int GEN_THREADS_X = 32;
constexpr int GEN_THREADS_Y = 8;

// max that keeps a NaN once seen (v != v only for a NaN)
template <typename T>
__device__ __forceinline__ T take_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// the half-width of the footprint's row at dy: the largest dx with
// 4 (dx^2 + dy^2) < size^2 (every row within the radius holds dx = 0)
__host__ __device__ constexpr int half_width(int size, int dy) {
  int k = size / 2;
  while (k > 0 && 4 * (k * k + dy * dy) >= size * size) --k;
  return k;
}

// A persistent block walks over TILE_W x TILE_H output tiles of all planes,
// tile = blockIdx.x + k * gridDim.x.  Its threads hold the next tile's
// window in registers (loaded while the current tile is computed) and
// store it to shared memory when the current one is done.
template <typename T, int SIZE>
__global__ void __launch_bounds__(THREADS)
moving_max_fixed(const T* __restrict__ in, T* __restrict__ out, int h, int w,
                 T lowest, int tiles_x, int tiles_per_plane, int64_t tiles) {
  constexpr int R = SIZE / 2;
  constexpr int WIN_W = TILE_W + 2 * R;
  constexpr int WIN_H = TILE_H + 2 * R;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS = (WIN_H + WARPS - 1) / WARPS;  // window rows a warp loads
  constexpr int COLS = (WIN_W + 31) / 32;            // window columns a lane loads
  __shared__ T win[WIN_H][WIN_W];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t plane_size = (int64_t)h * w;
  const int col = tid % TILE_W;
  const int row0 = (tid / TILE_W) * STRIP;

  // the fetched tile: its origin and this thread's share of its window,
  // the type's lowest value where the window leaves the plane
  int64_t base = 0;
  int x0 = 0, y0 = 0;
  T raw[ROWS][COLS];
  auto fetch = [&](int64_t tile) {
    const int64_t plane = tile / tiles_per_plane;
    const int rest = (int)(tile - plane * tiles_per_plane);
    const int ty = rest / tiles_x;
    y0 = ty * TILE_H;
    x0 = (rest - ty * tiles_x) * TILE_W;
    base = plane * plane_size;
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int gy = y0 - R + warp + a * WARPS;
      const bool row_in = gy >= 0 && gy < h;
      const T* srow = in + base + (int64_t)gy * w;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        const int gx = x0 - R + lane + b * 32;
        raw[a][b] = (row_in && gx >= 0 && gx < w) ? srow[gx] : lowest;
      }
    }
  };

  int64_t tile = blockIdx.x;
  if (tile < tiles) fetch(tile);
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t dst_base = base;
    const int tx0 = x0, ty0 = y0;
    __syncthreads();  // the previous tile's window consumed
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int r = warp + a * WARPS;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        const int c = lane + b * 32;
        if (r < WIN_H && c < WIN_W) win[r][c] = raw[a][b];
      }
    }
    __syncthreads();
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    if (tx0 + col >= w || ty0 + row0 >= h) continue;

    // hmax[k][i]: the maximum over [-k, k] around this column in window
    // row row0 + i (k = 0 is the column itself); output o is ready once
    // row o + 2R is, so only 2R + 1 rows of it are live at a time
    T hmax[R + 1][STRIP + 2 * R];
    T* drow = out + dst_base + (int64_t)(ty0 + row0) * w + tx0 + col;
#pragma unroll
    for (int i = 0; i < STRIP + 2 * R; ++i) {
      const T* centre = &win[row0 + i][col + R];
      T m = centre[0];
      hmax[0][i] = m;
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        m = take_max(take_max(m, centre[-k]), centre[k]);
        hmax[k][i] = m;
      }
      const int o = i - 2 * R;
      if (o >= 0 && ty0 + row0 + o < h) {
        T v = hmax[half_width(SIZE, 0)][o + R];
#pragma unroll
        for (int dy = 1; dy <= R; ++dy) {
          v = take_max(v, hmax[half_width(SIZE, dy)][o + R - dy]);
          v = take_max(v, hmax[half_width(SIZE, dy)][o + R + dy]);
        }
        drow[(int64_t)o * w] = v;
      }
    }
  }
}

// one thread per output pixel, taps read through the cache
template <typename T>
__global__ void moving_max_generic(const T* __restrict__ in,
                                   T* __restrict__ out, int64_t n, int h,
                                   int w, int size) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int radius = size / 2;
  const int64_t plane_size = (int64_t)h * w;
  for (int64_t plane = blockIdx.z; plane < n; plane += gridDim.z) {
    const T* src = in + plane * plane_size;
    T m = src[(int64_t)y * w + x];
    for (int dy = -radius; dy <= radius; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      const int k = half_width(size, dy);
      const int lo = x - k < 0 ? 0 : x - k;
      const int hi = x + k >= w ? w - 1 : x + k;
      const T* row = src + (int64_t)yy * w;
      for (int xx = lo; xx <= hi; ++xx) m = take_max(m, row[xx]);
    }
    out[plane * plane_size + (int64_t)y * w + x] = m;
  }
}

unsigned planes_in_grid(int64_t n) {
  return (unsigned)(n < MAX_GRID_YZ ? n : MAX_GRID_YZ);
}

template <typename T, int SIZE>
int launch_fixed(const T* src, T* dst, int64_t n, int h, int w, T lowest,
                 cudaStream_t s) {
  const int64_t tiles_x = ((int64_t)w + TILE_W - 1) / TILE_W;
  const int64_t tiles_per_plane = tiles_x * (((int64_t)h + TILE_H - 1) / TILE_H);
  if (tiles_per_plane >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int64_t tiles = n * tiles_per_plane;
  // as many blocks as fit on the card at once, each walking over tiles
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, moving_max_fixed<T, SIZE>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t blocks = tiles < resident ? tiles : resident;
  moving_max_fixed<T, SIZE><<<(unsigned)blocks, THREADS, 0, s>>>(
      src, dst, h, w, lowest, (int)tiles_x, (int)tiles_per_plane, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, int64_t n, int h, int w, int size,
           T lowest, cudaStream_t s) {
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  switch (size) {
    case 3: return launch_fixed<T, 3>(src, dst, n, h, w, lowest, s);
    case 5: return launch_fixed<T, 5>(src, dst, n, h, w, lowest, s);
    case 7: return launch_fixed<T, 7>(src, dst, n, h, w, lowest, s);
    default: break;
  }
  const int64_t blocks_y = ((int64_t)h + GEN_THREADS_Y - 1) / GEN_THREADS_Y;
  if (blocks_y > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  dim3 block(GEN_THREADS_X, GEN_THREADS_Y);
  dim3 grid((w + GEN_THREADS_X - 1) / GEN_THREADS_X, (unsigned)blocks_y,
            planes_in_grid(n));
  moving_max_generic<T><<<grid, block, 0, s>>>(src, dst, n, h, w, size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* moving_max_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// type codes: 0 float32, 1 float64, 2 int8, 3 int16, 4 int32, 5 int64,
// 6 uint8, 7 uint16, 8 uint32, 9 uint64.  `size` must be odd and >= 1.
int moving_max(const void* in, void* out, int64_t n, int h, int w, int size,
               int type_code, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (size < 1 || size % 2 == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0: return launch<float>(in, out, n, h, w, size, -INFINITY, s);
    case 1: return launch<double>(in, out, n, h, w, size, -(double)INFINITY, s);
    case 2: return launch<int8_t>(in, out, n, h, w, size, INT8_MIN, s);
    case 3: return launch<int16_t>(in, out, n, h, w, size, INT16_MIN, s);
    case 4: return launch<int32_t>(in, out, n, h, w, size, INT32_MIN, s);
    case 5: return launch<int64_t>(in, out, n, h, w, size, INT64_MIN, s);
    case 6: return launch<uint8_t>(in, out, n, h, w, size, 0, s);
    case 7: return launch<uint16_t>(in, out, n, h, w, size, 0, s);
    case 8: return launch<uint32_t>(in, out, n, h, w, size, 0, s);
    case 9: return launch<uint64_t>(in, out, n, h, w, size, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
