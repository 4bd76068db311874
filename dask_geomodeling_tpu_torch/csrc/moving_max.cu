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
// type's lowest value in the reference; since every window holds its
// centre, the kernel skips them instead.  A NaN in a window gives NaN, as
// torch.maximum and jnp.maximum do.  The maximum of values of one type is
// one of them, so the kernel works in the input's own type, every integer
// and float width, where the TPU kernel widened to f32 or i32.
//
// What bounds it: device memory.  Each plane is read once and written
// once: at the stencils path's shape, (64, 526, 526) float32, that is
// 2 x 70.8 MB per batch, 42 us at 3.35 TB/s.  The taps (9 for size 3) are
// comparisons, far below the card's rate.  Design: one thread per output
// pixel, a warp over 32 neighbouring columns, so each tap row is one
// coalesced load; a tap row's neighbouring windows overlap, and the
// repeats are served from L1/L2 rather than device memory.  A shared-
// memory tile with its halo (as gaussian_blur.cu has) would cut the
// cache traffic further; that is left to the kernel's redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int MAX_GRID_YZ = 65535;

// max that keeps a NaN once seen (v != v only for a NaN)
template <typename T>
__device__ __forceinline__ T take_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

template <typename T>
__global__ void moving_max_kernel(const T* __restrict__ in,
                                  T* __restrict__ out, int64_t n, int h,
                                  int w, int size) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int radius = size / 2;
  const int limit = size * size;
  const int64_t plane_size = (int64_t)h * w;
  for (int64_t plane = blockIdx.z; plane < n; plane += gridDim.z) {
    const T* src = in + plane * plane_size;
    T m = src[(int64_t)y * w + x];
    for (int dy = -radius; dy <= radius; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      const T* row = src + (int64_t)yy * w;
      for (int dx = -radius; dx <= radius; ++dx) {
        const int xx = x + dx;
        if (4 * (dx * dx + dy * dy) >= limit || xx < 0 || xx >= w) continue;
        m = take_max(m, row[xx]);
      }
    }
    out[plane * plane_size + (int64_t)y * w + x] = m;
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t n, int h, int w, int size,
           cudaStream_t stream) {
  const unsigned blocks_y = (unsigned)((h + THREADS_Y - 1) / THREADS_Y);
  if (blocks_y > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  dim3 block(THREADS_X, THREADS_Y);
  dim3 grid((w + THREADS_X - 1) / THREADS_X, blocks_y,
            (unsigned)(n < MAX_GRID_YZ ? n : MAX_GRID_YZ));
  moving_max_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, h, w, size);
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
    case 0: return launch<float>(in, out, n, h, w, size, s);
    case 1: return launch<double>(in, out, n, h, w, size, s);
    case 2: return launch<int8_t>(in, out, n, h, w, size, s);
    case 3: return launch<int16_t>(in, out, n, h, w, size, s);
    case 4: return launch<int32_t>(in, out, n, h, w, size, s);
    case 5: return launch<int64_t>(in, out, n, h, w, size, s);
    case 6: return launch<uint8_t>(in, out, n, h, w, size, s);
    case 7: return launch<uint16_t>(in, out, n, h, w, size, s);
    case 8: return launch<uint32_t>(in, out, n, h, w, size, s);
    case 9: return launch<uint64_t>(in, out, n, h, w, size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
