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
// Taps outside the plane read the double `fill`, as scipy pads with cval.
//
// What bounds it: device memory.  At the main path's radius 3 a plane is
// read once and written once (2 x 4 bytes per pixel for float32); the
// double arithmetic (about 2r+1 flops per tap pass) stays far below the
// card's FP64 rate.  The fused launch keeps the intermediate between the
// passes in shared memory, as the TPU kernel kept it in VMEM, so it never
// crosses HBM.  Above FUSED_MAX_RADIUS (zoom-mode Smooth, sigma of tens of
// pixels) the halo would crowd out the tile, so a second launch shape
// runs the two passes through a global scratch buffer that the caller
// allocates.
//
// Layout: N contiguous planes of H x W.  Weights: one double buffer on
// the device, [wy(2*ry+1), wx(2*rx+1)], centre of each at index r.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;             // output tile edge of the fused launch
constexpr int FUSED_MAX_RADIUS = 8;  // sigma <= 2: every exact-mode Smooth
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ double tap_pair(double a, double b, double w) {
  return __dmul_rn(__dadd_rn(a, b), w);
}

// One block: one TILE x TILE output tile of one plane (planes strided
// over gridDim.z).  Shared memory: the input window with its halo, then
// the y-pass result for the tile's rows over the window's columns.
template <typename T>
__global__ void blur_fused(const T* __restrict__ in, T* __restrict__ out,
                           const double* __restrict__ weights, int64_t n,
                           int h, int w, int ry, int rx, double fill) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double sw[2 * (2 * FUSED_MAX_RADIUS + 1)];
  const int win_w = TILE + 2 * rx;
  const int win_h = TILE + 2 * ry;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* mid = win + win_h * win_w;
  const double* wy = sw + ry;                   // wy[j], j in [-ry, ry]
  const double* wx = sw + (2 * ry + 1) + rx;    // wx[j], j in [-rx, rx]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int n_weights = 2 * ry + 1 + 2 * rx + 1;
  for (int i = tid; i < n_weights; i += nthreads) sw[i] = weights[i];

  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int64_t plane_size = (int64_t)h * w;

  for (int64_t plane = blockIdx.z; plane < n; plane += gridDim.z) {
    const T* src = in + plane * plane_size;
    T* dst = out + plane * plane_size;
    __syncthreads();  // weights loaded; previous plane's window consumed
    for (int i = tid; i < win_h * win_w; i += nthreads) {
      const int gy = y0 - ry + i / win_w;
      const int gx = x0 - rx + i % win_w;
      T v = T(0);  // out-of-plane slots are never read: taps test bounds
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = src[(int64_t)gy * w + gx];
      win[i] = v;
    }
    __syncthreads();

    // y pass over the tile's rows and every in-plane window column
    for (int i = tid; i < TILE * win_w; i += nthreads) {
      const int ty = i / win_w;
      const int cx = i % win_w;
      const int gy = y0 + ty;
      const int gx = x0 - rx + cx;
      if (gy >= h || gx < 0 || gx >= w) continue;
      const T* col = win + (ty + ry) * win_w + cx;
      double acc = __dmul_rn((double)col[0], wy[0]);
      for (int j = ry; j >= 1; --j) {
        const double above = gy - j >= 0 ? (double)col[-j * win_w] : fill;
        const double below = gy + j < h ? (double)col[j * win_w] : fill;
        acc = __dadd_rn(acc, tap_pair(above, below, wy[j]));
      }
      mid[ty * win_w + cx] = (T)acc;
    }
    __syncthreads();

    // x pass into the output
    for (int i = tid; i < TILE * TILE; i += nthreads) {
      const int ty = i / TILE;
      const int tx = i % TILE;
      const int gy = y0 + ty;
      const int gx = x0 + tx;
      if (gy >= h || gx >= w) continue;
      const T* row = mid + ty * win_w + tx + rx;
      double acc = __dmul_rn((double)row[0], wx[0]);
      for (int j = rx; j >= 1; --j) {
        const double left = gx - j >= 0 ? (double)row[-j] : fill;
        const double right = gx + j < w ? (double)row[j] : fill;
        acc = __dadd_rn(acc, tap_pair(left, right, wx[j]));
      }
      dst[(int64_t)gy * w + gx] = (T)acc;
    }
  }
}

// The large-radius shape: one 1-D pass per launch, one thread per output
// pixel, taps read straight from global memory (neighbouring threads read
// neighbouring addresses in both passes).  `step` is the element stride
// of the pass's axis (w for the y pass, 1 for the x pass) and `extent`
// its length.
template <typename T>
__global__ void blur_pass(const T* __restrict__ in, T* __restrict__ out,
                          const double* __restrict__ weights, int64_t n,
                          int h, int w, int radius, int along_y,
                          double fill) {
  const int64_t total = n * (int64_t)h * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int x = (int)(i % w);
    const int y = (int)((i / w) % h);
    const int pos = along_y ? y : x;
    const int extent = along_y ? h : w;
    const int64_t step = along_y ? w : 1;
    const T* c = in + i;
    double acc = __dmul_rn((double)c[0], weights[radius]);
    for (int j = radius; j >= 1; --j) {
      const double a = pos - j >= 0 ? (double)c[-j * step] : fill;
      const double b = pos + j < extent ? (double)c[j * step] : fill;
      acc = __dadd_rn(acc, tap_pair(a, b, weights[radius + j]));
    }
    out[i] = (T)acc;
  }
}

template <typename T>
int launch(const void* in, void* out, void* scratch, const void* weights,
           int64_t n, int h, int w, int ry, int rx, double fill,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (ry < 0 || rx < 0) return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const double* wts = static_cast<const double*>(weights);
  if (ry <= FUSED_MAX_RADIUS && rx <= FUSED_MAX_RADIUS) {
    dim3 block(THREADS_X, THREADS_Y);
    dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE,
              (unsigned)(n < MAX_GRID_Z ? n : MAX_GRID_Z));
    const size_t smem =
        sizeof(T) * ((size_t)(TILE + 2 * ry) * (TILE + 2 * rx) +
                     (size_t)TILE * (TILE + 2 * rx));
    blur_fused<T><<<grid, block, smem, s>>>(src, dst, wts, n, h, w, ry, rx,
                                            fill);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  T* mid = static_cast<T*>(scratch);
  const int threads = 256;
  const int64_t total = n * (int64_t)h * w;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  blur_pass<T><<<blocks, threads, 0, s>>>(src, mid, wts, n, h, w, ry, 1, fill);
  int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  blur_pass<T><<<blocks, threads, 0, s>>>(mid, dst, wts + 2 * ry + 1, n, h, w,
                                          rx, 0, fill);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest radius the fused launch takes; above it the caller must
// pass an N x H x W scratch buffer of the data type.
int gaussian_blur_fused_max_radius() { return FUSED_MAX_RADIUS; }

const char* gaussian_blur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gaussian_blur_f32(const void* in, void* out, void* scratch,
                      const void* weights, int64_t n, int h, int w, int ry,
                      int rx, double fill, void* stream) {
  return launch<float>(in, out, scratch, weights, n, h, w, ry, rx, fill,
                       stream);
}

int gaussian_blur_f64(const void* in, void* out, void* scratch,
                      const void* weights, int64_t n, int h, int w, int ry,
                      int rx, double fill, void* stream) {
  return launch<double>(in, out, scratch, weights, n, h, w, ry, rx, fill,
                        stream);
}

}  // extern "C"
