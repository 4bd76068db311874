// Scanline polygon rasterizer (native core of geo/rasterize.py).
//
// The port's copy of dask_geomodeling_tpu/native/rasterize.cpp: burns the
// polygonal features of Rasterize and AggregateRaster's host path (GDAL's
// RasterizeLayer in the reference).
//
// Convention identical to GDAL's default: a pixel is burned when its center
// is inside the polygon (even-odd rule over all rings); later features
// overwrite earlier ones.
//
// The Python layer ships flat coordinate arrays:
//   coords:      (total_vertices * 2) doubles, x0 y0 x1 y1 ...
//   ring_sizes:  vertex count per ring
//   ring_counts: ring count per feature
//
// Exposed with plain C linkage for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
    double x1, y1, x2, y2;
};

// Collect crossing x-coordinates of all edges with the horizontal line y=yc.
inline void scanline_crossings(const std::vector<Edge>& edges, double yc,
                               std::vector<double>& xs) {
    xs.clear();
    for (const Edge& e : edges) {
        bool down = e.y1 > yc && e.y2 <= yc;
        bool up = e.y2 > yc && e.y1 <= yc;
        if (down || up) {
            xs.push_back(e.x1 + (yc - e.y1) * (e.x2 - e.x1) / (e.y2 - e.y1));
        }
    }
    std::sort(xs.begin(), xs.end());
}

// Burn a single feature's rings into the value grid.
template <typename T>
void burn_feature(const double* coords, const int64_t* ring_sizes,
                  int64_t n_rings, T value, T* out, int64_t height,
                  int64_t width, double x0, double px_w, double y0,
                  double px_h) {
    std::vector<Edge> edges;
    double ymin = 1e300, ymax = -1e300;
    const double* p = coords;
    for (int64_t r = 0; r < n_rings; ++r) {
        int64_t n = ring_sizes[r];
        for (int64_t i = 0; i + 1 < n; ++i) {
            Edge e{p[2 * i], p[2 * i + 1], p[2 * i + 2], p[2 * i + 3]};
            if (e.y1 != e.y2) edges.push_back(e);
            ymin = std::min({ymin, e.y1, e.y2});
            ymax = std::max({ymax, e.y1, e.y2});
        }
        p += 2 * n;
    }
    if (edges.empty()) return;

    std::vector<double> xs;
    for (int64_t row = 0; row < height; ++row) {
        double yc = y0 + px_h * (row + 0.5);  // px_h is negative (north-up)
        if (yc < ymin || yc > ymax) continue;
        scanline_crossings(edges, yc, xs);
        for (size_t k = 0; k + 1 < xs.size(); k += 2) {
            // pixel centers inside [xs[k], xs[k+1])
            int64_t lo = (int64_t)std::ceil((xs[k] - x0) / px_w - 0.5);
            int64_t hi = (int64_t)std::ceil((xs[k + 1] - x0) / px_w - 0.5);
            lo = std::max<int64_t>(lo, 0);
            hi = std::min<int64_t>(hi, width);
            if (hi > lo) {
                T* dst = out + row * width + lo;
                if (sizeof(T) == 1 && value == (T)1) {
                    std::memset(dst, 1, (size_t)(hi - lo));
                } else {
                    std::fill(dst, dst + (hi - lo), value);
                }
            }
        }
    }
}

template <typename T>
void rasterize_impl(const double* coords, const int64_t* ring_sizes,
                    const int64_t* ring_counts, int64_t n_features,
                    const T* values, T* out, int64_t height, int64_t width,
                    double x0, double px_w, double y0, double px_h) {
    const double* feature_coords = coords;
    const int64_t* feature_rings = ring_sizes;
    for (int64_t f = 0; f < n_features; ++f) {
        int64_t n_rings = ring_counts[f];
        burn_feature(feature_coords, feature_rings, n_rings, values[f], out,
                     height, width, x0, px_w, y0, px_h);
        for (int64_t r = 0; r < n_rings; ++r) {
            feature_coords += 2 * feature_rings[r];
        }
        feature_rings += n_rings;
    }
}

}  // namespace

extern "C" {

void rasterize_int32(const double* coords, const int64_t* ring_sizes,
                     const int64_t* ring_counts, int64_t n_features,
                     const int32_t* values, int32_t* out, int64_t height,
                     int64_t width, double x0, double px_w, double y0,
                     double px_h) {
    rasterize_impl(coords, ring_sizes, ring_counts, n_features, values, out,
                   height, width, x0, px_w, y0, px_h);
}

void rasterize_float64(const double* coords, const int64_t* ring_sizes,
                       const int64_t* ring_counts, int64_t n_features,
                       const double* values, double* out, int64_t height,
                       int64_t width, double x0, double px_w, double y0,
                       double px_h) {
    rasterize_impl(coords, ring_sizes, ring_counts, n_features, values, out,
                   height, width, x0, px_w, y0, px_h);
}

void rasterize_uint8(const double* coords, const int64_t* ring_sizes,
                     const int64_t* ring_counts, int64_t n_features,
                     const uint8_t* values, uint8_t* out, int64_t height,
                     int64_t width, double x0, double px_w, double y0,
                     double px_h) {
    rasterize_impl(coords, ring_sizes, ring_counts, n_features, values, out,
                   height, width, x0, px_w, y0, px_h);
}

}  // extern "C"
