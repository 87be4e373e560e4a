// Native volume decode: raw UCHAR/USHORT/FLOAT -> box-filtered f32 XYZ grid.
//
// TPU-native counterpart of the reference's C++ importer
// (CPURenderer/ExternalImporter.cpp:25-232): reads the raw payload (skipping
// any header), averages over downsampling^3 blocks, zeroes values below the
// sparsity threshold, and emits an (X, Y, Z)-ordered float32 array ready for
// BrickGrid.from_dense.  OpenMP across output z-slices mirrors the
// reference's OpenMP slice loop (ExternalImporter.cpp:138-160).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image):
//   int load_raw(const char* path, long long header_bytes,
//                int rx, int ry, int rz, int fmt /*0=u8,1=u16,2=f32*/,
//                int downsampling, float lower_threshold, float* out);
// Returns 0 on success, negative error codes otherwise.
//
// Build: isosurfacesuperresolution_tpu_torch/native/build.py, at first use
//        (python -m isosurfacesuperresolution_tpu_torch.native.build)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

template <typename T>
int load_and_filter(std::FILE* f, long long header, int rx, int ry, int rz,
                    float scale, int ds, float thresh, float* out) {
    // input is stored slice-major: index = x + rx * (y + ry * z)
    const int ox = rx / ds, oy = ry / ds, oz = rz / ds;
    const size_t slice_elems = static_cast<size_t>(rx) * ry;
    if (std::fseek(f, static_cast<long>(header), SEEK_SET) != 0) return -3;

    // read ds input slices at a time, producing one output z-layer
    std::vector<T> buf(slice_elems * ds);
    const float inv = 1.0f / (scale * ds * ds * ds);
    for (int z = 0; z < oz; ++z) {
        const size_t want = slice_elems * ds;
        if (std::fread(buf.data(), sizeof(T), want, f) != want) return -4;
#pragma omp parallel for schedule(static)
        for (int y = 0; y < oy; ++y) {
            for (int x = 0; x < ox; ++x) {
                float acc = 0.0f;
                for (int iz = 0; iz < ds; ++iz)
                    for (int iy = 0; iy < ds; ++iy)
                        for (int ix = 0; ix < ds; ++ix) {
                            const size_t idx =
                                static_cast<size_t>(ix + ds * x) +
                                static_cast<size_t>(rx) *
                                    ((iy + ds * y) +
                                     static_cast<size_t>(ry) * iz);
                            acc += static_cast<float>(buf[idx]);
                        }
                float v = acc * inv;
                if (v < thresh) v = 0.0f;
                // output is (X, Y, Z) C-order: index = (x*oy + y)*oz + z
                out[(static_cast<size_t>(x) * oy + y) * oz + z] = v;
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

int load_raw(const char* path, long long header_bytes, int rx, int ry, int rz,
             int fmt, int downsampling, float lower_threshold, float* out) {
    if (downsampling < 1 || rx <= 0 || ry <= 0 || rz <= 0) return -1;
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -2;
    int rc;
    switch (fmt) {
        case 0:
            rc = load_and_filter<uint8_t>(f, header_bytes, rx, ry, rz, 255.0f,
                                          downsampling, lower_threshold, out);
            break;
        case 1:
            rc = load_and_filter<uint16_t>(f, header_bytes, rx, ry, rz,
                                           65535.0f, downsampling,
                                           lower_threshold, out);
            break;
        case 2:
            rc = load_and_filter<float>(f, header_bytes, rx, ry, rz, 1.0f,
                                        downsampling, lower_threshold, out);
            break;
        default:
            rc = -5;
    }
    std::fclose(f);
    return rc;
}

// Brick min/max summary (apron-conservative) computed natively for large
// volumes: values (X, Y, Z) C-order f32; out_min/out_max sized
// ceil(X/b)*ceil(Y/b)*ceil(Z/b) C-order.
int brick_minmax(const float* values, int X, int Y, int Z, int b,
                 float* out_min, float* out_max) {
    if (b < 1) return -1;
    const int bx = (X + b - 1) / b, by = (Y + b - 1) / b, bz = (Z + b - 1) / b;
#pragma omp parallel for schedule(static)
    for (int i = 0; i < bx; ++i) {
        for (int j = 0; j < by; ++j)
            for (int k = 0; k < bz; ++k) {
                const int x0 = i * b - 1, y0 = j * b - 1, z0 = k * b - 1;
                const int x1 = (i + 1) * b + 1, y1 = (j + 1) * b + 1,
                          z1 = (k + 1) * b + 1;
                float mn = 3.4e38f, mx = -3.4e38f;
                for (int x = x0 < 0 ? 0 : x0; x < (x1 > X ? X : x1); ++x)
                    for (int y = y0 < 0 ? 0 : y0; y < (y1 > Y ? Y : y1); ++y)
                        for (int z = z0 < 0 ? 0 : z0; z < (z1 > Z ? Z : z1);
                             ++z) {
                            const float v =
                                values[(static_cast<size_t>(x) * Y + y) * Z +
                                       z];
                            if (v < mn) mn = v;
                            if (v > mx) mx = v;
                        }
                out_min[(static_cast<size_t>(i) * by + j) * bz + k] = mn;
                out_max[(static_cast<size_t>(i) * by + j) * bz + k] = mx;
            }
    }
    return 0;
}

}  // extern "C"
