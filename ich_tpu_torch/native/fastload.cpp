// Native host-side data path: NIfTI-1 decode + batched CT preprocessing,
// copied from ich_tpu/native/fastload.cpp.
//
// zlib-aware NIfTI-1 reading with dtype conversion + scl scaling, and a
// multithreaded HU-window + bilinear-resize slice preprocessor. Exposed to
// Python via ctypes (ich_tpu_torch/native/__init__.py), which builds it with
// g++ into build/ich_tpu_torch/ and raises where it cannot be built: there
// is no Python fallback behind these entry points.
//
// Build: g++ -O3 -shared -fPIC fastload.cpp -o libfastload.so -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <new>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct NiftiHeader {
    int32_t sizeof_hdr;
    int16_t dim[8];
    int16_t datatype;
    int16_t bitpix;
    float pixdim[8];
    float vox_offset;
    float scl_slope;
    float scl_inter;
};

// peek the gzip footer's ISIZE (uncompressed length mod 2^32) to presize
// the output buffer; returns 0 when not gzip / unreadable
size_t gzip_isize_hint(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 0;
    unsigned char magic[2] = {0, 0};
    size_t hint = 0;
    if (std::fread(magic, 1, 2, f) == 2 && magic[0] == 0x1f && magic[1] == 0x8b &&
        std::fseek(f, -4, SEEK_END) == 0) {
        unsigned char tail[4];
        if (std::fread(tail, 1, 4, f) == 4)
            hint = (size_t)tail[0] | ((size_t)tail[1] << 8) |
                   ((size_t)tail[2] << 16) | ((size_t)tail[3] << 24);
    }
    std::fclose(f);
    return hint;
}

// read whole file (gzip-transparent: gzread handles plain files too)
bool read_all(const char* path, std::vector<unsigned char>& buf) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    try {
        gzbuffer(f, 1 << 20);  // default 8 KB internal buffer cripples gzread
        // Pre-size from the gzip ISIZE footer. ISIZE is a 32-bit field, so a
        // corrupt footer can claim up to ~4.29 GB — cap the eager reserve at
        // 2 GB (any real CT fits far below; oversized streams still load via
        // the incremental resize below, they just reallocate).
        size_t hint = gzip_isize_hint(path);
        if (hint > 0 && hint <= ((size_t)1 << 31)) buf.reserve(hint + 1);
        const size_t chunk = 1 << 20;
        size_t used = 0;
        while (true) {
            buf.resize(used + chunk);
            int n = gzread(f, buf.data() + used, chunk);
            if (n < 0) { gzclose(f); return false; }
            used += (size_t)n;
            if ((size_t)n < chunk) break;
        }
        buf.resize(used);
    } catch (const std::bad_alloc&) {
        // never let C++ exceptions cross the extern "C" boundary
        gzclose(f);
        return false;
    }
    gzclose(f);
    return true;
}

bool parse_header(const unsigned char* b, size_t n, NiftiHeader& h) {
    if (n < 348) return false;
    std::memcpy(&h.sizeof_hdr, b, 4);
    if (h.sizeof_hdr != 348) return false;  // (big-endian unsupported here)
    std::memcpy(h.dim, b + 40, 16);
    std::memcpy(&h.datatype, b + 70, 2);
    std::memcpy(&h.bitpix, b + 72, 2);
    std::memcpy(h.pixdim, b + 76, 32);
    std::memcpy(&h.vox_offset, b + 108, 4);
    std::memcpy(&h.scl_slope, b + 112, 4);
    std::memcpy(&h.scl_inter, b + 116, 4);
    return true;
}

// element size in bytes derived from the datatype code — never trust the
// header's bitpix for bounds checks (a corrupt header with datatype=64 /
// bitpix=8 would otherwise pass validation and read past the buffer)
int64_t datatype_size(int16_t datatype) {
    switch (datatype) {
        case 2: case 256:          return 1;   // uint8 / int8
        case 4: case 512:          return 2;   // int16 / uint16
        case 8: case 16: case 768: return 4;   // int32 / float32 / uint32
        case 64:                   return 8;   // float64
        default:                   return 0;   // unsupported
    }
}

// validated element count + payload offset; returns n (>0) or <0 error code
int64_t validate_payload(const NiftiHeader& h, size_t buf_size, size_t& off_out) {
    // hard cap on the element count: a CT volume is << 2^31 voxels; this
    // also makes the n * esize product below overflow-free (2^31 * 8 bytes
    // = 2^34, far inside uint64) — without it, a crafted header with dims
    // like 16384^4 wraps (uint64)n * esize to a small number and defeats
    // the bounds check entirely.
    const int64_t kMaxElems = (int64_t)1 << 31;
    int ndim = h.dim[0];
    if (ndim < 1 || ndim > 7) return -3;
    int64_t n = 1;
    for (int i = 1; i <= ndim; ++i) {
        if (h.dim[i] <= 0) return -3;
        n *= (int64_t)h.dim[i];  // n <= kMax before the multiply and
        // dim[i] <= 32767, so n <= 2^49 here — no signed overflow possible
        if (n > kMaxElems) return -3;
    }
    int64_t esize = datatype_size(h.datatype);
    if (esize == 0) return -6;
    // vox_offset is stored as float: must be finite and >= 348. The spec
    // minimum for single-file .nii is 352 (348-byte header + 4 extension
    // -flag bytes), but some legacy writers emit exactly 348 for extension
    // -less files (data abuts the header, no flag bytes) — accept that;
    // values strictly inside (348, 352) would start the payload mid-flag
    // and stay rejected.
    if (!std::isfinite(h.vox_offset) || h.vox_offset > 9.0e15f ||
        !(h.vox_offset == 348.0f || h.vox_offset >= 352.0f))
        return -5;
    size_t off = (size_t)h.vox_offset;
    if (buf_size < off || (buf_size - off) < (uint64_t)n * (uint64_t)esize) return -5;
    off_out = off;
    return n;
}

template <typename T>
void convert(const unsigned char* src, float* dst, int64_t n, float slope, float inter) {
    const T* s = reinterpret_cast<const T*>(src);
    if (slope == 0.0f) slope = 1.0f;
    if (slope == 1.0f && inter == 0.0f) {
        for (int64_t i = 0; i < n; ++i) dst[i] = (float)s[i];
    } else {
        for (int64_t i = 0; i < n; ++i) dst[i] = (float)s[i] * slope + inter;
    }
}

}  // namespace

extern "C" {

// Probe dims: returns ndim (>0) on success, <0 on error. dims_out[8], pixdim_out[8].
int nifti_probe(const char* path, int32_t* dims_out, float* pixdim_out) {
    std::vector<unsigned char> buf;
    if (!read_all(path, buf)) return -1;
    NiftiHeader h;
    if (!parse_header(buf.data(), buf.size(), h)) return -2;
    for (int i = 0; i < 8; ++i) {
        dims_out[i] = h.dim[i];
        pixdim_out[i] = h.pixdim[i];
    }
    return (int)h.dim[0];
}

// Read a NIfTI volume into a caller-allocated float32 buffer (Fortran voxel
// order exactly as stored). Returns number of elements written, <0 on error.
int64_t nifti_read_f32(const char* path, float* out, int64_t max_elems) {
    std::vector<unsigned char> buf;
    if (!read_all(path, buf)) return -1;
    NiftiHeader h;
    if (!parse_header(buf.data(), buf.size(), h)) return -2;
    size_t off = 0;
    int64_t n = validate_payload(h, buf.size(), off);
    if (n < 0) return n;
    if (n > max_elems) return -4;
    const unsigned char* d = buf.data() + off;
    switch (h.datatype) {
        case 2:    convert<uint8_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 4:    convert<int16_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 8:    convert<int32_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 16:   convert<float>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 64:   convert<double>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 256:  convert<int8_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 512:  convert<uint16_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 768:  convert<uint32_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        default:   return -6;
    }
    return n;
}

// Single-pass variant: decode + header in one read (one gzip pass); the
// buffer is allocated here and must be released with fastload_free.
// Returns elements written (>0), <0 on error; fills dims/pixdim[8].
int64_t nifti_read_alloc(const char* path, float** out_ptr,
                         int32_t* dims_out, float* pixdim_out) {
    std::vector<unsigned char> buf;
    if (!read_all(path, buf)) return -1;
    NiftiHeader h;
    if (!parse_header(buf.data(), buf.size(), h)) return -2;
    for (int i = 0; i < 8; ++i) {
        dims_out[i] = h.dim[i];
        pixdim_out[i] = h.pixdim[i];
    }
    size_t off = 0;
    int64_t n = validate_payload(h, buf.size(), off);
    if (n < 0) return n;
    float* out = (float*)malloc((size_t)n * sizeof(float));
    if (!out) return -7;
    const unsigned char* d = buf.data() + off;
    switch (h.datatype) {
        case 2:    convert<uint8_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 4:    convert<int16_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 8:    convert<int32_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 16:   convert<float>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 64:   convert<double>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 256:  convert<int8_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 512:  convert<uint16_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        case 768:  convert<uint32_t>(d, out, n, h.scl_slope, h.scl_inter); break;
        default:   free(out); return -6;
    }
    *out_ptr = out;
    return n;
}

void fastload_free(float* p) { free(p); }

// Thread-pooled multi-file decode: the host-side ingest of a study is many
// independent gzip streams, so file-level threads scale with cores (the
// single-file path is inherently serial — gzip can't be split). Each file's
// volume is malloc'd into out_ptrs[i] (release with fastload_free);
// status[i] = element count (>0) or the per-file error code (<0).
// dims_out/pixdim_out are (n_files * 8) arrays.
void nifti_read_many(const char** paths, int n_files, float** out_ptrs,
                     int32_t* dims_out, float* pixdim_out,
                     int64_t* status, int n_threads) {
    auto work = [&](int i0, int i1) {
        for (int i = i0; i < i1; ++i) {
            out_ptrs[i] = nullptr;
            status[i] = nifti_read_alloc(paths[i], &out_ptrs[i],
                                         dims_out + (int64_t)i * 8,
                                         pixdim_out + (int64_t)i * 8);
        }
    };
    if (n_threads <= 1 || n_files <= 1) {
        work(0, n_files);
        return;
    }
    int nt = n_threads < n_files ? n_threads : n_files;
    std::vector<std::thread> pool;
    int per = (n_files + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int s0 = t * per, s1 = s0 + per < n_files ? s0 + per : n_files;
        if (s0 >= s1) break;
        pool.emplace_back(work, s0, s1);
    }
    for (auto& th : pool) th.join();
}

// Batched CT preprocessing: HU window to [0,1] + bilinear resize, one thread
// pool over slices. in: (n, h, w) C-order float32 -> out: (n, oh, ow).
void window_resize_batch(const float* in, int n, int h, int w,
                         float center, float width,
                         float* out, int oh, int ow, int n_threads) {
    const float lo = center - width / 2.0f;
    const float inv = 1.0f / width;  // (x - lo) / (hi - lo)
    const float sy = (float)h / (float)oh;
    const float sx = (float)w / (float)ow;
    // antialias kernel scale (jax.image.resize 'linear' semantics)
    const float ky = sy > 1.0f ? sy : 1.0f;
    const float kx = sx > 1.0f ? sx : 1.0f;
    // window (clip) BEFORE interpolation, matching the python pipeline
    // (clip is nonlinear, so the order is observable)
    auto win = [&](float v) {
        v = (v - lo) * inv;
        if (v < 0.0f) v = 0.0f;
        if (v > 1.0f) v = 1.0f;
        return v;
    };

    auto work = [&](int s0, int s1) {
        std::vector<float> tmp((size_t)h * ow);
        for (int s = s0; s < s1; ++s) {
            const float* src = in + (int64_t)s * h * w;
            float* dst = out + (int64_t)s * oh * ow;
            // horizontal pass: window + antialiased tent resample along x
            for (int y = 0; y < h; ++y) {
                for (int x = 0; x < ow; ++x) {
                    float fx = (x + 0.5f) * sx - 0.5f;
                    int j0 = (int)std::floor(fx - kx) ;
                    int j1 = (int)std::ceil(fx + kx);
                    float acc = 0.0f, wsum = 0.0f;
                    for (int j = j0; j <= j1; ++j) {
                        float d = (fx - (float)j) / kx;
                        float wgt = 1.0f - (d < 0 ? -d : d);
                        if (wgt <= 0.0f || j < 0 || j > w - 1) continue;
                        acc += wgt * win(src[y * w + j]);
                        wsum += wgt;
                    }
                    tmp[(size_t)y * ow + x] = acc / wsum;
                }
            }
            // vertical pass
            for (int y = 0; y < oh; ++y) {
                float fy = (y + 0.5f) * sy - 0.5f;
                int j0 = (int)std::floor(fy - ky);
                int j1 = (int)std::ceil(fy + ky);
                for (int x = 0; x < ow; ++x) {
                    float acc = 0.0f, wsum = 0.0f;
                    for (int j = j0; j <= j1; ++j) {
                        float d = (fy - (float)j) / ky;
                        float wgt = 1.0f - (d < 0 ? -d : d);
                        if (wgt <= 0.0f || j < 0 || j > h - 1) continue;
                        acc += wgt * tmp[(size_t)j * ow + x];
                        wsum += wgt;
                    }
                    dst[y * ow + x] = acc / wsum;
                }
            }
        }
    };

    if (n_threads <= 1 || n <= 1) {
        work(0, n);
        return;
    }
    int nt = n_threads < n ? n_threads : n;
    std::vector<std::thread> pool;
    int per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int s0 = t * per, s1 = s0 + per < n ? s0 + per : n;
        if (s0 >= s1) break;
        pool.emplace_back(work, s0, s1);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
