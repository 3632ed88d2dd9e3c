// wass_native: C++ host-runtime for the wass_tpu framework.
//
// The reference implements its whole pipeline as native executables; in the
// JAX build the *compute* path is XLA plus a CUDA kernel, and this library provides the
// native host runtime around it — the parts that sit on the frame-streaming
// critical path at multi-fps rates:
//
//   * grayscale PNG / JPEG decode+encode (libpng / libjpeg), threadable
//   * .xyzC compressed point-cloud encode/decode (byte-compatible with
//     PovMesh::save_as_xyz_compressed, reference PovMesh.cpp:377-460)
//   * masked point-grid compaction (valid-mask -> packed point list),
//     the host-side step between device output and the .xyzC writer
//   * a bounded thread-pool prefetcher that overlaps image decode with
//     device compute (replaces the reference's 4-process thread_map)
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>
#include <jpeglib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG IO (8/16-bit grayscale)
// ---------------------------------------------------------------------------

// Reads a grayscale PNG; returns 0 on success. Caller provides the buffer
// via a two-phase call: first with buf==nullptr to get dimensions.
int wass_png_read_gray(const char* path, uint8_t* buf, int* w, int* h) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return -2;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    int width = png_get_image_width(png, info);
    int height = png_get_image_height(png, info);
    png_byte color = png_get_color_type(png, info);
    png_byte depth = png_get_bit_depth(png, info);

    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray_fixed(png, 1, -1, -1);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    png_read_update_info(png, info);

    *w = width;
    *h = height;
    if (!buf) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return 0;
    }
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y) rows[y] = buf + (size_t)y * width;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
}

int wass_png_write_gray(const char* path, const uint8_t* buf, int w, int h) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return -1;
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_write_struct(&png, &info);
        fclose(fp);
        return -2;
    }
    png_init_io(png, fp);
    png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_GRAY, PNG_INTERLACE_NONE,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    // Favor throughput over ratio: the workdir contract needs lossless
    // images, not maximal compression.
    png_set_compression_level(png, 1);
    png_write_info(png, info);
    std::vector<png_bytep> rows(h);
    for (int y = 0; y < h; ++y) rows[y] = const_cast<uint8_t*>(buf) + (size_t)y * w;
    png_write_image(png, rows.data());
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return 0;
}

// ---------------------------------------------------------------------------
// JPEG IO (grayscale or RGB)
// ---------------------------------------------------------------------------

int wass_jpeg_encode(const uint8_t* buf, int w, int h, int components, int quality,
                     uint8_t** out, unsigned long* out_size) {
    jpeg_compress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    *out = nullptr;
    *out_size = 0;
    jpeg_mem_dest(&cinfo, out, out_size);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = components;
    cinfo.in_color_space = components == 3 ? JCS_RGB : JCS_GRAYSCALE;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(buf) + (size_t)cinfo.next_scanline * w * components;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    return 0;
}

void wass_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// .xyzC codec
// ---------------------------------------------------------------------------

// Compact a (H*W, 3) float32 point grid by a uint8 mask, transform into the
// plane frame (R p + T) in double precision, quantize to 16 bits and write
// the full .xyzC stream. Multithreaded min/max scan + quantization.
int wass_xyzc_write(const char* path,
                    const float* pts,      // (n, 3) cam-frame points
                    const uint8_t* mask,   // (n,)
                    int64_t n,
                    const double* Rpl,     // (3,3) cam->plane
                    const double* Tpl,     // (3,)
                    const double* Rinv,    // (3,3) stored inverse transform
                    const double* Tinv,    // (3,)
                    int n_threads) {
    // Pass 1: compact + transform.
    std::vector<double> tp;
    tp.reserve(1024 * 1024);
    // Parallel partition: each thread compacts a slice, then slices are
    // concatenated in order.
    if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min(n_threads, 16));
    std::vector<std::vector<double>> parts(n_threads);
    std::vector<std::thread> threads;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        threads.emplace_back([&, t]() {
            int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
            auto& out = parts[t];
            out.reserve((hi - lo) / 2 * 3);
            for (int64_t i = lo; i < hi; ++i) {
                if (!mask[i]) continue;
                double x = pts[i * 3 + 0], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
                double px = Rpl[0] * x + Rpl[1] * y + Rpl[2] * z + Tpl[0];
                double py = Rpl[3] * x + Rpl[4] * y + Rpl[5] * z + Tpl[1];
                double pz = Rpl[6] * x + Rpl[7] * y + Rpl[8] * z + Tpl[2];
                out.push_back(px);
                out.push_back(py);
                out.push_back(pz);
            }
        });
    }
    for (auto& th : threads) th.join();
    size_t total = 0;
    for (auto& p : parts) total += p.size();
    uint32_t npts = (uint32_t)(total / 3);

    double mins[3] = {1e300, 1e300, 1e300};
    double maxs[3] = {-1e300, -1e300, -1e300};
    for (auto& p : parts)
        for (size_t i = 0; i < p.size(); i += 3)
            for (int c = 0; c < 3; ++c) {
                mins[c] = std::min(mins[c], p[i + c]);
                maxs[c] = std::max(maxs[c], p[i + c]);
            }
    double scales[3];
    for (int c = 0; c < 3; ++c) {
        double rng = maxs[c] - mins[c];
        scales[c] = 65535.0 / (rng > 0 ? rng : 1.0);
        if (npts == 0) { mins[c] = 0.0; scales[c] = 1.0; }
    }

    FILE* fp = fopen(path, "wb");
    if (!fp) return -1;
    fwrite(&npts, 4, 1, fp);
    fwrite(scales, 8, 3, fp);
    fwrite(mins, 8, 3, fp);
    fwrite(Rinv, 8, 9, fp);
    fwrite(Tinv, 8, 3, fp);
    std::vector<uint16_t> q;
    q.reserve(total);
    for (auto& p : parts)
        for (size_t i = 0; i < p.size(); i += 3)
            for (int c = 0; c < 3; ++c) {
                double v = (p[i + c] - mins[c]) * scales[c];
                v = std::max(0.0, std::min(65535.0, v));
                q.push_back((uint16_t)v);
            }
    fwrite(q.data(), 2, q.size(), fp);
    fclose(fp);
    return (int)npts >= 0 ? 0 : -2;
}

// Decode to camera-frame doubles (3*npts). Two-phase: buf==nullptr returns n.
int wass_xyzc_read(const char* path, double* buf, int64_t* npts_out) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return -1;
    uint32_t npts;
    double scales[3], mins[3], Rinv[9], Tinv[3];
    if (fread(&npts, 4, 1, fp) != 1) { fclose(fp); return -2; }
    fread(scales, 8, 3, fp);
    fread(mins, 8, 3, fp);
    fread(Rinv, 8, 9, fp);
    fread(Tinv, 8, 3, fp);
    *npts_out = npts;
    if (!buf) { fclose(fp); return 0; }
    std::vector<uint16_t> q((size_t)npts * 3);
    if (fread(q.data(), 2, q.size(), fp) != q.size()) { fclose(fp); return -3; }
    fclose(fp);
    for (int64_t i = 0; i < (int64_t)npts; ++i) {
        double p[3];
        for (int c = 0; c < 3; ++c) p[c] = q[i * 3 + c] / scales[c] + mins[c];
        for (int r = 0; r < 3; ++r)
            buf[i * 3 + r] = Rinv[r * 3 + 0] * p[0] + Rinv[r * 3 + 1] * p[1] + Rinv[r * 3 + 2] * p[2] + Tinv[r];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Prefetching image loader (thread pool + bounded queue)
// ---------------------------------------------------------------------------

struct Prefetcher {
    struct Item {
        std::string path;
        std::vector<uint8_t> data;
        int w = 0, h = 0, status = -100;
        bool done = false;
    };
    std::deque<Item*> queue;      // submitted, pending work
    std::vector<Item*> items;     // all items by ticket
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};

    explicit Prefetcher(int n_threads) {
        for (int i = 0; i < n_threads; ++i)
            workers.emplace_back([this]() { run(); });
    }
    ~Prefetcher() {
        stop = true;
        cv_work.notify_all();
        for (auto& w : workers) w.join();
        for (auto* it : items) delete it;
    }
    void run() {
        for (;;) {
            Item* it = nullptr;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [&] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                it = queue.front();
                queue.pop_front();
            }
            int w, h;
            int st = wass_png_read_gray(it->path.c_str(), nullptr, &w, &h);
            if (st == 0) {
                it->data.resize((size_t)w * h);
                st = wass_png_read_gray(it->path.c_str(), it->data.data(), &w, &h);
                it->w = w;
                it->h = h;
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                it->status = st;
                it->done = true;
            }
            cv_done.notify_all();
        }
    }
    int64_t submit(const char* path) {
        auto* it = new Item();
        it->path = path;
        std::lock_guard<std::mutex> lk(mu);
        items.push_back(it);
        queue.push_back(it);
        cv_work.notify_one();
        return (int64_t)items.size() - 1;
    }
    Item* wait(int64_t ticket) {
        std::unique_lock<std::mutex> lk(mu);
        Item* it = items[(size_t)ticket];
        cv_done.wait(lk, [&] { return it->done; });
        return it;
    }
};

void* wass_prefetcher_create(int n_threads) { return new Prefetcher(n_threads); }
void wass_prefetcher_destroy(void* p) { delete (Prefetcher*)p; }
int64_t wass_prefetcher_submit(void* p, const char* path) { return ((Prefetcher*)p)->submit(path); }
int wass_prefetcher_dims(void* p, int64_t ticket, int* w, int* h) {
    auto* it = ((Prefetcher*)p)->wait(ticket);
    *w = it->w;
    *h = it->h;
    return it->status;
}
int wass_prefetcher_take(void* p, int64_t ticket, uint8_t* buf) {
    auto* it = ((Prefetcher*)p)->wait(ticket);
    if (it->status != 0) return it->status;
    memcpy(buf, it->data.data(), it->data.size());
    it->data.clear();
    it->data.shrink_to_fit();
    return 0;
}

}  // extern "C"
