// Native RGB-D dataset loader: threaded PNG decode + ordered prefetch queue.
//
// Runtime replacement for the reference's FileGrabber
// (reference: src/Grabber/fileGrabber.cpp:40-160 — reads rgb_%05d.png /
// depth_%05d.png pairs on a grabber thread with a queue; busy-wait pop at
// :197-210). This version decodes on a worker pool, delivers frames strictly
// in order through a bounded queue (condvar, no busy wait), and converts to
// the engine's wire format on the worker side: gray float32 [0,1] and depth
// float32 metres — so Python only hands pointers to the device.
//
// C ABI (ctypes): ps_loader_create / ps_loader_next / ps_loader_destroy,
// plus ps_decode_pair for single-shot decode.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;
  int bit_depth = 0;
  std::vector<uint8_t> data;  // row-major, 16-bit stored big-endian-swapped to host
};

bool read_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // little-endian host order
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->channels = channels;
  out->bit_depth = bit_depth;
  out->data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// Convert a decoded RGB/gray image to float32 gray in [0,1].
void to_gray(const Image& im, float* out) {
  const int n = im.width * im.height;
  if (im.bit_depth == 8 && im.channels >= 3) {
    for (int i = 0; i < n; ++i) {
      const uint8_t* p = &im.data[i * im.channels];
      out[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) / 255.0f;
    }
  } else if (im.bit_depth == 8) {
    for (int i = 0; i < n; ++i) out[i] = im.data[i * im.channels] / 255.0f;
  } else {  // 16-bit gray
    const uint16_t* p = reinterpret_cast<const uint16_t*>(im.data.data());
    for (int i = 0; i < n; ++i) out[i] = p[i * im.channels] / 65535.0f;
  }
}

// Convert a decoded 16-bit depth image to float32 metres.
void to_depth(const Image& im, float inv_scale, float* out) {
  const int n = im.width * im.height;
  if (im.bit_depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(im.data.data());
    for (int i = 0; i < n; ++i) out[i] = p[i * im.channels] * inv_scale;
  } else {
    for (int i = 0; i < n; ++i) out[i] = im.data[i * im.channels] * inv_scale;
  }
}

struct Frame {
  std::vector<float> gray;
  std::vector<float> depth;
  bool ok = false;
};

class Loader {
 public:
  Loader(std::vector<std::string> rgb, std::vector<std::string> depth,
         int width, int height, float depth_scale, int n_threads,
         int queue_cap)
      : rgb_(std::move(rgb)),
        depth_(std::move(depth)),
        width_(width),
        height_(height),
        inv_scale_(1.0f / depth_scale),
        queue_cap_(queue_cap < 2 ? 2 : queue_cap) {
    const int nt = n_threads < 1 ? 1 : n_threads;
    for (int t = 0; t < nt; ++t)
      workers_.emplace_back([this] { this->worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& th : workers_) th.join();
  }

  // Blocks until the next in-order frame is decoded. Returns the frame
  // index, or -1 past the end. Buffers must hold width*height floats.
  int next(float* gray_out, float* depth_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (deliver_idx_ >= static_cast<int>(rgb_.size())) return -1;
    const int want = deliver_idx_;
    cv_ready_.wait(lk, [&] { return stop_ || done_.count(want) > 0; });
    if (stop_ && done_.count(want) == 0) return -1;
    Frame f = std::move(done_[want]);
    done_.erase(want);
    ++deliver_idx_;
    lk.unlock();
    cv_space_.notify_all();
    if (!f.ok) return -2;  // decode failure
    std::memcpy(gray_out, f.gray.data(), f.gray.size() * sizeof(float));
    std::memcpy(depth_out, f.depth.data(), f.depth.size() * sizeof(float));
    return want;
  }

 private:
  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ ||
                 (claim_idx_ < static_cast<int>(rgb_.size()) &&
                  claim_idx_ - deliver_idx_ < queue_cap_);
        });
        if (stop_) return;
        idx = claim_idx_++;
      }
      Frame f = decode(idx);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(f);
      }
      cv_ready_.notify_all();
    }
  }

  Frame decode(int idx) {
    Frame f;
    const int n = width_ * height_;
    f.gray.resize(n);
    f.depth.resize(n);
    Image rgb_im, d_im;
    if (!read_png(rgb_[idx].c_str(), &rgb_im) ||
        !read_png(depth_[idx].c_str(), &d_im))
      return f;
    if (rgb_im.width != width_ || rgb_im.height != height_ ||
        d_im.width != width_ || d_im.height != height_)
      return f;
    to_gray(rgb_im, f.gray.data());
    to_depth(d_im, inv_scale_, f.depth.data());
    f.ok = true;
    return f;
  }

  std::vector<std::string> rgb_, depth_;
  const int width_, height_;
  const float inv_scale_;
  const int queue_cap_;

  std::mutex mu_;
  std::condition_variable cv_space_, cv_ready_;
  std::map<int, Frame> done_;
  int claim_idx_ = 0;
  int deliver_idx_ = 0;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* ps_loader_create(const char** rgb_paths, const char** depth_paths,
                       int n_frames, int width, int height, float depth_scale,
                       int n_threads, int queue_cap) {
  std::vector<std::string> rgb(rgb_paths, rgb_paths + n_frames);
  std::vector<std::string> depth(depth_paths, depth_paths + n_frames);
  return new Loader(std::move(rgb), std::move(depth), width, height,
                    depth_scale, n_threads, queue_cap);
}

int ps_loader_next(void* handle, float* gray_out, float* depth_out) {
  return static_cast<Loader*>(handle)->next(gray_out, depth_out);
}

void ps_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int ps_decode_pair(const char* rgb_path, const char* depth_path, int width,
                   int height, float depth_scale, float* gray_out,
                   float* depth_out) {
  Image rgb_im, d_im;
  if (!read_png(rgb_path, &rgb_im) || !read_png(depth_path, &d_im)) return -1;
  if (rgb_im.width != width || rgb_im.height != height ||
      d_im.width != width || d_im.height != height)
    return -2;
  to_gray(rgb_im, gray_out);
  to_depth(d_im, 1.0f / depth_scale, depth_out);
  return 0;
}
}
