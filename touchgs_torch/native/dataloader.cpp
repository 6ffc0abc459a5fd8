// Threaded scene data loader — native runtime equivalent of the trainer's
// image pipeline (the reference delegates loading to nerfstudio's Python
// dataloader; here decode + normalization runs in C++ worker threads so the
// Python host loop only does a memcpy-sized ctypes call per step).
//
// C ABI (ctypes):
//   tgs_loader*  tgs_loader_create(paths, n, n_threads)
//   int          tgs_loader_prefetch(l, idx)       // enqueue decode
//   int          tgs_loader_get(l, idx, out, cap)  // block until decoded,
//                                                  // copy float32 samples
//   int          tgs_loader_shape(l, idx, wh[3])   // w, h, c after decode
//   void         tgs_loader_destroy(l)
//   int          tgs_decode_png(path, out, cap, shape[4])  // one-shot
//
// Pixels are normalized: 8-bit → [0,1] (÷255), 16-bit → meters (÷1000, the
// uint16-mm depth contract of utils/read_touch_depths.py:11).
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "png_io.h"
#include "jpeg_decode.h"

namespace {

struct Decoded {
  uint32_t w = 0, h = 0, c = 0;
  std::vector<float> samples;
  bool ok = false;
};

Decoded DecodeNormalized(const std::string& path) {
  Decoded d;
  touchgs::Image img;
  std::string err;
  if (!touchgs::ReadPng(path, &img, &err)) return d;
  d.w = img.width;
  d.h = img.height;
  d.c = img.channels;
  size_t n = size_t(img.width) * img.height * img.channels;
  d.samples.resize(n);
  if (img.bit_depth == 8) {
    const uint8_t* p = img.data.data();
    for (size_t i = 0; i < n; ++i) d.samples[i] = p[i] / 255.0f;
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.data.data());
    for (size_t i = 0; i < n; ++i) d.samples[i] = p[i] / 1000.0f;
  }
  d.ok = true;
  return d;
}

class Loader {
 public:
  Loader(std::vector<std::string> paths, int n_threads)
      : paths_(std::move(paths)), stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { Work(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  bool Prefetch(int idx) {
    if (idx < 0 || idx >= int(paths_.size())) return false;
    std::lock_guard<std::mutex> lk(mu_);
    if (cache_.count(idx) || pending_.count(idx)) return true;
    pending_.insert({idx, true});
    queue_.push_back(idx);
    cv_.notify_one();
    return true;
  }

  // Blocks until idx is decoded; copies samples out; drops the cache entry.
  int Get(int idx, float* out, long cap, int* shape3) {
    if (idx < 0 || idx >= int(paths_.size())) return -1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (!cache_.count(idx) && !pending_.count(idx)) {
        pending_.insert({idx, true});
        queue_.push_front(idx);  // demand fetches jump the queue
        cv_.notify_one();
      }
    }
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return cache_.count(idx) > 0; });
    Decoded d = std::move(cache_[idx]);
    cache_.erase(idx);
    if (!d.ok) return -2;
    long n = long(d.w) * d.h * d.c;
    if (n > cap) return -3;
    memcpy(out, d.samples.data(), n * sizeof(float));
    shape3[0] = d.h;
    shape3[1] = d.w;
    shape3[2] = d.c;
    return int(n);
  }

 private:
  void Work() {
    while (true) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        idx = queue_.front();
        queue_.pop_front();
      }
      Decoded d = DecodeNormalized(paths_[idx]);
      {
        std::lock_guard<std::mutex> lk(mu_);
        cache_[idx] = std::move(d);
        pending_.erase(idx);
      }
      done_cv_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<int> queue_;
  std::map<int, Decoded> cache_;
  std::map<int, bool> pending_;
  bool stop_;
};

}  // namespace

extern "C" {

void* tgs_loader_create(const char** paths, int n, int n_threads) {
  std::vector<std::string> p(paths, paths + n);
  return new Loader(std::move(p), n_threads > 0 ? n_threads : 2);
}

int tgs_loader_prefetch(void* l, int idx) {
  return static_cast<Loader*>(l)->Prefetch(idx) ? 0 : -1;
}

int tgs_loader_get(void* l, int idx, float* out, long cap, int* shape3) {
  return static_cast<Loader*>(l)->Get(idx, out, cap, shape3);
}

void tgs_loader_destroy(void* l) { delete static_cast<Loader*>(l); }

// one-shot JPEG → RGB8 decode (the MJPEG capture path's codec; exported so
// the Python tests can exercise it without camera hardware)
int tgs_decode_jpeg(const uint8_t* data, long len, uint8_t* out, long cap,
                    int* shape3) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  std::string err;
  if (!tgs_jpeg::DecodeRgb(data, size_t(len), &rgb, &w, &h, &err)) return -2;
  if (long(rgb.size()) > cap) return -3;
  memcpy(out, rgb.data(), rgb.size());
  shape3[0] = h;
  shape3[1] = w;
  shape3[2] = 3;
  return int(rgb.size());
}

int tgs_decode_png(const char* path, float* out, long cap, int* shape3) {
  Decoded d = DecodeNormalized(path);
  if (!d.ok) return -2;
  long n = long(d.w) * d.h * d.c;
  if (n > cap) return -3;
  memcpy(out, d.samples.data(), n * sizeof(float));
  shape3[0] = d.h;
  shape3[1] = d.w;
  shape3[2] = d.c;
  return int(n);
}

int tgs_encode_png_u16(const char* path, const uint16_t* data, int h, int w) {
  touchgs::Image img;
  img.width = w;
  img.height = h;
  img.channels = 1;
  img.bit_depth = 16;
  img.data.assign(reinterpret_cast<const uint8_t*>(data),
                  reinterpret_cast<const uint8_t*>(data) + size_t(h) * w * 2);
  std::string err;
  return touchgs::WritePng(path, img, &err) ? 0 : -1;
}

int tgs_encode_png_u8(const char* path, const uint8_t* data, int h, int w,
                      int c) {
  touchgs::Image img;
  img.width = w;
  img.height = h;
  img.channels = c;
  img.bit_depth = 8;
  img.data.assign(data, data + size_t(h) * w * c);
  std::string err;
  return touchgs::WritePng(path, img, &err) ? 0 : -1;
}

}  // extern "C"
