// Shared V4L2 mmap camera class + YUYV→RGB conversion (header-only), used
// by tgs_capture and tgs_sync_capture.  Extracted from v4l2_capture.cpp —
// reference parity: data_collection/ros1/dtv2_tactile_camera/
// src/usb_cam.cpp (UsbCam class, io_method mmap, init_mmap).
#ifndef TOUCHGS_NATIVE_V4L2_CAMERA_H_
#define TOUCHGS_NATIVE_V4L2_CAMERA_H_

#include <fcntl.h>
#include <linux/videodev2.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_decode.h"

namespace tgs_v4l2 {


struct Buffer {
  void* start = nullptr;
  size_t length = 0;
};

inline int XIoctl(int fd, unsigned long req, void* arg) {
  int r;
  do {
    r = ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}

inline void Yuyv2Rgb(const uint8_t* src, uint8_t* dst, int width, int height) {
  // ITU-R BT.601 full-swing conversion, two pixels per YUYV macropixel
  for (int i = 0; i < width * height / 2; ++i) {
    int y0 = src[0], u = src[1] - 128, y1 = src[2], v = src[3] - 128;
    for (int k = 0; k < 2; ++k) {
      int y = k == 0 ? y0 : y1;
      int r = y + ((351 * v) >> 8);
      int g = y - ((179 * v + 86 * u) >> 8);
      int b = y + ((443 * u) >> 8);
      dst[0] = uint8_t(r < 0 ? 0 : r > 255 ? 255 : r);
      dst[1] = uint8_t(g < 0 ? 0 : g > 255 ? 255 : g);
      dst[2] = uint8_t(b < 0 ? 0 : b > 255 ? 255 : b);
      dst += 3;
    }
    src += 4;
  }
}

class V4l2Camera {
 public:
  bool Open(const std::string& device, int width, int height,
            std::string* err) {
    fd_ = open(device.c_str(), O_RDWR | O_NONBLOCK);
    if (fd_ < 0) {
      *err = "cannot open " + device + ": " + strerror(errno);
      return false;
    }
    v4l2_capability cap{};
    if (XIoctl(fd_, VIDIOC_QUERYCAP, &cap) < 0) {
      *err = "VIDIOC_QUERYCAP failed";
      return false;
    }
    if (!(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE)) {
      *err = "device lacks video capture capability";
      return false;
    }
    // format negotiation: YUYV (or MJPEG when preferred/required — the
    // common high-rate USB mode; the vendored usb_cam decodes it via
    // ffmpeg, here via libjpeg).  If the driver rejects the first choice,
    // fall back to the other before failing.
    v4l2_format fmt{};
    fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    fmt.fmt.pix.width = width;
    fmt.fmt.pix.height = height;
    fmt.fmt.pix.field = V4L2_FIELD_INTERLACED;
    const uint32_t first = prefer_mjpeg_ ? V4L2_PIX_FMT_MJPEG
                                         : V4L2_PIX_FMT_YUYV;
    const uint32_t second = prefer_mjpeg_ ? V4L2_PIX_FMT_YUYV
                                          : V4L2_PIX_FMT_MJPEG;
    fmt.fmt.pix.pixelformat = first;
    if (XIoctl(fd_, VIDIOC_S_FMT, &fmt) < 0 ||
        (fmt.fmt.pix.pixelformat != first &&
         fmt.fmt.pix.pixelformat != second)) {
      fmt.fmt.pix.pixelformat = second;
      if (XIoctl(fd_, VIDIOC_S_FMT, &fmt) < 0) {
        *err = "VIDIOC_S_FMT failed";
        return false;
      }
    }
    pixelformat_ = fmt.fmt.pix.pixelformat;
    if (pixelformat_ != V4L2_PIX_FMT_YUYV &&
        pixelformat_ != V4L2_PIX_FMT_MJPEG) {
      *err = "driver negotiated an unsupported pixel format";
      return false;
    }
    width_ = fmt.fmt.pix.width;
    height_ = fmt.fmt.pix.height;

    v4l2_requestbuffers req{};
    req.count = 4;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (XIoctl(fd_, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
      *err = "mmap buffer request failed";
      return false;
    }
    buffers_.resize(req.count);
    for (unsigned i = 0; i < req.count; ++i) {
      v4l2_buffer buf{};
      buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      buf.memory = V4L2_MEMORY_MMAP;
      buf.index = i;
      if (XIoctl(fd_, VIDIOC_QUERYBUF, &buf) < 0) {
        *err = "VIDIOC_QUERYBUF failed";
        return false;
      }
      buffers_[i].length = buf.length;
      buffers_[i].start = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                               MAP_SHARED, fd_, buf.m.offset);
      if (buffers_[i].start == MAP_FAILED) {
        *err = "mmap failed";
        return false;
      }
    }
    for (unsigned i = 0; i < req.count; ++i) {
      v4l2_buffer buf{};
      buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      buf.memory = V4L2_MEMORY_MMAP;
      buf.index = i;
      if (XIoctl(fd_, VIDIOC_QBUF, &buf) < 0) {
        *err = "VIDIOC_QBUF failed";
        return false;
      }
    }
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    if (XIoctl(fd_, VIDIOC_STREAMON, &type) < 0) {
      *err = "VIDIOC_STREAMON failed";
      return false;
    }
    return true;
  }

  // Blocks (select) for the next frame; converts to RGB.
  bool Grab(std::vector<uint8_t>* rgb, std::string* err) {
    fd_set fds;
    FD_ZERO(&fds);
    FD_SET(fd_, &fds);
    timeval tv{2, 0};
    if (select(fd_ + 1, &fds, nullptr, nullptr, &tv) <= 0) {
      *err = "frame timeout";
      return false;
    }
    v4l2_buffer buf{};
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    if (XIoctl(fd_, VIDIOC_DQBUF, &buf) < 0) {
      *err = "VIDIOC_DQBUF failed";
      return false;
    }
    bool ok = true;
    if (pixelformat_ == V4L2_PIX_FMT_MJPEG) {
      int w = 0, h = 0;
      ok = tgs_jpeg::DecodeRgb(
          static_cast<const uint8_t*>(buffers_[buf.index].start),
          buf.bytesused, rgb, &w, &h, err);
      if (ok && (w != width_ || h != height_)) {
        width_ = w;  // some drivers stream a different JPEG size than S_FMT
        height_ = h;
      }
    } else {
      rgb->resize(size_t(width_) * height_ * 3);
      Yuyv2Rgb(static_cast<const uint8_t*>(buffers_[buf.index].start),
               rgb->data(), width_, height_);
    }
    XIoctl(fd_, VIDIOC_QBUF, &buf);
    return ok;
  }

  void set_prefer_mjpeg(bool v) { prefer_mjpeg_ = v; }
  uint32_t pixelformat() const { return pixelformat_; }

  ~V4l2Camera() {
    if (fd_ >= 0) {
      v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      XIoctl(fd_, VIDIOC_STREAMOFF, &type);
      for (auto& b : buffers_) {
        if (b.start) munmap(b.start, b.length);
      }
      close(fd_);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }

 private:
  int fd_ = -1;
  int width_ = 0, height_ = 0;
  bool prefer_mjpeg_ = false;
  uint32_t pixelformat_ = V4L2_PIX_FMT_YUYV;
  std::vector<Buffer> buffers_;
};

}  // namespace tgs_v4l2

#endif  // TOUCHGS_NATIVE_V4L2_CAMERA_H_
