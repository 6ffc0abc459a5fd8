// V4L2 mmap camera capture — native equivalent of the vendored usb_cam driver
// (docstring parity: data_collection/ros1/dtv2_tactile_camera/
// src/usb_cam.cpp — V4L2 ioctl/mmap capture loop, here without ROS).
//
// Usage: tgs_capture --device /dev/video0 --width 640 --height 480 \
//                    --count 10 --out /tmp/capture
// Captures YUYV frames via memory-mapped streaming I/O, converts to RGB and
// writes numbered PNGs — the raw-capture-dir contract the DenseTact pipeline
// consumes (SURVEY.md §2.11).  Builds and runs on any Linux; exits cleanly
// with a message when no camera hardware is present.
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "png_io.h"
#include "v4l2_camera.h"

using tgs_v4l2::V4l2Camera;

int main(int argc, char** argv) {
  std::string device = "/dev/video0", out_dir = "capture";
  int width = 640, height = 480, count = 10;
  bool mjpeg = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--mjpeg") { mjpeg = true; continue; }
    if (i + 1 >= argc) break;
    if (a == "--device") device = argv[++i];
    else if (a == "--width") width = atoi(argv[++i]);
    else if (a == "--height") height = atoi(argv[++i]);
    else if (a == "--count") count = atoi(argv[++i]);
    else if (a == "--out") out_dir = argv[++i];
  }

  V4l2Camera cam;
  cam.set_prefer_mjpeg(mjpeg);
  std::string err;
  if (!cam.Open(device, width, height, &err)) {
    fprintf(stderr, "tgs_capture: %s\n", err.c_str());
    return 1;
  }
  std::vector<uint8_t> rgb;
  for (int i = 0; i < count; ++i) {
    if (!cam.Grab(&rgb, &err)) {
      fprintf(stderr, "tgs_capture: %s\n", err.c_str());
      return 1;
    }
    touchgs::Image img;
    img.width = cam.width();
    img.height = cam.height();
    img.channels = 3;
    img.bit_depth = 8;
    img.data = rgb;
    char path[512];
    snprintf(path, sizeof(path), "%s/frame_%05d.png", out_dir.c_str(), i);
    if (!touchgs::WritePng(path, img, &err)) {
      fprintf(stderr, "tgs_capture: %s\n", err.c_str());
      return 1;
    }
    printf("captured %s\n", path);
  }
  return 0;
}
