// Synchronized multi-stream capture — native equivalent of the reference's
// ROS capture stack (docstring parity:
//   data_collection/ros1/capturedata/src/capturedata.cpp:11-30
//     (10 Hz Save::Update loop),
//   include/capturedata.h:72-159 (Save: latest-sample caches per stream,
//     keyboard-command-driven synchronized save of images + pose/wrench CSV),
//   src/keyboard_input.cpp:6-25 (raw-termios keyboard trigger)).
//
// Without ROS, streams are:
//   - any number of V4L2 cameras        (--camera /dev/videoN, YUYV mmap)
//   - a pose/wrench line feed on a Unix datagram socket or stdin
//     (--pose-socket PATH), line protocol:
//        pose <frame> <x> <y> <z> <qx> <qy> <qz> <qw>
//        wrench <fx> <fy> <fz> <tx> <ty> <tz>
//   - --sim N: N synthetic camera streams (moving gradient) so the tool and
//     its tests run with no hardware attached.
//
// Each stream runs on its own thread holding the LATEST sample + monotonic
// timestamp under a mutex (the Save callback+copy pattern).  The keyboard
// thread (raw termios, or --auto-capture K for headless use) triggers a
// synchronized snapshot: every stream's latest sample is written with one
// shared capture index — imgs_<cam>/frame_%05d.png, poses.csv, wrench.csv —
// and per-stream timestamps are recorded so downstream tooling can bound the
// sync skew (the reference achieves the same by sampling all caches in one
// Update tick).
//
// Usage:
//   tgs_sync_capture --out DIR [--camera /dev/video0]... [--sim 2]
//                    [--pose-socket /tmp/tgs_pose.sock]
//                    [--auto-capture K] [--rate-hz 10]
#include <fcntl.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <termios.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "png_io.h"
#include "v4l2_camera.h"

namespace {

double NowSec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct FrameCache {           // latest-sample cache, one per stream
  std::mutex mu;
  std::vector<uint8_t> rgb;   // H*W*3
  int width = 0, height = 0;
  double stamp = 0.0;
  bool valid = false;
  std::atomic<bool> disabled{false};  // stream failed to open: don't gate on it
};

struct PoseCache {
  std::mutex mu;
  double pose[8] = {0};       // frame-less: x y z qx qy qz qw (+pad)
  double wrench[6] = {0};
  std::string pose_frame = "none";
  double pose_stamp = 0.0, wrench_stamp = 0.0;
  bool pose_valid = false, wrench_valid = false;
};

std::atomic<bool> g_run{true};

// --- synthetic camera stream (hardware-free testing) -----------------------
void SimCameraThread(FrameCache* cache, int id) {
  const int w = 64, h = 48;
  int t = 0;
  while (g_run) {
    std::vector<uint8_t> rgb(w * h * 3);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        uint8_t* p = &rgb[(y * w + x) * 3];
        p[0] = uint8_t((x * 4 + t * 7 + id * 50) & 0xff);
        p[1] = uint8_t((y * 5 + t * 3) & 0xff);
        p[2] = uint8_t(id * 80 + 40);
      }
    {
      std::lock_guard<std::mutex> lk(cache->mu);
      cache->rgb = std::move(rgb);
      cache->width = w;
      cache->height = h;
      cache->stamp = NowSec();
      cache->valid = true;
    }
    ++t;
    usleep(33000);  // ~30 Hz
  }
}

// --- real V4L2 camera stream ------------------------------------------------
void V4l2Thread(FrameCache* cache, const std::string& device, bool mjpeg) {
  tgs_v4l2::V4l2Camera cam;
  cam.set_prefer_mjpeg(mjpeg);
  std::string err;
  if (!cam.Open(device, 640, 480, &err)) {
    std::fprintf(stderr, "tgs_sync_capture: %s (stream disabled)\n",
                 err.c_str());
    cache->disabled = true;
    return;
  }
  std::vector<uint8_t> rgb;
  while (g_run) {
    if (!cam.Grab(&rgb, &err)) continue;
    std::lock_guard<std::mutex> lk(cache->mu);
    cache->rgb = rgb;
    cache->width = cam.width();
    cache->height = cam.height();
    cache->stamp = NowSec();
    cache->valid = true;
  }
}

// --- pose/wrench feed (unix datagram socket) --------------------------------
void PoseSocketThread(PoseCache* cache, const std::string& path) {
  int fd = socket(AF_UNIX, SOCK_DGRAM, 0);
  if (fd < 0) return;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", path.c_str());
  unlink(path.c_str());
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(fd);
    return;
  }
  char buf[512];
  while (g_run) {
    timeval tv{0, 200000};
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(fd, &rfds);
    if (select(fd + 1, &rfds, nullptr, nullptr, &tv) <= 0) continue;
    ssize_t n = recv(fd, buf, sizeof(buf) - 1, 0);
    if (n <= 0) continue;
    buf[n] = 0;
    char kind[16], frame[64];
    double v[8];
    if (std::sscanf(buf, "pose %63s %lf %lf %lf %lf %lf %lf %lf", frame,
                    &v[0], &v[1], &v[2], &v[3], &v[4], &v[5], &v[6]) == 8) {
      std::lock_guard<std::mutex> lk(cache->mu);
      std::memcpy(cache->pose, v, sizeof(double) * 7);
      cache->pose_frame = frame;
      cache->pose_stamp = NowSec();
      cache->pose_valid = true;
    } else if (std::sscanf(buf, "%15s %lf %lf %lf %lf %lf %lf", kind, &v[0],
                           &v[1], &v[2], &v[3], &v[4], &v[5]) == 7 &&
               std::strcmp(kind, "wrench") == 0) {
      std::lock_guard<std::mutex> lk(cache->mu);
      std::memcpy(cache->wrench, v, sizeof(double) * 6);
      cache->wrench_stamp = NowSec();
      cache->wrench_valid = true;
    }
  }
  close(fd);
  unlink(path.c_str());
}

// --- raw-termios keyboard (keyboard_input.cpp equivalent) -------------------
char ReadKeyNonblock() {
  termios oldt{}, newt{};
  if (tcgetattr(STDIN_FILENO, &oldt) != 0) return 0;
  newt = oldt;
  newt.c_lflag &= ~(ICANON | ECHO);
  newt.c_cc[VMIN] = 0;
  newt.c_cc[VTIME] = 1;  // 0.1 s
  tcsetattr(STDIN_FILENO, TCSANOW, &newt);
  char c = 0;
  ssize_t n = read(STDIN_FILENO, &c, 1);
  tcsetattr(STDIN_FILENO, TCSANOW, &oldt);
  return n == 1 ? c : 0;
}

bool WriteCameraPng(const std::string& dir, int index, FrameCache* cache,
                    double* stamp_out) {
  std::vector<uint8_t> rgb;
  int w, h;
  {
    std::lock_guard<std::mutex> lk(cache->mu);
    if (!cache->valid) return false;
    rgb = cache->rgb;
    w = cache->width;
    h = cache->height;
    *stamp_out = cache->stamp;
  }
  char path[512];
  std::snprintf(path, sizeof(path), "%s/frame_%05d.png", dir.c_str(), index);
  touchgs::Image img;
  img.width = w;
  img.height = h;
  img.channels = 3;
  img.bit_depth = 8;
  img.data = std::move(rgb);
  std::string err;
  return touchgs::WritePng(path, img, &err);
}

}  // namespace

int main(int argc, char** argv) {
  std::string out_dir = "capture";
  std::vector<std::string> devices;
  std::string pose_socket;
  int sim = 0, auto_capture = 0;
  bool mjpeg = false;
  double rate_hz = 10.0;  // the reference's 10 Hz Update loop
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() { return std::string(i + 1 < argc ? argv[++i] : ""); };
    if (a == "--out") out_dir = next();
    else if (a == "--camera") devices.push_back(next());
    else if (a == "--pose-socket") pose_socket = next();
    else if (a == "--sim") sim = std::atoi(next().c_str());
    else if (a == "--auto-capture") auto_capture = std::atoi(next().c_str());
    else if (a == "--rate-hz") rate_hz = std::atof(next().c_str());
    else if (a == "--mjpeg") mjpeg = true;
  }
  if (devices.empty() && sim == 0) {
    std::fprintf(stderr, "no streams: pass --camera or --sim N\n");
    return 2;
  }
  mkdir(out_dir.c_str(), 0755);
  std::vector<std::unique_ptr<FrameCache>> cams;
  std::vector<std::thread> threads;
  for (const auto& dev : devices) {
    cams.emplace_back(new FrameCache);
    threads.emplace_back(V4l2Thread, cams.back().get(), dev, mjpeg);
  }
  for (int i = 0; i < sim; ++i) {
    cams.emplace_back(new FrameCache);
    threads.emplace_back(SimCameraThread, cams.back().get(), i);
  }
  for (size_t i = 0; i < cams.size(); ++i) {
    char d[512];
    std::snprintf(d, sizeof(d), "%s/imgs_cam%zu", out_dir.c_str(), i);
    mkdir(d, 0755);
  }
  PoseCache pose;
  if (!pose_socket.empty())
    threads.emplace_back(PoseSocketThread, &pose, pose_socket);

  std::string poses_csv = out_dir + "/poses.csv";
  std::string wrench_csv = out_dir + "/wrench.csv";
  FILE* fp = std::fopen(poses_csv.c_str(), "w");
  std::fprintf(fp, "index,frame,x,y,z,qx,qy,qz,qw,stamp\n");
  FILE* fw = std::fopen(wrench_csv.c_str(), "w");
  std::fprintf(fw, "index,fx,fy,fz,tx,ty,tz,stamp\n");

  std::fprintf(stderr,
               "tgs_sync_capture: %zu stream(s) → %s  "
               "[space/s = capture, q = quit]\n",
               cams.size(), out_dir.c_str());
  int index = 0;
  const useconds_t tick = (useconds_t)(1e6 / rate_hz);
  while (g_run) {
    bool trigger = false;
    if (auto_capture > 0) {
      trigger = true;
    } else {
      char c = ReadKeyNonblock();
      if (c == 'q') break;
      trigger = (c == ' ' || c == 's');
    }
    if (trigger) {
      // synchronized snapshot: sample every cache in one tick (the Save
      // class's Update-loop semantics) under one shared index.  The
      // reference's Save only starts sampling after every subscribed
      // stream has delivered its first message — gate the same way, so a
      // slow-starting stream delays the capture instead of being dropped
      // from it (capturedata.cpp Save::Update semantics).
      bool all_valid = true;
      for (auto& c : cams) {
        if (c->disabled) continue;  // failed-open streams can't gate capture
        std::lock_guard<std::mutex> lk(c->mu);
        if (!c->valid) { all_valid = false; break; }
      }
      if (!all_valid) {
        usleep(tick);
        continue;  // retry next tick; auto-capture count unaffected
      }
      bool any = false;
      double maxskew = 0.0, first_stamp = -1.0;
      for (size_t c = 0; c < cams.size(); ++c) {
        char d[512];
        std::snprintf(d, sizeof(d), "%s/imgs_cam%zu", out_dir.c_str(), c);
        double st = 0;
        if (WriteCameraPng(d, index, cams[c].get(), &st)) {
          any = true;
          if (first_stamp < 0) first_stamp = st;
          maxskew = std::max(maxskew, std::fabs(st - first_stamp));
        }
      }
      {
        std::lock_guard<std::mutex> lk(pose.mu);
        std::fprintf(fp, "%d,%s,%f,%f,%f,%f,%f,%f,%f,%f\n", index,
                     pose.pose_frame.c_str(), pose.pose[0], pose.pose[1],
                     pose.pose[2], pose.pose[3], pose.pose[4], pose.pose[5],
                     pose.pose[6], pose.pose_stamp);
        std::fprintf(fw, "%d,%f,%f,%f,%f,%f,%f,%f\n", index, pose.wrench[0],
                     pose.wrench[1], pose.wrench[2], pose.wrench[3],
                     pose.wrench[4], pose.wrench[5], pose.wrench_stamp);
        std::fflush(fp);
        std::fflush(fw);
      }
      if (any) {
        std::fprintf(stderr, "capture %d (skew %.1f ms)\n", index,
                     maxskew * 1e3);
        ++index;
      }
      if (auto_capture > 0 && index >= auto_capture) break;
    }
    usleep(tick);
  }
  g_run = false;
  for (auto& t : threads) t.join();
  std::fclose(fp);
  std::fclose(fw);
  std::fprintf(stderr, "wrote %d synchronized captures → %s\n", index,
               out_dir.c_str());
  return 0;
}
