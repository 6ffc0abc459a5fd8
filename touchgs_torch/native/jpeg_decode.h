// Baseline/progressive JPEG decode via libjpeg — the MJPEG half of the
// capture path.  Reference parity: the vendored usb_cam decodes MJPEG
// through ffmpeg's MJPEG codec
// (data_collection/ros1/dtv2_tactile_camera/src/usb_cam.cpp,
// mjpeg2rgb path); high-rate USB modes on the DenseTact cameras are MJPEG.
#ifndef TOUCHGS_NATIVE_JPEG_DECODE_H_
#define TOUCHGS_NATIVE_JPEG_DECODE_H_

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <jpeglib.h>

namespace tgs_jpeg {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char msg[JMSG_LENGTH_MAX];
};

inline void ErrExit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->jump, 1);
}

// Decode a JPEG byte stream to packed RGB8.  Returns false (with *err set)
// on malformed input instead of letting libjpeg call exit().
inline bool DecodeRgb(const uint8_t* data, size_t len,
                      std::vector<uint8_t>* rgb, int* width, int* height,
                      std::string* err) {
  jpeg_decompress_struct cinfo{};
  ErrMgr jerr{};
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = ErrExit;
  if (setjmp(jerr.jump)) {
    *err = std::string("jpeg decode failed: ") + jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    *err = "not a JPEG stream";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb->resize(size_t(*width) * *height * 3);
  const size_t stride = size_t(*width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace tgs_jpeg

#endif  // TOUCHGS_NATIVE_JPEG_DECODE_H_
