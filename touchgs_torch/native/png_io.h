// Minimal PNG codec (8-bit RGB/RGBA/gray, 16-bit gray) over zlib.
// Part of the native runtime layer (SURVEY.md §2 note: native C++ equivalents
// where the reference is native).  Supports exactly the formats the Touch-GS
// data contract uses: 8-bit RGB images and uint16-mm depth maps.
#pragma once

#include <cstdint>
#include <vector>
#include <string>

namespace touchgs {

struct Image {
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t channels = 0;   // 1, 2, 3 or 4
  uint32_t bit_depth = 0;  // 8 or 16
  // Row-major samples; 16-bit data stored native-endian.
  std::vector<uint8_t> data;

  size_t bytes_per_sample() const { return bit_depth / 8; }
  size_t row_bytes() const {
    return static_cast<size_t>(width) * channels * bytes_per_sample();
  }
};

// Decode a PNG file.  Returns false (and fills err) on failure.  Interlaced
// PNGs and palette images are not supported (never produced by the pipeline).
bool ReadPng(const std::string& path, Image* out, std::string* err);

// Encode an Image to a PNG file (no filtering heuristics: filter 0 rows).
bool WritePng(const std::string& path, const Image& img, std::string* err);

}  // namespace touchgs
