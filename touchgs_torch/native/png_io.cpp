// Minimal PNG codec over zlib — see png_io.h.
#include "png_io.h"

#include <zlib.h>

#include <cstdio>
#include <cstring>

namespace touchgs {
namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

uint32_t ReadBE32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void WriteBE32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = v >> 16;
  p[2] = v >> 8;
  p[3] = v;
}

int ChannelsForColorType(uint8_t color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0; // palette (3) unsupported
  }
}

// Paeth predictor (PNG spec).
inline int Paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool Inflate(const std::vector<uint8_t>& in, std::vector<uint8_t>* out,
             std::string* err) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) {
    *err = "inflateInit failed";
    return false;
  }
  zs.next_in = const_cast<uint8_t*>(in.data());
  zs.avail_in = in.size();
  std::vector<uint8_t> buf(1 << 18);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = buf.size();
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      *err = "inflate error";
      return false;
    }
    out->insert(out->end(), buf.data(),
                buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

bool Deflate(const std::vector<uint8_t>& in, std::vector<uint8_t>* out,
             std::string* err) {
  uLongf bound = compressBound(in.size());
  out->resize(bound);
  if (compress2(out->data(), &bound, in.data(), in.size(), 6) != Z_OK) {
    *err = "deflate error";
    return false;
  }
  out->resize(bound);
  return true;
}

}  // namespace

bool ReadPng(const std::string& path, Image* out, std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || memcmp(sig, kSig, 8) != 0) {
    fclose(f);
    *err = "not a png: " + path;
    return false;
  }

  uint32_t width = 0, height = 0;
  uint8_t bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  while (true) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len = ReadBE32(hdr);
    char type[5] = {char(hdr[4]), char(hdr[5]), char(hdr[6]), char(hdr[7]), 0};
    std::vector<uint8_t> payload(len);
    if (len && fread(payload.data(), 1, len, f) != len) {
      fclose(f);
      *err = "truncated chunk";
      return false;
    }
    fseek(f, 4, SEEK_CUR);  // skip CRC (we trust local files)
    if (strcmp(type, "IHDR") == 0) {
      width = ReadBE32(payload.data());
      height = ReadBE32(payload.data() + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (strcmp(type, "IDAT") == 0) {
      idat.insert(idat.end(), payload.begin(), payload.end());
    } else if (strcmp(type, "IEND") == 0) {
      break;
    }
  }
  fclose(f);

  int channels = ChannelsForColorType(color_type);
  if (channels == 0 || interlace != 0 || (bit_depth != 8 && bit_depth != 16)) {
    *err = "unsupported png format";
    return false;
  }

  std::vector<uint8_t> raw;
  if (!Inflate(idat, &raw, err)) return false;

  size_t bps = bit_depth / 8;
  size_t stride = size_t(width) * channels * bps;   // filtered row payload
  size_t fpx = channels * bps;                      // filter step
  if (raw.size() < height * (stride + 1)) {
    *err = "png data too short";
    return false;
  }

  out->width = width;
  out->height = height;
  out->channels = channels;
  out->bit_depth = bit_depth;
  out->data.resize(height * stride);

  std::vector<uint8_t> prev(stride, 0);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out->data.data() + y * stride;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= fpx ? dst[x - fpx] : 0;
      int b = prev[x];
      int c = x >= fpx ? prev[x - fpx] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += Paeth(a, b, c); break;
        default: *err = "bad filter"; return false;
      }
      dst[x] = uint8_t(v);
    }
    memcpy(prev.data(), dst, stride);
  }

  // big-endian 16-bit samples → native (little-endian) order
  if (bit_depth == 16) {
    for (size_t i = 0; i + 1 < out->data.size(); i += 2) {
      std::swap(out->data[i], out->data[i + 1]);
    }
  }
  return true;
}

bool WritePng(const std::string& path, const Image& img, std::string* err) {
  uint8_t color_type;
  switch (img.channels) {
    case 1: color_type = 0; break;
    case 2: color_type = 4; break;
    case 3: color_type = 2; break;
    case 4: color_type = 6; break;
    default: *err = "bad channel count"; return false;
  }
  size_t stride = img.row_bytes();

  // filter-0 rows, 16-bit back to big-endian
  std::vector<uint8_t> raw(img.height * (stride + 1));
  for (uint32_t y = 0; y < img.height; ++y) {
    uint8_t* dst = raw.data() + y * (stride + 1);
    dst[0] = 0;
    memcpy(dst + 1, img.data.data() + y * stride, stride);
    if (img.bit_depth == 16) {
      for (size_t i = 1; i + 1 < stride + 1; i += 2) std::swap(dst[i], dst[i + 1]);
    }
  }
  std::vector<uint8_t> compressed;
  if (!Deflate(raw, &compressed, err)) return false;

  FILE* f = fopen(path.c_str(), "wb");
  if (!f) {
    *err = "cannot write " + path;
    return false;
  }
  fwrite(kSig, 1, 8, f);

  auto write_chunk = [&](const char* type, const uint8_t* data, uint32_t len) {
    uint8_t hdr[8];
    WriteBE32(hdr, len);
    memcpy(hdr + 4, type, 4);
    fwrite(hdr, 1, 8, f);
    if (len) fwrite(data, 1, len, f);
    uLong crc = crc32(0, hdr + 4, 4);
    if (len) crc = crc32(crc, data, len);
    uint8_t crcb[4];
    WriteBE32(crcb, crc);
    fwrite(crcb, 1, 4, f);
  };

  uint8_t ihdr[13];
  WriteBE32(ihdr, img.width);
  WriteBE32(ihdr + 4, img.height);
  ihdr[8] = img.bit_depth;
  ihdr[9] = color_type;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  write_chunk("IHDR", ihdr, 13);
  write_chunk("IDAT", compressed.data(), compressed.size());
  write_chunk("IEND", nullptr, 0);
  fclose(f);
  return true;
}

}  // namespace touchgs
