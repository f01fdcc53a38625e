// Host PNG scanline unfilter for the port's image codec (io/image_codec.py).
//
// A PNG's zlib stream inflates to `height` scanlines, each one filter-type
// byte followed by `row_bytes` filtered bytes. Filters 1-4 (sub, up,
// average, Paeth) predict each byte from the byte `bpp` to its left, the
// byte above and the byte above-left; the Paeth predictor depends on the
// bytes just decoded, so a row is undone in order. Bound with ctypes; the
// numpy version is `native.png_unfilter_plain`.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// raw: height * (1 + row_bytes) inflated bytes; out: height * row_bytes.
// Returns 0, or 1 + the row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (row_bytes + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* up = y > 0 ? cur - row_bytes : nullptr;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
