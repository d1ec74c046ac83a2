// Fast P3 PPM encoder — the native counterpart of the reference's
// write_color stream (src/color.h:14-35, src/camera.h:35):
// header "P3\nW H\n255\n" then one "r g b\n" line per pixel, row-major.
//
// Build:  g++ -O3 -shared -fPIC -o libppm_io.so ppm_io.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Encodes [h*w*3] uint8 pixels into `out` (caller allocates; worst case
// 13 bytes/pixel + 32-byte header). Returns bytes written, or -1 if
// out_capacity is too small.
long ppm_encode(const uint8_t *pixels, int w, int h, char *out,
                long out_capacity) {
  long need = 32L + 13L * w * h;
  if (out_capacity < need) return -1;
  char *p = out;
  p += std::sprintf(p, "P3\n%d %d\n255\n", w, h);
  const long n = static_cast<long>(w) * h;
  for (long i = 0; i < n; ++i) {
    const uint8_t *px = pixels + 3 * i;
    // manual int->ascii: ~3x faster than sprintf for small ints
    for (int c = 0; c < 3; ++c) {
      unsigned v = px[c];
      if (v >= 100) {
        *p++ = '0' + v / 100;
        *p++ = '0' + (v / 10) % 10;
        *p++ = '0' + v % 10;
      } else if (v >= 10) {
        *p++ = '0' + v / 10;
        *p++ = '0' + v % 10;
      } else {
        *p++ = '0' + v;
      }
      *p++ = (c == 2) ? '\n' : ' ';
    }
  }
  return static_cast<long>(p - out);
}
}
