/* Native host-side decode helpers of the data loader (a copy of
 * unidepth_tpu/native/depth_decode.c): the 24-bit depth unpack (d = b2 +
 * b1 * 255 + b0 * 255^2) fused with the depth-scale division in one pass,
 * its uint16 variant, the ImageNet normalisation of uint8 RGB, and the PNG
 * scanline unfilter. Built with the system C compiler at first use and
 * bound with ctypes (unidepth_tpu_torch/native/__init__.py).
 */

#include <stdint.h>
#include <stddef.h>

void unpack24_scale(const uint8_t *in, float *out, int64_t n, float inv_scale) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t *px = in + 3 * i;
        /* matches the reference arithmetic exactly: 255 (not 256) radix */
        double v = (double)px[2] + (double)px[1] * 255.0 +
                   (double)px[0] * 255.0 * 255.0;
        out[i] = (float)(v * (double)inv_scale);
    }
}

void scale_u16(const uint16_t *in, float *out, int64_t n, float inv_scale) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (float)((double)in[i] * (double)inv_scale);
    }
}

/* normalize uint8 RGB to float32 with per-channel mean/std (imagenet) */
void normalize_u8(const uint8_t *in, float *out, int64_t npx,
                  const float *mean, const float *std_inv) {
    for (int64_t i = 0; i < npx; ++i) {
        const uint8_t *px = in + 3 * i;
        float *o = out + 3 * i;
        o[0] = ((float)px[0] / 255.0f - mean[0]) * std_inv[0];
        o[1] = ((float)px[1] / 255.0f - mean[1]) * std_inv[1];
        o[2] = ((float)px[2] / 255.0f - mean[2]) * std_inv[2];
    }
}

/* PNG scanline unfilter (spec filters 0-4) for arbitrary bytes-per-pixel.
 * raw: h * (1 + stride) filtered bytes (leading filter byte per row);
 * out: h * stride reconstructed bytes. Needed for 16-bit RGB flow PNGs,
 * which PIL silently downcasts to 8 bits. */
void png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h, int64_t stride,
                  int bpp) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t *line = raw + y * (stride + 1);
        uint8_t f = line[0];
        const uint8_t *src = line + 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *prev = y > 0 ? out + (y - 1) * stride : 0;
        for (int64_t x = 0; x < stride; ++x) {
            int a = x >= bpp ? cur[x - bpp] : 0;
            int b = prev ? prev[x] : 0;
            int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
            int v = src[x];
            switch (f) {
            case 1: v += a; break;
            case 2: v += b; break;
            case 3: v += (a + b) >> 1; break;
            case 4: {
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                v += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                break;
            }
            default: break;
            }
            cur[x] = (uint8_t)v;
        }
    }
}
