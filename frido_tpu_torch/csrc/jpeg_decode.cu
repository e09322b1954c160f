// JPEG decode on the card with nvJPEG: the port's counterpart of the
// libjpeg decode in native/frido_native.cpp (decode_jpeg).
//
// One image per call. nvJPEG's simple handle (nvjpegCreateSimple picks the
// default backend, the hybrid one: Huffman decoding on the host, the
// inverse DCT on the card; progressive JPEGs included) and a JPEG state
// are made on first use and kept in a free list: a call takes a pair,
// decodes and puts it back, so concurrent callers (the loader's threads)
// each hold a pair of their own while they decode, and no more pairs are
// made than callers ever ran at once. The pairs live as long as the
// process.
//
// The decode stops before the chroma upsampling and the colour conversion:
// it writes the planes as they are coded (NVJPEG_OUTPUT_YUV: Y, Cb and Cr
// at their own sizes; NVJPEG_OUTPUT_Y for a grey file; with `unchanged`,
// NVJPEG_OUTPUT_UNCHANGED: every component, four for a CMYK or YCCK
// file, as coded) into planes the caller allocated on the card, on the
// caller's stream. The caller upsamples and converts them as libjpeg and
// PIL do (frido_tpu_torch/ops/cuda/jpeg.py): nvJPEG's own upsampling and
// conversion round differently from libjpeg's, up to 4 levels on a 4:4:4
// file and tens of levels at colour edges of a 4:2:0 one. A component
// count other than 1, 3 or 4, or an unknown chroma layout of a 1- or
// 3-component file, is refused before decoding.
//
// C interface, bound with ctypes by frido_tpu_torch/ops/cuda/jpeg.py:
//   fj_info(data, len, &components, &subsampling, widths[4], heights[4])
//   fj_decode(data, len, p0, p1, p2, p3, components, unchanged, stream)
// Both return 0 or an nvjpegStatus_t; fj_decode returns -1 for a layout it
// refuses.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <mutex>
#include <vector>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

std::mutex pool_mu;
std::vector<Decoder*> pool;

// A handle and state of one's own, made on first use; nullptr and the
// status in *status when nvJPEG cannot make them.
Decoder* acquire(int* status) {
  {
    std::lock_guard<std::mutex> lk(pool_mu);
    if (!pool.empty()) {
      Decoder* d = pool.back();
      pool.pop_back();
      return d;
    }
  }
  Decoder* d = new Decoder();
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegJpegStateCreate(d->handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (d->handle != nullptr) nvjpegDestroy(d->handle);
    delete d;
    *status = static_cast<int>(s);
    return nullptr;
  }
  return d;
}

void release(Decoder* d) {
  std::lock_guard<std::mutex> lk(pool_mu);
  pool.push_back(d);
}

}  // namespace

extern "C" {

// The header's component count, chroma layout (nvjpegChromaSubsampling_t)
// and each component's plane width and height.
int fj_info(const unsigned char* data, size_t len, int* components,
            int* subsampling, int* widths, int* heights) {
  int status = 0;
  Decoder* d = acquire(&status);
  if (d == nullptr) return status;
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t s = nvjpegGetImageInfo(d->handle, data, len, components,
                                        &css, widths, heights);
  release(d);
  *subsampling = static_cast<int>(css);
  return static_cast<int>(s);
}

// Decode the coded planes: p0 [heights[0], widths[0]], and for three or
// four components p1, p2 (and p3) at their own sizes (from fj_info), on
// stream. `unchanged` (required for four components) asks for the
// components as coded (NVJPEG_OUTPUT_UNCHANGED).
int fj_decode(const unsigned char* data, size_t len, unsigned char* p0,
              unsigned char* p1, unsigned char* p2, unsigned char* p3,
              int components, int unchanged, cudaStream_t stream) {
  int status = 0;
  Decoder* d = acquire(&status);
  if (d == nullptr) return status;
  int got = 0;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t s = nvjpegGetImageInfo(d->handle, data, len, &got, &css,
                                        widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) {
    release(d);
    return static_cast<int>(s);
  }
  if (got != components || (got != 1 && got != 3 && got != 4) ||
      (got == 4 && !unchanged) || (got != 4 && css == NVJPEG_CSS_UNKNOWN)) {
    release(d);
    return -1;
  }
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  unsigned char* planes[4] = {p0, p1, p2, p3};
  for (int c = 0; c < got; ++c) {
    image.channel[c] = planes[c];
    image.pitch[c] = static_cast<size_t>(widths[c]);
  }
  nvjpegOutputFormat_t fmt = unchanged ? NVJPEG_OUTPUT_UNCHANGED
                             : (got == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV);
  s = nvjpegDecode(d->handle, d->state, data, len, fmt, &image, stream);
  release(d);
  return static_cast<int>(s);
}

}  // extern "C"
