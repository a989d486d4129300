// Baseline JPEG decoding on the card through nvJPEG: a plain C interface
// for ctypes (media/nvjpeg.py).
//
// What it replaces: the JAX package decodes MJPEG on the host through
// OpenCV's FFmpeg (caliscope_tpu/media/video.py, FrameSource); it has no TPU
// kernel for it. The port decodes on the card and keeps media/jpeg.py, a
// numpy decoder, as the plain version.
//
// Design. A decoder object owns one nvJPEG handle and its state. It is made
// with the hardware backend (the card's JPEG engines) where
// nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, ...) succeeds and decodes a batch
// with nvjpegDecodeBatched; where that backend is missing it takes nvJPEG's
// GPU backend (NVJPEG_BACKEND_GPU_HYBRID: Huffman decoding on the card too)
// through the decoupled API, one image after another. Both write planar
// 8-bit output (the Y plane alone for a grey image, else Y, Cb and Cr at the
// image's own sampling) into planes that the caller allocated on the device,
// on the caller's stream, and do not synchronise. What bounds it is the
// entropy decoding of the bitstream, which the engines do in hardware.
//
// Error codes: an nvjpegStatus_t is returned as it is (1-99); a CUDA error
// as 1000 + cudaError_t; 900 for arguments the shim refuses.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdlib>
#include <cstring>

namespace {

constexpr int kBadArgument = 900;
constexpr int kCudaBase = 1000;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  int hardware = 0;
  // hardware backend: the batched state and the batch it was set up for
  nvjpegJpegState_t batched = nullptr;
  int batch_n = 0;
  int batch_format = -1;
  // GPU backend: the decoupled decoder and its buffers
  nvjpegJpegDecoder_t decoder = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegBufferPinned_t pinned = nullptr;
  nvjpegBufferDevice_t device = nullptr;
  nvjpegJpegStream_t stream = nullptr;
  nvjpegDecodeParams_t params = nullptr;
};

#define TRY(call)                                        \
  do {                                                   \
    nvjpegStatus_t s_ = (call);                          \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_;     \
  } while (0)

void release(Decoder* d) {
  if (d->params) nvjpegDecodeParamsDestroy(d->params);
  if (d->stream) nvjpegJpegStreamDestroy(d->stream);
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->pinned) nvjpegBufferPinnedDestroy(d->pinned);
  if (d->device) nvjpegBufferDeviceDestroy(d->device);
  if (d->decoder) nvjpegDecoderDestroy(d->decoder);
  if (d->batched) nvjpegJpegStateDestroy(d->batched);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

int make_gpu_backend(Decoder* d) {
  TRY(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, NVJPEG_FLAGS_DEFAULT, &d->handle));
  TRY(nvjpegDecoderCreate(d->handle, NVJPEG_BACKEND_GPU_HYBRID, &d->decoder));
  TRY(nvjpegDecoderStateCreate(d->handle, d->decoder, &d->state));
  TRY(nvjpegBufferPinnedCreate(d->handle, nullptr, &d->pinned));
  TRY(nvjpegBufferDeviceCreate(d->handle, nullptr, &d->device));
  TRY(nvjpegJpegStreamCreate(d->handle, &d->stream));
  TRY(nvjpegDecodeParamsCreate(d->handle, &d->params));
  TRY(nvjpegStateAttachPinnedBuffer(d->state, d->pinned));
  TRY(nvjpegStateAttachDeviceBuffer(d->state, d->device));
  return 0;
}

}  // namespace

extern "C" {

const char* nvjpeg_decode_error_string(int code) {
  if (code >= kCudaBase) return cudaGetErrorString(static_cast<cudaError_t>(code - kCudaBase));
  switch (code) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "NVJPEG_STATUS_INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "NVJPEG_STATUS_EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    case kBadArgument: return "argument refused by the nvjpeg_decode shim";
    default: return "unknown nvJPEG status";
  }
}

// Make a decoder: *out receives it, *hardware_status what
// nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, ...) returned (0: the hardware
// backend is used; else the GPU backend is). Returns 0 or an error code.
int nvjpeg_decode_create(void** out, int* hardware_status) {
  Decoder* d = new Decoder();
  nvjpegStatus_t hw = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, NVJPEG_FLAGS_DEFAULT, &d->handle);
  if (hw == NVJPEG_STATUS_SUCCESS) hw = nvjpegJpegStateCreate(d->handle, &d->batched);
  if (hw == NVJPEG_STATUS_SUCCESS) {
    d->hardware = 1;
  } else {
    if (d->batched) nvjpegJpegStateDestroy(d->batched);
    if (d->handle) nvjpegDestroy(d->handle);
    d->batched = nullptr;
    d->handle = nullptr;
    int err = make_gpu_backend(d);
    if (err) {
      release(d);
      return err;
    }
  }
  *hardware_status = static_cast<int>(hw);
  *out = d;
  return 0;
}

int nvjpeg_decode_destroy(void* dec) {
  if (dec) release(static_cast<Decoder*>(dec));
  return 0;
}

// The image's components and each one's width and height (arrays of 4).
int nvjpeg_decode_info(void* dec, const unsigned char* data, size_t length, int* components, int* widths,
                       int* heights) {
  Decoder* d = static_cast<Decoder*>(dec);
  nvjpegChromaSubsampling_t subsampling;
  TRY(nvjpegGetImageInfo(d->handle, data, length, components, &subsampling, widths, heights));
  return 0;
}

// Decode n images. data[i] / lengths[i] are host bitstreams; planes[i *
// n_planes + c] is the device plane of component c of image i, pitches[c]
// its row pitch in bytes. n_planes is 1 (grey: NVJPEG_OUTPUT_Y) or 3
// (NVJPEG_OUTPUT_YUV). Enqueued on `stream`; does not synchronise.
int nvjpeg_decode_batch(void* dec, int n, const unsigned char* const* data, const size_t* lengths, int n_planes,
                        unsigned char* const* planes, const int* pitches, void* stream) {
  Decoder* d = static_cast<Decoder*>(dec);
  if (n < 1 || (n_planes != 1 && n_planes != 3)) return kBadArgument;
  const nvjpegOutputFormat_t format = n_planes == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegImage_t* images = static_cast<nvjpegImage_t*>(calloc(n, sizeof(nvjpegImage_t)));
  if (!images) return kBadArgument;
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < n_planes; ++c) {
      images[i].channel[c] = planes[i * n_planes + c];
      images[i].pitch[c] = pitches[c];
    }
  }
  int err = 0;
  if (d->hardware) {
    if (d->batch_n != n || d->batch_format != static_cast<int>(format)) {
      nvjpegStatus_t st = nvjpegDecodeBatchedInitialize(d->handle, d->batched, n, 1, format);
      if (st != NVJPEG_STATUS_SUCCESS) {
        free(images);
        return (int)st;
      }
      d->batch_n = n;
      d->batch_format = static_cast<int>(format);
    }
    err = (int)nvjpegDecodeBatched(d->handle, d->batched, data, lengths, images, s);
  } else {
    nvjpegStatus_t st = nvjpegDecodeParamsSetOutputFormat(d->params, format);
    for (int i = 0; i < n && st == NVJPEG_STATUS_SUCCESS; ++i) {
      st = nvjpegJpegStreamParse(d->handle, data[i], lengths[i], 0, 0, d->stream);
      if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegDecodeJpegHost(d->handle, d->decoder, d->state, d->params, d->stream);
      if (st == NVJPEG_STATUS_SUCCESS)
        st = nvjpegDecodeJpegTransferToDevice(d->handle, d->decoder, d->state, d->stream, s);
      if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegDecodeJpegDevice(d->handle, d->decoder, d->state, &images[i], s);
    }
    err = (int)st;
  }
  free(images);
  if (err) return err;
  const cudaError_t ce = cudaGetLastError();
  return ce == cudaSuccess ? 0 : kCudaBase + static_cast<int>(ce);
}

}  // extern "C"
