// Native JPEG decoder (libjpeg, ctypes-friendly).
//
// Completes the C++ data plane: with tfrecord.cc handling record framing +
// Example parsing, this removes the last Python-imaging dependency (PIL)
// from the native pipeline's hot path for JPEG-encoded datasets
// (kth/ucf101/google_robot). The reference's equivalent decode runs inside
// tf.image.decode_image's C++ kernel (reference
// datasets/base_dataset.py#decode_and_preprocess_images).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libimagecodec.so imagecodec.cc -ljpeg
// (built on first use by video_prediction_torch/native/__init__.py)

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  std::longjmp(err->jump, 1);
}

}  // namespace

extern "C" {

// Decode a JPEG byte buffer to tightly-packed RGB8.
// On success returns a malloc'd pixel buffer (caller frees with
// imgc_free) and sets *h/*w/*c; on failure returns nullptr and writes the
// error message into errbuf (errbuf_len bytes, always NUL-terminated).
uint8_t* imgc_jpeg_decode(const uint8_t* data, uint64_t len, int* h, int* w,
                          int* c, char* errbuf, uint64_t errbuf_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  // volatile: 'out' is modified between setjmp and a potential longjmp
  // (libjpeg can error mid-scanlines); without it the error path could
  // free a stale register copy (formally UB under C++ setjmp rules)
  uint8_t* volatile out = nullptr;
  if (setjmp(err.jump)) {
    if (errbuf && errbuf_len) {
      std::snprintf(errbuf, errbuf_len, "%s", err.message);
    }
    jpeg_destroy_decompress(&cinfo);
    std::free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // force RGB (grayscale sources upsample)
  jpeg_start_decompress(&cinfo);

  const int width = cinfo.output_width;
  const int height = cinfo.output_height;
  const int channels = cinfo.output_components;  // 3 after JCS_RGB
  const size_t stride = static_cast<size_t>(width) * channels;
  out = static_cast<uint8_t*>(std::malloc(stride * height));
  if (!out) {
    if (errbuf && errbuf_len) std::snprintf(errbuf, errbuf_len, "oom");
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + stride * cinfo.output_scanline;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = height;
  *w = width;
  *c = channels;
  return out;
}

void imgc_free(uint8_t* p) { std::free(p); }

}  // extern "C"
