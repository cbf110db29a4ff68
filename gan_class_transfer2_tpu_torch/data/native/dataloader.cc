// Native data loader of the PyTorch port: decode → random crop → flip →
// normalise → batch, on a pool of worker threads, with a bounded window of
// batches in flight; plus the packed uint8 dataset cache and CRC32C.
//
// Counterpart of gan_class_transfer2_tpu/data/native/dataloader.cc, with
// its C API (dl_create, dl_next, dl_error, dl_destroy, dl_decode_one,
// dl_cache_build, dl_crc32c) and its element semantics:
//   * decode forced to 3 channels (grey replicated, palette expanded,
//     alpha dropped), PNG or JPEG chosen by the magic bytes
//   * a uniform random crop to size×size when larger
//   * a horizontal flip with p = 1/2
//   * uint8/128 − 1 → float32 in [−1, 0.9921875]
//
// What differs, and why:
//   * PNG is decoded here (zlib's inflate, the five filters, colour types
//     0, 2, 3, 4 and 6 at 8 bits: what utils/png.py reads), not by libpng:
//     the card's machine has zlib's headers but not libpng's, and one code
//     path everywhere lets the CPU tests test what the card runs. libjpeg
//     is compiled in (-DGCT2_JPEG) only where jpeglib.h is found; without
//     it a JPEG stops the run by name (dl_next -3, dl_decode_one -4,
//     dl_cache_build -2 - i) instead of counting as a bad file.
//   * The stream does not depend on timing. A worker claims batch k and
//     its file indices together, under one lock, from the shared
//     shuffle-without-replacement stream; each image's crop and flip come
//     from a generator keyed by (seed, its position in that stream); dl_next
//     returns batches in claim order. So where every file decodes, batch k
//     is the same for 1 and for 8 workers, and epoch boundaries fall on
//     batch boundaries. A file that fails is replaced by the next draw of
//     the shared stream, as in JAX.
//   * dl_stop wakes a consumer blocked in dl_next (it returns -1), so the
//     binding can stop the loader while another thread iterates and destroy
//     it only after that call has returned.
//   * dl_decode_one is called twice by the binding: first with no buffer,
//     which fails with -3 after filling in the image's height and width,
//     then with a buffer of that size — no separate header parser.
//   dl_decode_one(seed) draws its crop and flip from std::mt19937_64(seed)
//   as JAX's does, so the two agree bit for bit.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include <zlib.h>
#ifdef GCT2_JPEG
#include <jpeglib.h>
#endif

namespace {

struct Image {
  std::vector<uint8_t> data;  // H*W*3
  int h = 0, w = 0;
};

// 2^26 pixels (67 MP): a corrupt header claiming more is refused before
// the allocation, which would otherwise throw on a worker thread
constexpr uint64_t kMaxPixels = 1ull << 26;

// Decode outcome: a file either decodes, is bad (tolerated, like TF's
// decoder), or is in a format this build has no decoder for (a JPEG where
// jpeglib.h was not found), which is not a bad file and stops the run.
enum Decoded { kOk = 0, kBad = 1, kNoDecoder = 2 };

// ---------------------------------------------------------------- PNG ------
// 8-bit non-interlaced PNG of colour type 0, 2, 3, 4 or 6 (what
// utils/png.py reads), inflated by zlib and unfiltered here, converted to
// RGB as Pillow's convert("RGB") and libpng's expand/strip transforms do:
// grey replicated, palette looked up (indices past it read as black), alpha
// dropped. One code path on every machine: zlib is everywhere, libpng's
// headers are not.

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool inflate_exact(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = Z_OK;
  while (rc == Z_OK && zs.avail_out > 0) rc = inflate(&zs, Z_NO_FLUSH);
  inflateEnd(&zs);
  // data past the image (or a missing end marker after it) is tolerated;
  // data that stops short of it is not
  return zs.avail_out == 0 && (rc == Z_OK || rc == Z_STREAM_END || rc == Z_BUF_ERROR);
}

// undo the scanline filters (PNG spec section 9): raw holds h rows of one
// filter byte and stride bytes; out gets h * stride. One loop per filter
// type, the first bpp bytes (no left neighbour) peeled off.
bool unfilter(const uint8_t* raw, int h, size_t stride, int bpp, uint8_t* out) {
  const std::vector<uint8_t> zeros(stride);  // the row above the first
  const size_t n = static_cast<size_t>(bpp);
  const uint8_t* prev = zeros.data();
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = raw + static_cast<size_t>(y) * (stride + 1) + 1;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    switch (f[-1]) {
      case 0:
        std::memcpy(cur, f, stride);
        break;
      case 1:
        for (size_t i = 0; i < n; ++i) cur[i] = f[i];
        for (size_t i = n; i < stride; ++i) cur[i] = f[i] + cur[i - n];
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] = f[i] + prev[i];
        break;
      case 3:
        for (size_t i = 0; i < n; ++i) cur[i] = f[i] + (prev[i] >> 1);
        for (size_t i = n; i < stride; ++i) cur[i] = f[i] + ((cur[i - n] + prev[i]) >> 1);
        break;
      case 4:
        for (size_t i = 0; i < n; ++i) cur[i] = f[i] + prev[i];
        for (size_t i = n; i < stride; ++i) {
          int a = cur[i - n], b = prev[i], c = prev[i - n];
          int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          cur[i] = f[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 33 || std::memcmp(buf, kSig, 8) != 0 || std::memcmp(buf + 12, "IHDR", 4) != 0)
    return false;
  uint32_t w = be32(buf + 16), h = be32(buf + 20);
  int depth = buf[24], ctype = buf[25];
  if (w == 0 || h == 0 || static_cast<uint64_t>(w) * h > kMaxPixels) return false;
  if (depth != 8 || buf[26] != 0 || buf[27] != 0 || buf[28] != 0) return false;
  int ch;
  switch (ctype) {
    case 0: case 3: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return false;
  }
  std::vector<uint8_t> idat, palette;
  bool ended = false;
  for (size_t pos = 8; pos + 12 <= len;) {
    uint32_t n = be32(buf + pos);
    if (n > len - pos - 12) return false;  // a chunk past the end of the file
    const uint8_t* tag = buf + pos + 4;
    const uint8_t* body = tag + 4;
    if (crc32(0, tag, n + 4) != be32(body + n)) return false;
    if (std::memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + n);
    } else if (std::memcmp(tag, "PLTE", 4) == 0) {
      palette.assign(body, body + n);
    } else if (std::memcmp(tag, "IEND", 4) == 0) {
      ended = true;
      break;
    }
    pos += 12 + static_cast<size_t>(n);
  }
  if (!ended || idat.empty()) return false;
  if (ctype == 3 && (palette.empty() || palette.size() % 3 != 0)) return false;
  size_t stride = static_cast<size_t>(w) * ch;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  if (!inflate_exact(idat, &raw)) return false;
  std::vector<uint8_t> px(static_cast<size_t>(h) * stride);
  if (!unfilter(raw.data(), static_cast<int>(h), stride, ch, px.data())) return false;

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->data.resize(static_cast<size_t>(h) * w * 3);
  uint8_t* dst = out->data.data();
  const size_t n_px = static_cast<size_t>(h) * w;
  uint8_t table[256][3] = {};  // entries past the palette read as black
  for (size_t i = 0; i < std::min<size_t>(palette.size() / 3, 256); ++i)
    std::memcpy(table[i], &palette[3 * i], 3);
  for (size_t i = 0; i < n_px; ++i) {
    const uint8_t* s = px.data() + i * ch;
    uint8_t* d = dst + i * 3;
    if (ctype == 3) {
      std::memcpy(d, table[s[0]], 3);
    } else if (ch <= 2) {
      d[0] = d[1] = d[2] = s[0];
    } else {
      d[0] = s[0], d[1] = s[1], d[2] = s[2];
    }
  }
  return true;
}

// --------------------------------------------------------------- JPEG ------

#ifdef GCT2_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_height == 0 || cinfo.output_width == 0 ||
      static_cast<uint64_t>(cinfo.output_height) * cinfo.output_width > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->data.resize(static_cast<size_t>(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        out->data.data() + static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif

Decoded decode_any(const uint8_t* buf, size_t len, Image* out) {
  if (len >= 8 && std::memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0)
    return decode_png(buf, len, out) ? kOk : kBad;
  bool jpeg_magic = len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8;
#ifdef GCT2_JPEG
  if (jpeg_magic) return decode_jpeg(buf, len, out) ? kOk : kBad;
  // unknown magic: try both (decoder tolerance like tf.image.decode_jpeg)
  return (decode_png(buf, len, out) || decode_jpeg(buf, len, out)) ? kOk : kBad;
#else
  if (jpeg_magic) return kNoDecoder;
  return decode_png(buf, len, out) ? kOk : kBad;
#endif
}

bool load_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  // ftell is -1 on non-seekable special files
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return false;
  }
  long n = ftell(f);
  if (n < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

Decoded decode_file(const std::string& path, Image* img) {
  std::vector<uint8_t> raw;
  if (!load_file(path, &raw)) return kBad;
  return decode_any(raw.data(), raw.size(), img);
}

// ------------------------------------------------------------ augment ------

// crop/flip/normalise into out[size*size*3] float32; false when the image
// is smaller than the crop
bool augment_to(const Image& img, int size, std::mt19937_64* rng, float* out) {
  if (img.h < size || img.w < size) return false;
  int max_i = img.h - size, max_j = img.w - size;
  int ci = 0, cj = 0;
  if (max_i > 0) ci = static_cast<int>((*rng)() % (max_i + 1));
  if (max_j > 0) cj = static_cast<int>((*rng)() % (max_j + 1));
  bool flip = ((*rng)() & 1) != 0;
  for (int i = 0; i < size; ++i) {
    const uint8_t* src =
        img.data.data() + (static_cast<size_t>(ci + i) * img.w + cj) * 3;
    float* dst = out + static_cast<size_t>(i) * size * 3;
    if (!flip) {
      for (int j = 0; j < size * 3; ++j)
        dst[j] = static_cast<float>(src[j]) * (1.0f / 128.0f) - 1.0f;
    } else {
      for (int j = 0; j < size; ++j) {
        const uint8_t* p = src + (size - 1 - j) * 3;
        dst[j * 3 + 0] = static_cast<float>(p[0]) * (1.0f / 128.0f) - 1.0f;
        dst[j * 3 + 1] = static_cast<float>(p[1]) * (1.0f / 128.0f) - 1.0f;
        dst[j * 3 + 2] = static_cast<float>(p[2]) * (1.0f / 128.0f) - 1.0f;
      }
    }
  }
  return true;
}

// the seed of one image's crop/flip generator: the loader seed and the
// image's position in the shared draw stream, through splitmix64
uint64_t draw_seed(uint64_t seed, uint64_t position) {
  uint64_t z = seed * 0x9E3779B97F4A7C15ULL + position + 1;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// ------------------------------------------------------------- loader ------

struct Draw {
  uint32_t file;
  uint64_t position;
};

struct Loader {
  std::vector<std::string> files;
  int size = 0;
  int batch = 0;
  uint64_t window = 0;  // batches claimed and not yet returned, at most
  uint64_t seed = 0;

  std::mutex mu;  // guards everything below
  std::condition_variable can_claim, ready;
  bool stop = false;
  int error = 0;  // 0, or dl_next's code for the failure: -2 or -3
  std::string error_message;

  // the shared epoch permutation: every file once per epoch across the pool
  std::vector<uint32_t> perm;
  size_t perm_pos = 0;
  uint64_t drawn = 0;
  std::mt19937_64 perm_rng;

  uint64_t next_claim = 0;  // id of the next batch a worker claims
  uint64_t next_out = 0;    // id of the next batch dl_next returns
  std::map<uint64_t, std::vector<float>> done;

  std::vector<std::thread> workers;

  Draw draw_locked() {
    if (perm_pos >= perm.size()) {
      std::shuffle(perm.begin(), perm.end(), perm_rng);
      perm_pos = 0;
    }
    return Draw{perm[perm_pos++], drawn++};
  }

  void halt() {
    {
      // under mu: a thread between its wait predicate and blocking would
      // otherwise miss the notify
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    can_claim.notify_all();
    ready.notify_all();
  }

  ~Loader() {
    halt();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

void fail_loader(Loader* L, const std::string& message, int code = -2) {
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->error_message.empty()) {
      L->error_message = message;
      L->error = code;
    }
    L->stop = true;
  }
  L->ready.notify_all();
  L->can_claim.notify_all();
}

void worker_loop(Loader* L) {
  const size_t elem = static_cast<size_t>(L->size) * L->size * 3;
  // tolerate scattered bad files, but fail loudly when nothing decodes or
  // fits the crop instead of leaving dl_next blocked forever
  const long fail_limit = std::max<long>(100, 2 * static_cast<long>(L->files.size()));
  long consecutive_failures = 0;
  std::vector<Draw> draws(L->batch);
  for (;;) {
    uint64_t id;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->can_claim.wait(lk, [L] { return L->stop || L->next_claim < L->next_out + L->window; });
      if (L->stop) return;
      id = L->next_claim++;
      for (auto& d : draws) d = L->draw_locked();
    }
    std::vector<float> out(static_cast<size_t>(L->batch) * elem);
    for (int b = 0; b < L->batch; ++b) {
      Draw d = draws[b];
      for (;;) {
        bool ok = false;
        try {
          Image img;
          std::mt19937_64 rng(draw_seed(L->seed, d.position));
          Decoded r = decode_file(L->files[d.file], &img);
          if (r == kNoDecoder) {
            fail_loader(L, L->files[d.file] + " is a JPEG, and this build of the native "
                        "loader has no JPEG decoder (jpeglib.h was not found)", -3);
            return;
          }
          ok = r == kOk && augment_to(img, L->size, &rng, out.data() + b * elem);
        } catch (const std::exception&) {
          ok = false;  // e.g. bad_alloc on a corrupt header: a bad file
        }
        if (ok) {
          consecutive_failures = 0;
          break;
        }
        if (++consecutive_failures >= fail_limit) {
          fail_loader(L, "native loader: " + std::to_string(consecutive_failures) +
                             " consecutive decode/crop failures (last: " +
                             L->files[d.file] + ")");
          return;
        }
        std::lock_guard<std::mutex> lk(L->mu);
        if (L->stop) return;
        d = L->draw_locked();  // refill the slot from the shared stream
      }
    }
    {
      std::lock_guard<std::mutex> lk(L->mu);
      if (L->stop) return;
      L->done.emplace(id, std::move(out));
    }
    L->ready.notify_all();
  }
}

void worker_main(Loader* L) {
  // an exception escaping a std::thread terminates the process
  try {
    worker_loop(L);
  } catch (const std::exception& e) {
    fail_loader(L, std::string("native loader worker: ") + e.what());
  } catch (...) {
    fail_loader(L, "native loader worker: unknown exception");
  }
}

// ------------------------------------------------------------ resize -------

// bilinear shortest-side resize to `target`, then the centre target×target
void resize_center_crop(const Image& img, int target, uint8_t* out) {
  double scale = static_cast<double>(target) / std::min(img.h, img.w);
  int rh = std::max(target, static_cast<int>(img.h * scale + 0.5));
  int rw = std::max(target, static_cast<int>(img.w * scale + 0.5));
  int off_h = (rh - target) / 2, off_w = (rw - target) / 2;
  for (int i = 0; i < target; ++i) {
    double sy = (i + off_h + 0.5) * img.h / rh - 0.5;
    int y0 = std::max(0, std::min(img.h - 1, static_cast<int>(sy)));
    int y1 = std::min(img.h - 1, y0 + 1);
    double fy = std::max(0.0, std::min(1.0, sy - y0));
    for (int j = 0; j < target; ++j) {
      double sx = (j + off_w + 0.5) * img.w / rw - 0.5;
      int x0 = std::max(0, std::min(img.w - 1, static_cast<int>(sx)));
      int x1 = std::min(img.w - 1, x0 + 1);
      double fx = std::max(0.0, std::min(1.0, sx - x0));
      for (int c = 0; c < 3; ++c) {
        double v00 = img.data[(static_cast<size_t>(y0) * img.w + x0) * 3 + c];
        double v01 = img.data[(static_cast<size_t>(y0) * img.w + x1) * 3 + c];
        double v10 = img.data[(static_cast<size_t>(y1) * img.w + x0) * 3 + c];
        double v11 = img.data[(static_cast<size_t>(y1) * img.w + x1) * 3 + c];
        double v = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
                   v10 * fy * (1 - fx) + v11 * fy * fx;
        out[(static_cast<size_t>(i) * target + j) * 3 + c] = static_cast<uint8_t>(v + 0.5);
      }
    }
  }
}

// ----------------------------------------------------------- crc32c --------
// Castagnoli CRC (reflected), slicing-by-8: TFRecord framing masks a CRC32C
// over every TensorBoard payload (utils/tensorboard.py).
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; ++n)
      for (int s = 1; s < 8; ++s) t[s][n] = (t[s - 1][n] >> 8) ^ t[0][t[s - 1][n] & 0xFF];
  }
};
const Crc32cTables kCrc;

uint32_t crc32c_impl(const uint8_t* p, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;  // little-endian hosts
    crc = kCrc.t[7][w & 0xFF] ^ kCrc.t[6][(w >> 8) & 0xFF] ^
          kCrc.t[5][(w >> 16) & 0xFF] ^ kCrc.t[4][(w >> 24) & 0xFF] ^
          kCrc.t[3][(w >> 32) & 0xFF] ^ kCrc.t[2][(w >> 40) & 0xFF] ^
          kCrc.t[1][(w >> 48) & 0xFF] ^ kCrc.t[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = kCrc.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// Packed uint8 dataset cache: a header (magic 'GCT2', version 1, count,
// store) and count records of store*store*3 bytes (decode → bilinear
// shortest-side resize → centre crop). Undecodable files and images with a
// side under 4 pixels are skipped. Returns the records written, -1 on an
// I/O failure, or -2 - i when file i is a JPEG and this build has no JPEG
// decoder.
int dl_cache_build(const char** files, int n_files, int store, const char* out_path) try {
  if (store <= 0 || n_files <= 0) return -1;
  FILE* f = fopen(out_path, "wb");
  if (!f) return -1;
  uint32_t header[4] = {0x47435432u, 1u, 0u, static_cast<uint32_t>(store)};
  if (fwrite(header, sizeof(header), 1, f) != 1) {
    fclose(f);
    return -1;
  }
  std::vector<uint8_t> rec(static_cast<size_t>(store) * store * 3);
  uint32_t written = 0;
  for (int i = 0; i < n_files; ++i) {
    Image img;
    try {
      Decoded r = decode_file(files[i], &img);
      if (r == kNoDecoder) {
        fclose(f);
        std::remove(out_path);
        return -2 - i;
      }
      if (r != kOk) continue;
    } catch (const std::exception&) {
      continue;
    }
    // tracking-pixel-sized images would become stretched constant records;
    // the live loaders skip them too
    if (img.h < 4 || img.w < 4) continue;
    resize_center_crop(img, store, rec.data());
    if (fwrite(rec.data(), rec.size(), 1, f) != 1) {
      fclose(f);
      return -1;
    }
    ++written;
  }
  // back-patch the record count; a failure here (disk full) must not
  // report success for a header that still says 0 records
  if (fseek(f, 2 * sizeof(uint32_t), SEEK_SET) != 0 ||
      fwrite(&written, sizeof(written), 1, f) != 1) {
    fclose(f);
    return -1;
  }
  if (fclose(f) != 0) return -1;
  return static_cast<int>(written);
} catch (const std::exception&) {
  return -1;  // never let an exception cross the C ABI
}

void* dl_create(const char** files, int n_files, int size, int batch, int workers,
                int capacity, uint64_t seed) try {
  if (n_files <= 0 || size <= 0 || batch <= 0) return nullptr;
  Loader* L = new Loader();
  L->files.reserve(n_files);
  for (int i = 0; i < n_files; ++i) L->files.emplace_back(files[i]);
  L->size = size;
  L->batch = batch;
  L->seed = seed;
  int w = workers > 0 ? workers : 2;
  L->window = static_cast<uint64_t>(capacity > 0 ? capacity : 2) + w;
  L->perm.resize(n_files);
  for (int i = 0; i < n_files; ++i) L->perm[i] = static_cast<uint32_t>(i);
  L->perm_rng.seed(seed ^ 0xD1B54A32D192ED03ULL);
  L->perm_pos = L->perm.size();  // the first draw shuffles epoch 0
  for (int i = 0; i < w; ++i) L->workers.emplace_back(worker_main, L);
  return L;
} catch (const std::exception&) {
  return nullptr;
}

// Blocks until the next batch in claim order is ready; copies
// batch*size*size*3 floats into out. Returns 0 on success, -1 when the
// loader stopped, -2 when the workers gave up on persistent decode failures,
// -3 when a file needs a decoder this build lacks (see dl_error).
int dl_next(void* handle, float* out) {
  if (!handle) return -1;
  Loader* L = static_cast<Loader*>(handle);
  std::vector<float> batch;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->ready.wait(lk, [L] { return L->stop || L->done.count(L->next_out) > 0; });
    auto it = L->done.find(L->next_out);
    if (L->stop || it == L->done.end()) return L->error ? L->error : -1;
    batch = std::move(it->second);
    L->done.erase(it);
    ++L->next_out;
  }
  L->can_claim.notify_all();
  memcpy(out, batch.data(), batch.size() * sizeof(float));
  return 0;
}

// Stops the workers and wakes every thread blocked in dl_next (which then
// returns -1, or the failure's code); the handle stays valid until dl_destroy.
void dl_stop(void* handle) {
  if (handle) static_cast<Loader*>(handle)->halt();
}

// The failure's description after dl_next returned -2 or -3; valid until
// dl_destroy.
const char* dl_error(void* handle) {
  if (!handle) return "";
  Loader* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  return L->error_message.c_str();
}

void dl_destroy(void* handle) {
  if (handle) delete static_cast<Loader*>(handle);
}

// One file decoded, and cropped/flipped/normalised from
// std::mt19937_64(seed) when do_augment (else normalised whole). Sets
// *out_h, *out_w to the decoded image's size first; returns 0 on success,
// -1 when the file does not decode, -2 when it is smaller than the crop,
// -3 when the result needs more than out_capacity floats (so a call with
// no buffer returns the size), -4 when it is a JPEG and this build has no
// JPEG decoder.
int dl_decode_one(const char* path, int size, uint64_t seed, int do_augment, float* out,
                  int64_t out_capacity, int* out_h, int* out_w) try {
  Image img;
  Decoded r = decode_file(path, &img);
  if (r != kOk) return r == kNoDecoder ? -4 : -1;
  *out_h = img.h;
  *out_w = img.w;
  if (!do_augment) {
    if (static_cast<int64_t>(img.data.size()) > out_capacity) return -3;
    for (size_t i = 0; i < img.data.size(); ++i)
      out[i] = static_cast<float>(img.data[i]) * (1.0f / 128.0f) - 1.0f;
    return 0;
  }
  if (static_cast<int64_t>(size) * size * 3 > out_capacity) return -3;
  std::mt19937_64 rng(seed);
  return augment_to(img, size, &rng, out) ? 0 : -2;
} catch (const std::exception&) {
  return -1;
}

uint32_t dl_crc32c(const uint8_t* data, uint64_t n) {
  return crc32c_impl(data, static_cast<size_t>(n));
}

}  // extern "C"
