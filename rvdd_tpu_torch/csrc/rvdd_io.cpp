// rvdd_io: the host decode pool of rvdd_tpu_torch (port of rvdd_tpu's
// native/rvdd_io.cpp).
//
// A TIFF decoder for the subset the datasets use, and a pthread pool that
// decodes a whole stack of frames in parallel into one dense float32
// buffer.  The subset: classic TIFF, little-endian ("II"), one page,
// uncompressed, chunky (planar 1), in strips (no tiles), no predictor,
// 1-4 samples a pixel of uint8, uint16 or float32, every sample the same.
// Any other file fails (status -1) without a partial result; the caller
// (data/io.py) routes such files to its numpy reader from their header.
//
// Values are divided by `scale` (v / scale in float32, as numpy divides a
// float32 array by a float), so the pool's output equals the numpy
// reader's bit for bit; scale <= 0 keeps the raw values.
//
// Plain C entry points for ctypes; data/native.py builds this file with
// g++ through _build.py (host route, no CUDA).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ImageInfo {
  uint32_t width = 0, height = 0, channels = 1;
  uint32_t bits = 1;  // the TIFF default; the subset needs 8, 16 or 32
  uint32_t sample_format = 1;  // 1 = unsigned integer, 3 = IEEE float
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long n = ok ? ftell(f) : -1;
  ok = ok && n >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out.resize(n);
    ok = fread(out.data(), 1, n, f) == (size_t)n;
  }
  fclose(f);
  return ok;
}

uint16_t u16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
uint32_t u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// The values of one IFD entry of type SHORT (3) or LONG (4), inline when
// they fit in its 4 bytes, else at the offset it holds.
bool entry_values(const std::vector<uint8_t>& d, const uint8_t* e,
                  std::vector<uint32_t>* vals) {
  const uint16_t type = u16(e + 2);
  const uint32_t count = u32(e + 4);
  const uint32_t size = type == 3 ? 2 : type == 4 ? 4 : 0;
  if (size == 0 || count == 0 || count > (1u << 24)) return false;
  const uint64_t bytes = (uint64_t)count * size;
  const uint8_t* p = e + 8;
  if (bytes > 4) {
    const uint32_t at = u32(e + 8);
    if (at + bytes > d.size()) return false;
    p = d.data() + at;
  }
  vals->resize(count);
  for (uint32_t k = 0; k < count; k++)
    (*vals)[k] = size == 2 ? u16(p + 2 * k) : u32(p + 4 * k);
  return true;
}

// The single value of a tag that holds one value, or one a sample, all
// equal (BitsPerSample, SampleFormat).
bool one_value(const std::vector<uint32_t>& v, uint32_t* out) {
  for (uint32_t x : v)
    if (x != v[0]) return false;
  *out = v[0];
  return true;
}

// Parse the subset described above.  Returns false on anything else.
bool parse_tiff(const std::vector<uint8_t>& d, ImageInfo* info,
                std::vector<std::pair<uint32_t, uint32_t>>* strips) {
  if (d.size() < 8 || d[0] != 'I' || d[1] != 'I' || u16(d.data() + 2) != 42)
    return false;
  const uint32_t ifd = u32(d.data() + 4);
  if ((uint64_t)ifd + 2 > d.size()) return false;
  const uint16_t n = u16(d.data() + ifd);
  if ((uint64_t)ifd + 2 + 12ull * n + 4 > d.size()) return false;
  if (u32(d.data() + ifd + 2 + 12 * n) != 0) return false;  // one page only

  uint32_t compression = 1, planar = 1, predictor = 1;
  bool have_w = false, have_h = false;
  std::vector<uint32_t> offsets, counts, vals;
  for (uint16_t i = 0; i < n; i++) {
    const uint8_t* e = d.data() + ifd + 2 + 12 * i;
    const uint16_t tag = u16(e);
    if (tag == 322 || tag == 324) return false;  // tiles
    const uint16_t type = u16(e + 2);
    if (type != 3 && type != 4) continue;  // ASCII, RATIONAL, ...: descriptive
    if (!entry_values(d, e, &vals)) return false;
    bool ok = true;
    switch (tag) {
      case 256: ok = one_value(vals, &info->width); have_w = true; break;
      case 257: ok = one_value(vals, &info->height); have_h = true; break;
      case 258: ok = one_value(vals, &info->bits); break;
      case 259: ok = one_value(vals, &compression); break;
      case 273: offsets = vals; break;
      case 277: ok = one_value(vals, &info->channels); break;
      case 279: counts = vals; break;
      case 284: ok = one_value(vals, &planar); break;
      case 317: ok = one_value(vals, &predictor); break;
      case 339: ok = one_value(vals, &info->sample_format); break;
      default: break;
    }
    if (!ok) return false;
  }
  if (!have_w || !have_h || !info->width || !info->height) return false;
  if (compression != 1 || planar != 1 || predictor != 1) return false;
  if (info->channels < 1 || info->channels > 4) return false;
  const bool sample_ok =
      (info->sample_format == 3 && info->bits == 32) ||
      (info->sample_format == 1 && (info->bits == 16 || info->bits == 8));
  if (!sample_ok) return false;
  if (offsets.empty() || offsets.size() != counts.size()) return false;
  strips->clear();
  for (size_t k = 0; k < offsets.size(); k++) {
    if ((uint64_t)offsets[k] + counts[k] > d.size()) return false;
    strips->push_back({offsets[k], counts[k]});
  }
  return true;
}

// Decode a TIFF of the subset into float32 HWC.  With expect (h, w, c)
// given, a file of another shape fails; else the image must fit in cap.
bool decode_to_float(const char* path, float* out, int64_t cap,
                     const int64_t* expect, ImageInfo* info, float scale) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return false;
  std::vector<std::pair<uint32_t, uint32_t>> strips;
  if (!parse_tiff(d, info, &strips)) return false;
  if (expect && (expect[0] != info->height || expect[1] != info->width ||
                 expect[2] != info->channels))
    return false;
  const int64_t total = (int64_t)info->width * info->height * info->channels;
  if (total > cap) return false;
  const int64_t bytes_each = info->bits / 8;

  // the strips' bytes in order, without copying when they are contiguous
  std::vector<uint8_t> joined;
  const uint8_t* p = d.data() + strips[0].first;
  uint64_t have = 0;
  bool contiguous = true;
  for (size_t k = 0; k < strips.size(); k++) {
    if (k && strips[k].first != strips[k - 1].first + strips[k - 1].second)
      contiguous = false;
    have += strips[k].second;
  }
  if (have < (uint64_t)(total * bytes_each)) return false;
  if (!contiguous) {
    joined.reserve(have);
    for (auto& s : strips)
      joined.insert(joined.end(), d.begin() + s.first,
                    d.begin() + s.first + s.second);
    p = joined.data();
  }

  if (info->bits == 32) {
    if (scale <= 0) {
      memcpy(out, p, total * 4);
    } else {
      for (int64_t k = 0; k < total; k++) {
        float v;
        memcpy(&v, p + 4 * k, 4);
        out[k] = v / scale;
      }
    }
  } else if (info->bits == 16) {
    for (int64_t k = 0; k < total; k++) {
      const float v = (float)u16(p + 2 * k);
      out[k] = scale > 0 ? v / scale : v;
    }
  } else {
    for (int64_t k = 0; k < total; k++) {
      const float v = (float)p[k];
      out[k] = scale > 0 ? v / scale : v;
    }
  }
  return true;
}

// --------------------------------------------------------------------------
// the pool: decode many frames concurrently into one dense output
// --------------------------------------------------------------------------

struct Job {
  std::string path;
  float* dst;
  int64_t cap;
  const int64_t* expect;  // h, w, c
  float scale;
  int* status;  // 0 pending, 1 ok, -1 failed
};

class Pool {
 public:
  explicit Pool(int workers) : stop_(false), pending_(0) {
    for (int i = 0; i < workers; i++)
      threads_.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void submit(Job j) {
    {
      std::lock_guard<std::mutex> g(mu_);
      q_.push(std::move(j));
      pending_++;
    }
    cv_.notify_one();
  }
  void wait_all() {
    std::unique_lock<std::mutex> g(mu_);
    done_cv_.wait(g, [this] { return pending_ == 0; });
  }

 private:
  void run() {
    for (;;) {
      Job j;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        j = std::move(q_.front());
        q_.pop();
      }
      ImageInfo info;
      const bool ok =
          decode_to_float(j.path.c_str(), j.dst, j.cap, j.expect, &info, j.scale);
      {
        std::lock_guard<std::mutex> g(mu_);
        *j.status = ok ? 1 : -1;
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::queue<Job> q_;
  std::vector<std::thread> threads_;
  bool stop_;
  int pending_;
};

}  // namespace

extern "C" {

// Single-image decode into out (capacity out_cap floats).  Returns 0 on
// success, -1 otherwise; shape3 receives (h, w, c).
int rvdd_read_image(const char* path, float* out, int64_t out_cap,
                    int64_t* shape3, float scale) {
  ImageInfo info;
  if (!decode_to_float(path, out, out_cap, nullptr, &info, scale)) return -1;
  shape3[0] = info.height;
  shape3[1] = info.width;
  shape3[2] = info.channels;
  return 0;
}

void* rvdd_pool_create(int workers) { return new Pool(workers); }
void rvdd_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Batch decode: n frames, each of shape frame_shape (h, w, c), into a dense
// [n, h*w*c] buffer.  statuses must be an int array of length n (1 ok, -1
// failed).  Blocks until all are done; returns the number of failures.
int rvdd_pool_read_batch(void* pool, const char** paths, int n, float* out,
                         const int64_t* frame_shape, float scale, int* statuses) {
  Pool* p = static_cast<Pool*>(pool);
  const int64_t frame_floats = frame_shape[0] * frame_shape[1] * frame_shape[2];
  for (int i = 0; i < n; i++) {
    statuses[i] = 0;
    Job j;
    j.path = paths[i];
    j.dst = out + (int64_t)i * frame_floats;
    j.cap = frame_floats;
    j.expect = frame_shape;
    j.scale = scale;
    j.status = &statuses[i];
    p->submit(std::move(j));
  }
  p->wait_all();
  int failures = 0;
  for (int i = 0; i < n; i++)
    if (statuses[i] != 1) failures++;
  return failures;
}

}  // extern "C"
