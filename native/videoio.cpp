// Native video IO: mmap-backed frame sources with a prefetch ring.
//
// Counterpart of the reference's native decode layer
// (OpenCV/FFmpeg behind cv2.VideoCapture, optical_flow.py:62-85).
// Codec decode stays pluggable on the Python side (cv2 backend); this
// library owns the zero-copy raw paths that production capture rigs
// use, where decode cost must be ~zero:
//
//  - raw grayscale stacks ((T,H,W) uint8, optionally .npy-framed)
//  - raw BGR stacks ((T,H,W,3) uint8) with exact BT.601 fixed-point
//    gray conversion (same 15-bit arithmetic as ops/cvx.py)
//  - YUV4MPEG2 (y4m) files (luma plane)
//
// A background worker thread converts/copies frames into a bounded
// ring of buffers so the host->device feed overlaps device compute.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kKindRawGray = 0;
constexpr int kKindRawBGR = 1;
constexpr int kKindY4M = 2;

struct Source {
  int kind = kKindRawGray;
  int T = 0, H = 0, W = 0;
  double fps = 30.0;
  const uint8_t* data = nullptr;  // mmap base
  size_t map_len = 0;
  size_t payload_off = 0;   // offset of frame 0
  size_t frame_stride = 0;  // bytes between frame starts
  size_t luma_off = 0;      // offset of luma within a frame record

  // Prefetch ring.
  int depth = 0;
  size_t gray_bytes = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<int> ring_idx;  // frame index held by each slot, -1 empty
  int next_produce = 0;       // next frame index the worker converts
  int next_consume = 0;       // next frame index vio_next returns
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::atomic<bool> stop{false};

  ~Source() {
    {
      // Hold mu while flipping stop: otherwise the worker can test its
      // wait predicate (stop==false), lose the race to this one-shot
      // notify, and block forever — deadlocking worker.join().
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
    if (data) munmap(const_cast<uint8_t*>(data), map_len);
  }
};

// Exact BT.601 fixed-point gray conversion (matches ops/cvx.bgr2gray_u8
// and cv2.cvtColor BGR2GRAY): y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15.
void bgr_to_gray(const uint8_t* bgr, uint8_t* gray, size_t npix) {
  for (size_t i = 0; i < npix; ++i) {
    const uint32_t b = bgr[3 * i + 0];
    const uint32_t g = bgr[3 * i + 1];
    const uint32_t r = bgr[3 * i + 2];
    gray[i] = static_cast<uint8_t>((r * 9798u + g * 19235u + b * 3735u + (1u << 14)) >> 15);
  }
}

void convert_frame(const Source* s, int idx, uint8_t* out) {
  const uint8_t* src = s->data + s->payload_off +
                       static_cast<size_t>(idx) * s->frame_stride + s->luma_off;
  if (s->kind == kKindRawBGR) {
    bgr_to_gray(src, out, static_cast<size_t>(s->H) * s->W);
  } else {
    std::memcpy(out, src, s->gray_bytes);
  }
}

void worker_loop(Source* s) {
  while (!s->stop.load()) {
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->next_produce >= s->T) return;
    const int slot = s->next_produce % s->depth;
    s->cv_full.wait(lk, [&] { return s->stop.load() || s->ring_idx[slot] == -1; });
    if (s->stop.load()) return;
    const int idx = s->next_produce;
    lk.unlock();
    convert_frame(s, idx, s->ring[slot].data());
    lk.lock();
    s->ring_idx[slot] = idx;
    s->next_produce = idx + 1;
    s->cv_empty.notify_all();
  }
}

bool parse_npy_header(const uint8_t* p, size_t len, Source* s, int expect_channels) {
  // Minimal NPY v1/v2 parser for C-contiguous uint8 arrays.
  if (len < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
  const int major = p[6];
  size_t hlen, off;
  if (major == 1) {
    hlen = p[8] | (p[9] << 8);
    off = 10;
  } else {
    hlen = p[8] | (p[9] << 8) | (p[10] << 16) | (static_cast<size_t>(p[11]) << 24);
    off = 12;
  }
  std::string hdr(reinterpret_cast<const char*>(p + off), hlen);
  if (hdr.find("'descr': '|u1'") == std::string::npos &&
      hdr.find("'descr': 'uint8'") == std::string::npos)
    return false;
  if (hdr.find("'fortran_order': False") == std::string::npos) return false;
  const auto sh = hdr.find("'shape': (");
  if (sh == std::string::npos) return false;
  int dims[4] = {0, 0, 0, 0};
  int nd = 0;
  const char* q = hdr.c_str() + sh + 10;
  while (nd < 4) {
    char* end;
    long v = strtol(q, &end, 10);
    if (end == q) break;
    dims[nd++] = static_cast<int>(v);
    q = end;
    while (*q == ',' || *q == ' ') ++q;
    if (*q == ')') break;
  }
  if (expect_channels == 3) {
    if (nd != 4 || dims[3] != 3) return false;
  } else if (nd != 3) {
    return false;
  }
  s->T = dims[0];
  s->H = dims[1];
  s->W = dims[2];
  s->payload_off = off + hlen;
  s->frame_stride = static_cast<size_t>(s->H) * s->W * (expect_channels == 3 ? 3 : 1);
  s->luma_off = 0;
  return true;
}

bool parse_y4m_header(const uint8_t* p, size_t len, Source* s) {
  if (len < 10 || std::memcmp(p, "YUV4MPEG2", 9) != 0) return false;
  size_t eol = 0;
  while (eol < len && p[eol] != '\n') ++eol;
  if (eol >= len) return false;
  std::string hdr(reinterpret_cast<const char*>(p), eol);
  int num = 30, den = 1;
  std::string sub = "420";
  size_t pos = 9;
  while (pos < hdr.size()) {
    while (pos < hdr.size() && hdr[pos] == ' ') ++pos;
    if (pos >= hdr.size()) break;
    const char tag = hdr[pos];
    size_t end = hdr.find(' ', pos);
    if (end == std::string::npos) end = hdr.size();
    std::string val = hdr.substr(pos + 1, end - pos - 1);
    if (tag == 'W') s->W = atoi(val.c_str());
    else if (tag == 'H') s->H = atoi(val.c_str());
    else if (tag == 'F') sscanf(val.c_str(), "%d:%d", &num, &den);
    else if (tag == 'C') sub = val;
    pos = end;
  }
  s->fps = den > 0 ? static_cast<double>(num) / den : 30.0;
  size_t chroma;
  const size_t ysz = static_cast<size_t>(s->H) * s->W;
  if (sub.rfind("420", 0) == 0) chroma = ysz / 2;
  else if (sub.rfind("422", 0) == 0) chroma = ysz;
  else if (sub.rfind("444", 0) == 0) chroma = 2 * ysz;
  else if (sub.rfind("mono", 0) == 0) chroma = 0;
  else return false;
  // Frame markers are 'FRAME[ <params>]\n' — the spec allows per-frame
  // parameters, so derive the marker length from the first frame's
  // actual marker line instead of assuming the bare 6-byte 'FRAME\n'.
  const size_t first = eol + 1;
  if (first + 5 > len || std::memcmp(p + first, "FRAME", 5) != 0) return false;
  size_t meol = first;
  while (meol < len && p[meol] != '\n') ++meol;
  if (meol >= len) return false;
  const size_t marker_len = meol - first + 1;
  s->payload_off = first + marker_len;
  s->frame_stride = marker_len + ysz + chroma;  // marker + planes
  s->luma_off = 0;
  s->T = static_cast<int>((len - first) / s->frame_stride);
  // The fixed-stride reader requires every marker to have the same
  // length; verify (cheap: touches a few bytes per frame) and reject
  // variable-length markers rather than silently misaligning luma.
  for (int i = 1; i < s->T; ++i) {
    const uint8_t* m = p + first + static_cast<size_t>(i) * s->frame_stride;
    if (std::memcmp(m, "FRAME", 5) != 0 || m[marker_len - 1] != '\n') return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* vio_open(const char* path, int kind, double fps, int prefetch_depth) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  auto* s = new Source();
  s->kind = kind;
  s->fps = fps;
  s->data = static_cast<const uint8_t*>(base);
  s->map_len = st.st_size;

  bool ok = false;
  if (kind == kKindRawGray) ok = parse_npy_header(s->data, s->map_len, s, 1);
  else if (kind == kKindRawBGR) ok = parse_npy_header(s->data, s->map_len, s, 3);
  else if (kind == kKindY4M) ok = parse_y4m_header(s->data, s->map_len, s);
  if (!ok || s->T <= 0 || s->H <= 0 || s->W <= 0) {
    delete s;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(s->data), s->map_len, MADV_SEQUENTIAL);

  s->gray_bytes = static_cast<size_t>(s->H) * s->W;
  s->depth = prefetch_depth > 0 ? prefetch_depth : 4;
  s->ring.resize(s->depth);
  s->ring_idx.assign(s->depth, -1);
  for (auto& b : s->ring) b.resize(s->gray_bytes);
  s->worker = std::thread(worker_loop, s);
  return s;
}

int vio_info(void* h, int* T, int* H, int* W, double* fps) {
  if (!h) return -1;
  auto* s = static_cast<Source*>(h);
  *T = s->T;
  *H = s->H;
  *W = s->W;
  *fps = s->fps;
  return 0;
}

// Sequential read through the prefetch ring; returns the frame index
// or -1 at end of stream.
int vio_next(void* h, uint8_t* out) {
  auto* s = static_cast<Source*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->next_consume >= s->T) return -1;
  const int idx = s->next_consume;
  const int slot = idx % s->depth;
  s->cv_empty.wait(lk, [&] { return s->stop.load() || s->ring_idx[slot] == idx; });
  if (s->ring_idx[slot] != idx) return -1;
  lk.unlock();
  std::memcpy(out, s->ring[slot].data(), s->gray_bytes);
  lk.lock();
  s->ring_idx[slot] = -1;
  s->next_consume = idx + 1;
  s->cv_full.notify_all();
  return idx;
}

// Random access (bypasses the ring).
int vio_read(void* h, int idx, uint8_t* out) {
  auto* s = static_cast<Source*>(h);
  if (idx < 0 || idx >= s->T) return -1;
  convert_frame(s, idx, out);
  return idx;
}

void vio_close(void* h) { delete static_cast<Source*>(h); }

}  // extern "C"
