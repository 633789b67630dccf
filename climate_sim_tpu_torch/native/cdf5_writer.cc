// Native CDF-5 snapshot writer for climate_sim_tpu.
//
// TPU-native replacement for the data plane of the reference's PnetCDF layer
// (reference: src/io.cpp:378-448 — ncmpi_create(NC_CLOBBER|NC_64BIT_DATA),
// dims time/y/x, one NC_DOUBLE variable u(time,y,x), global text attrs,
// collective record writes).  On TPU there is one controller process, so the
// parallel-I/O concern becomes a *latency-hiding* concern: `ncw_append`
// enqueues a frame copy and returns immediately; a background writer thread
// does the big-endian conversion and file I/O, overlapping device compute
// exactly where the reference overlapped MPI-IO with other ranks' compute.
//
// The on-disk bytes are identical to climate_sim_tpu.io.netcdf.NetCDFWriter
// (version=5) for this schema — tested byte-for-byte in tests/test_native_io.py.
//
// C ABI (consumed via ctypes from climate_sim_tpu/io/native.py):
//   ncw_create(path, ny, nx, nattrs, names[], values[]) -> handle (>=1), 0 on error
//   ncw_attach(path, ny, nx, nattrs, names[], values[]) -> handle; opens an
//       existing file created by another process with the SAME schema,
//       byte-verifies the header (numrecs excluded) and never touches it —
//       the per-rank half of parallel hyperslab writes (io.cpp:402-424).
//   ncw_append(handle, frame_ptr, irec)  -> 0 ok      (async; copies the frame)
//   ncw_append_region(handle, ptr, irec, y0, x0, by, bx) -> 0 ok (async
//       hyperslab write of a (by, bx) block at rows y0.., cols x0..)
//   ncw_flush(handle)                    -> 0 ok      (drain queue)
//   ncw_close(handle)                    -> 0 ok      (drain + close + free)
//   ncw_queue_depth(handle)              -> frames currently queued, <0 error
//   ncw_last_error()                     -> const char* message

#define _FILE_OFFSET_BITS 64  // 64-bit fseeko/off_t on 32-bit platforms

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cerrno>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Per-thread error slot: each calling thread sees only its own last error,
// and the buffer returned by ncw_last_error() cannot be freed/reallocated
// by a concurrent set_error on another thread (the ctypes layer copies the
// C string on the same thread that made the failing call).
thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

// ---- CDF-5 header encoding (big-endian) -----------------------------------

void put_u32(std::string& out, uint32_t v) {
  char b[4] = {char(v >> 24), char(v >> 16), char(v >> 8), char(v)};
  out.append(b, 4);
}

void put_u64(std::string& out, uint64_t v) {
  char b[8] = {char(v >> 56), char(v >> 48), char(v >> 40), char(v >> 32),
               char(v >> 24), char(v >> 16), char(v >> 8),  char(v)};
  out.append(b, 8);
}

size_t pad4(size_t n) { return (4 - (n % 4)) % 4; }

// NON_NEG fields are 8 bytes in CDF-5.
void put_nonneg(std::string& out, uint64_t v) { put_u64(out, v); }

void put_name(std::string& out, const std::string& s) {
  put_nonneg(out, s.size());
  out.append(s);
  out.append(pad4(s.size()), '\0');
}

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;
constexpr uint32_t NC_CHAR = 2;
constexpr uint32_t NC_DOUBLE = 6;

// Header for: dims time(UNLIMITED)/y/x; global char attrs; var u(time,y,x)
// NC_DOUBLE.  numrecs is patched in place on append (offset 4, 8 bytes).
std::string encode_header(int64_t ny, int64_t nx, int64_t numrecs,
                          const std::vector<std::pair<std::string, std::string>>& attrs,
                          int64_t begin) {
  std::string h;
  h.append("CDF\x05", 4);
  put_nonneg(h, uint64_t(numrecs));

  put_u32(h, NC_DIMENSION);
  put_nonneg(h, 3);
  put_name(h, "time");
  put_nonneg(h, 0);  // UNLIMITED
  put_name(h, "y");
  put_nonneg(h, uint64_t(ny));
  put_name(h, "x");
  put_nonneg(h, uint64_t(nx));

  if (attrs.empty()) {
    put_u32(h, 0);
    put_nonneg(h, 0);
  } else {
    put_u32(h, NC_ATTRIBUTE);
    put_nonneg(h, attrs.size());
    for (const auto& kv : attrs) {
      put_name(h, kv.first);
      put_u32(h, NC_CHAR);
      put_nonneg(h, kv.second.size());
      h.append(kv.second);
      h.append(pad4(kv.second.size()), '\0');
    }
  }

  put_u32(h, NC_VARIABLE);
  put_nonneg(h, 1);
  put_name(h, "u");
  put_nonneg(h, 3);
  put_nonneg(h, 0);  // dimid time
  put_nonneg(h, 1);  // dimid y
  put_nonneg(h, 2);  // dimid x
  put_u32(h, 0);     // no var attrs (ABSENT)
  put_nonneg(h, 0);
  put_u32(h, NC_DOUBLE);
  put_nonneg(h, uint64_t(ny * nx * 8));  // vsize: single record var, unpadded
  put_u64(h, uint64_t(begin));           // begin (8 bytes in CDF-2/5)
  return h;
}

// ---- async writer ----------------------------------------------------------

struct Frame {
  int64_t irec;
  // Region within the record: full frames are y0=x0=0, by=ny, bx=nx.
  int64_t y0, x0, by, bx;
  std::vector<double> data;  // host byte order; swapped in the worker
};

class Writer {
 public:
  Writer(const std::string& path, int64_t ny, int64_t nx,
         std::vector<std::pair<std::string, std::string>> attrs, bool create)
      : ny_(ny), nx_(nx), owns_header_(create) {
    // Two-pass: header size depends only on counts/strings.
    std::string probe = encode_header(ny, nx, 0, attrs, 0);
    size_t hlen = probe.size() + pad4(probe.size());
    begin_ = int64_t(hlen);
    std::string header = encode_header(ny, nx, 0, attrs, begin_);
    header.append(pad4(header.size()), '\0');

    if (create) {
      f_ = std::fopen(path.c_str(), "w+b");
      if (!f_) throw std::runtime_error("cannot open " + path);
      if (std::fwrite(header.data(), 1, header.size(), f_) != header.size()) {
        std::fclose(f_);
        f_ = nullptr;
        throw std::runtime_error("short header write to " + path);
      }
      // Attaching processes read this back as soon as their open barrier
      // releases: make it visible now.  ENOSPC/EIO here must fail the
      // create, not surface as a peer's header-mismatch later.
      if (std::fflush(f_) != 0) {
        // Capture errno BEFORE fclose (whose own syscalls may clobber it).
        std::string why = std::strerror(errno);
        std::fclose(f_);
        f_ = nullptr;
        throw std::runtime_error("header flush failed: " + why);
      }
    } else {
      // Attach: verify the creator's on-disk header matches this schema
      // byte-for-byte, numrecs field (offset 4, 8 bytes) excluded.
      f_ = std::fopen(path.c_str(), "r+b");
      if (!f_) throw std::runtime_error("cannot open existing " + path);
      std::string ondisk(header.size(), '\0');
      size_t got = std::fread(&ondisk[0], 1, ondisk.size(), f_);
      if (got != header.size() ||
          ondisk.compare(0, 4, header, 0, 4) != 0 ||
          ondisk.compare(12, std::string::npos, header, 12, std::string::npos) != 0) {
        std::fclose(f_);
        f_ = nullptr;
        throw std::runtime_error(path + ": existing header does not match schema");
      }
    }
    worker_ = std::thread([this] { this->run(); });
  }

  ~Writer() {
    try {
      close();
    } catch (...) {
    }
  }

  void append(const double* frame, int64_t irec) {
    append_region(frame, irec, 0, 0, ny_, nx_);
  }

  void append_region(const double* block, int64_t irec, int64_t y0, int64_t x0,
                     int64_t by, int64_t bx) {
    if (y0 < 0 || x0 < 0 || by <= 0 || bx <= 0 || y0 + by > ny_ || x0 + bx > nx_)
      throw std::runtime_error("region out of bounds");
    auto fr = Frame{irec, y0, x0, by, bx,
                    std::vector<double>(block, block + by * bx)};
    std::unique_lock<std::mutex> lk(mu_);
    // Bounded queue: cap buffered frames so a slow disk cannot exhaust RAM.
    not_full_.wait(lk, [this] { return queue_.size() < kMaxQueue || stop_; });
    if (stop_) throw std::runtime_error("append on closed writer");
    if (error_.size()) throw std::runtime_error(error_);
    queue_.push_back(std::move(fr));
    not_empty_.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu_);
    drained_.wait(lk, [this] { return (queue_.empty() && !busy_) || !error_.empty(); });
    if (!error_.empty()) throw std::runtime_error(error_);
    if (std::fflush(f_) != 0)
      throw std::runtime_error("flush failed: " +
                               std::string(std::strerror(errno)));
  }

  void close() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      if (stop_) return;
      drained_.wait(lk, [this] { return (queue_.empty() && !busy_) || !error_.empty(); });
      stop_ = true;
      not_empty_.notify_all();
      not_full_.notify_all();
    }
    if (worker_.joinable()) worker_.join();
    if (f_) {
      // fclose flushes the stdio buffer: a failure here means the file
      // tail never reached disk — the no-partial-snapshot contract
      // requires it to surface, not vanish with the handle.
      int rc = std::fclose(f_);
      f_ = nullptr;
      if (rc != 0 && error_.empty())
        error_ = "close failed: " + std::string(std::strerror(errno));
    }
    if (!error_.empty()) throw std::runtime_error(error_);
  }

  int64_t queue_depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return int64_t(queue_.size()) + (busy_ ? 1 : 0);
  }

 private:
  static constexpr size_t kMaxQueue = 4;

  void run() {
    std::vector<uint64_t> swapped;
    for (;;) {
      Frame fr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        not_empty_.wait(lk, [this] { return !queue_.empty() || stop_; });
        if (queue_.empty()) return;  // stop_ and drained
        fr = std::move(queue_.front());
        queue_.pop_front();
        busy_ = true;
        not_full_.notify_one();
      }
      std::string err;
      try {
        write_frame(fr, swapped);
      } catch (const std::exception& e) {
        err = e.what();
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        busy_ = false;
        if (!err.empty() && error_.empty()) error_ = err;
        drained_.notify_all();
      }
    }
  }

  void write_frame(const Frame& fr, std::vector<uint64_t>& swapped) {
    const int64_t n = fr.by * fr.bx;
    swapped.resize(size_t(n));
    const uint64_t* src = reinterpret_cast<const uint64_t*>(fr.data.data());
    for (int64_t i = 0; i < n; ++i) swapped[size_t(i)] = __builtin_bswap64(src[i]);

    const int64_t recsize = ny_ * nx_ * 8;
    const int64_t rec_base = begin_ + fr.irec * recsize;
    // fseeko + off_t: record offsets exceed 2 GiB within ~16 frames at
    // 4096^2 f64, overflowing a 32-bit long.
    if (fr.bx == nx_) {
      // Full-width row band: one contiguous write.
      if (fseeko(f_, off_t(rec_base + fr.y0 * nx_ * 8), SEEK_SET) != 0)
        throw std::runtime_error("seek failed");
      if (std::fwrite(swapped.data(), 1, size_t(n * 8), f_) != size_t(n * 8))
        throw std::runtime_error("short record write");
    } else {
      // One write per row segment at its deterministic offset.
      for (int64_t r = 0; r < fr.by; ++r) {
        int64_t el = (fr.y0 + r) * nx_ + fr.x0;
        if (fseeko(f_, off_t(rec_base + el * 8), SEEK_SET) != 0)
          throw std::runtime_error("seek failed");
        if (std::fwrite(swapped.data() + size_t(r * fr.bx), 1,
                        size_t(fr.bx * 8), f_) != size_t(fr.bx * 8))
          throw std::runtime_error("short region write");
      }
    }
    if (owns_header_ && fr.irec + 1 > numrecs_) {
      numrecs_ = fr.irec + 1;
      // Patch the 8-byte numrecs field at offset 4 (CDF-5).
      char b[8];
      uint64_t v = uint64_t(numrecs_);
      for (int i = 0; i < 8; ++i) b[i] = char(v >> (56 - 8 * i));
      if (fseeko(f_, 4, SEEK_SET) != 0) throw std::runtime_error("seek failed");
      if (std::fwrite(b, 1, 8, f_) != 8) throw std::runtime_error("numrecs patch failed");
      if (fseeko(f_, 0, SEEK_END) != 0) throw std::runtime_error("seek failed");
    }
  }

  int64_t ny_, nx_;
  bool owns_header_ = true;
  int64_t begin_ = 0;
  int64_t numrecs_ = 0;
  std::FILE* f_ = nullptr;

  std::thread worker_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_, drained_;
  std::deque<Frame> queue_;
  bool busy_ = false;
  bool stop_ = false;
  std::string error_;
};

std::mutex g_table_mu;
// shared_ptr: a handle looked up by one thread stays alive even if another
// thread closes it concurrently (close drains; late appends then throw).
std::map<int64_t, std::shared_ptr<Writer>> g_writers;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

static int64_t make_writer(const char* path, int64_t ny, int64_t nx,
                           int64_t nattrs, const char** names,
                           const char** values, bool create) {
  try {
    std::vector<std::pair<std::string, std::string>> attrs;
    for (int64_t i = 0; i < nattrs; ++i) attrs.emplace_back(names[i], values[i]);
    auto w = std::make_shared<Writer>(path, ny, nx, std::move(attrs), create);
    std::lock_guard<std::mutex> lk(g_table_mu);
    int64_t h = g_next_handle++;
    g_writers[h] = std::move(w);
    return h;
  } catch (const std::exception& e) {
    set_error(e.what());
    return 0;
  }
}

int64_t ncw_create(const char* path, int64_t ny, int64_t nx, int64_t nattrs,
                   const char** names, const char** values) {
  return make_writer(path, ny, nx, nattrs, names, values, true);
}

int64_t ncw_attach(const char* path, int64_t ny, int64_t nx, int64_t nattrs,
                   const char** names, const char** values) {
  return make_writer(path, ny, nx, nattrs, names, values, false);
}

static std::shared_ptr<Writer> lookup(int64_t h) {
  std::lock_guard<std::mutex> lk(g_table_mu);
  auto it = g_writers.find(h);
  return it == g_writers.end() ? nullptr : it->second;
}

int64_t ncw_append(int64_t handle, const double* frame, int64_t irec) {
  auto w = lookup(handle);
  if (!w) {
    set_error("bad handle");
    return -1;
  }
  try {
    w->append(frame, irec);
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what());
    return -1;
  }
}

int64_t ncw_append_region(int64_t handle, const double* block, int64_t irec,
                          int64_t y0, int64_t x0, int64_t by, int64_t bx) {
  auto w = lookup(handle);
  if (!w) {
    set_error("bad handle");
    return -1;
  }
  try {
    w->append_region(block, irec, y0, x0, by, bx);
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what());
    return -1;
  }
}

int64_t ncw_flush(int64_t handle) {
  auto w = lookup(handle);
  if (!w) {
    set_error("bad handle");
    return -1;
  }
  try {
    w->flush();
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what());
    return -1;
  }
}

int64_t ncw_queue_depth(int64_t handle) {
  auto w = lookup(handle);
  if (!w) {
    set_error("bad handle");
    return -1;
  }
  return w->queue_depth();
}

int64_t ncw_close(int64_t handle) {
  std::shared_ptr<Writer> w;
  {
    std::lock_guard<std::mutex> lk(g_table_mu);
    auto it = g_writers.find(handle);
    if (it == g_writers.end()) {
      set_error("bad handle");
      return -1;
    }
    w = std::move(it->second);
    g_writers.erase(it);
  }
  try {
    w->close();
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what());
    return -1;
  }
}

const char* ncw_last_error() { return g_last_error.c_str(); }

}  // extern "C"
