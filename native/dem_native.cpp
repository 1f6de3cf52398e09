// dem_native — native runtime helpers for decentralized_ekf_mhe_tpu.
//
// The reference's runtime layer is C++ (ROS2 nodes, the Data_Logger
// header-only codec at src/decentral_legged_est/include/decentral_legged_est/
// data_logger.hpp, and the per-message synchronization logic in
// DecentralEst.cpp:863-985). This library provides the framework's
// native equivalents for the host-side paths that sit outside the XLA
// compute graph:
//
//  - the Data_Logger binary codec (writer + reader index computation),
//    wire-compatible with the reference format;
//  - the replay alignment core: latest-value sampling and upper_bound
//    timestamp synchronization over large logs (the hot part of
//    io/replay.align for hour-long recordings);
//  - a double-buffered tick-block feeder for streaming aligned blocks to
//    the device without Python-loop overhead.
//
// Exposed as a C ABI for ctypes (no pybind11 on this image).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Alignment core
// ---------------------------------------------------------------------------

// idx[i] = clamp(upper_bound(stream_t, sample_t[i]) - 1, 0, n-1)
// (latest-value DDS sampling; DecentralEst.cpp:895-913 semantics)
void dem_latest_index(const double* stream_t, int64_t n,
                      const double* sample_t, int64_t m, int64_t* idx_out) {
  for (int64_t i = 0; i < m; ++i) {
    const double* p = std::upper_bound(stream_t, stream_t + n, sample_t[i]);
    int64_t idx = static_cast<int64_t>(p - stream_t) - 1;
    if (idx < 0) idx = 0;
    if (idx > n - 1) idx = n - 1;
    idx_out[i] = idx;
  }
}

// upper_bound sync with discard signalling: returns upper_bound-1, or -1 if
// the stamp precedes the first tick (caller must discard the measurement —
// DecentralEst.cpp:898-904, orien_ekf.cpp:178-183).
void dem_upper_bound_sync(const double* tick_t, int64_t n,
                          const double* stamps, int64_t m, int64_t* idx_out) {
  for (int64_t i = 0; i < m; ++i) {
    const double* p = std::upper_bound(tick_t, tick_t + n, stamps[i]);
    idx_out[i] = static_cast<int64_t>(p - tick_t) - 1;
  }
}

// Gather rows: out[i, :] = src[idx[i], :] (the sampling step after
// dem_latest_index, fused here to avoid a Python round-trip).
void dem_gather_rows(const double* src, int64_t n, int64_t width,
                     const int64_t* idx, int64_t m, double* out) {
  for (int64_t i = 0; i < m; ++i) {
    std::memcpy(out + i * width, src + idx[i] * width,
                sizeof(double) * static_cast<size_t>(width));
  }
}

// ---------------------------------------------------------------------------
// Data_Logger codec (format of data_logger.hpp:253-295)
// ---------------------------------------------------------------------------

struct DemLogger {
  FILE* data = nullptr;
  FILE* schema = nullptr;
  // per channel: element bytes (8 for f64, 4 for f32) and length
  std::vector<int> elem_bytes;
  std::vector<int> lengths;
  std::mutex mu;
};

// type codes: 0 double(f64 x1), 1 int(f32 x1), 2 VectorXd(f64 xN),
//             3 VectorXf(f32 xN), 4 VectorXi(f32 xN), 5 Quaterniond(f64 x4)
static const char* kTypeNames[] = {"double", "int",      "VectorXd",
                                   "VectorXf", "VectorXi", "Quaterniond"};

void* dem_logger_open(const char* data_path, const char* schema_path) {
  DemLogger* lg = new DemLogger();
  lg->data = std::fopen(data_path, "wb");
  lg->schema = std::fopen(schema_path, "w");
  if (!lg->data || !lg->schema) {
    if (lg->data) std::fclose(lg->data);
    if (lg->schema) std::fclose(lg->schema);
    delete lg;
    return nullptr;
  }
  return lg;
}

int dem_logger_add_channel(void* handle, const char* name, int type_code,
                           int length) {
  DemLogger* lg = static_cast<DemLogger*>(handle);
  if (type_code < 0 || type_code > 5) return -1;
  int len = length;
  if (type_code == 0 || type_code == 1) len = 1;
  if (type_code == 5) len = 4;
  int ebytes = (type_code == 0 || type_code == 2 || type_code == 5) ? 8 : 4;
  lg->elem_bytes.push_back(ebytes);
  lg->lengths.push_back(len);
  std::fprintf(lg->schema, "%s,%s,%d,\n", name, kTypeNames[type_code], len);
  std::fflush(lg->schema);
  return 0;
}

// values: concatenated f64 for all channels in registration order (the
// caller passes doubles; f32 channels are cast on write, mirroring the
// reference's int/VectorXi casts).
int dem_logger_log_tick(void* handle, const double* values) {
  DemLogger* lg = static_cast<DemLogger*>(handle);
  std::lock_guard<std::mutex> lock(lg->mu);
  int64_t off = 0;
  for (size_t c = 0; c < lg->lengths.size(); ++c) {
    int len = lg->lengths[c];
    if (lg->elem_bytes[c] == 8) {
      std::fwrite(values + off, sizeof(double), len, lg->data);
    } else {
      float tmp[64];
      std::vector<float> big;
      float* dst = tmp;
      if (len > 64) {
        big.resize(len);
        dst = big.data();
      }
      for (int i = 0; i < len; ++i)
        dst[i] = static_cast<float>(values[off + i]);
      std::fwrite(dst, sizeof(float), len, lg->data);
    }
    off += len;
  }
  return 0;
}

// Bulk write: values (T, total_len) row-major f64.
int dem_logger_log_sequence(void* handle, const double* values, int64_t T,
                            int64_t total_len) {
  DemLogger* lg = static_cast<DemLogger*>(handle);
  for (int64_t t = 0; t < T; ++t) {
    if (dem_logger_log_tick(handle, values + t * total_len) != 0) return -1;
  }
  (void)total_len;
  return 0;
}

void dem_logger_close(void* handle) {
  DemLogger* lg = static_cast<DemLogger*>(handle);
  std::fclose(lg->data);
  std::fclose(lg->schema);
  delete lg;
}

// Reader: decode a _Data file given the channel layout; returns ticks read.
// elem_bytes/lengths arrays describe the schema (from the _Name.csv, parsed
// by the Python side); out receives (T, total_len) f64 row-major.
int64_t dem_log_decode(const char* data_path, const int* elem_bytes,
                       const int* lengths, int n_channels, double* out,
                       int64_t max_ticks) {
  FILE* f = std::fopen(data_path, "rb");
  if (!f) return -1;
  int64_t tick_bytes = 0, total_len = 0;
  for (int c = 0; c < n_channels; ++c) {
    tick_bytes += static_cast<int64_t>(elem_bytes[c]) * lengths[c];
    total_len += lengths[c];
  }
  std::vector<unsigned char> buf(tick_bytes);
  int64_t t = 0;
  while (t < max_ticks &&
         std::fread(buf.data(), 1, tick_bytes, f) == (size_t)tick_bytes) {
    int64_t boff = 0, voff = 0;
    for (int c = 0; c < n_channels; ++c) {
      for (int i = 0; i < lengths[c]; ++i) {
        if (elem_bytes[c] == 8) {
          double v;
          std::memcpy(&v, buf.data() + boff, 8);
          out[t * total_len + voff] = v;
          boff += 8;
        } else {
          float v;
          std::memcpy(&v, buf.data() + boff, 4);
          out[t * total_len + voff] = static_cast<double>(v);
          boff += 4;
        }
        ++voff;
      }
    }
    ++t;
  }
  std::fclose(f);
  return t;
}

// ---------------------------------------------------------------------------
// Double-buffered tick-block feeder
// ---------------------------------------------------------------------------
// Serves fixed-size blocks of an aligned log for device feeding. The consumer
// alternates buffers so the next block is staged while the device crunches
// the current one (host-side analog of the double-buffered DMA pattern).

struct DemFeeder {
  const double* src = nullptr;  // (T, width) row-major, borrowed
  int64_t T = 0, width = 0, block = 0, pos = 0;
  std::vector<double> buf[2];
  int cur = 0;
};

void* dem_feeder_create(const double* src, int64_t T, int64_t width,
                        int64_t block) {
  DemFeeder* fd = new DemFeeder();
  fd->src = src;
  fd->T = T;
  fd->width = width;
  fd->block = block;
  fd->buf[0].resize(block * width);
  fd->buf[1].resize(block * width);
  return fd;
}

// Fill the next block (wrapping); returns pointer to the staged buffer and
// writes the number of valid ticks to n_valid.
const double* dem_feeder_next(void* handle, int64_t* n_valid) {
  DemFeeder* fd = static_cast<DemFeeder*>(handle);
  int64_t remain = fd->T - fd->pos;
  int64_t n = remain < fd->block ? remain : fd->block;
  if (n <= 0) {
    fd->pos = 0;
    remain = fd->T;
    n = remain < fd->block ? remain : fd->block;
  }
  double* dst = fd->buf[fd->cur].data();
  std::memcpy(dst, fd->src + fd->pos * fd->width,
              sizeof(double) * static_cast<size_t>(n * fd->width));
  // zero-pad the tail so block shapes stay static for XLA
  if (n < fd->block)
    std::memset(dst + n * fd->width, 0,
                sizeof(double) * static_cast<size_t>((fd->block - n) * fd->width));
  fd->pos += n;
  fd->cur ^= 1;
  *n_valid = n;
  return dst;
}

void dem_feeder_destroy(void* handle) {
  delete static_cast<DemFeeder*>(handle);
}

}  // extern "C"
