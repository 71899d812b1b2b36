// Native host-side runtime for stereo_depth_ruler_tpu.
//
// The reference implements its entire runtime in C++ (OpenCV/PCL); the
// JAX framework keeps the compute path in XLA but implements the
// host-side I/O runtime natively where throughput matters:
//   - binary PCD writing (the reference's pcl::io::savePCDFileBinary,
//     point_cloud/src/pcd_write.cpp:135-146) without Python overhead;
//   - hash-map voxel-grid downsampling (PCL VoxelGrid semantics,
//     pcd_write.cpp:123-130) for host-side export paths;
//   - an SBSV frame loader with a background prefetch thread + ring
//     buffer, so video decode overlaps device compute (the async analog
//     of the reference's synchronous cap >> frame loop,
//     stereo_displayer.cpp:145-148).
//
// C ABI only (consumed via ctypes from
// stereo_depth_ruler_tpu/utils/native.py); Python fallbacks exist for
// every function.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PCD writing
// ---------------------------------------------------------------------------

// Write a PCD v0.7 file. xyz: n*3 floats; rgb: n*3 bytes or null;
// binary: 1 = DATA binary, 0 = DATA ascii. Returns 0 on success.
int sdr_write_pcd(const char* path, const float* xyz, const uint8_t* rgb,
                  int64_t n, int binary) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const bool has_rgb = rgb != nullptr;
  std::string header = "# .PCD v0.7 - Point Cloud Data file format\n";
  header += "VERSION 0.7\n";
  header += has_rgb ? "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n"
                      "COUNT 1 1 1 1\n"
                    : "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n";
  header += "WIDTH " + std::to_string(n) + "\nHEIGHT 1\n";
  header += "VIEWPOINT 0 0 0 1 0 0 0\n";
  header += "POINTS " + std::to_string(n) + "\n";
  header += binary ? "DATA binary\n" : "DATA ascii\n";
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return -2;
  }
  int rc = 0;
  if (binary) {
    if (has_rgb) {
      // interleave x y z rgb(packed float) rows; buffered in chunks
      const int64_t CHUNK = 65536;
      std::vector<float> buf(CHUNK * 4);
      for (int64_t off = 0; off < n && rc == 0; off += CHUNK) {
        int64_t m = std::min(CHUNK, n - off);
        for (int64_t i = 0; i < m; ++i) {
          buf[i * 4 + 0] = xyz[(off + i) * 3 + 0];
          buf[i * 4 + 1] = xyz[(off + i) * 3 + 1];
          buf[i * 4 + 2] = xyz[(off + i) * 3 + 2];
          uint32_t packed = (uint32_t(rgb[(off + i) * 3 + 0]) << 16) |
                            (uint32_t(rgb[(off + i) * 3 + 1]) << 8) |
                            uint32_t(rgb[(off + i) * 3 + 2]);
          std::memcpy(&buf[i * 4 + 3], &packed, 4);
        }
        if (std::fwrite(buf.data(), 16, m, f) != size_t(m)) rc = -3;
      }
    } else {
      if (std::fwrite(xyz, 12, n, f) != size_t(n)) rc = -3;
    }
  } else {
    for (int64_t i = 0; i < n && rc == 0; ++i) {
      if (has_rgb) {
        uint32_t packed = (uint32_t(rgb[i * 3 + 0]) << 16) |
                          (uint32_t(rgb[i * 3 + 1]) << 8) |
                          uint32_t(rgb[i * 3 + 2]);
        float pf;
        std::memcpy(&pf, &packed, 4);
        if (std::fprintf(f, "%.8g %.8g %.8g %.8g\n", xyz[i * 3],
                         xyz[i * 3 + 1], xyz[i * 3 + 2], pf) < 0)
          rc = -3;
      } else {
        if (std::fprintf(f, "%.8g %.8g %.8g\n", xyz[i * 3], xyz[i * 3 + 1],
                         xyz[i * 3 + 2]) < 0)
          rc = -3;
      }
    }
  }
  std::fclose(f);
  return rc;
}

// ---------------------------------------------------------------------------
// Voxel-grid downsample (PCL VoxelGrid centroid semantics)
// ---------------------------------------------------------------------------

// out_xyz/out_rgb must have capacity n. Returns the voxel count, or -1.
// Non-finite points are skipped (PCL is_dense=false handling).
int64_t sdr_voxel_downsample(const float* xyz, const uint8_t* rgb, int64_t n,
                             float leaf, float* out_xyz, uint8_t* out_rgb) {
  struct Acc {
    double x = 0, y = 0, z = 0, r = 0, g = 0, b = 0;
    int64_t cnt = 0;
  };
  std::unordered_map<int64_t, Acc> map;
  map.reserve(size_t(n / 4 + 16));
  const double inv = 1.0 / double(leaf);
  for (int64_t i = 0; i < n; ++i) {
    float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    if (!(x == x && y == y && z == z)) continue;  // NaN
    if (x > 1e30f || x < -1e30f || y > 1e30f || y < -1e30f || z > 1e30f ||
        z < -1e30f)
      continue;  // inf-ish
    int64_t cx = int64_t(std::floor(x * inv));
    int64_t cy = int64_t(std::floor(y * inv));
    int64_t cz = int64_t(std::floor(z * inv));
    int64_t key = ((cx & 0x1FFFFF) << 42) | ((cy & 0x1FFFFF) << 21) |
                  (cz & 0x1FFFFF);
    Acc& a = map[key];
    a.x += x;
    a.y += y;
    a.z += z;
    if (rgb) {
      a.r += rgb[i * 3];
      a.g += rgb[i * 3 + 1];
      a.b += rgb[i * 3 + 2];
    }
    a.cnt++;
  }
  int64_t k = 0;
  for (auto& kv : map) {
    const Acc& a = kv.second;
    out_xyz[k * 3 + 0] = float(a.x / a.cnt);
    out_xyz[k * 3 + 1] = float(a.y / a.cnt);
    out_xyz[k * 3 + 2] = float(a.z / a.cnt);
    if (rgb && out_rgb) {
      out_rgb[k * 3 + 0] = uint8_t(a.r / a.cnt + 0.5);
      out_rgb[k * 3 + 1] = uint8_t(a.g / a.cnt + 0.5);
      out_rgb[k * 3 + 2] = uint8_t(a.b / a.cnt + 0.5);
    }
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------------------
// SBSV loader with background prefetch
// ---------------------------------------------------------------------------

struct SbsvReader {
  FILE* f = nullptr;
  int32_t n = 0, h = 0, w = 0, c = 0;
  int64_t frame_bytes = 0;
  // prefetch state
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> buf;     // prefetched block
  int64_t buf_start = -1, buf_count = 0;
  int64_t want_start = -1, want_count = 0;
  bool stop = false, ready = false;

  void loop() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv.wait(lk, [&] { return stop || want_start >= 0; });
      if (stop) return;
      int64_t s = want_start, cnt = want_count;
      want_start = -1;
      lk.unlock();
      std::vector<uint8_t> tmp(size_t(cnt * frame_bytes));
      std::fseek(f, long(24 + s * frame_bytes), SEEK_SET);
      size_t got = std::fread(tmp.data(), size_t(frame_bytes), size_t(cnt), f);
      lk.lock();
      buf = std::move(tmp);
      buf_start = s;
      buf_count = int64_t(got);
      ready = true;
      cv.notify_all();
    }
  }
};

void* sdr_sbsv_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "SBSV0001", 8)) {
    std::fclose(f);
    return nullptr;
  }
  auto* r = new SbsvReader();
  r->f = f;
  int32_t hdr[4];
  if (std::fread(hdr, 4, 4, f) != 4) {
    std::fclose(f);
    delete r;
    return nullptr;
  }
  r->n = hdr[0];
  r->h = hdr[1];
  r->w = hdr[2];
  r->c = hdr[3];
  r->frame_bytes = int64_t(r->h) * r->w * r->c;
  r->worker = std::thread([r] { r->loop(); });
  return r;
}

void sdr_sbsv_info(void* h, int32_t* out) {
  auto* r = static_cast<SbsvReader*>(h);
  out[0] = r->n;
  out[1] = r->h;
  out[2] = r->w;
  out[3] = r->c;
}

// Request async prefetch of [start, start+count).
void sdr_sbsv_prefetch(void* h, int64_t start, int64_t count) {
  auto* r = static_cast<SbsvReader*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  r->want_start = start;
  r->want_count = count;
  r->ready = false;
  r->cv.notify_all();
}

// Blocking read; serves from the prefetch buffer when it matches.
// Returns frames actually read.
int64_t sdr_sbsv_read(void* h, int64_t start, int64_t count, uint8_t* out) {
  auto* r = static_cast<SbsvReader*>(h);
  {
    std::unique_lock<std::mutex> lk(r->mu);
    if (r->want_start >= 0 || r->ready) {
      r->cv.wait(lk, [&] { return r->ready || r->stop; });
      if (r->ready && r->buf_start == start && r->buf_count >= count) {
        std::memcpy(out, r->buf.data(), size_t(count * r->frame_bytes));
        return count;
      }
    }
  }
  std::fseek(r->f, long(24 + start * r->frame_bytes), SEEK_SET);
  return int64_t(
      std::fread(out, size_t(r->frame_bytes), size_t(count), r->f));
}

void sdr_sbsv_close(void* h) {
  auto* r = static_cast<SbsvReader*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop = true;
    r->cv.notify_all();
  }
  r->worker.join();
  std::fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// CSV append (measurement records; schema of stereo_displayer.cpp:81-93)
// ---------------------------------------------------------------------------

int sdr_csv_append(const char* path, const char* header, const char* row) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  if (std::ftell(f) == 0 && header) {
    std::fputs(header, f);
    std::fputc('\n', f);
  }
  std::fputs(row, f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
