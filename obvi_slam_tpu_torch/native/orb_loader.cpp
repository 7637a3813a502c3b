// Native ORB-output data loader.
//
// The reference's feature loader is C++
// (orb_output_low_level_feature_reader.cpp); this is its equivalent for the
// host runtime: parses a directory of per-frame observation files
//   line 1: frame id, line 2: pose (skipped),
//   rest:   feat_id cam_id x y [cam_id x y ...]
// into flat arrays in one pass (no Python-level line parsing).
//
// Built with g++ on first use by obvi_slam_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct OrbObservations {
  int64_t n;
  int64_t* feature_id;  // [n]
  int64_t* frame_id;    // [n]
  int64_t* camera_id;   // [n]
  double* px;           // [n]
  double* py;           // [n]
};

// Parse ONE per-frame observation file, appending to the arrays. Returns the
// frame id from line 1 or -1 on failure.
static int64_t parse_frame_file(const char* path,
                                std::vector<int64_t>& feat,
                                std::vector<int64_t>& frame,
                                std::vector<int64_t>& cam,
                                std::vector<double>& xs,
                                std::vector<double>& ys) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (std::fread(&buf[0], 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const char* p = buf.c_str();
  const char* end = p + size;
  char* next = nullptr;
  int64_t frame_id = std::strtoll(p, &next, 10);
  p = next;
  // skip rest of line 1 and all of line 2 (pose)
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  while (p < end) {
    // one line: feat cam x y [cam x y ...]
    while (p < end && (*p == ' ' || *p == '\r' || *p == '\n')) ++p;
    if (p >= end) break;
    int64_t feature = std::strtoll(p, &next, 10);
    if (next == p) break;
    p = next;
    while (p < end && *p != '\n') {
      int64_t camera = std::strtoll(p, &next, 10);
      if (next == p) break;
      p = next;
      double x = std::strtod(p, &next);
      if (next == p) break;
      p = next;
      double y = std::strtod(p, &next);
      if (next == p) break;
      p = next;
      feat.push_back(feature);
      frame.push_back(frame_id);
      cam.push_back(camera);
      xs.push_back(x);
      ys.push_back(y);
      while (p < end && (*p == ' ' || *p == '\r')) ++p;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  return frame_id;
}

// paths: NUL-separated list of file paths, n_paths entries.
int load_orb_observations(const char* paths, int64_t n_paths,
                          OrbObservations* out) {
  std::vector<int64_t> feat, frame, cam;
  std::vector<double> xs, ys;
  const char* p = paths;
  for (int64_t i = 0; i < n_paths; ++i) {
    parse_frame_file(p, feat, frame, cam, xs, ys);
    p += std::strlen(p) + 1;
  }
  out->n = (int64_t)feat.size();
  size_t n = feat.size() ? feat.size() : 1;
  out->feature_id = (int64_t*)std::malloc(sizeof(int64_t) * n);
  out->frame_id = (int64_t*)std::malloc(sizeof(int64_t) * n);
  out->camera_id = (int64_t*)std::malloc(sizeof(int64_t) * n);
  out->px = (double*)std::malloc(sizeof(double) * n);
  out->py = (double*)std::malloc(sizeof(double) * n);
  if (!feat.empty()) {
    std::memcpy(out->feature_id, feat.data(), sizeof(int64_t) * feat.size());
    std::memcpy(out->frame_id, frame.data(), sizeof(int64_t) * feat.size());
    std::memcpy(out->camera_id, cam.data(), sizeof(int64_t) * feat.size());
    std::memcpy(out->px, xs.data(), sizeof(double) * feat.size());
    std::memcpy(out->py, ys.data(), sizeof(double) * feat.size());
  }
  return 0;
}

void free_orb_observations(OrbObservations* o) {
  std::free(o->feature_id);
  std::free(o->frame_id);
  std::free(o->camera_id);
  std::free(o->px);
  std::free(o->py);
  std::memset(o, 0, sizeof(OrbObservations));
}

}  // extern "C"
