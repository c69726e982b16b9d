// Native template I/O: parallel parser/packer for final .dat templates.
//
// The host-side data loader of the matching engine: walks a gallery dir,
// parses every final-format rolled template (layout per
// the reference's matching/matcher.cpp:886-983 — 12 u16 reserved header,
// h/w/blkH/blkW, minutiae sections, uint8 PQ texture codes) and packs the
// fields straight into caller-provided dense arrays (the PackedGallery
// layout), fanned out over OpenMP threads. Replaces the per-file Python
// reader for large galleries.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libtemplate_io.so template_io.cpp
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <string>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace fs = std::filesystem;

namespace {

struct Reader {
  const uint8_t *p, *end;
  bool ok = true;
  template <typename T> bool read(T *out, size_t n = 1) {
    size_t bytes = sizeof(T) * n;
    if (!ok || (size_t)(end - p) < bytes) {
      ok = false;
      return false;
    }
    std::memcpy(out, p, bytes);
    p += bytes;
    return true;
  }
  bool skip(size_t bytes) {
    if (!ok || (size_t)(end - p) < bytes) {
      ok = false;
      return false;
    }
    p += bytes;
    return true;
  }
};

// Parse one final rolled template into the packed slot g.
// Returns 0 on success (possibly empty template), keeps zeros on failure.
int parse_rolled(const std::vector<uint8_t> &buf, int64_t g, int minu_cap,
                 int tex_cap, int des_dim, int n_subs, float *minu_des,
                 float *minu_x, float *minu_y, float *minu_ori,
                 int32_t *minu_n, uint8_t *codes, float *tex_x, float *tex_y,
                 float *tex_ori, int32_t *tex_n) {
  if (buf.size() <= 10) return 0;  // empty-template skip semantics
  Reader r{buf.data(), buf.data() + buf.size()};
  uint16_t header[12], h, w, blkH, blkW;
  if (!r.read(header, 12) || !r.read(&h) || !r.read(&w) || !r.read(&blkH) ||
      !r.read(&blkW))
    return 0;
  uint8_t n_minu_templates = 0;
  if (!r.read(&n_minu_templates)) return 0;

  std::vector<uint16_t> xs, ys;
  std::vector<float> oris, des;
  for (int t = 0; t < n_minu_templates; ++t) {
    uint16_t n = 0;
    if (!r.read(&n)) return 0;
    if ((int)n <= 0) continue;
    if (n > 2000) return 0;
    xs.resize(n);
    ys.resize(n);
    oris.resize(n);
    if (!r.read(xs.data(), n) || !r.read(ys.data(), n) ||
        !r.read(oris.data(), n))
      return 0;
    uint16_t dlen = 0;
    if (!r.read(&dlen)) return 0;
    des.resize((size_t)n * dlen);
    if (!r.read(des.data(), (size_t)n * dlen)) return 0;
    if (t == 0) {  // the matcher uses rolled minutiae template 0
      int keep = std::min<int>(n, minu_cap);
      minu_n[g] = keep;
      int d_use = std::min<int>(dlen, des_dim);
      for (int i = 0; i < keep; ++i) {
        minu_x[g * minu_cap + i] = xs[i];
        minu_y[g * minu_cap + i] = ys[i];
        minu_ori[g * minu_cap + i] = oris[i];
        std::memcpy(&minu_des[((int64_t)g * minu_cap + i) * des_dim],
                    &des[(size_t)i * dlen], sizeof(float) * d_use);
      }
    }
  }

  uint8_t n_tex = 0;
  if (!r.read(&n_tex)) return 0;
  for (int t = 0; t < n_tex; ++t) {
    uint16_t n = 0;
    if (!r.read(&n)) return 0;
    if ((int)n <= 0) continue;
    if (n > 2000) return 0;
    xs.resize(n);
    ys.resize(n);
    oris.resize(n);
    if (!r.read(xs.data(), n) || !r.read(ys.data(), n) ||
        !r.read(oris.data(), n))
      return 0;
    uint16_t dlen = 0;
    if (!r.read(&dlen)) return 0;
    std::vector<uint8_t> c((size_t)n * dlen);
    if (!r.read(c.data(), (size_t)n * dlen)) return 0;
    if (t == 0) {
      int keep = std::min<int>(n, tex_cap);
      tex_n[g] = keep;
      int s_use = std::min<int>(dlen, n_subs);
      for (int i = 0; i < keep; ++i) {
        tex_x[g * tex_cap + i] = xs[i];
        tex_y[g * tex_cap + i] = ys[i];
        tex_ori[g * tex_cap + i] = oris[i];
        std::memcpy(&codes[((int64_t)g * tex_cap + i) * n_subs],
                    &c[(size_t)i * dlen], s_use);
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// List .dat files (sorted) into a newline-joined buffer; returns count or
// -needed_bytes when the buffer is too small.
int list_dat_files(const char *dir, char *out, int64_t out_cap) {
  std::vector<std::string> files;
  std::error_code ec;
  for (auto &e : fs::directory_iterator(dir, ec)) {
    if (e.path().extension() == ".dat") files.push_back(e.path().string());
  }
  std::sort(files.begin(), files.end());
  int64_t need = 1;
  for (auto &f : files) need += (int64_t)f.size() + 1;
  if (need > out_cap) return (int)-need;
  char *p = out;
  for (auto &f : files) {
    std::memcpy(p, f.c_str(), f.size());
    p += f.size();
    *p++ = '\n';
  }
  *p = 0;
  return (int)files.size();
}

// Parse `n_files` newline-separated paths into preallocated packed arrays.
// minu_des is [n, minu_cap, des_dim] f32; codes [n, tex_cap, n_subs] u8;
// coordinate/orientation planes are [n, cap] f32; counts are int32[n].
// Returns the number of successfully read templates.
int pack_gallery_files(const char *paths_joined, int n_files, int minu_cap,
                       int tex_cap, int des_dim, int n_subs, float *minu_des,
                       float *minu_x, float *minu_y, float *minu_ori,
                       int32_t *minu_n, uint8_t *codes, float *tex_x,
                       float *tex_y, float *tex_ori, int32_t *tex_n) {
  std::vector<std::string> files;
  {
    const char *p = paths_joined;
    while (*p) {
      const char *nl = std::strchr(p, '\n');
      if (!nl) nl = p + std::strlen(p);
      if (nl > p) files.emplace_back(p, nl - p);
      if (!*nl) break;
      p = nl + 1;
    }
  }
  int n = std::min<int>(files.size(), n_files);
  int ok = 0;
#pragma omp parallel for schedule(dynamic, 16) reduction(+ : ok)
  for (int g = 0; g < n; ++g) {
    std::ifstream is(files[g], std::ios::binary | std::ios::ate);
    if (!is) continue;
    auto size = is.tellg();
    std::vector<uint8_t> buf((size_t)size);
    is.seekg(0);
    is.read(reinterpret_cast<char *>(buf.data()), size);
    parse_rolled(buf, g, minu_cap, tex_cap, des_dim, n_subs, minu_des,
                 minu_x, minu_y, minu_ori, minu_n, codes, tex_x, tex_y,
                 tex_ori, tex_n);
    ok += 1;
  }
  return ok;
}

// Count-only scan: record template-0 minutiae/texture counts per file so
// the caller can right-size the packed arrays before pack_gallery_files
// (two-pass loading keeps huge galleries from over-allocating at the cap).
int scan_gallery_counts(const char *paths_joined, int n_files,
                        int32_t *minu_n, int32_t *tex_n) {
  std::vector<std::string> files;
  {
    const char *p = paths_joined;
    while (*p) {
      const char *nl = std::strchr(p, '\n');
      if (!nl) nl = p + std::strlen(p);
      if (nl > p) files.emplace_back(p, nl - p);
      if (!*nl) break;
      p = nl + 1;
    }
  }
  int n = std::min<int>(files.size(), n_files);
  int ok = 0;
#pragma omp parallel for schedule(dynamic, 16) reduction(+ : ok)
  for (int g = 0; g < n; ++g) {
    minu_n[g] = 0;
    tex_n[g] = 0;
    std::ifstream is(files[g], std::ios::binary | std::ios::ate);
    if (!is) continue;
    auto size = is.tellg();
    std::vector<uint8_t> buf((size_t)size);
    is.seekg(0);
    is.read(reinterpret_cast<char *>(buf.data()), size);
    if (buf.size() <= 10) {
      ok += 1;
      continue;
    }
    Reader r{buf.data(), buf.data() + buf.size()};
    uint16_t header[12], hw[4];
    uint8_t n_minu_templates = 0;
    if (!r.read(header, 12) || !r.read(hw, 4) || !r.read(&n_minu_templates))
      continue;
    bool bad = false;
    for (int t = 0; t < n_minu_templates && !bad; ++t) {
      uint16_t cnt = 0, dlen = 0;
      if (!r.read(&cnt)) { bad = true; break; }
      if ((int)cnt <= 0) continue;
      if (cnt > 2000 ||
          !r.skip((size_t)cnt * (2 + 2 + 4)) || !r.read(&dlen) ||
          !r.skip((size_t)cnt * dlen * 4)) { bad = true; break; }
      if (t == 0) minu_n[g] = cnt;
    }
    uint8_t n_tex_templates = 0;
    if (!bad && r.read(&n_tex_templates)) {
      for (int t = 0; t < n_tex_templates; ++t) {
        uint16_t cnt = 0, dlen = 0;
        if (!r.read(&cnt)) break;
        if ((int)cnt <= 0) continue;
        if (cnt > 2000 ||
            !r.skip((size_t)cnt * (2 + 2 + 4)) || !r.read(&dlen) ||
            !r.skip((size_t)cnt * dlen)) break;
        if (t == 0) tex_n[g] = cnt;
      }
    }
    ok += 1;
  }
  return ok;
}

// The terms of the PQ reconstruction squared norms of packed codes:
// terms[g, i, k] = cw_sqnorm[k, codes[g, i, k]] for the valid rows
// i < tex_n[g], 0 for the padding rows. The caller sums them over k in the
// order its Python packer does, so both loaders give the same bits.
void pq_sqnorm_terms(const uint8_t *codes, const int32_t *tex_n, int64_t n,
                     int tex_cap, int n_subs, int n_clusters,
                     const float *cw_sqnorm /* [n_subs, n_clusters] */,
                     float *terms) {
#pragma omp parallel for schedule(static)
  for (int64_t g = 0; g < n; ++g) {
    const int64_t base = g * tex_cap * n_subs;
    const int valid = std::min(std::max(tex_n[g], 0), tex_cap);
    for (int64_t e = 0; e < (int64_t)valid * n_subs; ++e)
      terms[base + e] = cw_sqnorm[(e % n_subs) * n_clusters + codes[base + e]];
    std::fill(terms + base + (int64_t)valid * n_subs,
              terms + base + (int64_t)tex_cap * n_subs, 0.f);
  }
}

}  // extern "C"
