// drts_native: host-side runtime for the path tracer.
//
// Native (C++) replacements for the reference's host-side native
// components (SURVEY.md §2.3): DirectXTK12's GeometricPrimitive geosphere
// generator (used at /root/reference/Source/MyScene.ixx:56), DirectXMesh's
// ComputeTangentFrame (MyScene.ixx:70), the MathLib Halton sequence
// (HaltonSampler.ixx:32-34), and a PNG writer standing in for the
// DirectXTex/DirectXTK save path.
//
// Exposed as a C ABI for ctypes (drts_tpu/native.py); the Python layer
// falls back to numpy implementations when this library is absent, so the
// build is optional but preferred (scene build drops from ~hundreds of ms
// of Python to native speed for large tessellations).
//
// Build: make -C native  (g++ -O3 -shared -fPIC, links zlib)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

#include <zlib.h>

namespace {

struct Mesh {
  std::vector<float> pos;   // 3 * v
  std::vector<float> nrm;   // 3 * v
  std::vector<float> uv;    // 2 * v
  std::vector<int32_t> idx; // 3 * f
};

void normalize3(double* v) {
  double len = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  if (len > 0) {
    v[0] /= len; v[1] /= len; v[2] /= len;
  }
}

// Octahedron-subdivision geodesic sphere with lat-long UVs — the
// construction DirectXTK12's CreateGeoSphere uses, written from scratch.
Mesh build_geosphere(int tessellation, float diameter) {
  std::vector<double> verts = {
      0, 1, 0,  0, 0, -1,  1, 0, 0,  0, 0, 1,  -1, 0, 0,  0, -1, 0};
  std::vector<int64_t> faces = {0, 1, 2, 0, 2, 3, 0, 3, 4, 0, 4, 1,
                                5, 2, 1, 5, 3, 2, 5, 4, 3, 5, 1, 4};

  for (int level = 1; level < tessellation; ++level) {
    std::map<std::pair<int64_t, int64_t>, int64_t> edge_cache;
    std::vector<int64_t> new_faces;
    new_faces.reserve(faces.size() * 4);

    auto midpoint = [&](int64_t a, int64_t b) -> int64_t {
      auto key = a < b ? std::make_pair(a, b) : std::make_pair(b, a);
      auto it = edge_cache.find(key);
      if (it != edge_cache.end()) return it->second;
      double mid[3] = {verts[3 * a] + verts[3 * b],
                       verts[3 * a + 1] + verts[3 * b + 1],
                       verts[3 * a + 2] + verts[3 * b + 2]};
      normalize3(mid);
      int64_t id = static_cast<int64_t>(verts.size() / 3);
      verts.insert(verts.end(), mid, mid + 3);
      edge_cache.emplace(key, id);
      return id;
    };

    for (size_t f = 0; f < faces.size(); f += 3) {
      int64_t a = faces[f], b = faces[f + 1], c = faces[f + 2];
      int64_t ab = midpoint(a, b), bc = midpoint(b, c), ca = midpoint(c, a);
      int64_t quad[12] = {a, ab, ca, ab, b, bc, ca, bc, c, ab, bc, ca};
      new_faces.insert(new_faces.end(), quad, quad + 12);
    }
    faces.swap(new_faces);
  }

  Mesh mesh;
  size_t v_count = verts.size() / 3;
  mesh.pos.resize(3 * v_count);
  mesh.nrm.resize(3 * v_count);
  mesh.uv.resize(2 * v_count);
  for (size_t i = 0; i < v_count; ++i) {
    double v[3] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    normalize3(v);
    for (int c = 0; c < 3; ++c) {
      mesh.nrm[3 * i + c] = static_cast<float>(v[c]);
      mesh.pos[3 * i + c] = static_cast<float>(v[c] * diameter * 0.5);
    }
    mesh.uv[2 * i] =
        static_cast<float>((1.0 + std::atan2(v[0], v[2]) / M_PI) / 2.0);
    double y = v[1] < -1 ? -1 : (v[1] > 1 ? 1 : v[1]);
    mesh.uv[2 * i + 1] = static_cast<float>(std::acos(y) / M_PI);
  }
  mesh.idx.assign(faces.begin(), faces.end());
  return mesh;
}

thread_local Mesh g_mesh;
thread_local int g_mesh_tess = -1;
thread_local float g_mesh_diameter = 0;

}  // namespace

extern "C" {

// --- geosphere (two-call protocol: counts, then copy-out) -----------------

int geosphere_counts(int tessellation, float diameter, int* v_count,
                     int* f_count) {
  if (tessellation < 1 || tessellation > 8) return -1;
  if (g_mesh_tess != tessellation || g_mesh_diameter != diameter) {
    g_mesh = build_geosphere(tessellation, diameter);
    g_mesh_tess = tessellation;
    g_mesh_diameter = diameter;
  }
  *v_count = static_cast<int>(g_mesh.pos.size() / 3);
  *f_count = static_cast<int>(g_mesh.idx.size() / 3);
  return 0;
}

int geosphere_copy(float* pos, float* nrm, float* uv, int32_t* idx) {
  if (g_mesh_tess < 0) return -1;
  std::memcpy(pos, g_mesh.pos.data(), g_mesh.pos.size() * sizeof(float));
  std::memcpy(nrm, g_mesh.nrm.data(), g_mesh.nrm.size() * sizeof(float));
  std::memcpy(uv, g_mesh.uv.data(), g_mesh.uv.size() * sizeof(float));
  std::memcpy(idx, g_mesh.idx.data(), g_mesh.idx.size() * sizeof(int32_t));
  return 0;
}

// --- tangent frames (Lengyel UV-gradient accumulation) --------------------

void tangent_frame(const int32_t* idx, int f_count, const float* pos,
                   const float* nrm, const float* uv, int v_count,
                   float* tan_out) {
  std::vector<double> tan(3 * v_count, 0.0);
  for (int f = 0; f < f_count; ++f) {
    int i0 = idx[3 * f], i1 = idx[3 * f + 1], i2 = idx[3 * f + 2];
    double e1[3], e2[3];
    for (int c = 0; c < 3; ++c) {
      e1[c] = pos[3 * i1 + c] - pos[3 * i0 + c];
      e2[c] = pos[3 * i2 + c] - pos[3 * i0 + c];
    }
    double du1 = uv[2 * i1] - uv[2 * i0], dv1 = uv[2 * i1 + 1] - uv[2 * i0 + 1];
    double du2 = uv[2 * i2] - uv[2 * i0], dv2 = uv[2 * i2 + 1] - uv[2 * i0 + 1];
    double det = du1 * dv2 - du2 * dv1;
    if (std::fabs(det) < 1e-12) continue;
    double r = 1.0 / det;
    for (int c = 0; c < 3; ++c) {
      double t = (e1[c] * dv2 - e2[c] * dv1) * r;
      tan[3 * i0 + c] += t;
      tan[3 * i1 + c] += t;
      tan[3 * i2 + c] += t;
    }
  }
  for (int i = 0; i < v_count; ++i) {
    double n[3] = {nrm[3 * i], nrm[3 * i + 1], nrm[3 * i + 2]};
    double t[3] = {tan[3 * i], tan[3 * i + 1], tan[3 * i + 2]};
    double d = t[0] * n[0] + t[1] * n[1] + t[2] * n[2];
    for (int c = 0; c < 3; ++c) t[c] -= n[c] * d;
    double len = std::sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
    if (len < 1e-8) {
      // Fall back to any perpendicular.
      double up[3] = {0, 1, 0};
      if (std::fabs(n[1]) > 0.99) { up[0] = 1; up[1] = 0; }
      t[0] = n[1] * up[2] - n[2] * up[1];
      t[1] = n[2] * up[0] - n[0] * up[2];
      t[2] = n[0] * up[1] - n[1] * up[0];
      len = std::sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
    }
    for (int c = 0; c < 3; ++c)
      tan_out[3 * i + c] = static_cast<float>(t[c] / len);
  }
}

// --- Halton (2,3) ---------------------------------------------------------

void halton23(int count, int start, float* out) {
  for (int i = 0; i < count; ++i) {
    uint64_t n = static_cast<uint64_t>(start + i + 1);
    double f = 1.0, r = 0.0;
    for (uint64_t v = n; v; v /= 2) { f /= 2; r += f * (v % 2); }
    out[2 * i] = static_cast<float>(r);
    f = 1.0; r = 0.0;
    for (uint64_t v = n; v; v /= 3) { f /= 3; r += f * (v % 3); }
    out[2 * i + 1] = static_cast<float>(r);
  }
}

// --- PNG writer (zlib) ----------------------------------------------------

namespace {
uint32_t crc_update(uint32_t crc, const uint8_t* data, size_t len) {
  return static_cast<uint32_t>(
      crc32(crc, reinterpret_cast<const Bytef*>(data),
            static_cast<uInt>(len)));
}

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v >> 24); out.push_back(v >> 16);
  out.push_back(v >> 8); out.push_back(v);
}

void put_chunk(std::vector<uint8_t>& out, const char* tag,
               const std::vector<uint8_t>& data) {
  put_be32(out, static_cast<uint32_t>(data.size()));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data.begin(), data.end());
  uint32_t crc = crc_update(crc32(0, nullptr, 0), out.data() + start,
                            out.size() - start);
  put_be32(out, crc);
}
}  // namespace

int write_png(const char* path, const uint8_t* pixels, int width, int height,
              int channels) {
  if (channels != 1 && channels != 3 && channels != 4) return -1;
  int color_type = channels == 1 ? 0 : (channels == 3 ? 2 : 6);

  std::vector<uint8_t> raw;
  raw.reserve(static_cast<size_t>(height) * (1 + width * channels));
  for (int y = 0; y < height; ++y) {
    raw.push_back(0);  // no filter
    const uint8_t* row = pixels + static_cast<size_t>(y) * width * channels;
    raw.insert(raw.end(), row, row + static_cast<size_t>(width) * channels);
  }

  uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(),
                static_cast<uLong>(raw.size()), 6) != Z_OK)
    return -2;
  comp.resize(comp_cap);

  std::vector<uint8_t> png = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::vector<uint8_t> ihdr;
  put_be32(ihdr, static_cast<uint32_t>(width));
  put_be32(ihdr, static_cast<uint32_t>(height));
  ihdr.push_back(8);
  ihdr.push_back(static_cast<uint8_t>(color_type));
  ihdr.push_back(0); ihdr.push_back(0); ihdr.push_back(0);
  put_chunk(png, "IHDR", ihdr);
  put_chunk(png, "IDAT", comp);
  put_chunk(png, "IEND", {});

  FILE* f = std::fopen(path, "wb");
  if (!f) return -3;
  size_t written = std::fwrite(png.data(), 1, png.size(), f);
  std::fclose(f);
  return written == png.size() ? 0 : -4;
}

}  // extern "C"
