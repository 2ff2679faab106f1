// tinypt native OBJ parser.
//
// Fast line parser for the subset of OBJ the scenes use
// (v / vn / vt / usemtl / f with triangular faces), replicating the
// reference's face-index layout heuristic (see io/objmesh.py and
// RayTracingOnCPU/scene.cpp:150-190): a vt line seen while no vn exists
// flips the interpretation of "a/b/c" from v/vn/vt to v/vt/vn.
//
// Two-call C API (ctypes):
//   tinypt_obj_scan(path, &n_tris, &names_bytes, &n_verts)          -> 0 on success
//   tinypt_obj_parse(path, v9, vn9, vt6, mtl, names, cap, fv3, v3)  -> n_tris
// where v9/vn9/vt6 are (T,9)/(T,9)/(T,6) float64 buffers, mtl (T,) int32
// indices into the '\n'-joined usemtl name blob written to `names`, fv3
// (T,3) int64 each face's vertex ids and v3 (V,3) float64 the shared
// vertex table.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Parsed {
  std::vector<double> v;       // flat xyz
  std::vector<double> vn;
  std::vector<double> vt;      // flat uv
  std::vector<int64_t> fv, fn, ft;  // per corner, -1 = absent
  std::vector<int32_t> fm;
  std::vector<std::string> names;
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

bool parse_file(const char* path, Parsed* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[1024];
  bool isvnvt = true;
  int32_t cur_mtl = -1;
  std::unordered_map<std::string, int32_t> name_ix;

  while (std::fgets(line, sizeof line, f)) {
    const char* p = skip_ws(line);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      double x, y, z;
      if (std::sscanf(p + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
        out->v.push_back(x);
        out->v.push_back(y);
        out->v.push_back(z);
      }
    } else if (p[0] == 'v' && p[1] == 'n') {
      double x, y, z;
      if (std::sscanf(p + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        out->vn.push_back(x);
        out->vn.push_back(y);
        out->vn.push_back(z);
      }
    } else if (p[0] == 'v' && p[1] == 't') {
      if (out->vn.empty()) isvnvt = false;
      double x, y;
      if (std::sscanf(p + 2, "%lf %lf", &x, &y) == 2) {
        out->vt.push_back(x);
        out->vt.push_back(y);
      }
    } else if (!std::strncmp(p, "usemtl", 6)) {
      const char* q = skip_ws(p + 6);
      const char* e = q;
      while (*e && !std::isspace((unsigned char)*e)) ++e;
      std::string name(q, e - q);
      auto it = name_ix.find(name);
      if (it == name_ix.end()) {
        it = name_ix.emplace(name, (int32_t)out->names.size()).first;
        out->names.push_back(name);
      }
      cur_mtl = it->second;
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 1;
      int64_t vi[3] = {0, 0, 0}, ni[3] = {-1, -1, -1}, ti[3] = {-1, -1, -1};
      for (int k = 0; k < 3; ++k) {
        q = skip_ws(q);
        int64_t idx[3] = {0, -1, -1};
        int slot = 0;
        while (*q && !std::isspace((unsigned char)*q)) {
          if (*q == '/') {
            ++slot;
            ++q;
            if (slot > 2) break;
            if (*q == '/') continue;  // empty component
            idx[slot] = 0;
          } else {
            if (idx[slot] < 0) idx[slot] = 0;
            idx[slot] = idx[slot] * 10 + (*q - '0');
            ++q;
          }
        }
        vi[k] = idx[0] - 1;
        if (slot >= 2) {  // a/b/c
          if (isvnvt) {
            if (idx[1] > 0) ni[k] = idx[1] - 1;
            if (idx[2] > 0) ti[k] = idx[2] - 1;
          } else {
            if (idx[1] > 0) ti[k] = idx[1] - 1;
            if (idx[2] > 0) ni[k] = idx[2] - 1;
          }
        } else if (slot == 1) {  // a/b
          if (isvnvt) {
            if (idx[1] > 0) ti[k] = idx[1] - 1;
          } else {
            if (idx[1] > 0) ni[k] = idx[1] - 1;
          }
        }
      }
      for (int k = 0; k < 3; ++k) {
        out->fv.push_back(vi[k]);
        out->fn.push_back(ni[k]);
        out->ft.push_back(ti[k]);
      }
      out->fm.push_back(cur_mtl);
    }
  }
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" int tinypt_obj_scan(const char* path, int64_t* n_tris,
                               int64_t* names_bytes, int64_t* n_verts) {
  Parsed p;
  if (!parse_file(path, &p)) return -1;
  *n_tris = (int64_t)p.fm.size();
  *n_verts = (int64_t)p.v.size() / 3;
  int64_t nb = 1;
  for (const auto& n : p.names) nb += (int64_t)n.size() + 1;
  *names_bytes = nb;
  return 0;
}

extern "C" int64_t tinypt_obj_parse(const char* path, double* v9, double* vn9,
                                    double* vt6, int32_t* mtl, char* names,
                                    int64_t names_cap, int64_t* fv3,
                                    double* v3) {
  Parsed p;
  if (!parse_file(path, &p)) return -1;
  const int64_t T = (int64_t)p.fm.size();
  const int64_t NV = (int64_t)p.v.size() / 3;
  const int64_t NN = (int64_t)p.vn.size() / 3;
  const int64_t NT = (int64_t)p.vt.size() / 2;
  for (int64_t t = 0; t < T; ++t) {
    for (int k = 0; k < 3; ++k) {
      int64_t a = p.fv[t * 3 + k];
      for (int c = 0; c < 3; ++c)
        v9[t * 9 + k * 3 + c] = (a >= 0 && a < NV) ? p.v[a * 3 + c] : 0.0;
      int64_t b = p.fn[t * 3 + k];
      for (int c = 0; c < 3; ++c)
        vn9[t * 9 + k * 3 + c] = (b >= 0 && b < NN) ? p.vn[b * 3 + c] : 0.0;
      int64_t d = p.ft[t * 3 + k];
      for (int c = 0; c < 2; ++c)
        vt6[t * 6 + k * 2 + c] = (d >= 0 && d < NT) ? p.vt[d * 2 + c] : 0.0;
    }
    mtl[t] = p.fm[t];
  }
  std::memcpy(fv3, p.fv.data(), p.fv.size() * sizeof(int64_t));
  std::memcpy(v3, p.v.data(), p.v.size() * sizeof(double));
  int64_t off = 0;
  for (const auto& n : p.names) {
    if (off + (int64_t)n.size() + 1 >= names_cap) break;
    std::memcpy(names + off, n.data(), n.size());
    off += (int64_t)n.size();
    names[off++] = '\n';
  }
  names[off] = 0;
  return T;
}
