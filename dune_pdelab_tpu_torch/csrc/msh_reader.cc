// Native Gmsh MSH 2.x ASCII parser, host C++ (the port's copy of
// dune_pdelab_tpu/io/native/msh_reader.cc; reference analog: dune-grid's
// GmshReader, through which dune/pdelab/test/grids/*.msh are read).
//
// Two-call C API used from ctypes (dune_pdelab_tpu_torch/io/msh_native.py):
//   msh_open  - parse the file, report entity counts
//   msh_fill  - copy the parsed arrays into caller-allocated buffers
//   msh_close - free the parse state
// Node ids are remapped to file row order exactly like the Python parser
// (mesh/simplex.py _parse_msh_py), so both give identical arrays. Unlike
// the reference's copy, which reads tokens across line ends, this one
// reads the file line by line with the Python parser's rules, so the two
// accept and refuse the same files: a node line needs an id and three
// coordinates, an element line its type, tag count and tags; every node id
// of every element must be known (elements of other types than lines,
// triangles and tetrahedra are then skipped); lines, triangles and
// tetrahedra need 2, 3 and 4 nodes. Anything else returns an error code:
//   1 cannot open, 2 no $MeshFormat, 3 not MSH 2.x, 4 no $Nodes,
//   5 bad node count, 6 bad node line, 7 no $Elements, 8 bad element
//   count, 9 bad element line, 11 wrong node count for the type,
//   12 unknown node id.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_host.py).
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct MshData {
  std::vector<double> coords;                       // nn * 3
  std::vector<int64_t> tris, tritags;               // nt * 3, nt
  std::vector<int64_t> tets, tettags;               // nq * 4, nq
  std::vector<int64_t> lns, lntags;                 // nl * 2, nl
};

struct Reader {
  FILE* f = nullptr;
  char* buf = nullptr;
  size_t cap = 0;
  std::vector<char*> tok;

  ~Reader() {
    std::free(buf);
    if (f) std::fclose(f);
  }

  // next line split at whitespace into `tok`; false at the end of the file
  bool line() {
    if (getline(&buf, &cap, f) < 0) return false;
    tok.clear();
    char* save = nullptr;
    for (char* t = strtok_r(buf, " \t\r\n\v\f", &save); t;
         t = strtok_r(nullptr, " \t\r\n\v\f", &save))
      tok.push_back(t);
    return true;
  }

  // advance past the line that is `name` (surrounding blanks ignored)
  bool seek(const char* name) {
    while (line())
      if (tok.size() == 1 && std::strcmp(tok[0], name) == 0) return true;
    return false;
  }
};

bool to_i64(const char* t, long long& v) {
  char* end;
  errno = 0;
  v = std::strtoll(t, &end, 10);
  return end != t && *end == 0 && errno == 0;
}

bool to_f64(const char* t, double& v) {
  char* end;
  v = std::strtod(t, &end);
  return end != t && *end == 0;
}

}  // namespace

extern "C" {

void* msh_open(const char* path, int64_t* nnodes, int64_t* ntris,
               int64_t* ntets, int64_t* nlines, int* err) {
  *err = 0;
  *nnodes = *ntris = *ntets = *nlines = 0;
  Reader R;
  R.f = std::fopen(path, "r");
  if (!R.f) { *err = 1; return nullptr; }
  MshData* d = nullptr;
  auto fail = [&](int code) -> void* {
    delete d;
    *err = code;
    return nullptr;
  };
  if (!R.seek("$MeshFormat")) return fail(2);
  if (!R.line() || R.tok.empty() || R.tok[0][0] != '2') return fail(3);
  if (!R.seek("$Nodes")) return fail(4);
  long long nn;
  if (!R.line() || R.tok.size() != 1 || !to_i64(R.tok[0], nn) || nn < 0)
    return fail(5);
  d = new MshData();
  d->coords.resize(static_cast<size_t>(nn) * 3);
  std::unordered_map<int64_t, int64_t> idmap;
  idmap.reserve(static_cast<size_t>(nn) * 2);
  for (long long r = 0; r < nn; ++r) {
    long long id;
    double x[3];
    if (!R.line() || R.tok.size() < 4 || !to_i64(R.tok[0], id) ||
        !to_f64(R.tok[1], x[0]) || !to_f64(R.tok[2], x[1]) ||
        !to_f64(R.tok[3], x[2]))
      return fail(6);
    idmap[id] = r;
    for (int k = 0; k < 3; ++k) d->coords[3 * r + k] = x[k];
  }
  if (!R.seek("$Elements")) return fail(7);
  long long ne;
  if (!R.line() || R.tok.size() != 1 || !to_i64(R.tok[0], ne) || ne < 0)
    return fail(8);
  std::vector<int64_t> nodes;
  for (long long r = 0; r < ne; ++r) {
    long long etype, ntags, tag = 0, v;
    if (!R.line() || R.tok.size() < 3 || !to_i64(R.tok[1], etype) ||
        !to_i64(R.tok[2], ntags))
      return fail(9);
    if (ntags > 0 && (R.tok.size() < 4 || !to_i64(R.tok[3], tag)))
      return fail(9);
    nodes.clear();
    for (size_t k = 3 + static_cast<size_t>(ntags < 0 ? 0 : ntags);
         k < R.tok.size(); ++k) {
      if (!to_i64(R.tok[k], v)) return fail(9);
      auto it = idmap.find(v);
      if (it == idmap.end()) return fail(12);
      nodes.push_back(it->second);
    }
    std::vector<int64_t>* arr;
    std::vector<int64_t>* tg;
    size_t nv;
    if (etype == 1) { arr = &d->lns; tg = &d->lntags; nv = 2; }
    else if (etype == 2) { arr = &d->tris; tg = &d->tritags; nv = 3; }
    else if (etype == 4) { arr = &d->tets; tg = &d->tettags; nv = 4; }
    else continue;
    if (nodes.size() != nv) return fail(11);
    arr->insert(arr->end(), nodes.begin(), nodes.end());
    tg->push_back(tag);
  }
  *nnodes = nn;
  *ntris = static_cast<int64_t>(d->tris.size() / 3);
  *ntets = static_cast<int64_t>(d->tets.size() / 4);
  *nlines = static_cast<int64_t>(d->lns.size() / 2);
  return d;
}

void msh_fill(void* h, double* coords, int64_t* tris, int64_t* tritags,
              int64_t* tets, int64_t* tettags, int64_t* lns,
              int64_t* lntags) {
  auto* d = static_cast<MshData*>(h);
  auto cp = [](auto* dst, const auto& src) {
    if (!src.empty())
      std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cp(coords, d->coords);
  cp(tris, d->tris);
  cp(tritags, d->tritags);
  cp(tets, d->tets);
  cp(tettags, d->tettags);
  cp(lns, d->lns);
  cp(lntags, d->lntags);
}

void msh_close(void* h) { delete static_cast<MshData*>(h); }

}  // extern "C"
