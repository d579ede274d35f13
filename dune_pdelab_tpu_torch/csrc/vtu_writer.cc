// Binary .vtu writer (appended raw encoding), host C++: the port's copy of
// dune_pdelab_tpu/io/native/vtu_writer.cc, reached through ctypes from
// dune_pdelab_tpu_torch/io/vtk_binary.py. Writes the VTK XML
// UnstructuredGrid format with appended raw binary payloads (header_type
// UInt64, little-endian): each payload is a uint64 byte count followed by
// the raw array, so a multi-million-point field is one fwrite, not text.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_host.py).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Appended {
  std::vector<const char*> ptrs;
  std::vector<uint64_t> nbytes;
  uint64_t offset = 0;

  uint64_t add(const void* p, uint64_t n) {
    ptrs.push_back(static_cast<const char*>(p));
    nbytes.push_back(n);
    uint64_t off = offset;
    offset += sizeof(uint64_t) + n;
    return off;
  }
};

void data_array_header(std::string& xml, const char* type, const char* name,
                       int ncomp, uint64_t offset) {
  char buf[512];
  std::snprintf(buf, sizeof(buf),
                "<DataArray type=\"%s\" Name=\"%s\" "
                "NumberOfComponents=\"%d\" format=\"appended\" "
                "offset=\"%llu\"/>\n",
                type, name, ncomp,
                static_cast<unsigned long long>(offset));
  xml += buf;
}

}  // namespace

extern "C" int write_vtu_binary(
    const char* path,
    int64_t npoints, const double* points,            // (npoints, 3)
    int64_t ncells, int ncorners, const int64_t* conn,  // (ncells, ncorners)
    uint8_t celltype,
    int n_point_fields, const char** pnames, const int* pcomps,
    const double** pdata,
    int n_cell_fields, const char** cnames, const int* ccomps,
    const double** cdata) {
  Appended app;
  std::string xml;
  xml += "<?xml version=\"1.0\"?>\n";
  xml += "<VTKFile type=\"UnstructuredGrid\" version=\"1.0\" "
         "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n";
  xml += "<UnstructuredGrid>\n";
  {
    char buf[256];
    std::snprintf(buf, sizeof(buf),
                  "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
                  static_cast<long long>(npoints),
                  static_cast<long long>(ncells));
    xml += buf;
  }

  xml += "<PointData>\n";
  for (int i = 0; i < n_point_fields; ++i) {
    uint64_t off = app.add(pdata[i],
                           uint64_t(npoints) * pcomps[i] * sizeof(double));
    data_array_header(xml, "Float64", pnames[i], pcomps[i], off);
  }
  xml += "</PointData>\n<CellData>\n";
  for (int i = 0; i < n_cell_fields; ++i) {
    uint64_t off = app.add(cdata[i],
                           uint64_t(ncells) * ccomps[i] * sizeof(double));
    data_array_header(xml, "Float64", cnames[i], ccomps[i], off);
  }
  xml += "</CellData>\n<Points>\n";
  {
    uint64_t off = app.add(points, uint64_t(npoints) * 3 * sizeof(double));
    data_array_header(xml, "Float64", "Points", 3, off);
  }
  xml += "</Points>\n<Cells>\n";

  std::vector<int64_t> offsets(ncells);
  for (int64_t i = 0; i < ncells; ++i) offsets[i] = (i + 1) * ncorners;
  std::vector<uint8_t> types(ncells, celltype);
  {
    uint64_t off = app.add(conn,
                           uint64_t(ncells) * ncorners * sizeof(int64_t));
    data_array_header(xml, "Int64", "connectivity", 1, off);
    off = app.add(offsets.data(), uint64_t(ncells) * sizeof(int64_t));
    data_array_header(xml, "Int64", "offsets", 1, off);
    off = app.add(types.data(), uint64_t(ncells) * sizeof(uint8_t));
    data_array_header(xml, "UInt8", "types", 1, off);
  }
  xml += "</Cells>\n</Piece>\n</UnstructuredGrid>\n";
  xml += "<AppendedData encoding=\"raw\">\n_";

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  if (std::fwrite(xml.data(), 1, xml.size(), f) != xml.size()) {
    std::fclose(f);
    return 2;
  }
  for (size_t i = 0; i < app.ptrs.size(); ++i) {
    uint64_t n = app.nbytes[i];
    if (std::fwrite(&n, sizeof(uint64_t), 1, f) != 1 ||
        std::fwrite(app.ptrs[i], 1, n, f) != n) {
      std::fclose(f);
      return 3;
    }
  }
  const char* tail = "\n</AppendedData>\n</VTKFile>\n";
  std::fwrite(tail, 1, std::strlen(tail), f);
  std::fclose(f);
  return 0;
}
