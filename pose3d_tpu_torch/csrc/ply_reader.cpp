// Native PLY vertex reader for the port's host data path (a host library,
// not a kernel). The port's own copy of the JAX package's reader: built at
// first use by the host's C++ compiler (ops/_build.py build_host, with
// -O3 -fPIC -std=c++17 -shared) and bound with ctypes (data/ply.py).
//
// Reads format ascii 1.0 and binary_little_endian 1.0 files whose vertex
// element comes first and holds x, y and z among its scalar properties, of
// any PLY scalar type (integers with their sign, float, double). Anything
// else (binary_big_endian, a list property in the vertex element, another
// element first, a short file) returns a null pointer, and the caller reads
// the file with the numpy reader, which raises where it cannot read it.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Kind { kI8, kU8, kI16, kU16, kI32, kU32, kF32, kF64, kBad };

Kind prop_kind(const std::string &t) {
  if (t == "char" || t == "int8") return kI8;
  if (t == "uchar" || t == "uint8") return kU8;
  if (t == "short" || t == "int16") return kI16;
  if (t == "ushort" || t == "uint16") return kU16;
  if (t == "int" || t == "int32") return kI32;
  if (t == "uint" || t == "uint32") return kU32;
  if (t == "float" || t == "float32") return kF32;
  if (t == "double" || t == "float64") return kF64;
  return kBad;
}

int kind_size(Kind k) {
  switch (k) {
    case kI8: case kU8: return 1;
    case kI16: case kU16: return 2;
    case kI32: case kU32: case kF32: return 4;
    case kF64: return 8;
    default: return -1;
  }
}

// One little-endian value as float: the value's own type, then rounded once
// to float (as numpy's astype(float32) does).
float read_le(const unsigned char *p, Kind k) {
  switch (k) {
    case kI8: { int8_t v; std::memcpy(&v, p, 1); return (float)v; }
    case kU8: { uint8_t v; std::memcpy(&v, p, 1); return (float)v; }
    case kI16: { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
    case kU16: { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
    case kI32: { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
    case kU32: { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
    case kF32: { float v; std::memcpy(&v, p, 4); return v; }
    case kF64: { double v; std::memcpy(&v, p, 8); return (float)v; }
    default: return 0.0f;
  }
}

}  // namespace

extern "C" {

// A malloc'd row-major (n, 3) float array of the vertices, n in *out_n; a
// null pointer where the file is not one this reader takes.
float *ply_read_vertices(const char *path, long *out_n) {
  *out_n = 0;
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;

  char line[4096];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3) != 0) {
    std::fclose(f);
    return nullptr;
  }

  bool binary = false, ascii = false, vertex_first = false, any_element = false;
  bool ended = false;
  long n_vertices = 0;
  std::vector<Kind> kinds;
  std::vector<std::string> names;
  std::string element;

  while (std::fgets(line, sizeof line, f)) {
    char a[128] = {0}, b[128] = {0}, c[128] = {0};
    long num = 0;
    if (std::sscanf(line, "%127s", a) != 1) continue;
    if (std::strcmp(a, "format") == 0) {
      std::sscanf(line, "%*s %127s", b);
      if (std::strcmp(b, "binary_little_endian") == 0) binary = true;
      else if (std::strcmp(b, "ascii") == 0) ascii = true;
      else { std::fclose(f); return nullptr; }
    } else if (std::strcmp(a, "element") == 0) {
      if (std::sscanf(line, "%*s %127s %ld", b, &num) != 2) { std::fclose(f); return nullptr; }
      element = b;
      if (element == "vertex") {
        n_vertices = num;
        vertex_first = !any_element;
      }
      any_element = true;
    } else if (std::strcmp(a, "property") == 0 && element == "vertex") {
      if (std::sscanf(line, "%*s %127s %127s", b, c) != 2) { std::fclose(f); return nullptr; }
      Kind k = prop_kind(b);
      if (k == kBad) { std::fclose(f); return nullptr; }  // a list, or an unknown type
      kinds.push_back(k);
      names.push_back(c);
    } else if (std::strcmp(a, "end_header") == 0) {
      ended = true;
      break;
    }
  }

  int xi = -1, yi = -1, zi = -1;
  for (size_t i = 0; i < names.size(); ++i) {
    if (names[i] == "x") xi = (int)i;
    else if (names[i] == "y") yi = (int)i;
    else if (names[i] == "z") zi = (int)i;
  }
  if (!ended || !vertex_first || n_vertices <= 0 || xi < 0 || yi < 0 || zi < 0 ||
      (!binary && !ascii)) {
    std::fclose(f);
    return nullptr;
  }

  float *out = (float *)std::malloc(sizeof(float) * 3 * (size_t)n_vertices);
  if (!out) { std::fclose(f); return nullptr; }

  if (ascii) {
    // each value parsed as a double, then rounded once to float
    std::vector<double> vals(names.size());
    for (long i = 0; i < n_vertices; ++i) {
      for (size_t j = 0; j < names.size(); ++j) {
        if (std::fscanf(f, "%lf", &vals[j]) != 1) {
          std::free(out); std::fclose(f); return nullptr;
        }
      }
      out[3 * i + 0] = (float)vals[xi];
      out[3 * i + 1] = (float)vals[yi];
      out[3 * i + 2] = (float)vals[zi];
    }
  } else {
    size_t row_size = 0;
    std::vector<size_t> offsets(kinds.size());
    for (size_t j = 0; j < kinds.size(); ++j) {
      offsets[j] = row_size;
      row_size += (size_t)kind_size(kinds[j]);
    }
    std::vector<unsigned char> rows(row_size * (size_t)n_vertices);
    if (std::fread(rows.data(), 1, rows.size(), f) != rows.size()) {
      std::free(out); std::fclose(f); return nullptr;
    }
    for (long i = 0; i < n_vertices; ++i) {
      const unsigned char *row = rows.data() + (size_t)i * row_size;
      out[3 * i + 0] = read_le(row + offsets[xi], kinds[xi]);
      out[3 * i + 1] = read_le(row + offsets[yi], kinds[yi]);
      out[3 * i + 2] = read_le(row + offsets[zi], kinds[zi]);
    }
  }

  std::fclose(f);
  *out_n = n_vertices;
  return out;
}

void ply_free(float *ptr) { std::free(ptr); }

}  // extern "C"
