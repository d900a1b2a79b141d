// Native .crtscene parser — the counterpart of the reference's vendored
// rapidjson DOM walk (CRTSceneParser.cpp:407-427 over rapidjson/).
//
// A compact recursive-descent JSON parser with a specialized fast path for
// large numeric arrays (the bulk of a .crtscene file is vertices/triangles
// floats), exposed through a plain C ABI consumed via ctypes
// (crtscene_native.py).  Also provides the parse-time vertex-normal
// accumulation the reference runs in CRTMesh::calculateVertexNormals
// (CRTMesh.cpp:66-94): per-face normals summed onto vertices, then
// normalized.
//
// Build: g++ -O2 -shared -fPIC parser.cpp -o libcrtscene.so   (native/build.py)

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Value;
using ValuePtr = std::unique_ptr<Value>;

struct Value {
  enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ, NUMARR } kind = NUL;
  double num = 0.0;
  bool boolean = false;
  std::string str;
  std::vector<ValuePtr> arr;
  std::vector<std::pair<std::string, ValuePtr>> obj;
  std::vector<double> numarr;  // fast path: array of plain numbers

  const Value* get(const char* key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return kv.second.get();
    return nullptr;
  }
};

struct Parser {
  const char* p;
  const char* end;
  std::string err;

  explicit Parser(const char* data, size_t n) : p(data), end(data + n) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool fail(const char* msg) {
    if (err.empty()) {
      char buf[96];
      snprintf(buf, sizeof buf, "%s at offset %zd", msg, (size_t)(p - end));
      err = buf;
    }
    return false;
  }

  // Reads the 4 hex digits after "\u"; leaves p on the last digit (the
  // caller's ++p consumes it, mirroring the single-char escape cases).
  bool parseHex4(unsigned* cp) {
    if (end - p <= 4) return fail("truncated \\u escape");
    unsigned v = 0;
    for (int i = 1; i <= 4; ++i) {
      char c = p[i];
      unsigned d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return fail("bad \\u escape");
      v = (v << 4) | d;
    }
    p += 4;
    *cp = v;
    return true;
  }

  static void appendUtf8(std::string* out, unsigned cp) {
    if (cp < 0x80) {
      out->push_back((char)cp);
    } else if (cp < 0x800) {
      out->push_back((char)(0xC0 | (cp >> 6)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out->push_back((char)(0xE0 | (cp >> 12)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      out->push_back((char)(0xF0 | (cp >> 18)));
      out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    }
  }

  bool parseString(std::string* out) {
    if (*p != '"') return fail("expected string");
    ++p;
    out->clear();
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': out->push_back('\n'); break;
          case 't': out->push_back('\t'); break;
          case 'r': out->push_back('\r'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'u': {  // \uXXXX (+ surrogate pairs) -> UTF-8, matching
            // Python json.loads on non-ASCII texture/material names
            unsigned cp = 0;
            if (!parseHex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 7 &&
                p[1] == '\\' && p[2] == 'u') {
              unsigned lo = 0;
              const char* save = p;
              p += 2;
              if (!parseHex4(&lo)) return false;
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                p = save;  // unpaired high surrogate: emit replacement
                cp = 0xFFFD;
              }
            } else if (cp >= 0xD800 && cp <= 0xDFFF) {
              cp = 0xFFFD;  // lone surrogate
            }
            appendUtf8(out, cp);
            break;
          }
          default: out->push_back(*p);
        }
        ++p;
      } else {
        out->push_back(*p++);
      }
    }
    if (p >= end) return fail("unterminated string");
    ++p;
    return true;
  }

  bool parseNumber(double* out) {
    char* q = nullptr;
    *out = strtod(p, &q);
    if (q == p) return fail("bad number");
    p = q;
    return true;
  }

  bool parseValue(Value* v) {
    ws();
    if (p >= end) return fail("unexpected end");
    switch (*p) {
      case '{': {
        v->kind = Value::OBJ;
        ++p;
        ws();
        if (p < end && *p == '}') { ++p; return true; }
        while (true) {
          ws();
          std::string key;
          if (!parseString(&key)) return false;
          ws();
          if (p >= end || *p != ':') return fail("expected ':'");
          ++p;
          auto child = std::make_unique<Value>();
          if (!parseValue(child.get())) return false;
          v->obj.emplace_back(std::move(key), std::move(child));
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == '}') { ++p; return true; }
          return fail("expected ',' or '}'");
        }
      }
      case '[': {
        ++p;
        ws();
        if (p < end && *p == ']') { ++p; v->kind = Value::ARR; return true; }
        // Fast path: array of plain numbers (the hot case — vertex floats).
        if (p < end && (*p == '-' || (*p >= '0' && *p <= '9'))) {
          v->kind = Value::NUMARR;
          v->numarr.reserve(64);
          while (true) {
            double d;
            if (!parseNumber(&d)) return false;
            v->numarr.push_back(d);
            ws();
            if (p < end && *p == ',') { ++p; ws(); continue; }
            if (p < end && *p == ']') { ++p; return true; }
            return fail("expected ',' or ']'");
          }
        }
        v->kind = Value::ARR;
        while (true) {
          auto child = std::make_unique<Value>();
          if (!parseValue(child.get())) return false;
          v->arr.push_back(std::move(child));
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == ']') { ++p; return true; }
          return fail("expected ',' or ']'");
        }
      }
      case '"':
        v->kind = Value::STR;
        return parseString(&v->str);
      case 't':
        if (end - p >= 4 && !memcmp(p, "true", 4)) {
          v->kind = Value::BOOL; v->boolean = true; p += 4; return true;
        }
        return fail("bad literal");
      case 'f':
        if (end - p >= 5 && !memcmp(p, "false", 5)) {
          v->kind = Value::BOOL; v->boolean = false; p += 5; return true;
        }
        return fail("bad literal");
      case 'n':
        if (end - p >= 4 && !memcmp(p, "null", 4)) { v->kind = Value::NUL; p += 4; return true; }
        return fail("bad literal");
      default: {
        v->kind = Value::NUM;
        return parseNumber(&v->num);
      }
    }
  }
};

struct Doc {
  Value root;
};

const std::vector<double>* numArr(const Value* v) {
  if (!v) return nullptr;
  if (v->kind == Value::NUMARR) return &v->numarr;
  return nullptr;
}

double numOr(const Value* v, double dflt) {
  return (v && v->kind == Value::NUM) ? v->num : dflt;
}

}  // namespace

extern "C" {

void* crt_parse(const char* path, char* errbuf, int errlen) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data(n, '\0');
  if (fread(&data[0], 1, n, f) != (size_t)n) {
    fclose(f);
    snprintf(errbuf, errlen, "short read on %s", path);
    return nullptr;
  }
  fclose(f);

  auto doc = std::make_unique<Doc>();
  Parser ps(data.data(), data.size());
  if (!ps.parseValue(&doc->root)) {
    snprintf(errbuf, errlen, "%s", ps.err.c_str());
    return nullptr;
  }
  return doc.release();
}

void crt_free(void* h) { delete static_cast<Doc*>(h); }

// settings { background_color[3], image_settings { width, height } }
void crt_settings(void* h, float* bg, int* width, int* height) {
  const Value& root = static_cast<Doc*>(h)->root;
  bg[0] = bg[1] = bg[2] = 0.0f;
  *width = 1920; *height = 1080;
  const Value* s = root.get("settings");
  if (!s) return;
  if (auto* b = numArr(s->get("background_color")); b && b->size() >= 3)
    for (int i = 0; i < 3; ++i) bg[i] = (float)(*b)[i];
  if (const Value* im = s->get("image_settings")) {
    *width = (int)numOr(im->get("width"), 1920);
    *height = (int)numOr(im->get("height"), 1080);
  }
}

// camera { matrix[9] row-major, position[3] } -> has_camera
int crt_camera(void* h, float* matrix9, float* position3) {
  const Value& root = static_cast<Doc*>(h)->root;
  const Value* c = root.get("camera");
  if (!c) return 0;
  if (auto* m = numArr(c->get("matrix")); m && m->size() >= 9)
    for (int i = 0; i < 9; ++i) matrix9[i] = (float)(*m)[i];
  if (auto* p = numArr(c->get("position")); p && p->size() >= 3)
    for (int i = 0; i < 3; ++i) position3[i] = (float)(*p)[i];
  return 1;
}

int crt_num_lights(void* h) {
  const Value* l = static_cast<Doc*>(h)->root.get("lights");
  return (l && l->kind == Value::ARR) ? (int)l->arr.size() : 0;
}

void crt_lights(void* h, float* pos3xN, float* intensityN) {
  const Value* l = static_cast<Doc*>(h)->root.get("lights");
  if (!l || l->kind != Value::ARR) return;
  for (size_t i = 0; i < l->arr.size(); ++i) {
    const Value* e = l->arr[i].get();
    intensityN[i] = (float)numOr(e->get("intensity"), 0.0);
    if (auto* p = numArr(e->get("position")); p && p->size() >= 3)
      for (int k = 0; k < 3; ++k) pos3xN[3 * i + k] = (float)(*p)[k];
  }
}

int crt_num_materials(void* h) {
  const Value* m = static_cast<Doc*>(h)->root.get("materials");
  return (m && m->kind == Value::ARR) ? (int)m->arr.size() : 0;
}

// type string copied out; albedo may be a texture name (string albedo,
// CRTSceneParser.cpp:380-384) -> returned in texname with has_tex=1.
void crt_material(void* h, int i, char* type, int typecap, float* albedo3,
                  int* smooth, float* ior, char* texname, int texcap,
                  int* has_tex, float* spec2) {
  const Value* m = static_cast<Doc*>(h)->root.get("materials");
  const Value* e = m->arr[i].get();
  const Value* t = e->get("type");
  snprintf(type, typecap, "%s", (t && t->kind == Value::STR) ? t->str.c_str() : "");
  albedo3[0] = albedo3[1] = albedo3[2] = 0.0f;
  *has_tex = 0;
  texname[0] = '\0';
  if (const Value* a = e->get("albedo")) {
    if (auto* arr = numArr(a); arr && arr->size() >= 3) {
      for (int k = 0; k < 3; ++k) albedo3[k] = (float)(*arr)[k];
    } else if (a->kind == Value::STR) {
      snprintf(texname, texcap, "%s", a->str.c_str());
      *has_tex = 1;
    }
  }
  const Value* s = e->get("smooth_shading");
  *smooth = (s && s->kind == Value::BOOL && s->boolean) ? 1 : 0;
  *ior = (float)numOr(e->get("ior"), 1.0);
  // Blinn-Phong extension keys (mirrors io/crtscene.py).
  spec2[0] = (float)numOr(e->get("specular"), 0.0);
  spec2[1] = (float)numOr(e->get("shininess"), 32.0);
}

int crt_num_textures(void* h) {
  const Value* t = static_cast<Doc*>(h)->root.get("textures");
  return (t && t->kind == Value::ARR) ? (int)t->arr.size() : 0;
}

void crt_texture(void* h, int i, char* name, int namecap, char* type,
                 int typecap, float* albedo3, float* colorA3, float* colorB3,
                 float* edge3, float* scalars2, char* filepath, int pathcap) {
  const Value* t = static_cast<Doc*>(h)->root.get("textures");
  const Value* e = t->arr[i].get();
  auto cpstr = [&](const char* key, char* out, int cap) {
    const Value* v = e->get(key);
    snprintf(out, cap, "%s", (v && v->kind == Value::STR) ? v->str.c_str() : "");
  };
  cpstr("name", name, namecap);
  cpstr("type", type, typecap);
  cpstr("file_path", filepath, pathcap);
  auto cpvec = [&](const char* key, float* out) {
    out[0] = out[1] = out[2] = 0.0f;
    if (auto* a = numArr(e->get(key)); a && a->size() >= 3)
      for (int k = 0; k < 3; ++k) out[k] = (float)(*a)[k];
  };
  cpvec("albedo", albedo3);
  cpvec("color_A", colorA3);
  cpvec("color_B", colorB3);
  // edges textures: edge_color -> edge3[0:3], inner_color -> colorB3 when
  // color_B absent (the two texture families share the B slot downstream)
  cpvec("edge_color", edge3);
  if (e->get("inner_color")) cpvec("inner_color", colorB3);
  scalars2[0] = (float)numOr(e->get("square_size"), 1.0);
  scalars2[1] = (float)numOr(e->get("edge_width"), 1.0);
}

int crt_num_objects(void* h) {
  const Value* o = static_cast<Doc*>(h)->root.get("objects");
  return (o && o->kind == Value::ARR) ? (int)o->arr.size() : 0;
}

void crt_object_counts(void* h, int i, int* n_vert_floats, int* n_tri_ints,
                       int* n_uv_floats, int* material_index) {
  const Value* o = static_cast<Doc*>(h)->root.get("objects");
  const Value* e = o->arr[i].get();
  auto len = [&](const char* key) {
    auto* a = numArr(e->get(key));
    return a ? (int)a->size() : 0;
  };
  *n_vert_floats = len("vertices");
  *n_tri_ints = len("triangles");
  *n_uv_floats = len("uvs");
  *material_index = (int)numOr(e->get("material_index"), 0.0);
}

void crt_object_data(void* h, int i, float* verts, int* tris, float* uvs) {
  const Value* o = static_cast<Doc*>(h)->root.get("objects");
  const Value* e = o->arr[i].get();
  if (auto* a = numArr(e->get("vertices")))
    for (size_t k = 0; k < a->size(); ++k) verts[k] = (float)(*a)[k];
  if (auto* a = numArr(e->get("triangles")))
    for (size_t k = 0; k < a->size(); ++k) tris[k] = (int)(*a)[k];
  if (auto* a = numArr(e->get("uvs")))
    for (size_t k = 0; k < a->size(); ++k) uvs[k] = (float)(*a)[k];
}

// Area-weighted-by-accumulation vertex normals (CRTMesh.cpp:66-94): sum of
// adjacent (unnormalized-sum of unit) face normals, then normalize.
void crt_vertex_normals(const float* verts, int n_verts, const int* tris,
                        int n_tris, float* out) {
  memset(out, 0, sizeof(float) * 3 * n_verts);
  for (int t = 0; t < n_tris; ++t) {
    const int i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
    const float* a = verts + 3 * i0;
    const float* b = verts + 3 * i1;
    const float* c = verts + 3 * i2;
    const float e0[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    const float e1[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float n[3] = {e0[1] * e1[2] - e0[2] * e1[1],
                  e0[2] * e1[0] - e0[0] * e1[2],
                  e0[0] * e1[1] - e0[1] * e1[0]};
    const float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-20f) {
      n[0] /= len; n[1] /= len; n[2] /= len;
    }
    for (int k = 0; k < 3; ++k) {
      out[3 * i0 + k] += n[k];
      out[3 * i1 + k] += n[k];
      out[3 * i2 + k] += n[k];
    }
  }
  for (int v = 0; v < n_verts; ++v) {
    float* n = out + 3 * v;
    const float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 1e-20f) {
      n[0] /= len; n[1] /= len; n[2] /= len;
    }
  }
}

}  // extern "C"
