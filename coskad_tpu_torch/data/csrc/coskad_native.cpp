// _coskad_torch_native: C++ data-plane accelerators for coskad_tpu_torch.
//
// The reference's dataset startup is dominated by parsing per-clip
// AlphaPose JSONs in Python (utils/dataset.py:144-148, SURVEY.md hot loop
// #1). This CPython extension parses the constrained schema
//   { person_id: { frame_key: { "keypoints": [x, y, c, ...], ... }, ... }
//   | person_id: [ {frame_key: {...}}, ... ] }
// with a single-pass recursive-descent parser, returning per-person flat
// keypoint buffers. Ordering/merging semantics stay in the Python shim
// (coskad_tpu_torch/data/native.py) so they remain byte-identical to the
// pure Python path.
//
// Build (the shim does this at first use, into build/coskad_tpu_torch/):
//   g++ -O3 -shared -fPIC -std=c++17 -I<python-include> coskad_native.cpp \
//       -o _coskad_torch_native<ext-suffix>

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Parser {
  const char* p;
  const char* begin;
  const char* end;

  explicit Parser(const char* data, size_t len)
      : p(data), begin(data), end(data + len) {}

  [[noreturn]] void fail(const char* msg) {
    throw std::runtime_error(std::string(msg) + " at offset " +
                             std::to_string(static_cast<size_t>(p - begin)));
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  char peek() {
    skip_ws();
    if (p >= end) fail("unexpected end of input");
    return *p;
  }

  void expect(char c) {
    if (peek() != c) fail("unexpected character");
    ++p;
  }

  std::string parse_string() {
    expect('"');
    std::string out;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        ++p;
        if (p >= end) fail("bad escape");
        switch (*p) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'n': out.push_back('\n'); break;
          case 'r': out.push_back('\r'); break;
          case 't': out.push_back('\t'); break;
          case 'u': {
            // frame keys / person ids are ASCII digits; decode BMP only
            if (end - p < 5) fail("bad \\u escape");
            unsigned code = 0;
            for (int i = 1; i <= 4; ++i) {
              char c = p[i];
              code <<= 4;
              if (c >= '0' && c <= '9') code |= c - '0';
              else if (c >= 'a' && c <= 'f') code |= c - 'a' + 10;
              else if (c >= 'A' && c <= 'F') code |= c - 'A' + 10;
              else fail("bad \\u escape");
            }
            // UTF-8 encode
            if (code < 0x80) out.push_back(static_cast<char>(code));
            else if (code < 0x800) {
              out.push_back(static_cast<char>(0xC0 | (code >> 6)));
              out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            } else {
              out.push_back(static_cast<char>(0xE0 | (code >> 12)));
              out.push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
              out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            }
            p += 4;
            break;
          }
          default: fail("unsupported escape");
        }
        ++p;
      } else {
        out.push_back(*p++);
      }
    }
    if (p >= end) fail("unterminated string");
    ++p;  // closing quote
    return out;
  }

  double parse_number() {
    skip_ws();
    char* num_end = nullptr;
    double v = std::strtod(p, &num_end);
    if (num_end == p) fail("bad number");
    p = num_end;
    return v;
  }

  // Skip any JSON value (used for fields we don't need).
  void skip_value() {
    char c = peek();
    if (c == '"') {
      parse_string();
    } else if (c == '{') {
      ++p;
      if (peek() == '}') { ++p; return; }
      while (true) {
        parse_string();
        expect(':');
        skip_value();
        char d = peek();
        if (d == ',') { ++p; continue; }
        expect('}');
        break;
      }
    } else if (c == '[') {
      ++p;
      if (peek() == ']') { ++p; return; }
      while (true) {
        skip_value();
        char d = peek();
        if (d == ',') { ++p; continue; }
        expect(']');
        break;
      }
    } else if (c == 't') {
      if (end - p < 4 || std::strncmp(p, "true", 4)) fail("bad literal");
      p += 4;
    } else if (c == 'f') {
      if (end - p < 5 || std::strncmp(p, "false", 5)) fail("bad literal");
      p += 5;
    } else if (c == 'n') {
      if (end - p < 4 || std::strncmp(p, "null", 4)) fail("bad literal");
      p += 4;
    } else {
      parse_number();
    }
  }

  // Parse a numbers-only array into out; returns count.
  size_t parse_number_array(std::vector<double>& out) {
    expect('[');
    size_t n = 0;
    if (peek() == ']') { ++p; return 0; }
    while (true) {
      out.push_back(parse_number());
      ++n;
      char d = peek();
      if (d == ',') { ++p; continue; }
      expect(']');
      break;
    }
    return n;
  }
};

struct Frame {
  std::string key;
  size_t offset;  // into the person's flat keypoint buffer
  size_t count;
};

struct Person {
  std::string id;
  std::vector<Frame> frames;
  std::vector<double> kps;  // concatenated keypoints
};

// frame object: { "keypoints": [...], <other fields skipped> }
void parse_frame_object(Parser& ps, Person& person, const std::string& frame_key) {
  Frame fr;
  fr.key = frame_key;
  fr.offset = person.kps.size();
  fr.count = 0;
  ps.expect('{');
  if (ps.peek() == '}') { ++ps.p; person.frames.push_back(fr); return; }
  while (true) {
    std::string key = ps.parse_string();
    ps.expect(':');
    if (key == "keypoints") {
      fr.count = ps.parse_number_array(person.kps);
    } else {
      ps.skip_value();
    }
    char d = ps.peek();
    if (d == ',') { ++ps.p; continue; }
    ps.expect('}');
    break;
  }
  person.frames.push_back(fr);
}

// person value: {frame: obj, ...} or [ {frame: obj, ...}, ... ]
void parse_person_value(Parser& ps, Person& person) {
  char c = ps.peek();
  if (c == '[') {
    ++ps.p;
    if (ps.peek() == ']') { ++ps.p; return; }
    while (true) {
      parse_person_value(ps, person);
      char d = ps.peek();
      if (d == ',') { ++ps.p; continue; }
      ps.expect(']');
      break;
    }
    return;
  }
  ps.expect('{');
  if (ps.peek() == '}') { ++ps.p; return; }
  while (true) {
    std::string frame_key = ps.parse_string();
    ps.expect(':');
    parse_frame_object(ps, person, frame_key);
    char d = ps.peek();
    if (d == ',') { ++ps.p; continue; }
    ps.expect('}');
    break;
  }
}

}  // namespace

// parse_clip(data: bytes) ->
//   list[(person_id: str, frame_keys: list[str], kp_buffer: bytes,
//         offsets: bytes /* uint64 */, counts: bytes /* uint64 */)]
static PyObject* parse_clip(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "y#", &data, &len)) return nullptr;

  std::vector<Person> persons;
  std::string error;
  // NOTE: exceptions must not cross Py_BEGIN/END_ALLOW_THREADS (they would
  // skip the GIL reacquisition and crash on PyErr_SetString) — catch inside.
  Py_BEGIN_ALLOW_THREADS;
  try {
    Parser ps(data, static_cast<size_t>(len));
    ps.expect('{');
    if (ps.peek() == '}') {
      ++ps.p;
    } else {
      while (true) {
        Person person;
        person.id = ps.parse_string();
        ps.expect(':');
        parse_person_value(ps, person);
        persons.push_back(std::move(person));
        char d = ps.peek();
        if (d == ',') { ++ps.p; continue; }
        ps.expect('}');
        break;
      }
    }
  } catch (const std::exception& e) {
    error = e.what();
  }
  Py_END_ALLOW_THREADS;
  if (!error.empty()) {
    PyErr_SetString(PyExc_ValueError, error.c_str());
    return nullptr;
  }

  PyObject* out = PyList_New(static_cast<Py_ssize_t>(persons.size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < persons.size(); ++i) {
    const Person& person = persons[i];
    PyObject* keys = PyList_New(static_cast<Py_ssize_t>(person.frames.size()));
    std::vector<uint64_t> offsets(person.frames.size());
    std::vector<uint64_t> counts(person.frames.size());
    for (size_t j = 0; j < person.frames.size(); ++j) {
      PyList_SET_ITEM(keys, static_cast<Py_ssize_t>(j),
                      PyUnicode_FromStringAndSize(person.frames[j].key.data(),
                                                  static_cast<Py_ssize_t>(person.frames[j].key.size())));
      offsets[j] = person.frames[j].offset;
      counts[j] = person.frames[j].count;
    }
    PyObject* kp_bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(person.kps.data()),
        static_cast<Py_ssize_t>(person.kps.size() * sizeof(double)));
    PyObject* off_bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(offsets.data()),
        static_cast<Py_ssize_t>(offsets.size() * sizeof(uint64_t)));
    PyObject* cnt_bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(counts.data()),
        static_cast<Py_ssize_t>(counts.size() * sizeof(uint64_t)));
    PyObject* tup = Py_BuildValue(
        "s#NNNN", person.id.data(), static_cast<Py_ssize_t>(person.id.size()),
        keys, kp_bytes, off_bytes, cnt_bytes);
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), tup);
  }
  return out;
}

namespace {

// Shared CSV core: comma-separated floats, one trajectory row per line (the
// Morais CSV format: frame, x1, y1, ..., x17, y17). Blank lines skipped;
// ragged rows throw.
void parse_csv_buffer(const char* data, size_t len, std::vector<double>& values,
                      size_t& n_rows, size_t& n_cols) {
  const char* p = data;
  const char* end = data + len;
  n_rows = n_cols = 0;
  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    size_t cols = 0;
    while (true) {
      char* num_end = nullptr;
      double v = std::strtod(p, &num_end);
      if (num_end == p) throw std::runtime_error("bad number in CSV");
      values.push_back(v);
      ++cols;
      p = num_end;
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p < end && *p == ',') { ++p; continue; }
      break;
    }
    while (p < end && *p != '\n') ++p;  // consume to EOL
    if (n_cols == 0) n_cols = cols;
    else if (cols != n_cols) throw std::runtime_error("ragged CSV row");
    ++n_rows;
  }
}

}  // namespace

// parse_csv(data: bytes) -> (n_rows: int, n_cols: int, values: bytes /* f64 */)
static PyObject* parse_csv(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "y#", &data, &len)) return nullptr;

  std::vector<double> values;
  size_t n_rows = 0, n_cols = 0;
  std::string error;
  Py_BEGIN_ALLOW_THREADS;
  try {
    parse_csv_buffer(data, static_cast<size_t>(len), values, n_rows, n_cols);
  } catch (const std::exception& e) {
    error = e.what();
  }
  Py_END_ALLOW_THREADS;
  if (!error.empty()) {
    PyErr_SetString(PyExc_ValueError, error.c_str());
    return nullptr;
  }
  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(values.data()),
      static_cast<Py_ssize_t>(values.size() * sizeof(double)));
  return Py_BuildValue("nnN", static_cast<Py_ssize_t>(n_rows),
                       static_cast<Py_ssize_t>(n_cols), buf);
}

// parse_csv_files(paths: list[str], n_threads: int) ->
//   list[(n_rows: int, n_cols: int, values: bytes /* f64 */)]
//
// Reads and parses many Morais trajectory CSVs with IO + parse off the GIL
// on a small thread pool (the reference walks thousands of per-person CSVs
// serially in Python, utils/data.py load_trajectories; SURVEY.md flags the
// walk as the robust-pipeline startup cost). Enumeration order is the
// caller's: results are positionally aligned with `paths`, so the Python
// shim's os.listdir ordering semantics are untouched.
static PyObject* parse_csv_files(PyObject*, PyObject* args) {
  PyObject* path_list;
  Py_ssize_t n_threads = 0;
  if (!PyArg_ParseTuple(args, "O!|n", &PyList_Type, &path_list, &n_threads))
    return nullptr;
  const Py_ssize_t n = PyList_GET_SIZE(path_list);
  std::vector<std::string> paths(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(path_list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) return nullptr;
    paths[static_cast<size_t>(i)] = s;
  }
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<Py_ssize_t>(hw) : 1;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;

  struct FileResult {
    std::vector<double> values;
    size_t n_rows = 0, n_cols = 0;
    std::string error;
  };
  std::vector<FileResult> results(paths.size());

  Py_BEGIN_ALLOW_THREADS;
  {
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (size_t i = next.fetch_add(1); i < paths.size();
           i = next.fetch_add(1)) {
        FileResult& r = results[i];
        try {
          std::FILE* f = std::fopen(paths[i].c_str(), "rb");
          if (!f) throw std::runtime_error("cannot open " + paths[i]);
          std::fseek(f, 0, SEEK_END);
          long sz = std::ftell(f);
          std::fseek(f, 0, SEEK_SET);
          std::string buf(static_cast<size_t>(sz > 0 ? sz : 0), '\0');
          if (sz > 0 && std::fread(&buf[0], 1, buf.size(), f) != buf.size()) {
            std::fclose(f);
            throw std::runtime_error("short read on " + paths[i]);
          }
          std::fclose(f);
          parse_csv_buffer(buf.data(), buf.size(), r.values, r.n_rows,
                           r.n_cols);
        } catch (const std::exception& e) {
          r.error = std::string(e.what()) + " [" + paths[i] + "]";
        }
      }
    };
    std::vector<std::thread> pool;
    for (Py_ssize_t t = 1; t < n_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }
  Py_END_ALLOW_THREADS;

  for (const FileResult& r : results) {
    if (!r.error.empty()) {
      PyErr_SetString(PyExc_ValueError, r.error.c_str());
      return nullptr;
    }
  }
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    const FileResult& r = results[static_cast<size_t>(i)];
    PyObject* buf = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(r.values.data()),
        static_cast<Py_ssize_t>(r.values.size() * sizeof(double)));
    PyObject* tup = Py_BuildValue("nnN", static_cast<Py_ssize_t>(r.n_rows),
                                  static_cast<Py_ssize_t>(r.n_cols), buf);
    if (!tup) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, i, tup);
  }
  return out;
}

static PyMethodDef methods[] = {
    {"parse_clip", parse_clip, METH_VARARGS,
     "Parse an AlphaPose tracked-person clip JSON into per-person buffers."},
    {"parse_csv", parse_csv, METH_VARARGS,
     "Parse a comma-separated float matrix (Morais trajectory CSV)."},
    {"parse_csv_files", parse_csv_files, METH_VARARGS,
     "Read + parse many trajectory CSVs on a thread pool (GIL released)."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_coskad_torch_native",
    "C++ data-plane accelerators for coskad_tpu_torch", -1, methods,
};

PyMODINIT_FUNC PyInit__coskad_torch_native(void) { return PyModule_Create(&moduledef); }
