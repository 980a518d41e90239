// Native match decoder: a drain's pulled tables -> matches.
//
// A copy of the JAX package's native/decoder.cc. Both drains of the
// engine feed it. The flat drain walks every pending match chain on the
// device into a dense [match, hop] table (ops/engine.py
// build_chain_flatten), so the C side is a flat loop over rows with no
// pointer chasing: `decode_matches_flat` builds Staged/Sequence objects,
// `decode_matches_json` JSON sink bytes plus emission-identity frames and
// `decode_matches_arrow` Arrow string-column buffers. The pool drain
// (drain_mode="pool", ops/engine.py drain_compact) pulls the ring and the
// pend-reachable node planes instead, and `decode_matches` walks each
// chain back through them here. One C call per drain does the walk, the
// stage grouping, the normalization check and the construction.
//
// Semantics are exactly ops/runtime.py decode_chains + materialize_sequence
// (the Python walks in parallel/batched.py are the semantic reference):
//   * a chain's hops are newest-first; a hop whose event id is negative
//     (a GC-dropped put under region overflow) is skipped while the rest
//     of the chain survives; an all-dead chain decodes to nothing;
//   * grouping is by stage NAME (ids are keyed by (name, type): a
//     begin-position one_or_more's BEGIN and NORMAL stages share one name
//     and must land in one group), first-occurrence order;
//   * a group already normalized under the Event contract (one
//     (topic, partition), strictly increasing offsets) skips Staged's
//     sorted(set(...)) -- the decode hot path; others go through the
//     Python constructor.
//
// Built at first use by native/__init__.py with g++ (plain CPython C API).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace {

struct Buf {
  Py_buffer buf{};
  bool held = false;

  ~Buf() {
    if (held) PyBuffer_Release(&buf);
  }
};

// Strided 2D int32 view: the pool drain pulls device arrays [N, K] and
// hands their [K, N] transposes here, so contiguity must not be required.
struct View2D {
  const char* data = nullptr;
  Py_ssize_t s0 = 0, s1 = 0;

  int32_t at(Py_ssize_t i, Py_ssize_t j) const {
    return *reinterpret_cast<const int32_t*>(data + i * s0 + j * s1);
  }
};

bool get_i32_2d(PyObject* obj, const char* what, Buf* b, View2D* v,
                Py_ssize_t* d0, Py_ssize_t* d1) {
  if (PyObject_GetBuffer(obj, &b->buf, PyBUF_STRIDES) < 0) return false;
  b->held = true;
  if (b->buf.ndim != 2 || b->buf.itemsize != 4) {
    PyErr_Format(PyExc_ValueError, "%s must be int32 [K, N]", what);
    return false;
  }
  if (*d0 < 0) *d0 = b->buf.shape[0];
  if (*d1 < 0) *d1 = b->buf.shape[1];
  if (b->buf.shape[0] != *d0 || b->buf.shape[1] != *d1) {
    PyErr_Format(PyExc_ValueError, "%s shape mismatch", what);
    return false;
  }
  v->data = static_cast<const char*>(b->buf.buf);
  v->s0 = b->buf.strides[0];
  v->s1 = b->buf.strides[1];
  return true;
}

// Strided 3D int32 view: the flat drain pulls one [3, M, C, K] table and
// hands per-plane [K, M, C] transposes here (numpy moveaxis views), so
// contiguity must not be required.
struct View3D {
  const char* data = nullptr;
  Py_ssize_t s0 = 0, s1 = 0, s2 = 0;

  int32_t at(Py_ssize_t i, Py_ssize_t j, Py_ssize_t c) const {
    return *reinterpret_cast<const int32_t*>(data + i * s0 + j * s1 +
                                             c * s2);
  }
};

bool get_i32_3d(PyObject* obj, const char* what, Buf* b, View3D* v,
                Py_ssize_t* d0, Py_ssize_t* d1, Py_ssize_t* d2) {
  if (PyObject_GetBuffer(obj, &b->buf, PyBUF_STRIDES) < 0) return false;
  b->held = true;
  if (b->buf.ndim != 3 || b->buf.itemsize != 4) {
    PyErr_Format(PyExc_ValueError, "%s must be int32 [K, M, C]", what);
    return false;
  }
  Py_ssize_t* dims[3] = {d0, d1, d2};
  for (int i = 0; i < 3; ++i) {
    if (*dims[i] < 0) *dims[i] = b->buf.shape[i];
    if (b->buf.shape[i] != *dims[i]) {
      PyErr_Format(PyExc_ValueError, "%s shape mismatch", what);
      return false;
    }
  }
  v->data = static_cast<const char*>(b->buf.buf);
  v->s0 = b->buf.strides[0];
  v->s1 = b->buf.strides[1];
  v->s2 = b->buf.strides[2];
  return true;
}

// A Staged/Sequence instance without running Python-level __init__
// (the C analog of cls.__new__(cls)).
PyObject* bare_instance(PyObject* type) {
  PyTypeObject* tp = reinterpret_cast<PyTypeObject*>(type);
  PyObject* empty = PyTuple_New(0);
  if (empty == nullptr) return nullptr;
  PyObject* obj = tp->tp_new(tp, empty, nullptr);
  Py_DECREF(empty);
  return obj;
}

// ---------------------------------------------------------------- sink bytes
// Helpers for the sink-to-bytes decode (decode_matches_json /
// decode_matches_arrow): emit the exact bytes the host-Python egress path
// would produce -- streams/serde.py sequence_to_json for payloads,
// streams/emission.py sequence_identity's per-stage frames for digests --
// so goldens and emission digests stay byte-identical to the object path.

// Append one JSON string token, escaped exactly as
// json.dumps(..., ensure_ascii=True) does (quote, backslash, the five
// short escapes, \u00xx for other control chars, \uXXXX for everything
// past 0x7e with surrogate pairs beyond the BMP).
bool json_escape(PyObject* u, std::string& out) {
  if (!PyUnicode_Check(u)) {
    PyErr_SetString(PyExc_TypeError, "expected str");
    return false;
  }
#if PY_VERSION_HEX < 0x030C0000
  if (PyUnicode_READY(u) < 0) return false;
#endif
  const int kind = PyUnicode_KIND(u);
  const void* data = PyUnicode_DATA(u);
  Py_ssize_t n = PyUnicode_GET_LENGTH(u);
  char tmp[16];
  out.push_back('"');
  for (Py_ssize_t i = 0; i < n; ++i) {
    Py_UCS4 ch = PyUnicode_READ(kind, data, i);
    switch (ch) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\t': out += "\\t"; break;
      case '\n': out += "\\n"; break;
      case '\f': out += "\\f"; break;
      case '\r': out += "\\r"; break;
      default:
        if (ch >= 0x20 && ch <= 0x7e) {
          out.push_back(static_cast<char>(ch));
        } else if (ch <= 0xffff) {
          snprintf(tmp, sizeof tmp, "\\u%04x", static_cast<unsigned>(ch));
          out += tmp;
        } else {
          Py_UCS4 v = ch - 0x10000;
          snprintf(tmp, sizeof tmp, "\\u%04x\\u%04x",
                   static_cast<unsigned>(0xd800 + (v >> 10)),
                   static_cast<unsigned>(0xdc00 + (v & 0x3ff)));
          out += tmp;
        }
    }
  }
  out.push_back('"');
  return true;
}

// Append the JSON encoding of one resolved event value. The fast paths
// (None/bool/int/float/str) mirror json.dumps(..., separators=(",", ":"))
// exactly -- json calls int.__repr__/float.__repr__, never the subclass's
// -- and anything else round-trips through `fragment_fn` (Python
// json.dumps with the same separators), so exotic values compose
// byte-identically into the surrounding document.
bool write_json_value(PyObject* v, PyObject* fragment_fn, std::string& out) {
  if (v == Py_None) {
    out += "null";
    return true;
  }
  if (v == Py_True) {
    out += "true";
    return true;
  }
  if (v == Py_False) {
    out += "false";
    return true;
  }
  if (PyUnicode_Check(v)) return json_escape(v, out);
  if (PyLong_Check(v) || PyFloat_Check(v)) {
    PyObject* r;
    if (PyLong_Check(v)) {
      r = PyLong_Type.tp_repr(v);
    } else {
      double d = PyFloat_AS_DOUBLE(v);
      if (std::isnan(d)) {
        out += "NaN";
        return true;
      }
      if (std::isinf(d)) {
        out += d > 0 ? "Infinity" : "-Infinity";
        return true;
      }
      r = PyFloat_Type.tp_repr(v);
    }
    if (r == nullptr) return false;
    Py_ssize_t sz;
    const char* s = PyUnicode_AsUTF8AndSize(r, &sz);
    if (s == nullptr) {
      Py_DECREF(r);
      return false;
    }
    out.append(s, sz);
    Py_DECREF(r);
    return true;
  }
  PyObject* frag = PyObject_CallFunctionObjArgs(fragment_fn, v, nullptr);
  if (frag == nullptr) return false;
  Py_ssize_t sz;
  const char* s =
      PyUnicode_Check(frag) ? PyUnicode_AsUTF8AndSize(frag, &sz) : nullptr;
  if (s == nullptr) {
    if (!PyErr_Occurred()) {
      PyErr_SetString(PyExc_TypeError, "fragment_fn must return str");
    }
    Py_DECREF(frag);
    return false;
  }
  out.append(s, sz);
  Py_DECREF(frag);
  return true;
}

// streams/emission.py sequence_identity framing: 4-byte LE length + data.
void put_frame(std::string& out, const char* data, size_t n) {
  uint32_t len = static_cast<uint32_t>(n);
  char hdr[4] = {static_cast<char>(len & 0xff),
                 static_cast<char>((len >> 8) & 0xff),
                 static_cast<char>((len >> 16) & 0xff),
                 static_cast<char>((len >> 24) & 0xff)};
  out.append(hdr, 4);
  out.append(data, n);
}

// struct.pack("<q", v)
void put_i64(std::string& out, long long v) {
  uint64_t u = static_cast<uint64_t>(v);
  char b[8];
  for (int i = 0; i < 8; ++i) b[i] = static_cast<char>((u >> (8 * i)) & 0xff);
  out.append(b, 8);
}

// streams/serde.py _event_value_repr: a dict with a "name" key serializes
// that entry; a value with a non-None `name` attribute serializes the
// attribute; anything else serializes as-is. Returns a NEW reference.
PyObject* resolve_value_repr(PyObject* value, PyObject* s_name) {
  if (PyDict_Check(value)) {
    PyObject* nm = PyDict_GetItemWithError(value, s_name);
    if (nm != nullptr) {
      Py_INCREF(nm);
      return nm;
    }
    if (PyErr_Occurred()) return nullptr;
  } else {
    PyObject* nm = PyObject_GetAttr(value, s_name);
    if (nm == nullptr) {
      if (!PyErr_ExceptionMatches(PyExc_AttributeError)) return nullptr;
      PyErr_Clear();
    } else if (nm != Py_None) {
      return nm;
    } else {
      Py_DECREF(nm);
    }
  }
  Py_INCREF(value);
  return value;
}

// Shared chain -> Sequence materialization. Both decode entry points feed
// NEWEST-FIRST (name_id << 32 | gidx) chains here (the walk order);
// assembly iterates them reversed, so groups build oldest-first exactly as
// ops/runtime.py materialize_sequence does.
struct Materializer {
  PyObject* name_of_id = nullptr;     // borrowed
  PyObject* registry = nullptr;       // borrowed
  PyObject* staged_type = nullptr;    // borrowed
  PyObject* sequence_type = nullptr;  // borrowed
  Py_ssize_t n_names = 0;
  std::vector<int32_t> canon;
  // Stacked-query attribution (ops/tables.py compile_multi_query): the
  // per-name-id query table, or null for a single query.
  const int32_t* qid_of_name = nullptr;
  Py_ssize_t n_qids = 0;
  PyObject* s_topic = nullptr;
  PyObject* s_partition = nullptr;
  PyObject* s_offset = nullptr;
  PyObject* s_stage = nullptr;
  PyObject* s_events_attr = nullptr;
  PyObject* s_matched = nullptr;
  PyObject* s_by_name = nullptr;
  PyObject* s_name = nullptr;
  PyObject* s_value = nullptr;

  struct Group {
    int32_t canon_id;
    PyObject* name;    // borrowed from name_of_id
    PyObject* events;  // owned list
  };
  std::vector<Group> groups;  // scratch reused across matches

  // `qid_b` is caller-owned so the qid buffer outlives this object.
  bool init(PyObject* name_of_id_, PyObject* registry_, PyObject* staged_,
            PyObject* sequence_, PyObject* qid_obj, Buf* qid_b) {
    if (!PyList_Check(name_of_id_) || !PyDict_Check(registry_) ||
        !PyType_Check(staged_) || !PyType_Check(sequence_)) {
      PyErr_SetString(PyExc_TypeError,
                      "name_of_id list, registry dict, Staged/Sequence types");
      return false;
    }
    name_of_id = name_of_id_;
    registry = registry_;
    staged_type = staged_;
    sequence_type = sequence_;

    if (qid_obj != Py_None) {
      if (PyObject_GetBuffer(qid_obj, &qid_b->buf, PyBUF_C_CONTIGUOUS) < 0) {
        return false;
      }
      qid_b->held = true;
      if (qid_b->buf.ndim != 1 || qid_b->buf.itemsize != 4) {
        PyErr_SetString(PyExc_ValueError, "qid_of_name_id must be int32 [N]");
        return false;
      }
      qid_of_name = static_cast<const int32_t*>(qid_b->buf.buf);
      n_qids = qid_b->buf.shape[0];
    }

    // name_id -> canonical group id: ids whose name strings compare equal
    // share a group (grouping is by NAME, not id).
    n_names = PyList_GET_SIZE(name_of_id);
    canon.assign(n_names, 0);
    for (Py_ssize_t i = 0; i < n_names; ++i) {
      canon[i] = static_cast<int32_t>(i);
      PyObject* ni = PyList_GET_ITEM(name_of_id, i);
      for (Py_ssize_t j = 0; j < i; ++j) {
        int eq =
            PyObject_RichCompareBool(ni, PyList_GET_ITEM(name_of_id, j), Py_EQ);
        if (eq < 0) return false;
        if (eq) {
          canon[i] = canon[j];
          break;
        }
      }
    }

    s_topic = PyUnicode_InternFromString("topic");
    s_partition = PyUnicode_InternFromString("partition");
    s_offset = PyUnicode_InternFromString("offset");
    s_stage = PyUnicode_InternFromString("stage");
    s_events_attr = PyUnicode_InternFromString("_events");
    s_matched = PyUnicode_InternFromString("matched");
    s_by_name = PyUnicode_InternFromString("_by_name");
    s_name = PyUnicode_InternFromString("name");
    s_value = PyUnicode_InternFromString("value");
    return s_topic && s_partition && s_offset && s_stage && s_events_attr &&
           s_matched && s_by_name && s_name && s_value;
  }

  void fini() {
    Py_XDECREF(s_topic);
    Py_XDECREF(s_partition);
    Py_XDECREF(s_offset);
    Py_XDECREF(s_stage);
    Py_XDECREF(s_events_attr);
    Py_XDECREF(s_matched);
    Py_XDECREF(s_by_name);
    Py_XDECREF(s_name);
    Py_XDECREF(s_value);
  }

  // Oldest-first group assembly, first-occurrence stage order. On failure
  // returns false with a Python error set and every group event list freed.
  bool collect(const std::vector<int64_t>& chain) {
    bool fail = false;
    groups.clear();
    for (size_t c = chain.size(); c-- > 0 && !fail;) {
      int32_t name_id = static_cast<int32_t>(chain[c] >> 32);
      int32_t gidx = static_cast<int32_t>(chain[c] & 0xffffffff);
      if (name_id < 0 || name_id >= n_names) {
        PyErr_Format(PyExc_ValueError, "bad stage name id %d", name_id);
        fail = true;
        break;
      }
      int32_t cid = canon[name_id];
      Group* grp = nullptr;
      for (auto& g2 : groups) {
        if (g2.canon_id == cid) {
          grp = &g2;
          break;
        }
      }
      if (grp == nullptr) {
        PyObject* lst = PyList_New(0);
        if (lst == nullptr) {
          fail = true;
          break;
        }
        groups.push_back(Group{cid, PyList_GET_ITEM(name_of_id, cid), lst});
        grp = &groups.back();
      }
      PyObject* g_obj = PyLong_FromLong(gidx);
      if (g_obj == nullptr) {
        fail = true;
        break;
      }
      PyObject* event = PyDict_GetItemWithError(registry, g_obj);  // borrowed
      Py_DECREF(g_obj);
      if (event == nullptr) {
        if (!PyErr_Occurred()) {
          PyErr_Format(PyExc_KeyError, "event registry missing gidx %d", gidx);
        }
        fail = true;
        break;
      }
      if (PyList_Append(grp->events, event) < 0) fail = true;
    }
    if (fail) {
      for (auto& g2 : groups) Py_XDECREF(g2.events);
      groups.clear();
      return false;
    }
    return true;
  }

  // Normalized exactly when all events share one (topic, partition) and
  // offsets strictly increase -- then Staged's sorted(set(...)) is the
  // identity and can be skipped. 1 yes, 0 no, -1 error (exception set).
  int group_normalized(PyObject* events) {
    Py_ssize_t ne = PyList_GET_SIZE(events);
    PyObject* topic0 = nullptr;
    long long part0 = 0, prev_off = 0;
    int result = 1;
    for (Py_ssize_t i2 = 0; i2 < ne && result == 1; ++i2) {
      PyObject* e = PyList_GET_ITEM(events, i2);
      PyObject* topic = PyObject_GetAttr(e, s_topic);
      PyObject* part = topic ? PyObject_GetAttr(e, s_partition) : nullptr;
      PyObject* off = part ? PyObject_GetAttr(e, s_offset) : nullptr;
      if (off == nullptr) {
        Py_XDECREF(topic);
        Py_XDECREF(part);
        result = -1;
        break;
      }
      long long part_v = PyLong_AsLongLong(part);
      long long off_v = PyLong_AsLongLong(off);
      if ((part_v == -1 || off_v == -1) && PyErr_Occurred()) {
        // Non-int partition/offset: fall back to the Python ctor.
        PyErr_Clear();
        result = 0;
      } else if (i2 == 0) {
        topic0 = topic;
        Py_INCREF(topic0);
        part0 = part_v;
        prev_off = off_v;
      } else {
        int teq = PyObject_RichCompareBool(topic, topic0, Py_EQ);
        if (teq < 0) {
          result = -1;
        } else if (!teq || part_v != part0 || off_v <= prev_off) {
          result = 0;
        }
        prev_off = off_v;
      }
      Py_DECREF(topic);
      Py_DECREF(part);
      Py_DECREF(off);
    }
    Py_XDECREF(topic0);
    return result;
  }

  // The group's event list in Staged order: a normalized group IS already
  // in Staged order (sorted(set(...)) is the identity), others round-trip
  // through the Python Staged ctor exactly like the object path does.
  // Returns a NEW reference to a list, or nullptr with an error set.
  PyObject* normalized_events(Group& grp) {
    int normalized = group_normalized(grp.events);
    if (normalized < 0) return nullptr;
    if (normalized == 1) {
      Py_INCREF(grp.events);
      return grp.events;
    }
    PyObject* staged = PyObject_CallFunctionObjArgs(staged_type, grp.name,
                                                    grp.events, nullptr);
    if (staged == nullptr) return nullptr;
    PyObject* evs = PyObject_GetAttr(staged, s_events_attr);
    Py_DECREF(staged);
    if (evs != nullptr && !PyList_Check(evs)) {
      PyErr_SetString(PyExc_TypeError, "Staged._events must be a list");
      Py_DECREF(evs);
      return nullptr;
    }
    return evs;
  }

  // Materialize one chain and append the Sequence to per_key. Returns
  // false with a Python error set.
  bool emit(const std::vector<int64_t>& chain, PyObject* per_key) {
    if (!collect(chain)) return false;
    bool fail = false;
    PyObject* matched = PyList_New(0);
    if (matched == nullptr) fail = true;
    for (auto& grp : groups) {
      if (fail) {
        Py_XDECREF(grp.events);
        continue;
      }
      int normalized = group_normalized(grp.events);
      if (normalized < 0) fail = true;

      PyObject* staged = nullptr;
      if (!fail && normalized == 1) {
        staged = bare_instance(staged_type);
        if (staged == nullptr || PyObject_SetAttr(staged, s_stage, grp.name) < 0 ||
            PyObject_SetAttr(staged, s_events_attr, grp.events) < 0) {
          fail = true;
        }
      } else if (!fail) {
        staged = PyObject_CallFunctionObjArgs(staged_type, grp.name, grp.events,
                                              nullptr);
        if (staged == nullptr) fail = true;
      }
      Py_DECREF(grp.events);
      if (!fail && PyList_Append(matched, staged) < 0) fail = true;
      Py_XDECREF(staged);
    }
    groups.clear();
    if (fail) {
      Py_XDECREF(matched);
      return false;
    }

    // Sequence.__init__ is matched + a stage->Staged dict; build both
    // here so no Python frame runs per match.
    PyObject* by_name = PyDict_New();
    PyObject* seq = by_name ? bare_instance(sequence_type) : nullptr;
    if (seq == nullptr) {
      Py_XDECREF(by_name);
      Py_DECREF(matched);
      return false;
    }
    Py_ssize_t n_groups = PyList_GET_SIZE(matched);
    for (Py_ssize_t i2 = 0; i2 < n_groups && !fail; ++i2) {
      PyObject* st = PyList_GET_ITEM(matched, i2);
      PyObject* nm = PyObject_GetAttr(st, s_stage);
      if (nm == nullptr || PyDict_SetItem(by_name, nm, st) < 0) fail = true;
      Py_XDECREF(nm);
    }
    if (!fail && (PyObject_SetAttr(seq, s_matched, matched) < 0 ||
                  PyObject_SetAttr(seq, s_by_name, by_name) < 0)) {
      fail = true;
    }
    Py_DECREF(by_name);
    Py_DECREF(matched);
    if (!fail && qid_of_name != nullptr) {
      // Stacked-query attribution: chains never span queries, so any
      // chain node's name id identifies the owner.
      int32_t nm0 = static_cast<int32_t>(chain[0] >> 32);
      long qid = (nm0 >= 0 && nm0 < n_qids) ? qid_of_name[nm0] : -1;
      PyObject* pair = Py_BuildValue("(lO)", qid, seq);
      if (pair == nullptr || PyList_Append(per_key, pair) < 0) fail = true;
      Py_XDECREF(pair);
    } else if (!fail && PyList_Append(per_key, seq) < 0) {
      fail = true;
    }
    Py_DECREF(seq);
    return !fail;
  }

  // Serialize one chain straight to sink bytes, skipping Staged/Sequence
  // construction entirely on the normalized fast path. Appends to per_key:
  //   json:  (payload, ident, last_event) with payload byte-equal to
  //          sequence_to_json(seq).encode("utf-8"),
  //   arrow: (stage_offsets, stage_data, value_offsets, value_data, rows,
  //          ident, last_event) -- int32 offset + utf8 data buffers for the
  //          stage/value string columns, wrapped by the caller
  //          (streams/serde.py arrow_ipc_from_columns).
  // `ident` is the per-stage identity frame suffix of
  // streams/emission.py sequence_identity (the digest parity pin);
  // `last_event` is matched[-1].events[-1], the Record metadata anchor.
  bool emit_bytes(const std::vector<int64_t>& chain, PyObject* per_key,
                  int arrow, PyObject* fragment_fn) {
    if (!collect(chain)) return false;
    bool fail = false;
    std::string payload, ident, stage_data, value_data;
    std::vector<int32_t> stage_off{0}, value_off{0};
    PyObject* last_event = nullptr;  // owned
    if (!arrow) payload += "{\"events\":[";
    bool first_group = true;
    for (auto& grp : groups) {
      if (fail) {
        Py_XDECREF(grp.events);
        continue;
      }
      PyObject* evs = normalized_events(grp);
      if (evs == nullptr) {
        Py_DECREF(grp.events);
        fail = true;
        continue;
      }
      Py_ssize_t stage_len = 0;
      const char* stage_s =
          PyUnicode_Check(grp.name)
              ? PyUnicode_AsUTF8AndSize(grp.name, &stage_len)
              : nullptr;
      if (stage_s == nullptr) {
        if (!PyErr_Occurred()) {
          PyErr_SetString(PyExc_TypeError, "stage name must be str");
        }
        Py_DECREF(evs);
        Py_DECREF(grp.events);
        fail = true;
        continue;
      }
      put_frame(ident, "\x01", 1);
      put_frame(ident, stage_s, stage_len);
      if (!arrow) {
        if (!first_group) payload += ",";
        payload += "{\"name\":";
        if (!json_escape(grp.name, payload)) fail = true;
        payload += ",\"events\":[";
      }
      first_group = false;
      Py_ssize_t ne = fail ? 0 : PyList_GET_SIZE(evs);
      for (Py_ssize_t i2 = 0; i2 < ne && !fail; ++i2) {
        PyObject* e = PyList_GET_ITEM(evs, i2);
        PyObject* topic = PyObject_GetAttr(e, s_topic);
        PyObject* part = topic ? PyObject_GetAttr(e, s_partition) : nullptr;
        PyObject* off = part ? PyObject_GetAttr(e, s_offset) : nullptr;
        Py_ssize_t t_len = 0;
        const char* t_s =
            off && PyUnicode_Check(topic)
                ? PyUnicode_AsUTF8AndSize(topic, &t_len)
                : nullptr;
        long long part_v = t_s ? PyLong_AsLongLong(part) : 0;
        long long off_v =
            t_s && !PyErr_Occurred() ? PyLong_AsLongLong(off) : 0;
        if (t_s == nullptr || PyErr_Occurred()) {
          if (!PyErr_Occurred()) {
            PyErr_SetString(PyExc_TypeError,
                            "event topic must be str and partition/offset "
                            "int for sink-bytes identity");
          }
          fail = true;
        } else {
          put_frame(ident, t_s, t_len);
          put_i64(ident, part_v);
          put_i64(ident, off_v);
        }
        Py_XDECREF(topic);
        Py_XDECREF(part);
        Py_XDECREF(off);
        if (fail) break;
        PyObject* val = PyObject_GetAttr(e, s_value);
        PyObject* rep = val ? resolve_value_repr(val, s_name) : nullptr;
        Py_XDECREF(val);
        if (rep == nullptr) {
          fail = true;
          break;
        }
        if (arrow) {
          stage_data.append(stage_s, stage_len);
          stage_off.push_back(static_cast<int32_t>(stage_data.size()));
          if (!write_json_value(rep, fragment_fn, value_data)) fail = true;
          value_off.push_back(static_cast<int32_t>(value_data.size()));
        } else {
          if (i2) payload += ",";
          if (!write_json_value(rep, fragment_fn, payload)) fail = true;
        }
        Py_DECREF(rep);
      }
      if (!arrow && !fail) payload += "]}";
      if (!fail && ne > 0) {
        Py_XDECREF(last_event);
        last_event = PyList_GET_ITEM(evs, ne - 1);
        Py_INCREF(last_event);
      }
      Py_DECREF(evs);
      Py_DECREF(grp.events);
    }
    groups.clear();
    if (!arrow && !fail) payload += "]}";
    if (!fail && last_event == nullptr) {
      PyErr_SetString(PyExc_RuntimeError, "empty match chain");
      fail = true;
    }
    if (fail) {
      Py_XDECREF(last_event);
      return false;
    }
    PyObject* tup;
    if (arrow) {
      Py_ssize_t rows = static_cast<Py_ssize_t>(stage_off.size()) - 1;
      tup = Py_BuildValue(
          "(y#y#y#y#ny#O)",
          reinterpret_cast<const char*>(stage_off.data()),
          static_cast<Py_ssize_t>(stage_off.size() * sizeof(int32_t)),
          stage_data.data(), static_cast<Py_ssize_t>(stage_data.size()),
          reinterpret_cast<const char*>(value_off.data()),
          static_cast<Py_ssize_t>(value_off.size() * sizeof(int32_t)),
          value_data.data(), static_cast<Py_ssize_t>(value_data.size()),
          rows, ident.data(), static_cast<Py_ssize_t>(ident.size()),
          last_event);
    } else {
      tup = Py_BuildValue(
          "(y#y#O)", payload.data(), static_cast<Py_ssize_t>(payload.size()),
          ident.data(), static_cast<Py_ssize_t>(ident.size()), last_event);
    }
    Py_DECREF(last_event);
    if (tup == nullptr) return false;
    if (PyList_Append(per_key, tup) < 0) {
      Py_DECREF(tup);
      return false;
    }
    Py_DECREF(tup);
    return true;
  }
};

// The flat drain table walk shared by the three flat entry points:
// gidx/name/live are [K, M, C] int32 planes (strided views of the
// [3, M, C, K] table), hops newest-first; live == 0 ends a chain, a live
// hop with gidx < 0 is a GC-dropped put (skipped while the chain
// continues). `fragment_fn` null: Sequence objects (or (qid, Sequence)
// pairs when `qid_obj` is a table); else sink tuples, Arrow column
// buffers when `arrow` is set and JSON payloads when not.
PyObject* decode_flat_impl(PyObject* counts_obj, PyObject* g_obj,
                           PyObject* n_obj, PyObject* l_obj,
                           PyObject* name_of_id, PyObject* registry,
                           PyObject* staged_type, PyObject* sequence_type,
                           PyObject* fragment_fn, int arrow,
                           PyObject* qid_obj) {
  Buf counts_b;
  if (PyObject_GetBuffer(counts_obj, &counts_b.buf, PyBUF_C_CONTIGUOUS) < 0) {
    return nullptr;
  }
  counts_b.held = true;
  if (counts_b.buf.ndim != 1 || counts_b.buf.itemsize != 4) {
    PyErr_SetString(PyExc_ValueError, "counts must be int32 [K]");
    return nullptr;
  }
  Py_ssize_t K = counts_b.buf.shape[0];
  Py_ssize_t M = -1, C = -1;
  Buf g_b, n_b, l_b;
  View3D gidx, name, live;
  if (!get_i32_3d(g_obj, "gidx", &g_b, &gidx, &K, &M, &C)) return nullptr;
  if (!get_i32_3d(n_obj, "name", &n_b, &name, &K, &M, &C)) return nullptr;
  if (!get_i32_3d(l_obj, "live", &l_b, &live, &K, &M, &C)) return nullptr;

  const auto* counts = static_cast<const int32_t*>(counts_b.buf.buf);

  Buf qid_b;
  Materializer mat;
  if (!mat.init(name_of_id, registry, staged_type, sequence_type, qid_obj,
                &qid_b)) {
    mat.fini();
    return nullptr;
  }

  PyObject* out = PyList_New(K);
  bool fail = out == nullptr;
  std::vector<int64_t> chain;

  for (Py_ssize_t k = 0; k < K && !fail; ++k) {
    PyObject* per_key = PyList_New(0);
    if (per_key == nullptr) {
      fail = true;
      break;
    }
    PyList_SET_ITEM(out, k, per_key);
    Py_ssize_t n = counts[k];
    if (n > M) n = M;
    for (Py_ssize_t j = 0; j < n && !fail; ++j) {
      chain.clear();
      for (Py_ssize_t c = 0; c < C; ++c) {
        if (!live.at(k, j, c)) break;  // chain ended
        int32_t g = gidx.at(k, j, c);
        if (g >= 0) {
          // Dropped puts (g < 0) skip the hop, not the chain.
          chain.push_back((static_cast<int64_t>(name.at(k, j, c)) << 32) |
                          static_cast<uint32_t>(g));
        }
      }
      if (chain.empty()) continue;  // GC-dropped (node_drops counts it)
      bool ok = fragment_fn == nullptr
                    ? mat.emit(chain, per_key)
                    : mat.emit_bytes(chain, per_key, arrow, fragment_fn);
      if (!ok) fail = true;
    }
  }

  mat.fini();
  if (fail) {
    Py_XDECREF(out);
    return nullptr;
  }
  return out;
}

// decode_matches_flat(counts, gidx, name, live, name_of_id, registry,
//                     staged_type, sequence_type[, qid_of_name_id])
//   -> [list[Sequence]] * K, or [list[(qid, Sequence)]] * K when the
//      optional per-name-id query-attribution table is given (a stacked
//      multi-query decode, ops/tables.py compile_multi_query).
PyObject* decode_matches_flat(PyObject*, PyObject* args) {
  PyObject *counts_obj, *g_obj, *n_obj, *l_obj;
  PyObject *name_of_id, *registry, *staged_type, *sequence_type;
  PyObject* qid_obj = Py_None;
  if (!PyArg_ParseTuple(args, "OOOOOOOO|O", &counts_obj, &g_obj, &n_obj,
                        &l_obj, &name_of_id, &registry, &staged_type,
                        &sequence_type, &qid_obj)) {
    return nullptr;
  }
  return decode_flat_impl(counts_obj, g_obj, n_obj, l_obj, name_of_id,
                          registry, staged_type, sequence_type, nullptr, 0,
                          qid_obj);
}

// decode_matches_json / decode_matches_arrow
//   (counts, gidx, name, live, name_of_id, registry, staged_type,
//    sequence_type, fragment_fn)
//   -> [list[(payload, ident, last_event)]] * K               (json)
//   -> [list[(stage_off, stage_data, value_off, value_data,
//             rows, ident, last_event)]] * K                  (arrow)
// The consumer is a serializing sink: matches decode straight to bytes
// with no Sequence materialization on the normalized fast path. A stacked
// multi-query engine (qid attribution) is not served here: the engine
// refuses bytes sinks for it.
PyObject* decode_bytes(PyObject* args, int arrow) {
  PyObject *counts_obj, *g_obj, *n_obj, *l_obj;
  PyObject *name_of_id, *registry, *staged_type, *sequence_type, *fragment_fn;
  if (!PyArg_ParseTuple(args, "OOOOOOOOO", &counts_obj, &g_obj, &n_obj, &l_obj,
                        &name_of_id, &registry, &staged_type, &sequence_type,
                        &fragment_fn)) {
    return nullptr;
  }
  return decode_flat_impl(counts_obj, g_obj, n_obj, l_obj, name_of_id,
                          registry, staged_type, sequence_type, fragment_fn,
                          arrow, Py_None);
}

PyObject* decode_matches_json(PyObject*, PyObject* args) {
  return decode_bytes(args, 0);
}

PyObject* decode_matches_arrow(PyObject*, PyObject* args) {
  return decode_bytes(args, 1);
}

// decode_matches(counts, pend, node_event, node_name, node_pred, name_of_id,
//                registry, staged_type, sequence_type[, qid_of_name_id])
//   -> [list[Sequence]] * K, or [list[(qid, Sequence)]] * K given the
//      per-name-id query-attribution table (a stacked multi-query decode).
// The pool drain's decode: pend is [K, M] (each key's ring, valid ids
// compacted to the front), the node planes [K, B] in closure-rank space
// (ops/engine.py drain_compact), all strided views. Each of a key's first
// counts[k] ring entries walks its chain newest -> oldest through the
// planes; a -1 entry (a chain a GC nulled under region overflow) and a
// chain whose every event id is negative decode to nothing.
PyObject* decode_matches(PyObject*, PyObject* args) {
  PyObject *counts_obj, *pend_obj, *ev_obj, *nm_obj, *pr_obj;
  PyObject *name_of_id, *registry, *staged_type, *sequence_type;
  PyObject* qid_obj = Py_None;
  if (!PyArg_ParseTuple(args, "OOOOOOOOO|O", &counts_obj, &pend_obj, &ev_obj,
                        &nm_obj, &pr_obj, &name_of_id, &registry, &staged_type,
                        &sequence_type, &qid_obj)) {
    return nullptr;
  }

  Buf counts_b;
  if (PyObject_GetBuffer(counts_obj, &counts_b.buf, PyBUF_C_CONTIGUOUS) < 0) {
    return nullptr;
  }
  counts_b.held = true;
  if (counts_b.buf.ndim != 1 || counts_b.buf.itemsize != 4) {
    PyErr_SetString(PyExc_ValueError, "counts must be int32 [K]");
    return nullptr;
  }
  Py_ssize_t K = counts_b.buf.shape[0];
  Py_ssize_t M = -1, B = -1;
  Buf pend_b, ev_b, nm_b, pr_b;
  View2D pend, node_event, node_name, node_pred;
  if (!get_i32_2d(pend_obj, "pend", &pend_b, &pend, &K, &M)) return nullptr;
  if (!get_i32_2d(ev_obj, "node_event", &ev_b, &node_event, &K, &B)) {
    return nullptr;
  }
  if (!get_i32_2d(nm_obj, "node_name", &nm_b, &node_name, &K, &B)) {
    return nullptr;
  }
  if (!get_i32_2d(pr_obj, "node_pred", &pr_b, &node_pred, &K, &B)) {
    return nullptr;
  }

  const auto* counts = static_cast<const int32_t*>(counts_b.buf.buf);

  Buf qid_b;
  Materializer mat;
  if (!mat.init(name_of_id, registry, staged_type, sequence_type, qid_obj,
                &qid_b)) {
    mat.fini();
    return nullptr;
  }

  PyObject* out = PyList_New(K);
  bool fail = out == nullptr;

  // Scratch reused across matches: the chain as (name_id, gidx) pairs
  // (newest-first as walked, consumed oldest-first by the materializer).
  std::vector<int64_t> chain;

  for (Py_ssize_t k = 0; k < K && !fail; ++k) {
    PyObject* per_key = PyList_New(0);
    if (per_key == nullptr) {
      fail = true;
      break;
    }
    PyList_SET_ITEM(out, k, per_key);
    Py_ssize_t n = counts[k];
    if (n > M) n = M;
    for (Py_ssize_t j = 0; j < n && !fail; ++j) {
      int32_t cur = pend.at(k, j);
      chain.clear();
      // Walk newest -> oldest; a cycle (corrupt pool) cannot loop past B.
      for (Py_ssize_t hops = 0; cur >= 0 && cur < B && hops <= B; ++hops) {
        int32_t g = node_event.at(k, cur);
        if (g >= 0) {
          // Dropped puts (g < 0) skip the node, not the chain.
          chain.push_back((static_cast<int64_t>(node_name.at(k, cur)) << 32) |
                          static_cast<uint32_t>(g));
        }
        cur = node_pred.at(k, cur);
      }
      if (chain.empty()) continue;  // GC-dropped (node_drops counts it)
      if (!mat.emit(chain, per_key)) fail = true;
    }
  }

  mat.fini();
  if (fail) {
    Py_XDECREF(out);
    return nullptr;
  }
  return out;
}

PyMethodDef methods[] = {
    {"decode_matches", decode_matches, METH_VARARGS,
     "Walk per-key match chains from a pool drain's pulled ring and node "
     "planes and build Sequence objects; returns a list of K lists (of "
     "(qid, Sequence) pairs given a qid_of_name_id table)."},
    {"decode_matches_flat", decode_matches_flat, METH_VARARGS,
     "Build Sequence objects from a chain-flattened drain table "
     "([K, M, C] gidx/name/live planes); returns a list of K lists "
     "(of (qid, Sequence) pairs given a qid_of_name_id table)."},
    {"decode_matches_json", decode_matches_json, METH_VARARGS,
     "Serialize matches from a chain-flattened drain table straight to "
     "JSON sink bytes; returns a list of K lists of "
     "(payload, ident, last_event) tuples."},
    {"decode_matches_arrow", decode_matches_arrow, METH_VARARGS,
     "Serialize matches from a chain-flattened drain table straight to "
     "Arrow string-column buffers; returns a list of K lists of "
     "(stage_off, stage_data, value_off, value_data, rows, ident, "
     "last_event) tuples."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_decoder",
    "Native match decoder (see decoder.cc).", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__decoder() { return PyModule_Create(&module); }
