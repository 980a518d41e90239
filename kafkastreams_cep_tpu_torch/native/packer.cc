// Native micro-batch packer: Python Event lists -> [T, K] columns.
//
// A copy of the JAX package's native/packer.cc. The Python packer
// (parallel/batched.py `_pack_python` over ops/schema.py) walks every
// (event, field) pair in the interpreter; this CPython extension does the
// same walk in one C call per micro-batch: field extraction (scalar / dict
// entry / attribute), string tokenization against the schema vocabulary,
// topic ids, timestamp rebasing, validity flags, global event-id
// assignment and the host event-registry update.
//
// Built at first use by native/__init__.py with g++ (plain CPython C API).
// The Python packer is the semantic reference the tests hold this to.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Resolve a field from an event value: name == "" -> the value itself,
// dict -> item, otherwise attribute.
PyObject* field_of(PyObject* value, PyObject* name, bool scalar) {
  if (scalar) {
    Py_INCREF(value);
    return value;
  }
  if (PyDict_CheckExact(value)) {
    PyObject* item = PyDict_GetItemWithError(value, name);  // borrowed
    if (item == nullptr) {
      if (!PyErr_Occurred()) {
        PyErr_Format(PyExc_KeyError, "event value missing field %R", name);
      }
      return nullptr;
    }
    Py_INCREF(item);
    return item;
  }
  if (PyDict_Check(value)) {
    // dict subclass: honor an overridden __getitem__, as the Python
    // packer's value[name] does.
    return PyObject_GetItem(value, name);
  }
  return PyObject_GetAttr(value, name);
}

// vocab[value] (interning new codes into vocab + rev list), as
// EventSchema.token().
long token_of(PyObject* vocab, PyObject* rev, PyObject* value) {
  PyObject* code = PyDict_GetItemWithError(vocab, value);  // borrowed
  if (code != nullptr) {
    return PyLong_AsLong(code);
  }
  if (PyErr_Occurred()) return -1;
  // Append to rev FIRST: if the dict insert then fails we can roll the
  // list back, so vocab and rev_vocab can never diverge (a divergence
  // would make later decodes of the interned code return the wrong value).
  Py_ssize_t next = PyList_GET_SIZE(rev);
  if (PyList_Append(rev, value) < 0) return -1;
  PyObject* next_obj = PyLong_FromSsize_t(next);
  if (next_obj == nullptr || PyDict_SetItem(vocab, value, next_obj) < 0) {
    Py_XDECREF(next_obj);
    // Roll the rev append back with the original error parked: DelItem
    // must not run with an exception pending, and a rollback failure must
    // not clear the original error (callers treat -1 + no-exception as a
    // legitimate token).
    PyObject *etype, *evalue, *etrace;
    PyErr_Fetch(&etype, &evalue, &etrace);
    if (PySequence_DelItem(rev, next) < 0) PyErr_Clear();
    PyErr_Restore(etype, evalue, etrace);
    return -1;
  }
  Py_DECREF(next_obj);
  return static_cast<long>(next);
}

struct Col {
  Py_buffer buf{};
  bool is_float = false;
  bool held = false;

  ~Col() {
    if (held) PyBuffer_Release(&buf);
  }
};

bool get_2d(PyObject* obj, Py_ssize_t T, Py_ssize_t K, int itemsize, Col* col) {
  if (PyObject_GetBuffer(obj, &col->buf, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) <
      0) {
    return false;
  }
  col->held = true;
  if (col->buf.ndim != 2 || col->buf.shape[0] != T || col->buf.shape[1] != K ||
      col->buf.itemsize != itemsize) {
    PyErr_SetString(PyExc_ValueError, "column buffer shape/itemsize mismatch");
    return false;
  }
  return true;
}

// pack_batch(events_by_lane, field_names, field_is_float, vocab, rev,
//            topic_vocab, ts_base, f_cols, ts_col, topic_col, valid, gidx,
//            next_gidx, registry) -> new next_gidx
PyObject* pack_batch(PyObject*, PyObject* args) {
  PyObject *lanes, *field_names, *field_is_float, *vocab, *rev, *topic_vocab;
  long long ts_base;
  PyObject *f_cols, *ts_obj, *topic_obj, *valid_obj, *gidx_obj, *registry;
  long long next_gidx;
  if (!PyArg_ParseTuple(args, "OOOOOOLOOOOOLO", &lanes, &field_names,
                        &field_is_float, &vocab, &rev, &topic_vocab, &ts_base,
                        &f_cols, &ts_obj, &topic_obj, &valid_obj, &gidx_obj,
                        &next_gidx, &registry)) {
    return nullptr;
  }
  if (!PyList_Check(lanes) || !PyTuple_Check(field_names) ||
      !PyTuple_Check(field_is_float) || !PyTuple_Check(f_cols)) {
    PyErr_SetString(PyExc_TypeError,
                    "lanes must be a list; field specs and f_cols tuples");
    return nullptr;
  }
  Py_ssize_t K = PyList_GET_SIZE(lanes);
  Py_ssize_t F = PyTuple_GET_SIZE(field_names);
  if (PyTuple_GET_SIZE(field_is_float) != F || PyTuple_GET_SIZE(f_cols) != F) {
    PyErr_SetString(PyExc_ValueError, "field spec arity mismatch");
    return nullptr;
  }

  // T from the ts column's buffer.
  Col ts_col;
  if (PyObject_GetBuffer(ts_obj, &ts_col.buf,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) < 0) {
    return nullptr;
  }
  ts_col.held = true;
  if (ts_col.buf.ndim != 2 || ts_col.buf.itemsize != 4) {
    PyErr_SetString(PyExc_ValueError, "ts column must be int32 [T, K]");
    return nullptr;
  }
  Py_ssize_t T = ts_col.buf.shape[0];
  if (ts_col.buf.shape[1] != K) {
    PyErr_SetString(PyExc_ValueError, "ts column K mismatch");
    return nullptr;
  }

  Col topic_col, valid_col, gidx_col;
  if (!get_2d(topic_obj, T, K, 4, &topic_col)) return nullptr;
  if (!get_2d(valid_obj, T, K, 1, &valid_col)) return nullptr;
  if (!get_2d(gidx_obj, T, K, 4, &gidx_col)) return nullptr;

  std::vector<Col> cols(F);
  for (Py_ssize_t f = 0; f < F; ++f) {
    cols[f].is_float =
        PyObject_IsTrue(PyTuple_GET_ITEM(field_is_float, f)) == 1;
    if (!get_2d(PyTuple_GET_ITEM(f_cols, f), T, K, 4, &cols[f])) {
      return nullptr;
    }
  }

  PyObject* s_value = PyUnicode_InternFromString("value");
  PyObject* s_timestamp = PyUnicode_InternFromString("timestamp");
  PyObject* s_topic = PyUnicode_InternFromString("topic");
  if (!s_value || !s_timestamp || !s_topic) return nullptr;

  auto* ts_data = static_cast<int32_t*>(ts_col.buf.buf);
  auto* topic_data = static_cast<int32_t*>(topic_col.buf.buf);
  auto* valid_data = static_cast<uint8_t*>(valid_col.buf.buf);
  auto* gidx_data = static_cast<int32_t*>(gidx_col.buf.buf);

  long long g = next_gidx;
  bool fail = false;
  for (Py_ssize_t k = 0; k < K && !fail; ++k) {
    PyObject* evs = PyList_GET_ITEM(lanes, k);  // borrowed
    Py_ssize_t n = PySequence_Size(evs);
    if (n < 0) {
      fail = true;
      break;
    }
    for (Py_ssize_t t = 0; t < n && !fail; ++t) {
      PyObject* ev = PySequence_GetItem(evs, t);  // new ref
      if (ev == nullptr) {
        fail = true;
        break;
      }
      PyObject* value = PyObject_GetAttr(ev, s_value);
      PyObject* ts = PyObject_GetAttr(ev, s_timestamp);
      PyObject* topic = PyObject_GetAttr(ev, s_topic);
      if (!value || !ts || !topic) {
        fail = true;
      }
      const Py_ssize_t at = t * K + k;
      if (!fail) {
        long long ts_v = PyLong_AsLongLong(ts);
        if (ts_v == -1 && PyErr_Occurred()) {
          // schema.pack coerces via int(t): accept float (and other
          // __index__/__int__-bearing) timestamps identically.
          PyErr_Clear();
          PyObject* ts_int = PyNumber_Long(ts);
          if (ts_int == nullptr) {
            fail = true;
          } else {
            ts_v = PyLong_AsLongLong(ts_int);
            Py_DECREF(ts_int);
            if (ts_v == -1 && PyErr_Occurred()) fail = true;
          }
        }
        if (!fail) {
          ts_data[at] = static_cast<int32_t>(ts_v - ts_base);
        }
      }
      if (!fail) {
        // topic id: dict-backed counter identical to EventSchema.topic_id.
        PyObject* code = PyDict_GetItemWithError(topic_vocab, topic);
        if (code == nullptr && PyErr_Occurred()) {
          fail = true;
        } else if (code == nullptr) {
          Py_ssize_t next = PyDict_GET_SIZE(topic_vocab);
          PyObject* next_obj = PyLong_FromSsize_t(next);
          if (next_obj == nullptr ||
              PyDict_SetItem(topic_vocab, topic, next_obj) < 0) {
            Py_XDECREF(next_obj);
            fail = true;
          } else {
            topic_data[at] = static_cast<int32_t>(next);
            Py_DECREF(next_obj);
          }
        } else {
          topic_data[at] = static_cast<int32_t>(PyLong_AsLong(code));
        }
      }
      for (Py_ssize_t f = 0; f < F && !fail; ++f) {
        PyObject* name = PyTuple_GET_ITEM(field_names, f);
        bool scalar = PyUnicode_GetLength(name) == 0;
        PyObject* raw = field_of(value, name, scalar);
        if (raw == nullptr) {
          fail = true;
          break;
        }
        if (PyUnicode_Check(raw)) {
          long code = token_of(vocab, rev, raw);
          if (code < 0 && PyErr_Occurred()) {
            fail = true;
          } else if (cols[f].is_float) {
            static_cast<float*>(cols[f].buf.buf)[at] =
                static_cast<float>(code);
          } else {
            static_cast<int32_t*>(cols[f].buf.buf)[at] =
                static_cast<int32_t>(code);
          }
        } else if (cols[f].is_float) {
          double v = PyFloat_AsDouble(raw);
          if (v == -1.0 && PyErr_Occurred()) {
            fail = true;
          } else {
            static_cast<float*>(cols[f].buf.buf)[at] = static_cast<float>(v);
          }
        } else {
          long long v = PyLong_AsLongLong(raw);
          if (v == -1 && PyErr_Occurred()) {
            PyErr_Clear();
            double d = PyFloat_AsDouble(raw);
            if (d == -1.0 && PyErr_Occurred()) {
              fail = true;
            } else {
              static_cast<int32_t*>(cols[f].buf.buf)[at] =
                  static_cast<int32_t>(d);
            }
          } else {
            static_cast<int32_t*>(cols[f].buf.buf)[at] =
                static_cast<int32_t>(v);
          }
        }
        Py_DECREF(raw);
      }
      if (!fail) {
        valid_data[at] = 1;
        gidx_data[at] = static_cast<int32_t>(g);
        PyObject* g_obj = PyLong_FromLongLong(g);
        if (g_obj == nullptr || PyDict_SetItem(registry, g_obj, ev) < 0) {
          Py_XDECREF(g_obj);
          fail = true;
        } else {
          Py_DECREF(g_obj);
          ++g;
        }
      }
      Py_XDECREF(value);
      Py_XDECREF(ts);
      Py_XDECREF(topic);
      Py_DECREF(ev);
    }
  }

  Py_DECREF(s_value);
  Py_DECREF(s_timestamp);
  Py_DECREF(s_topic);
  if (fail) return nullptr;
  return PyLong_FromLongLong(g);
}

PyMethodDef methods[] = {
    {"pack_batch", pack_batch, METH_VARARGS,
     "Pack per-lane Event lists into [T, K] columns; returns next gidx."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_packer",
    "Native micro-batch packer (see packer.cc).", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__packer() { return PyModule_Create(&module); }
