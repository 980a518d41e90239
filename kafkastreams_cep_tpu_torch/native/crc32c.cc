// Native CRC-32C (Castagnoli): the checksum that seals checkpoint frames.
//
// The counterpart of the C-extension path of the JAX package's
// state/serde.py `crc32c` (google_crc32c's `extend`): same polynomial
// (reflected 0x82F63B78), init and xor-out, so a frame sealed by either
// package verifies in the other. On x86-64 it runs the SSE4.2 `crc32`
// instruction eight bytes at a time; elsewhere (or on a CPU without
// SSE4.2) a slicing-by-8 table walk in C. The Python slicing-by-8 in
// state/serde.py (`crc32c_python`) is the reference the tests hold this to.
//
// Built at first use by native/__init__.py with g++ (plain CPython C API).
// The GIL is released while the checksum runs.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t g_table[8][256];

void init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    g_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t prev = g_table[t - 1][i];
      g_table[t][i] = g_table[0][prev & 0xFF] ^ (prev >> 8);
    }
  }
}

// Raw (un-inverted) register update, slicing-by-8.
uint32_t crc_table(uint32_t crc, const unsigned char* p, size_t n) {
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = g_table[7][lo & 0xFF] ^ g_table[6][(lo >> 8) & 0xFF] ^
          g_table[5][(lo >> 16) & 0xFF] ^ g_table[4][lo >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_table[0][(crc ^ *p++) & 0xFF];
  return crc;
}

#if defined(__x86_64__)
bool g_hw = false;

// Raw register update with the SSE4.2 instruction (little-endian loads,
// the same reflected polynomial as the table).
__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t crc, const unsigned char* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}
#endif

uint32_t crc_update(uint32_t crc, const unsigned char* p, size_t n) {
#if defined(__x86_64__)
  if (g_hw) return crc_hw(crc, p, n);
#endif
  return crc_table(crc, p, n);
}

// extend(crc, data) -> crc32c of data continuing from crc (0 to start).
PyObject* extend(PyObject*, PyObject* args) {
  unsigned long long crc_in;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Ky*", &crc_in, &buf)) return nullptr;
  if (crc_in > 0xFFFFFFFFull) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "crc must fit in 32 bits");
    return nullptr;
  }
  uint32_t crc = static_cast<uint32_t>(crc_in) ^ 0xFFFFFFFFu;
  const unsigned char* p = static_cast<const unsigned char*>(buf.buf);
  size_t n = static_cast<size_t>(buf.len);
  if (n >= (1u << 16)) {
    Py_BEGIN_ALLOW_THREADS
    crc = crc_update(crc, p, n);
    Py_END_ALLOW_THREADS
  } else {
    crc = crc_update(crc, p, n);
  }
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(crc ^ 0xFFFFFFFFu);
}

PyObject* hardware(PyObject*, PyObject*) {
#if defined(__x86_64__)
  if (g_hw) Py_RETURN_TRUE;
#endif
  Py_RETURN_FALSE;
}

PyMethodDef methods[] = {
    {"extend", extend, METH_VARARGS,
     "extend(crc, data) -> CRC-32C of data continuing from crc."},
    {"hardware", hardware, METH_NOARGS,
     "True when the SSE4.2 crc32 instruction computes the checksum."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_crc32c",
    "Native CRC-32C (see crc32c.cc).", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__crc32c() {
  init_tables();
#if defined(__x86_64__)
  __builtin_cpu_init();
  g_hw = __builtin_cpu_supports("sse4.2");
#endif
  return PyModule_Create(&module);
}
