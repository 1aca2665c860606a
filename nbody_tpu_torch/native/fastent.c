/* fastent — native host-side monitor kernels.
 *
 * The reference's host-side "systems" code is pure Python + zlib
 * (reference: reality_glitch_tests.py:273-298, universe_2d.py:689-702);
 * at 100k+ particles those per-tick host probes (entropy estimates,
 * float-class censuses) become the realtime engine's bottleneck. This
 * C extension provides the two hot host kernels:
 *
 *   byte_entropy(buffer) -> (shannon_bits_per_byte, distinct_bytes)
 *       single-pass byte-histogram Shannon entropy: an O(n) stand-in for
 *       the zlib compressibility proxy (zlib is O(n) with a ~20x larger
 *       constant and allocates the compressed copy).
 *
 *   float_census(buffer) -> (nan, inf, subnormal, zero, min_nonzero_abs)
 *       single-pass IEEE-754 class census over a float32 buffer —
 *       the host-side twin of diagnostics.glitch.count_subnormals for
 *       streamed snapshots that are already on the host.
 *
 * Built with the host C compiler at first use (see native/__init__.py); every
 * caller has a pure-Python fallback, so the extension is an accelerator,
 * never a dependency.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

static PyObject *
fastent_byte_entropy(PyObject *self, PyObject *args)
{
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view))
        return NULL;

    uint64_t hist[256];
    memset(hist, 0, sizeof(hist));

    const uint8_t *p = (const uint8_t *)view.buf;
    Py_ssize_t n = view.len;
    for (Py_ssize_t i = 0; i < n; i++)
        hist[p[i]]++;

    double entropy = 0.0;
    long distinct = 0;
    if (n > 0) {
        const double inv_n = 1.0 / (double)n;
        for (int b = 0; b < 256; b++) {
            if (hist[b]) {
                distinct++;
                double q = (double)hist[b] * inv_n;
                entropy -= q * log2(q);
            }
        }
    }
    PyBuffer_Release(&view);
    return Py_BuildValue("(dl)", entropy, distinct);
}

static PyObject *
fastent_float_census(PyObject *self, PyObject *args)
{
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view))
        return NULL;
    if (view.len % 4 != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError,
                        "buffer length must be a multiple of 4 (float32)");
        return NULL;
    }

    const uint32_t *p = (const uint32_t *)view.buf;
    Py_ssize_t n = view.len / 4;
    uint64_t n_nan = 0, n_inf = 0, n_sub = 0, n_zero = 0;
    uint32_t min_mag = 0x7F7FFFFFu; /* FLT_MAX bits */
    int seen_nonzero = 0;

    for (Py_ssize_t i = 0; i < n; i++) {
        uint32_t bits = p[i];
        uint32_t mag = bits & 0x7FFFFFFFu;
        uint32_t expo = mag >> 23;
        if (mag == 0) {
            n_zero++;
        } else if (expo == 0xFF) {
            if (mag == 0x7F800000u) n_inf++;
            else n_nan++;
        } else {
            if (expo == 0) n_sub++;
            if (!seen_nonzero || mag < min_mag) {
                min_mag = mag;
                seen_nonzero = 1;
            }
        }
    }
    PyBuffer_Release(&view);

    double min_nonzero = 0.0;
    if (seen_nonzero) {
        float f;
        memcpy(&f, &min_mag, 4);
        min_nonzero = (double)f;
    }
    return Py_BuildValue("(KKKKd)", (unsigned long long)n_nan,
                         (unsigned long long)n_inf,
                         (unsigned long long)n_sub,
                         (unsigned long long)n_zero, min_nonzero);
}

static PyMethodDef FastentMethods[] = {
    {"byte_entropy", fastent_byte_entropy, METH_VARARGS,
     "Shannon entropy (bits/byte) + distinct byte count of a buffer."},
    {"float_census", fastent_float_census, METH_VARARGS,
     "IEEE-754 class census (nan, inf, subnormal, zero, min_nonzero) of "
     "a float32 buffer."},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef fastentmodule = {
    PyModuleDef_HEAD_INIT, "_fastent",
    "Native host-side monitor kernels for nbody_tpu_torch.", -1, FastentMethods
};

PyMODINIT_FUNC
PyInit__fastent(void)
{
    return PyModule_Create(&fastentmodule);
}
