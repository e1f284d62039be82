// libonnxstream_tpu_torch — the 15-function C ABI (parity with reference
// src/exports.cpp:42-311) of onnxstream_tpu_torch, implemented by embedding
// CPython and forwarding to onnxstream_tpu_torch.api.capi; a copy of the JAX
// package's csrc/exports.cpp that imports the port's module instead. The
// runtime executes on the CUDA card (capi's device); this shim gives C/C#/
// foreign-language clients the same entry points the reference exports.
//
// Build: onnxstream_tpu_torch/runtime/native.py exports_library() (g++, the
// include and link flags from sysconfig). Requires libpython.
//
// Thread-safety: every call grabs the GIL (PyGILState_Ensure), so the ABI is
// callable from any thread, like the reference.

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#if defined(_WIN32)
#define OSTPU_EXPORT extern "C" __declspec(dllexport)
#else
#define OSTPU_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

std::once_flag g_init_once;
PyObject* g_capi = nullptr;  // onnxstream_tpu_torch.api.capi module

void ensure_python() {
    std::call_once(g_init_once, [] {
        bool we_initialized = false;
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            we_initialized = true;
        }
        PyGILState_STATE gil = PyGILState_Ensure();
        g_capi = PyImport_ImportModule("onnxstream_tpu_torch.api.capi");
        if (!g_capi) {
            PyErr_Print();
        }
        PyGILState_Release(gil);
        if (we_initialized) {
            // Py_InitializeEx leaves THIS thread holding the GIL; detach so
            // other threads' PyGILState_Ensure can acquire it — the ABI is
            // callable from any thread (finalizer threads, worker pools)
            PyEval_SaveThread();
        }
    });
}

char* dup_cstr(const std::string& s) {
    char* out = (char*)::malloc(s.size() + 1);
    std::memcpy(out, s.c_str(), s.size() + 1);
    return out;
}

// call capi.<fn>(args...) and return the result (new ref), or nullptr
PyObject* call(const char* fn, PyObject* args) {
    if (!g_capi) return nullptr;
    PyObject* f = PyObject_GetAttrString(g_capi, fn);
    if (!f) { PyErr_Print(); Py_XDECREF(args); return nullptr; }
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) PyErr_Print();
    return r;
}

struct ReturnLayout {  // identical to the reference's model_get_tensor layout
    size_t dims_num;
    size_t* dims;
    size_t data_num;
    float* data;
};

}  // namespace

typedef void ModelContext;  // opaque: the integer handle

OSTPU_EXPORT ModelContext* model_new() {
    ensure_python();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_new", PyTuple_New(0));
    long h = r ? PyLong_AsLong(r) : 0;
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return (ModelContext*)(intptr_t)h;
}

OSTPU_EXPORT ModelContext* model_new_2(int threads_count, char* wp_name) {
    ensure_python();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_new_2", Py_BuildValue("(is)", threads_count, wp_name ? wp_name : "dict"));
    long h = r ? PyLong_AsLong(r) : 0;
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return (ModelContext*)(intptr_t)h;
}

static void drop_pending(long h);
static void drop_tensors(long h);

OSTPU_EXPORT void model_delete(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    long h = (long)(intptr_t)obj;
    drop_pending(h);
    drop_tensors(h);
    Py_XDECREF(call("model_delete", Py_BuildValue("(l)", h)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT void model_read_string(ModelContext* obj, char* str) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(call("model_read_string", Py_BuildValue("(ls)", (long)(intptr_t)obj, str)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT char* model_read_file(ModelContext* obj, char* fn) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_read_file", Py_BuildValue("(ls)", (long)(intptr_t)obj, fn));
    char* err = nullptr;
    if (r && r != Py_None) err = dup_cstr(PyUnicode_AsUTF8(r));
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return err;
}

OSTPU_EXPORT char* model_get_weights_names(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_get_weights_names", Py_BuildValue("(l)", (long)(intptr_t)obj));
    char* out = r ? dup_cstr(PyUnicode_AsUTF8(r)) : nullptr;
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return out;
}

// Client allocates-and-fills: we return a malloc'd staging buffer; the bytes
// are handed to Python on the next model_run of THAT model (deferred copy
// like the reference's alloc-in-provider flow, which stages per-provider —
// src/exports.cpp:150-167). Entries are keyed by model handle so concurrent
// models never receive each other's weights, and staging buffers are freed
// once Python has copied them.
struct PendingWeight {
    long handle;
    std::string type, name;
    void* buf;
    unsigned size;
};
static std::vector<PendingWeight>* g_pending = nullptr;

OSTPU_EXPORT void* model_add_weights_file(ModelContext* obj, char* type, char* name, unsigned int size) {
    void* buf = ::malloc(size);
    PyGILState_STATE gil = PyGILState_Ensure();
    if (!g_pending) g_pending = new std::vector<PendingWeight>();
    g_pending->push_back({(long)(intptr_t)obj, type ? type : "float32", name ? name : "", buf, size});
    PyGILState_Release(gil);
    return buf;
}

static void flush_pending(long h) {
    if (!g_pending) return;
    // snapshot THIS handle's entries first, atomically under the GIL: the
    // call() below re-enters the interpreter, which can hand the GIL to
    // another thread that push_backs into g_pending and reallocates the
    // vector mid-iteration
    std::vector<PendingWeight> mine, keep;
    for (auto& p : *g_pending) (p.handle == h ? mine : keep).push_back(p);
    g_pending->swap(keep);
    for (auto& p : mine) {
        PyObject* mem = PyMemoryView_FromMemory((char*)p.buf, p.size, PyBUF_READ);
        Py_XDECREF(call("model_add_weights_file",
                        Py_BuildValue("(lssN)", h, p.type.c_str(), p.name.c_str(), mem)));
        ::free(p.buf);  // capi copied the bytes (np.frombuffer(...).copy())
    }
}

static void drop_pending(long h) {  // model_delete without delivery
    if (!g_pending) return;
    std::vector<PendingWeight> keep;
    for (auto& p : *g_pending) {
        if (p.handle != h) keep.push_back(p);
        else ::free(p.buf);
    }
    g_pending->swap(keep);
}

// Same alloc-in-runtime staging for input tensors (reference
// src/exports.cpp:169-203): the caller fills the returned buffer, the bytes
// are pushed on the next model_run of this model, then the buffer is freed.
struct PendingTensor {
    long handle;
    std::string type, name;
    std::vector<size_t> dims;
    void* buf;
    size_t bytes;
};
static std::vector<PendingTensor>* g_pending_tensors = nullptr;

OSTPU_EXPORT void* model_add_tensor(ModelContext* obj, char* type, char* name,
                                    unsigned int dims_num, unsigned int* dims) {
    size_t n = 1;
    std::vector<size_t> dvec(dims_num);
    for (unsigned i = 0; i < dims_num; i++) {
        n *= dims[i];
        dvec[i] = dims[i];
    }
    size_t itemsize = 4;
    std::string t = type ? type : "float32";
    if (t == "float16") itemsize = 2;
    else if (t == "int64") itemsize = 8;
    else if (t == "uint8") itemsize = 1;
    void* buf = ::malloc(n * itemsize);
    PyGILState_STATE gil = PyGILState_Ensure();
    if (!g_pending_tensors) g_pending_tensors = new std::vector<PendingTensor>();
    g_pending_tensors->push_back(
        {(long)(intptr_t)obj, t, name ? name : "", std::move(dvec), buf, n * itemsize});
    PyGILState_Release(gil);
    return buf;
}

static void flush_tensors(long h) {
    if (!g_pending_tensors) return;
    // same snapshot-first discipline as flush_pending (GIL can move inside
    // call(), invalidating a live iterator)
    std::vector<PendingTensor> mine, keep;
    for (auto& p : *g_pending_tensors) {
        (p.handle == h ? mine : keep).push_back(p);
    }
    g_pending_tensors->swap(keep);
    for (auto& p : mine) {
        PyObject* dlist = PyList_New((Py_ssize_t)p.dims.size());
        for (size_t i = 0; i < p.dims.size(); i++)
            PyList_SetItem(dlist, (Py_ssize_t)i, PyLong_FromSize_t(p.dims[i]));
        PyObject* mem = PyMemoryView_FromMemory((char*)p.buf, p.bytes, PyBUF_READ);
        Py_XDECREF(call("model_add_tensor",
                        Py_BuildValue("(lssNN)", h, p.type.c_str(), p.name.c_str(), dlist, mem)));
        ::free(p.buf);  // capi copied (np.frombuffer(...).copy())
    }
}

static void drop_tensors(long h) {  // model_delete without delivery
    if (!g_pending_tensors) return;
    std::vector<PendingTensor> keep;
    for (auto& p : *g_pending_tensors) {
        if (p.handle != h) keep.push_back(p);
        else ::free(p.buf);
    }
    g_pending_tensors->swap(keep);
}

OSTPU_EXPORT void* model_get_tensor(ModelContext* obj, char* name) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_get_tensor", Py_BuildValue("(ls)", (long)(intptr_t)obj, name));
    if (!r || r == Py_None) {
        Py_XDECREF(r);
        PyGILState_Release(gil);
        return nullptr;
    }
    PyObject* dims = PyTuple_GetItem(r, 0);
    PyObject* data = PyTuple_GetItem(r, 1);
    Py_ssize_t nd = PyList_Size(dims);
    Py_buffer view;
    if (PyObject_GetBuffer(data, &view, PyBUF_SIMPLE) != 0) {
        PyErr_Print();
        Py_DECREF(r);
        PyGILState_Release(gil);
        return nullptr;
    }
    size_t nel = view.len / sizeof(float);
    // one malloc holding layout + dims + data (freed by model_free_buffer)
    size_t bytes = sizeof(ReturnLayout) + nd * sizeof(size_t) + view.len;
    ReturnLayout* ret = (ReturnLayout*)::malloc(bytes);
    ret->dims_num = (size_t)nd;
    ret->dims = (size_t*)((char*)ret + sizeof(ReturnLayout));
    ret->data_num = nel;
    ret->data = (float*)((char*)ret->dims + nd * sizeof(size_t));
    for (Py_ssize_t i = 0; i < nd; i++) ret->dims[i] = (size_t)PyLong_AsSize_t(PyList_GetItem(dims, i));
    std::memcpy(ret->data, view.buf, view.len);
    PyBuffer_Release(&view);
    Py_DECREF(r);
    PyGILState_Release(gil);
    return ret;
}

OSTPU_EXPORT char* model_get_all_tensor_names(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call("model_get_all_tensor_names", Py_BuildValue("(l)", (long)(intptr_t)obj));
    char* out = r ? dup_cstr(PyUnicode_AsUTF8(r)) : nullptr;
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return out;
}

OSTPU_EXPORT void model_run(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    long h = (long)(intptr_t)obj;
    flush_pending(h);
    flush_tensors(h);
    Py_XDECREF(call("model_run", Py_BuildValue("(l)", h)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT char* model_run_2(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    long h = (long)(intptr_t)obj;
    flush_pending(h);
    flush_tensors(h);
    PyObject* r = call("model_run_2", Py_BuildValue("(l)", h));
    char* err = nullptr;
    if (r && r != Py_None) err = dup_cstr(PyUnicode_AsUTF8(r));
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return err;
}

OSTPU_EXPORT void model_clear_tensors(ModelContext* obj) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(call("model_clear_tensors", Py_BuildValue("(l)", (long)(intptr_t)obj)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT void model_set_option(ModelContext* obj, char* name, unsigned int value) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(call("model_set_option", Py_BuildValue("(lsI)", (long)(intptr_t)obj, name, value)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT void model_add_extra_output(ModelContext* obj, char* name) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(call("model_add_extra_output", Py_BuildValue("(ls)", (long)(intptr_t)obj, name)));
    PyGILState_Release(gil);
}

OSTPU_EXPORT void model_free_buffer(void* ptr) { ::free(ptr); }
