// Minimal stable C ABI of lightgbm_tpu_torch.
//
// Port of lightgbm_tpu/native/capi.cpp. The reference's C API
// (include/LightGBM/c_api.h, 64 LGBM_* functions) is the surface R,
// SWIG/Java and Spark bind to. This package's core is Python and PyTorch,
// so its stable non-Python surface is this small C library: it embeds (or
// joins) a CPython interpreter and forwards into
// lightgbm_tpu_torch.capi_impl. The LGBMTPU_* names and signatures are the
// reference package's, so one C host binds either library: train from a
// config file, a booster from a model file or string, dense-matrix
// predict, save, a Dataset from memory with stepwise training, a
// coalescing prediction server (LGBMTPU_Server*), continuous learning
// (LGBMTPU_DatasetAppend, LGBMTPU_Online*), and LGBMTPU_GetLastError, the
// reference c_api.cpp's error convention (a nonzero return, the message
// through GetLastError).
//
// Threading: every entry takes the GIL through PyGILState_Ensure, so a
// host may call from any thread, one that already runs Python too.
//
// Build: python -m lightgbm_tpu_torch.native.build_capi (links against the
// running interpreter's libpython).

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

// thread_local like the reference's c_api.cpp error convention: the pointer
// GetLastError returns stays valid for the calling thread with no locking
thread_local std::string g_last_error = "";
PyObject* g_impl = nullptr;   // lightgbm_tpu_torch.capi_impl (owned)

void set_error(const std::string& msg) { g_last_error = msg; }

// capture the pending Python exception into the last-error slot
void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  set_error(msg);
}

// interpreter bring-up for pure-C hosts. Must run BEFORE PyGILState_Ensure
// (taking the GIL state of an uninitialized interpreter is undefined);
// Py_InitializeEx leaves the GIL held, so release it for the uniform
// GilGuard pattern below. A once_flag keeps concurrent first calls safe.
std::once_flag g_init_once;

void ensure_interpreter() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();
    }
  });
}

// import capi_impl (GIL must be held); returns 0 on success
int ensure_impl() {
  if (g_impl == nullptr) {
    PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.capi_impl");
    if (mod == nullptr) {
      capture_py_error();
      return -1;
    }
    g_impl = mod;
  }
  return 0;
}

struct GilGuard {
  PyGILState_STATE st;
  GilGuard() : st(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

const char* LGBMTPU_GetLastError() { return g_last_error.c_str(); }

// Train a model from a config file (CLI task semantics). Returns 0 on
// success.
int LGBMTPU_TrainFromConfig(const char* config_path) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "train_from_config", "s",
                                    config_path);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  return static_cast<int>(rc);
}

// Load a model file into an opaque booster handle. Returns 0 on success.
int LGBMTPU_BoosterCreateFromModelfile(const char* filename, void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* b = PyObject_CallMethod(g_impl, "booster_from_file", "s",
                                    filename);
  if (b == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(b);   // owned reference held by the handle
  return 0;
}

int LGBMTPU_BoosterLoadModelFromString(const char* model_str, void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* b = PyObject_CallMethod(g_impl, "booster_from_string", "s",
                                    model_str);
  if (b == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(b);
  return 0;
}

int LGBMTPU_BoosterFree(void* handle) {
  if (handle == nullptr) return 0;
  ensure_interpreter();
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

int LGBMTPU_BoosterNumFeature(void* handle, int* out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "num_feature", "O",
                                    static_cast<PyObject*>(handle));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBMTPU_BoosterNumTrees(void* handle, int* out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "num_trees", "O",
                                    static_cast<PyObject*>(handle));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

// Predict on a dense row-major double matrix (reference:
// LGBM_BoosterPredictForMat, c_api.h:822). out_len receives the number of
// doubles written into out_result (capacity out_cap). Returns 0 on success.
int LGBMTPU_BoosterPredictForMat(void* handle, const double* data,
                                 long long nrow, int ncol, int raw_score,
                                 int pred_leaf, double* out_result,
                                 long long out_cap, long long* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(
      g_impl, "predict_for_mat", "OLLiiiLL",
      static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(data)),
      nrow, ncol, raw_score, pred_leaf,
      static_cast<long long>(reinterpret_cast<intptr_t>(out_result)),
      out_cap);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long long n = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (n < 0) {
    set_error("output buffer too small");
    return -1;
  }
  *out_len = n;
  return 0;
}

// ---- dataset-from-memory + stepwise training (reference: LGBM_DatasetCreateFromMat c_api.h:215, LGBM_DatasetSetField
// c_api.h:322, LGBM_BoosterCreate c_api.h:387, LGBM_BoosterUpdateOneIter
// c_api.h:482) — lets an R/JNI-style host drive the full train loop from
// in-memory buffers without config files ----

// Create a Dataset from a dense row-major f64 matrix. `reference` is an
// optional existing dataset handle whose bin mappers align the new one
// (validation data), or NULL. Params use the reference's "k=v k2=v2" form.
int LGBMTPU_DatasetCreateFromMat(const double* data, long long nrow,
                                 int ncol, const char* params,
                                 void* reference, void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* ref = reference ? static_cast<PyObject*>(reference) : Py_None;
  PyObject* d = PyObject_CallMethod(
      g_impl, "dataset_from_mat", "LLisO",
      static_cast<long long>(reinterpret_cast<intptr_t>(data)),
      nrow, ncol, params ? params : "", ref);
  if (d == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(d);
  return 0;
}

// Set a metadata field BEFORE the dataset is consumed by BoosterCreate.
// name: "label" | "weight" | "init_score" (dtype 0 = f64) or "group"
// (dtype 1 = i32 query sizes, like the reference's group field).
int LGBMTPU_DatasetSetField(void* handle, const char* name,
                            const void* data, long long n, int dtype) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(
      g_impl, "dataset_set_field", "OsLLi",
      static_cast<PyObject*>(handle), name,
      static_cast<long long>(reinterpret_cast<intptr_t>(data)), n, dtype);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int LGBMTPU_DatasetNumData(void* handle, long long* out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "dataset_num_data", "O",
                                    static_cast<PyObject*>(handle));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

int LGBMTPU_DatasetNumFeature(void* handle, int* out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "dataset_num_feature", "O",
                                    static_cast<PyObject*>(handle));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBMTPU_DatasetFree(void* handle) {
  if (handle == nullptr) return 0;
  ensure_interpreter();
  GilGuard gil;
  Py_DECREF(static_cast<PyObject*>(handle));
  return 0;
}

// Create a training booster over a dataset handle (constructs/bins the
// dataset on first use). Params: "k=v k2=v2".
int LGBMTPU_BoosterCreate(void* train_dataset, const char* params,
                          void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* b = PyObject_CallMethod(g_impl, "booster_create", "Os",
                                    static_cast<PyObject*>(train_dataset),
                                    params ? params : "");
  if (b == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(b);
  return 0;
}

int LGBMTPU_BoosterAddValidData(void* booster, void* valid_dataset,
                                const char* name) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "booster_add_valid", "OOs",
                                    static_cast<PyObject*>(booster),
                                    static_cast<PyObject*>(valid_dataset),
                                    name ? name : "valid_0");
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Metric values on one eval set (reference: LGBM_BoosterGetEval,
// c_api.h:556): data_idx 0 = training set, 1.. = valid sets in AddValidData
// order. out receives up to cap doubles; *out_len = metrics written.
// Enables a pure-C host to drive early stopping around UpdateOneIter.
int LGBMTPU_BoosterGetEval(void* booster, int data_idx, double* out,
                           int cap, int* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(
      g_impl, "booster_get_eval", "OiLi",
      static_cast<PyObject*>(booster), data_idx,
      static_cast<long long>(reinterpret_cast<intptr_t>(out)), cap);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  if (n < 0) {
    set_error("output buffer too small or bad data_idx");
    return -1;
  }
  *out_len = static_cast<int>(n);
  return 0;
}

// Signal the end of the update loop (the reference package flushes its
// lagged stop check here; this package checks each iteration as it goes,
// so the call only returns 0).
int LGBMTPU_BoosterFinishTraining(void* booster) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "booster_finish_training", "O",
                                    static_cast<PyObject*>(booster));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// One boosting iteration; *is_finished = 1 when no further splits are
// possible (reference: LGBM_BoosterUpdateOneIter, c_api.h:482).
int LGBMTPU_BoosterUpdateOneIter(void* booster, int* is_finished) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "booster_update_one_iter", "O",
                                    static_cast<PyObject*>(booster));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *is_finished = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int LGBMTPU_BoosterSaveModel(void* handle, const char* filename) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "save_model", "Os",
                                    static_cast<PyObject*>(handle), filename);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// ---- serving (server.py, fleet/): an opaque server handle, coalesced
// predicts from any host thread, hot-swap, canary rollouts and stats ----

namespace {

// a server entry returning an int through ``out`` (-1 from Python: the
// entry's own failure, named by ``what``)
int server_int(const char* method, PyObject* args, int* out,
               const char* what) {
  if (args == nullptr) {
    capture_py_error();
    return -1;
  }
  PyObject* fn = PyObject_GetAttrString(g_impl, method);
  if (fn == nullptr) {
    capture_py_error();
    Py_XDECREF(args);
    return -1;
  }
  PyObject* r = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  if (v < 0) {
    set_error(what);
    return -1;
  }
  if (out != nullptr) *out = static_cast<int>(v);
  return 0;
}

// a server entry returning a JSON string into buf (capacity cap, NUL
// included); out_len receives the string's length. Returns -1 with the
// needed length in out_len when buf is too small
int server_json(void* server, const char* method, char* buf, long long cap,
                long long* out_len) {
  PyObject* r = PyObject_CallMethod(g_impl, method, "O",
                                    static_cast<PyObject*>(server));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_ssize_t n = 0;
  const char* c = PyUnicode_AsUTF8AndSize(r, &n);
  if (c == nullptr) {
    capture_py_error();
    Py_DECREF(r);
    return -1;
  }
  *out_len = static_cast<long long>(n);
  if (static_cast<long long>(n) + 1 > cap) {
    Py_DECREF(r);
    set_error("output buffer too small");
    return -1;
  }
  std::memcpy(buf, c, static_cast<size_t>(n) + 1);
  Py_DECREF(r);
  return 0;
}

}  // namespace

// Start a PredictServer (a FleetServer with fleet_replicas > 1 in params)
// on a model file: version 1 is published and warmed before the call
// returns. Free with LGBMTPU_ServerClose.
int LGBMTPU_ServerCreate(const char* model_path, const char* params,
                         void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(g_impl, "server_create", "ss",
                                    model_path, params ? params : "");
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(r);
  return 0;
}

// Coalesced predict on a dense row-major double matrix: blocks until the
// scheduler's flush that serves it (concurrent host threads share device
// batches). Returns 0, -1 on an error, -2 when the request was shed at
// overload (back off and retry).
int LGBMTPU_ServerPredict(void* server, const double* data, long long nrow,
                          int ncol, int raw_score, int pred_leaf,
                          double* out_result, long long out_cap,
                          long long* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(
      g_impl, "server_predict", "OLLiiiLL", static_cast<PyObject*>(server),
      static_cast<long long>(reinterpret_cast<intptr_t>(data)), nrow, ncol,
      raw_score, pred_leaf,
      static_cast<long long>(reinterpret_cast<intptr_t>(out_result)),
      out_cap);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long long n = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (n == -2) {
    set_error("request shed: the serving queue is full");
    return -2;
  }
  if (n < 0) {
    set_error("output buffer too small");
    return -1;
  }
  *out_len = n;
  return 0;
}

// Atomic hot-swap to a new model file; out_version receives its version.
int LGBMTPU_ServerPublish(void* server, const char* model_path,
                          int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_int("server_publish",
                    Py_BuildValue("(Os)", static_cast<PyObject*>(server),
                                  model_path),
                    out_version, "publish failed");
}

// One-line JSON of the scheduler, registry, SLO and latency state.
int LGBMTPU_ServerStatsJSON(void* server, char* buf, long long cap,
                            long long* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_json(server, "server_stats_json", buf, cap, out_len);
}

// Start a canary (shadow != 0: a shadow) rollout of a model file;
// fraction <= 0 takes canary_fraction. out_version: the candidate's.
int LGBMTPU_ServerCanary(void* server, const char* model_path,
                         double fraction, int shadow, int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_int("server_canary",
                    Py_BuildValue("(Osdi)", static_cast<PyObject*>(server),
                                  model_path, fraction, shadow),
                    out_version, "canary failed");
}

// Promote the active canary now; out_version: the new live version.
int LGBMTPU_ServerPromote(void* server, int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_int("server_promote",
                    Py_BuildValue("(O)", static_cast<PyObject*>(server)),
                    out_version, "no active canary to promote");
}

// Roll the active canary back now; out_version: the incumbent's.
int LGBMTPU_ServerRollback(void* server, int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_int("server_rollback",
                    Py_BuildValue("(O)", static_cast<PyObject*>(server)),
                    out_version, "no active canary to roll back");
}

// One-line JSON of the fleet and rollout state.
int LGBMTPU_ServerFleetStatsJSON(void* server, char* buf, long long cap,
                                 long long* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_json(server, "server_fleet_stats_json", buf, cap, out_len);
}

// Drain queued requests, stop the scheduler and free the handle.
int LGBMTPU_ServerClose(void* server) {
  if (server == nullptr) return 0;
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  int rc = server_int("server_close",
                      Py_BuildValue("(O)", static_cast<PyObject*>(server)),
                      nullptr, "close failed");
  Py_DECREF(static_cast<PyObject*>(server));
  return rc;
}

// ---- continuous learning (Dataset.append, online.py) ----

// Append dense rows (and labels, or null) to a constructed Dataset under
// its frozen binning.
int LGBMTPU_DatasetAppend(void* handle, const double* data, long long nrow,
                          int ncol, const double* label) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  PyObject* r = PyObject_CallMethod(
      g_impl, "dataset_append", "OLLiL", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(data)), nrow, ncol,
      static_cast<long long>(reinterpret_cast<intptr_t>(label)));
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// An OnlineTrainer over a constructed Dataset, continuing from a Booster
// (null: it trains the initial model); a non-null server takes its
// publishes and its !learn / !label lines.
int LGBMTPU_OnlineCreate(void* dataset, void* booster, void* server,
                         const char* params, void** out) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  auto obj = [](void* h) {
    return h ? static_cast<PyObject*>(h) : Py_None;
  };
  PyObject* r = PyObject_CallMethod(g_impl, "online_create", "OOOs",
                                    obj(dataset), obj(booster), obj(server),
                                    params ? params : "");
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<void*>(r);
  return 0;
}

namespace {

// call capi_impl.<method>(*args) (GIL held; args owned) and store its
// integer result, negative ones included; returns 0 or -1 on a Python
// error
int impl_long(const char* method, PyObject* args, long long* out) {
  if (args == nullptr) {
    capture_py_error();
    return -1;
  }
  PyObject* fn = PyObject_GetAttrString(g_impl, method);
  if (fn == nullptr) {
    capture_py_error();
    Py_DECREF(args);
    return -1;
  }
  PyObject* r = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_DECREF(args);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  long long v = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (v == -1 && PyErr_Occurred()) {
    capture_py_error();
    return -1;
  }
  if (out != nullptr) *out = v;
  return 0;
}

long long addr(const void* p) {
  return static_cast<long long>(reinterpret_cast<intptr_t>(p));
}

}  // namespace

// Feed one labeled batch; out_version: the version its synchronous refit
// cycle published, else 0.
int LGBMTPU_OnlineFeed(void* trainer, const double* data, long long nrow,
                       int ncol, const double* label, int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  long long v = 0;
  if (impl_long("online_feed",
                Py_BuildValue("(OLLiL)", static_cast<PyObject*>(trainer),
                              addr(data), nrow, ncol, addr(label)),
                &v) != 0)
    return -1;
  if (out_version != nullptr) *out_version = static_cast<int>(v);
  return 0;
}

// Capture served features under request id rid for a delayed-label join;
// out_pending: the pending joins (a duplicate rid is counted and ignored).
int LGBMTPU_OnlineCapture(void* trainer, const char* rid, const double* data,
                          long long nrow, int ncol, int* out_pending) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  long long v = 0;
  if (impl_long("online_capture",
                Py_BuildValue("(OsLLi)", static_cast<PyObject*>(trainer), rid,
                              addr(data), nrow, ncol),
                &v) != 0)
    return -1;
  if (v < 0) {
    set_error("capture failed: malformed input");
    return -1;
  }
  if (out_pending != nullptr) *out_pending = static_cast<int>(v);
  return 0;
}

// Join a late label (weight <= 0: none) against the features captured
// under rid; out_result: the published version when the join triggered a
// synchronous refit, 0 when it buffered, -1 when rid matched nothing.
int LGBMTPU_OnlineLabel(void* trainer, const char* rid, double label,
                        double weight, int* out_result) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  long long v = 0;
  if (impl_long("online_label",
                Py_BuildValue("(Osdd)", static_cast<PyObject*>(trainer), rid,
                              label, weight),
                &v) != 0)
    return -1;
  if (out_result != nullptr) *out_result = static_cast<int>(v);
  return 0;
}

// One-line JSON of the join counters.
int LGBMTPU_OnlineJoinStatsJSON(void* trainer, char* buf, long long cap,
                                long long* out_len) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  return server_json(trainer, "online_join_stats_json", buf, cap, out_len);
}

// Drain the pending rows through refit cycles now; out_version: the last
// published version, 0 when nothing pended.
int LGBMTPU_OnlineFlush(void* trainer, int* out_version) {
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  long long v = 0;
  if (impl_long("online_flush",
                Py_BuildValue("(O)", static_cast<PyObject*>(trainer)),
                &v) != 0)
    return -1;
  if (out_version != nullptr) *out_version = static_cast<int>(v);
  return 0;
}

// Stop the trainer's worker, close its feed log and free the handle.
int LGBMTPU_OnlineClose(void* trainer) {
  if (trainer == nullptr) return 0;
  ensure_interpreter();
  GilGuard gil;
  if (ensure_impl() != 0) return -1;
  int rc = impl_long("online_close",
                     Py_BuildValue("(O)", static_cast<PyObject*>(trainer)),
                     nullptr);
  Py_DECREF(static_cast<PyObject*>(trainer));
  return rc;
}

}  // extern "C"
