"""The C API of the PyTorch/CUDA port (lightgbm_tpu_torch/native/capi.cpp,
forwarding into lightgbm_tpu_torch.capi_impl), on the CPU, against the
port's Python surface and the JAX reference (lightgbm_tpu).

A pure-C host (gcc, no Python of its own: the library embeds the
interpreter) loads a model file the reference wrote and predicts it; its
"%.17g" lines equal the port's Booster.predict bit for bit, and the
reference's predict within rtol 1e-6: the port sums the trees' leaf values
in f64, the reference's prediction engine in f32 (as in
tests/test_torch_train.py's loaded reference models). A C host trains
stepwise from an
in-memory matrix and ends with the model text of ``train`` on the same
rows. The error convention: a failing call returns nonzero and
LGBMTPU_GetLastError names the cause (a server on a missing model file
names the file); the continuous-learning entries append rows to a Dataset
and create an online trainer (their whole round trip is in
tests/test_torch_online_join.py).
The server entries' round trip is in tests/test_torch_server.py. Skips where there is no g++, gcc or
Python.h to build and link against.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}
PARAMS = ("objective=binary num_leaves=7 min_data_in_leaf=5 verbosity=-1 "
          "device_type=cpu")


@pytest.fixture(scope="module")
def so():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no g++/gcc to build the C ABI and its C host")
    if not os.path.exists(os.path.join(sysconfig.get_path("include"),
                                       "Python.h")):
        pytest.skip("no Python.h to build the C ABI against")
    from lightgbm_tpu_torch.native.build_capi import build_capi
    path = build_capi()
    assert path is not None, "the C ABI did not build"
    assert os.path.basename(path).startswith("liblightgbm_tpu_torch_")
    return path


@pytest.fixture(scope="module")
def capi(so):
    lib = ctypes.CDLL(so)
    lib.LGBMTPU_GetLastError.restype = ctypes.c_char_p
    vp, pvp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    dp = ctypes.POINTER(ctypes.c_double)
    sigs = {
        "LGBMTPU_BoosterCreateFromModelfile": [ctypes.c_char_p, pvp],
        "LGBMTPU_BoosterLoadModelFromString": [ctypes.c_char_p, pvp],
        "LGBMTPU_BoosterPredictForMat": [
            vp, dp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, dp, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)],
        "LGBMTPU_BoosterFree": [vp],
        "LGBMTPU_DatasetCreateFromMat": [dp, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_char_p, vp, pvp],
        "LGBMTPU_DatasetSetField": [vp, ctypes.c_char_p, vp,
                                    ctypes.c_longlong, ctypes.c_int],
        "LGBMTPU_DatasetFree": [vp],
        "LGBMTPU_BoosterCreate": [vp, ctypes.c_char_p, pvp],
        "LGBMTPU_BoosterAddValidData": [vp, vp, ctypes.c_char_p],
        "LGBMTPU_BoosterUpdateOneIter": [vp, ctypes.POINTER(ctypes.c_int)],
        "LGBMTPU_BoosterGetEval": [vp, ctypes.c_int, dp, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)],
        "LGBMTPU_ServerCreate": [ctypes.c_char_p, ctypes.c_char_p, pvp],
        "LGBMTPU_DatasetAppend": [vp, dp, ctypes.c_longlong, ctypes.c_int,
                                  dp],
        "LGBMTPU_OnlineCreate": [vp, vp, vp, ctypes.c_char_p, pvp],
        "LGBMTPU_DatasetNumData": [vp, ctypes.POINTER(ctypes.c_longlong)],
        "LGBMTPU_OnlineClose": [vp],
    }
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _data(n=400, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = np.ascontiguousarray(rng.randn(n, f))
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _run_host(so, tmp_path, source, args):
    src = tmp_path / "host.c"
    src.write_text(source)
    host = str(tmp_path / "host")
    subprocess.run(["gcc", str(src), so, "-o", host,
                    f"-Wl,-rpath,{os.path.dirname(so)}"], check=True,
                   capture_output=True, timeout=120)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in sys.path
                                                    if p]))
    r = subprocess.run([host, *args], capture_output=True, timeout=600,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout.decode()


PREDICT_HOST = r'''
#include <stdio.h>
#include <stdlib.h>
extern const char* LGBMTPU_GetLastError(void);
extern int LGBMTPU_BoosterCreateFromModelfile(const char*, void**);
extern int LGBMTPU_BoosterPredictForMat(void*, const double*, long long,
    int, int, int, double*, long long, long long*);
int main(int argc, char** argv) {
  long long nrow = atoll(argv[3]), n;
  int ncol = atoi(argv[4]);
  void* h;
  if (LGBMTPU_BoosterCreateFromModelfile(argv[1], &h)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return 1; }
  double* x = malloc(nrow * ncol * sizeof(double));
  double* out = malloc(nrow * sizeof(double));
  FILE* f = fopen(argv[2], "rb");
  if (fread(x, sizeof(double), nrow * ncol, f) != (size_t)(nrow * ncol))
    return 2;
  fclose(f);
  if (LGBMTPU_BoosterPredictForMat(h, x, nrow, ncol, 0, 0, out, nrow, &n)) {
    fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return 3; }
  for (long long i = 0; i < n; ++i) printf("%.17g\n", out[i]);
  return 0;
}
'''


def test_pure_c_host_predicts_reference_model(so, tmp_path):
    X, y = _data()
    ref = lgb.train({"objective": "binary", "num_leaves": 7,
                     "min_data_in_leaf": 5, "verbosity": -1, **CPU},
                    lgb.Dataset(X, label=y), 6)
    model = str(tmp_path / "ref_model.txt")
    ref.save_model(model)
    rows = tmp_path / "x.bin"
    X[:50].tofile(rows)
    out = _run_host(so, tmp_path, PREDICT_HOST,
                    [model, str(rows), "50", "5"])
    got = np.array([float(v) for v in out.split()])
    ours = lt.Booster(model_file=model, params=CPU).predict(X[:50])
    np.testing.assert_array_equal(got, ours)
    np.testing.assert_allclose(got, np.asarray(ref.predict(X[:50])),
                               rtol=1e-6)


TRAIN_HOST = r'''
#include <stdio.h>
#include <stdlib.h>
extern const char* LGBMTPU_GetLastError(void);
extern int LGBMTPU_TrainFromConfig(const char*);
extern int LGBMTPU_DatasetCreateFromMat(const double*, long long, int,
    const char*, void*, void**);
extern int LGBMTPU_DatasetSetField(void*, const char*, const void*,
    long long, int);
extern int LGBMTPU_BoosterCreate(void*, const char*, void**);
extern int LGBMTPU_BoosterUpdateOneIter(void*, int*);
extern int LGBMTPU_BoosterFinishTraining(void*);
extern int LGBMTPU_BoosterSaveModel(void*, const char*);
extern int LGBMTPU_BoosterNumTrees(void*, int*);
#define CHECK(x, code) if (x) { \
  fprintf(stderr, "%s\n", LGBMTPU_GetLastError()); return code; }
int main(int argc, char** argv) {
  /* argv: config rows labels nrow ncol params model */
  long long nrow = atoll(argv[4]);
  int ncol = atoi(argv[5]), fin, nt;
  double* x = malloc(nrow * ncol * sizeof(double));
  double* y = malloc(nrow * sizeof(double));
  FILE* f = fopen(argv[2], "rb");
  if (fread(x, sizeof(double), nrow * ncol, f) != (size_t)(nrow * ncol))
    return 9;
  fclose(f);
  f = fopen(argv[3], "rb");
  if (fread(y, sizeof(double), nrow, f) != (size_t)nrow) return 9;
  fclose(f);
  CHECK(LGBMTPU_TrainFromConfig(argv[1]), 1);
  void *d, *b;
  CHECK(LGBMTPU_DatasetCreateFromMat(x, nrow, ncol, argv[6], 0, &d), 2);
  CHECK(LGBMTPU_DatasetSetField(d, "label", y, nrow, 0), 3);
  CHECK(LGBMTPU_BoosterCreate(d, argv[6], &b), 4);
  for (int i = 0; i < 4; ++i) CHECK(LGBMTPU_BoosterUpdateOneIter(b, &fin), 5);
  CHECK(LGBMTPU_BoosterFinishTraining(b), 6);
  CHECK(LGBMTPU_BoosterNumTrees(b, &nt), 7);
  CHECK(LGBMTPU_BoosterSaveModel(b, argv[7]), 8);
  printf("%d\n", nt);
  return 0;
}
'''


def test_pure_c_host_trains_from_config_and_stepwise(so, tmp_path):
    X, y = _data(300, 4, 1)
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    conf = tmp_path / "t.conf"
    conf.write_text(f"task=train\ndata={data}\nobjective=binary\n"
                    "num_leaves=7\nnum_iterations=3\nmin_data_in_leaf=5\n"
                    f"output_model={tmp_path / 'cli.txt'}\n"
                    "device_type=cpu\nverbosity=-1\n")
    X.tofile(tmp_path / "x.bin")
    y.tofile(tmp_path / "y.bin")
    out = _run_host(so, tmp_path, TRAIN_HOST,
                    [str(conf), str(tmp_path / "x.bin"),
                     str(tmp_path / "y.bin"), "300", "4", PARAMS,
                     str(tmp_path / "step.txt")])
    assert out.split() == ["4"]
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbosity": -1, **CPU}

    def body(path):
        with open(path) as fh:
            return fh.read().split("\nparameters:\n")[0]
    assert body(tmp_path / "step.txt") == lt.train(
        p, lt.Dataset(X, label=y, params=p), 4).model_to_string().split(
            "\nparameters:\n")[0]
    cli = lt.Booster(model_file=str(tmp_path / "cli.txt"), params=CPU)
    assert cli.num_trees() == 3


def test_capi_in_process_matches_booster(capi, tmp_path):
    """Called through ctypes (the interpreter is running): a model string,
    a Dataset from memory with a valid set, stepwise updates and metric
    readback against the Python surface."""
    X, y = _data(400, 5, 2)
    Xv, yv = _data(150, 5, 3)
    params = PARAMS.encode() + b" metric=auc"
    d, dv, b = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    assert capi.LGBMTPU_DatasetCreateFromMat(_dptr(X), 400, 5, params, None,
                                             ctypes.byref(d)) == 0
    assert capi.LGBMTPU_DatasetSetField(d, b"label", y.ctypes.data, 400,
                                        0) == 0
    assert capi.LGBMTPU_BoosterCreate(d, params, ctypes.byref(b)) == 0
    assert capi.LGBMTPU_DatasetCreateFromMat(_dptr(Xv), 150, 5, params, d,
                                             ctypes.byref(dv)) == 0
    assert capi.LGBMTPU_DatasetSetField(dv, b"label", yv.ctypes.data, 150,
                                        0) == 0
    assert capi.LGBMTPU_BoosterAddValidData(b, dv, b"v0") == 0, \
        capi.LGBMTPU_GetLastError()
    fin = ctypes.c_int()
    for _ in range(5):
        assert capi.LGBMTPU_BoosterUpdateOneIter(b, ctypes.byref(fin)) == 0
    auc = np.zeros(2)
    n = ctypes.c_int()
    assert capi.LGBMTPU_BoosterGetEval(b, 1, _dptr(auc), 2,
                                       ctypes.byref(n)) == 0
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         "verbosity": -1, "metric": "auc", **CPU}
    ds = lt.Dataset(X, label=y, params=p)
    want = lt.train(p, ds, 5, valid_sets=[ds.create_valid(Xv, label=yv)],
                    verbose_eval=False)
    assert n.value == 1 and auc[0] == want.eval_valid()[0][2]
    assert capi.LGBMTPU_BoosterGetEval(b, 7, _dptr(auc), 2,
                                       ctypes.byref(n)) == -1
    text = want.model_to_string().encode()
    h = ctypes.c_void_p()
    assert capi.LGBMTPU_BoosterLoadModelFromString(text, ctypes.byref(h)) \
        == 0
    out = np.zeros(150)
    written = ctypes.c_longlong()
    assert capi.LGBMTPU_BoosterPredictForMat(
        h, _dptr(Xv), 150, 5, 1, 0, _dptr(out), 150,
        ctypes.byref(written)) == 0
    assert written.value == 150
    np.testing.assert_array_equal(out, want.predict(Xv, raw_score=True))
    # an output buffer too small is an error, not an overrun
    assert capi.LGBMTPU_BoosterPredictForMat(
        h, _dptr(Xv), 150, 5, 0, 0, _dptr(out), 10,
        ctypes.byref(written)) == -1
    assert b"too small" in capi.LGBMTPU_GetLastError()
    for handle in (h, b):
        assert capi.LGBMTPU_BoosterFree(handle) == 0
    for handle in (dv, d):
        assert capi.LGBMTPU_DatasetFree(handle) == 0


def test_capi_error_convention(capi, tmp_path):
    h = ctypes.c_void_p()
    assert capi.LGBMTPU_BoosterCreateFromModelfile(
        str(tmp_path / "no_such_model.txt").encode(), ctypes.byref(h)) == -1
    assert b"no_such_model" in capi.LGBMTPU_GetLastError()
    assert capi.LGBMTPU_ServerCreate(
        str(tmp_path / "no_such_server_model.txt").encode(), b"",
        ctypes.byref(h)) == -1
    assert b"no_such_server_model" in capi.LGBMTPU_GetLastError()
    X, _ = _data(20, 3)
    d = ctypes.c_void_p()
    assert capi.LGBMTPU_DatasetCreateFromMat(_dptr(X), 20, 3, PARAMS.encode(),
                                             None, ctypes.byref(d)) == 0
    y = np.ascontiguousarray(X[:, 0] > 0, dtype=np.float64)
    assert capi.LGBMTPU_DatasetSetField(d, b"label", y.ctypes.data, 20,
                                        0) == 0
    # continuous learning: rows append under the frozen binning, and an
    # online trainer (its initial model trained here) takes the Dataset
    assert capi.LGBMTPU_DatasetAppend(d, _dptr(X), 20, 3, _dptr(y)) == 0
    n = ctypes.c_longlong()
    assert capi.LGBMTPU_DatasetNumData(d, ctypes.byref(n)) == 0
    assert n.value == 40
    assert capi.LGBMTPU_OnlineCreate(
        d, None, None, b"objective=binary num_leaves=7 min_data_in_leaf=5 "
        b"num_iterations=2 verbosity=-1 device_type=cpu",
        ctypes.byref(h)) == 0
    assert capi.LGBMTPU_OnlineClose(h) == 0
    # a label of the wrong width is an error naming the field
    assert capi.LGBMTPU_DatasetAppend(d, _dptr(X), 20, 3, None) == -1
    assert b"label" in capi.LGBMTPU_GetLastError()
    assert capi.LGBMTPU_DatasetSetField(d, b"colour", X.ctypes.data, 20,
                                        0) == -1
    assert b"colour" in capi.LGBMTPU_GetLastError()
    assert capi.LGBMTPU_DatasetFree(d) == 0
