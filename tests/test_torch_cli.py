"""The text parser, the native host library and the command line of the
PyTorch/CUDA port (lightgbm_tpu_torch) against the JAX reference
(lightgbm_tpu), on the CPU.

Exact: format detection, parsed arrays, column roles and sidecars against
the reference's ``load_file``; the native parser against the Python one;
the native binner against the port's numpy ``values_to_bins``; two-round
loading against one pass; the C++ code generated from one model file by
both packages. Against the reference CLI on the same file: the first
tree's structure exact (C1: later binary trees inherit the CPU exp gap),
predictions rtol 1e-4 (C2: the reference renews leaves from bf16 hi/lo
sums), refit leaves rtol 1e-4.
"""
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from lightgbm_tpu import app as ref_app
from lightgbm_tpu.io import parser as ref_parser
from lightgbm_tpu.io.model_text import model_to_cpp as ref_model_to_cpp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import app, native
from lightgbm_tpu_torch.binning import MISSING_NAN, find_bin_mappers
from lightgbm_tpu_torch.io import parser, vfs
from lightgbm_tpu_torch.io.model_text import model_to_cpp, parse_model_text
import torch

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = {"histogram_impl": "pallas", "use_quantized_grad": "true",
          "prewarm": 0}
TRAIN = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
         "min_data_in_leaf": 5, "num_iterations": 3, "verbosity": -1,
         **PALLAS}


def _rows(n=400, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = np.round(rng.randn(n, f), 4)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + 0.5 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _write(path, y, X, delim="\t", header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(header) + "\n")
        for yi, row in zip(y, X):
            fh.write(delim.join(["%g" % yi] + ["nan" if np.isnan(v)
                                               else repr(float(v))
                                               for v in row]) + "\n")
    return str(path)


def _same_parsed(a, b):
    for f in ("X", "label", "weight", "group", "init_score"):
        x, z = getattr(a, f), getattr(b, f)
        assert (x is None) == (z is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(z),
                                          err_msg=f)
    assert a.feature_names == b.feature_names


# ---------------- the parser ----------------

@pytest.mark.parametrize("text,want", [
    ("1\t0.5\t2.0\n0\t0.1\t3.5\n", ("tsv", "\t")),
    ("1,0.5,2.0\n0,0.1,3.5\n", ("csv", ",")),
    ("1 0.5 2.0\n0 0.1 3.5\n", ("tsv", " ")),
    ("1 0:0.5 3:1.2\n0 1:0.1\n1 0:0.3 2:0.7 4:0.9\n", ("libsvm", " ")),
])
def test_detect_format_matches_reference(tmp_path, text, want):
    p = tmp_path / "data.txt"
    p.write_text(text)
    assert parser.detect_format(str(p)) == ref_parser.detect_format(
        str(p)) == want


def test_tsv_with_sidecars_matches_reference(tmp_path):
    X, y = _rows()
    path = _write(tmp_path / "d.tsv", y, X)
    rng = np.random.RandomState(1)
    np.savetxt(path + ".weight", rng.rand(len(y)))
    np.savetxt(path + ".query", [100, 150, 150], fmt="%d")
    np.savetxt(path + ".init", rng.randn(len(y)))
    ours = parser.load_file(path)
    _same_parsed(ours, ref_parser.load_file(path))
    assert ours.group.tolist() == [100, 150, 150]
    assert parser.LAST_PARSE_PATH == "native"


def test_csv_header_and_column_roles_match_reference(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("id,f0,target,f1,w,q\n1,0.5,1.0,2.0,0.1,7\n"
                 "2,0.2,0.0,na,0.9,7\n3,?,1.0,1.5,0.4,8\n")
    for kw in ({"label_column": "name:target", "weight_column": "name:w",
                "group_column": "name:q", "ignore_column": "name:id"},
               {"label_column": "2", "weight_column": "3",
                "ignore_column": "0,4"}):
        ours = parser.load_file(str(p), header=True, **kw)
        _same_parsed(ours, ref_parser.load_file(str(p), header=True, **kw))
    assert ours.feature_names == ["f0", "f1"]


def test_libsvm_with_feature_hint_matches_reference(tmp_path):
    p = tmp_path / "d.svm"
    p.write_text("1 0:0.5 3:1.2\n0 1:0.1\n1\t0:0.3 2:0.7 4:0.9\n")
    for hint in (0, 8):
        ours = parser.load_file(str(p), num_features_hint=hint)
        _same_parsed(ours, ref_parser.load_file(str(p),
                                                num_features_hint=hint))
    assert ours.X.shape == (3, 8)


def test_native_parser_equals_python_parser(tmp_path, monkeypatch,
                                            caplog):
    X, y = _rows(300, 6, 2)
    path = _write(tmp_path / "d.tsv", y, X, header=[f"c{i}"
                                                     for i in range(7)])
    svm = tmp_path / "d.svm"
    svm.write_text("1 0:0.5 3:1.2\n0 1:0.1\n")
    native_out = [parser.load_file(path, header=True),
                  parser.load_file(str(svm))]
    assert parser.LAST_PARSE_PATH == "native"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    caplog.set_level("WARNING", logger="lightgbm_tpu_torch")
    python_out = [parser.load_file(path, header=True),
                  parser.load_file(str(svm))]
    assert parser.LAST_PARSE_PATH == "python"
    assert "Python parser" in caplog.text
    for a, b in zip(native_out, python_out):
        _same_parsed(a, b)


def _native_bins(data, mappers):
    """native.bin_values with each mapper's numeric upper bounds and its
    NaN bin (the bin of 0.0 when it has none)."""
    bounds, nas = [], []
    for m in mappers:
        nan_bin = m.missing_type == MISSING_NAN
        bounds.append(m.upper_bounds[:m.num_bins - nan_bin])
        nas.append(m.num_bins - 1 if nan_bin
                   else int(m.values_to_bins(np.asarray([0.0]))[0]))
    return native.bin_values(data, bounds, nas)


def test_native_binner_equals_numpy_bins():
    """native.bin_values with the port's mappers gives the bins of their
    numpy values_to_bins, NaN and out-of-range values included."""
    rng = np.random.RandomState(3)
    X = rng.randn(5000, 5)
    X[rng.rand(5000) < 0.1, 1] = np.nan
    X[:, 2] = np.round(X[:, 2] * 3)          # few distinct values
    X[:, 3] = np.where(rng.rand(5000) < 0.6, 0.0, X[:, 3])
    X[:, 4] = rng.rand(5000) * 1e4
    for max_bin, zero_missing in ((255, False), (15, False), (63, True)):
        mappers = find_bin_mappers(X[:4000], max_bin,
                                   zero_as_missing=zero_missing)
        test = np.concatenate([X[4000:], [[1e9, -1e9, np.nan, 0.0, -1.0]]])
        for dt in (np.float64, np.float32):
            got = _native_bins(test.astype(dt), mappers)
            want = np.stack([m.values_to_bins(test.astype(dt)[:, j])
                             for j, m in enumerate(mappers)], axis=1)
            np.testing.assert_array_equal(got, want.astype(np.uint8))


def test_two_round_matches_one_pass(tmp_path):
    X, y = _rows(500, 4, 4)
    path = _write(tmp_path / "d.tsv", y, X)
    with open(path, "a") as fh:
        fh.write("\n")                         # a blank line is skipped
    a = parser.load_file(path)
    b = parser.load_file(path, two_round=True)
    _same_parsed(a, b)
    _same_parsed(b, ref_parser.load_file(path, two_round=True))


def test_vfs_scheme_registry(tmp_path):
    import io
    store = {"mem://d.tsv": b"1\t0.5\t2.0\n0\t0.1\t3.5\n"}

    def opener(path, mode):
        if path not in store:
            raise FileNotFoundError(path)
        return io.BytesIO(store[path])
    vfs.register_scheme("mem", opener)
    assert vfs.exists("mem://d.tsv") and not vfs.exists("mem://none")
    pf = parser.load_file("mem://d.tsv")
    np.testing.assert_array_equal(pf.X, [[0.5, 2.0], [0.1, 3.5]])
    with pytest.raises(lt.LightGBMError, match="no file handler"):
        vfs.open_file("nope://x")


def test_parse_args_overrides_config_file(tmp_path):
    conf = tmp_path / "train.conf"
    conf.write_text("# a comment\ntask = train\nnum_leaves=7 # inline\n"
                    "objective=binary\n\n")
    argv = [f"config={conf}", "num_leaves=15", "metric=auc"]
    got = app.parse_args(argv)
    assert got == ref_app.parse_args(argv)
    assert got["num_leaves"] == "15" and got["task"] == "train"
    with pytest.raises(lt.LightGBMError, match="does not exist"):
        app.parse_args([f"config={tmp_path / 'missing.conf'}"])


# ---------------- the command line against the reference's ----------------

def _conf(path, items):
    with open(path, "w") as fh:
        for k, v in items.items():
            fh.write(f"{k}={v}\n")
    return str(path)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The same train, predict, convert_model and refit through both
    packages' command lines (in process)."""
    d = tmp_path_factory.mktemp("cli")
    X, y = _rows(400, 5, 6)
    Xv, yv = _rows(200, 5, 7)
    train = _write(d / "train.tsv", y, X)
    valid = _write(d / "valid.tsv", yv, Xv)
    out = {"X": X, "Xv": Xv, "yv": yv, "valid": valid, "dir": d}
    for name, main, extra in (("ref", ref_app.main, {}),
                              ("port", app.main, {"device_type": "cpu"})):
        conf = _conf(d / f"{name}.conf", {
            **TRAIN, **extra, "task": "train", "data": train,
            "valid": valid, "metric": "auc",
            "output_model": d / f"{name}_model.txt"})
        assert main([f"config={conf}"]) == 0
        common = [f"config={conf}", f"input_model={d / f'{name}_model.txt'}"]
        assert main(common + ["task=predict", f"data={valid}",
                              f"output_result={d / f'{name}_pred.txt'}"]) == 0
        assert main(common + ["task=convert_model",
                              f"convert_model={d / f'{name}.cpp'}"]) == 0
        assert main(common + ["task=refit", f"data={valid}",
                              f"output_model={d / f'{name}_refit.txt'}"]
                    ) == 0
        for what in ("model", "refit"):
            with open(d / f"{name}_{what}.txt") as fh:
                out[f"{name}_{what}"] = fh.read()
        out[f"{name}_pred"] = np.loadtxt(d / f"{name}_pred.txt")
        out[f"{name}_conf"] = conf
    return out


def test_cli_train_matches_reference(cli_runs):
    _, ta = parse_model_text(cli_runs["ref_model"])
    _, tb = parse_model_text(cli_runs["port_model"])
    assert len(ta) == len(tb) == 3
    for f in ("split_feature", "left_child", "right_child", "default_left",
              "threshold_real"):
        np.testing.assert_array_equal(getattr(tb[0], f), getattr(ta[0], f))
    np.testing.assert_allclose(tb[0].leaf_value, ta[0].leaf_value,
                               rtol=1e-4)
    body = cli_runs["port_model"].split("\nparameters:\n")[0]
    assert "feature_names=Column_0 Column_1" in body


def test_cli_predict_matches_reference_and_booster(cli_runs):
    np.testing.assert_allclose(cli_runs["port_pred"], cli_runs["ref_pred"],
                               rtol=1e-4)
    bst = lt.Booster(model_file=str(cli_runs["dir"] / "port_model.txt"),
                     params={"device_type": "cpu"})
    # the result file holds Booster.predict of the parsed rows exactly
    np.testing.assert_array_equal(cli_runs["port_pred"],
                                  bst.predict(cli_runs["Xv"]))
    np.testing.assert_array_equal(bst.predict(cli_runs["valid"]),
                                  bst.predict(cli_runs["Xv"]))


@pytest.mark.parametrize("task_args,kw", [
    (["predict_raw_score=true"], {"raw_score": True}),
    (["predict_leaf_index=true"], {"pred_leaf": True}),
    (["predict_contrib=true"], {"pred_contrib": True}),
    (["num_iteration_predict=2"], {"num_iteration": 2}),
])
def test_cli_predict_options(cli_runs, task_args, kw):
    d = cli_runs["dir"]
    model = str(d / "port_model.txt")
    out = str(d / "opt_pred.txt")
    assert app.main([f"config={cli_runs['port_conf']}", "task=predict",
                     f"data={cli_runs['valid']}", f"input_model={model}",
                     f"output_result={out}", *task_args]) == 0
    got = np.loadtxt(out)
    want = lt.Booster(model_file=model, params={"device_type": "cpu"}
                      ).predict(cli_runs["Xv"], **kw)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_cli_convert_model_matches_reference_and_compiles(cli_runs,
                                                          tmp_path):
    """The same model file gives both packages' code generators the same
    C++, which g++ compiles into the model's raw scores."""
    d = cli_runs["dir"]
    model = str(d / "ref_model.txt")
    ours = model_to_cpp(*(lambda b: (b, b._host_trees()))(
        lt.Booster(model_file=model, params={"device_type": "cpu"})))
    rb = lgb.Booster(model_file=model)
    assert ours == ref_model_to_cpp(rb, rb._ensure_host_trees())
    with open(d / "port.cpp") as fh:
        cpp = fh.read()
    main_src = tmp_path / "main.cpp"
    main_src.write_text("""#include <cstdio>
void Predict(const double* features, double* output);
int main() {
  double row[5], out[1];
  while (scanf("%lf %lf %lf %lf %lf", &row[0], &row[1], &row[2], &row[3],
               &row[4]) == 5) {
    Predict(row, out);
    printf("%.17g\\n", out[0]);
  }
  return 0;
}
""")
    exe = str(tmp_path / "pred")
    subprocess.run(["g++", "-O1", "-o", exe, str(d / "port.cpp"),
                    str(main_src)], check=True, timeout=120)
    Xv = np.nan_to_num(cli_runs["Xv"][:64])   # IsLeft reads NaN as missing
    inp = "\n".join(" ".join(f"{v:.17g}" for v in row) for row in Xv)
    res = subprocess.run([exe], input=inp, capture_output=True, text=True,
                         check=True, timeout=60)
    got = np.array([float(s) for s in res.stdout.split()])
    bst = lt.Booster(model_file=str(d / "port_model.txt"),
                     params={"device_type": "cpu"})
    assert "PredictTree2" in cpp
    np.testing.assert_allclose(got, bst.predict(Xv, raw_score=True),
                               rtol=2e-5, atol=1e-6)


def test_cli_refit_matches_reference(cli_runs):
    _, ta = parse_model_text(cli_runs["ref_refit"])
    _, tb = parse_model_text(cli_runs["port_refit"])
    _, t0 = parse_model_text(cli_runs["port_model"])
    for a, b, c in zip(ta, tb, t0):
        np.testing.assert_array_equal(b.split_feature, c.split_feature)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-6)
    assert not np.allclose(tb[0].leaf_value, t0[0].leaf_value)


@pytest.mark.parametrize("task,item", [("serve", "A18"), ("online", "A19")])
def test_cli_serve_and_online_not_ported(tmp_path, monkeypatch, capsys, task,
                                         item):
    """task=serve (A18) over stdin/stdout answers each feature row with its
    version and the model's prediction, hot-swaps on !publish and stops at
    !quit. task=online (A19) trains on ``data``, drains ``online_feed``
    through the online trainer and saves the model: its trees equal the
    same feed through the Python API (OnlineTrainer over tail_source) byte
    for byte, and the reference's task=online in structure (leaves rtol
    1e-4 plus 1e-4 of the largest, C2; L2 labels on a 1/8 grid)."""
    if task == "online":
        X, _ = _rows(300, 4, 9)
        y = np.round((X[:, 0] - np.nan_to_num(X[:, 2])) * 8) / 8
        data = _write(tmp_path / "d.tsv", y[:200], X[:200])
        feed = _write(tmp_path / "feed.csv", y[200:], X[200:], delim=",")
        keys = {**TRAIN, "objective": "regression", "online_feed": feed,
                "online_refit_rows": 60, "online_boost_rounds": 2}
        argv = [f"task={task}", f"data={data}"] + \
            [f"{k}={v}" for k, v in keys.items()]
        out = {}
        for pkg, main, extra in ((lt, app.main, ["device_type=cpu"]),
                                 (lgb, ref_app.main, [])):
            path = str(tmp_path / f"{pkg.__name__}.txt")
            main(argv + extra + [f"output_model={path}"])
            out[pkg] = open(path).read()
        from lightgbm_tpu_torch.online import OnlineTrainer, tail_source
        pp = {**keys, "device_type": "cpu"}
        tr = OnlineTrainer(pp, lt.Dataset(X[:200], label=y[:200], params=pp))
        assert tr.run(tail_source(feed, follow=False)) == 100
        assert tr.cycles == 1 and tr.dataset.num_data == 300
        # the trees byte for byte (the parameter echo holds the CLI's keys)
        assert out[lt].split("\nparameters:")[0] == \
            tr.booster.model_to_string().split("\nparameters:")[0]
        tr.close()
        _, ta = parse_model_text(out[lgb])
        _, tb = parse_model_text(out[lt])
        assert len(ta) == len(tb) == 5
        for t_ref, t_port in zip(ta, tb):
            for f in ("split_feature", "threshold_bin", "left_child",
                      "right_child"):
                np.testing.assert_array_equal(getattr(t_port, f),
                                              getattr(t_ref, f))
            np.testing.assert_allclose(
                t_port.leaf_value, t_ref.leaf_value, rtol=1e-4,
                atol=1e-4 * np.abs(t_ref.leaf_value).max())
        return
    X, y = _rows(300, 4, 9)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "device_type": "cpu"}
    models = []
    for rounds in (2, 3):
        b = lt.train(p, lt.Dataset(X, label=y, params=p), rounds)
        path = str(tmp_path / f"m{rounds}.txt")
        b.save_model(path)
        models.append((b, path))
    rows = ["\t".join("%.17g" % v for v in X[i]) for i in range(3)]
    script = (f"{rows[0]}\n{rows[1]}\n!publish {models[1][1]}\n{rows[2]}\n"
              "!quit\n")
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    app.main([f"task={task}", f"input_model={models[0][1]}",
              "device_type=cpu", "verbosity=-1"])
    out = capsys.readouterr().out.splitlines()
    assert out[2] == "ok version=2"
    for line, (i, ver, b) in zip((out[0], out[1], out[3]),
                                 ((0, "1", models[0][0]),
                                  (1, "1", models[0][0]),
                                  (2, "2", models[1][0]))):
        v, score = line.split("\t")
        assert v == ver and float(score) == b.predict(X[i:i + 1])[0]


def test_cli_binary_cache_and_reference_pickle(tmp_path, caplog):
    """save_binary=true writes the port's .bin beside the data and the
    next run loads it; a reference pickle there is not read: the text is
    parsed instead, and the log says so."""
    X, y = _rows(300, 4, 8)
    data = _write(tmp_path / "d.tsv", y, X)
    caplog.set_level("INFO", logger="lightgbm_tpu_torch")
    base = [f"data={data}", "device_type=cpu", "objective=binary",
            "num_iterations=2", "num_leaves=7", "min_data_in_leaf=5"]
    app.main(base + ["save_binary=true", f"output_model={tmp_path / 'a.txt'}"])
    assert os.path.exists(data + ".bin")
    app.main(base + [f"output_model={tmp_path / 'b.txt'}"])
    assert "Loaded binned dataset" in caplog.text
    assert (tmp_path / "a.txt").read_text().split("\nparameters:")[0] == \
        (tmp_path / "b.txt").read_text().split("\nparameters:")[0]
    with open(data + ".bin", "wb") as fh:
        pickle.dump({"magic": "lightgbm_tpu_dataset"}, fh)
    caplog.clear()
    app.main(base + [f"output_model={tmp_path / 'c.txt'}"])
    assert "parsing" in caplog.text and "instead" in caplog.text


def test_python_m_entry_point(tmp_path):
    """``python -m lightgbm_tpu_torch`` trains with snapshots and logs its
    loading and iteration times on stderr."""
    X, y = _rows(300, 4, 9)
    data = _write(tmp_path / "d.tsv", y, X)
    conf = _conf(tmp_path / "t.conf", {
        "task": "train", "data": data, "device_type": "cpu",
        "objective": "binary", "num_iterations": 4, "num_leaves": 7,
        "min_data_in_leaf": 5, "snapshot_freq": 2, "snapshot_keep": 1,
        "snapshot_dir": tmp_path / "snaps",
        "output_model": tmp_path / "m.txt"})
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO] + sys.path))
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                        f"config={conf}"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Finished loading data in" in r.stderr
    assert "s/iteration" in r.stderr
    assert sorted(os.listdir(tmp_path / "snaps")) == [
        "snapshot_iter_4.state.npz", "snapshot_iter_4.txt",
        "snapshot_manifest.json"]
    assert lt.Booster(model_file=str(tmp_path / "m.txt"),
                      params={"device_type": "cpu"}).num_trees() == 4
