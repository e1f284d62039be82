"""The port's 15-function model API, its bindings and its C library, held to
the JAX package's on the CPU (``capi.set_device("cpu")``).

Counterpart of tests/test_api.py and tests/test_capi_c_client.py: every
capi function with its error strings (equal to JAX's), PyModel, the ctypes
Model over libonnxstream_tpu_torch.so and a C client (tests/data/
capi_smoke.c) linked against it, the last two in fresh processes.
"""

import os
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

from onnxstream_tpu.api import capi as jax_capi
from onnxstream_tpu.api.bindings import PyModel as JaxPyModel
from onnxstream_tpu_torch.api import capi
from onnxstream_tpu_torch.api.bindings import OnnxStreamError, PyModel
from onnxstream_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = (
    "m:Mul*input:x(2,3);w.bin(float32:2,3)*output:y(2,3)\n"
    "a:Add*input:y(2,3);b.bin(float32:3)*output:z(2,3)\n"
)
W = np.arange(6, dtype=np.float32).reshape(2, 3)
B = np.array([1, 2, 3], np.float32)


@pytest.fixture(autouse=True)
def cpu_device():
    saved = capi._device[0]
    capi.set_device("cpu")
    yield
    capi._device[0] = saved


def _drive(model):
    model.add_weights_file("float32", "w.bin", W)
    model.add_weights_file("float32", "b.bin", B)
    model.read_string(MODEL)
    names = model.get_weights_names()
    model.add_extra_output("y")
    x = np.full((2, 3), 2.0, np.float32)
    model.add_tensor("x", x)
    model.run()
    out = {n: model.get_tensor(n) for n in ("z", "y")}
    all_names = model.get_all_tensor_names()
    model.clear_tensors()
    return names, out, all_names


def test_pymodel_matches_jax():
    with PyModel(weights_provider_name="dict") as m, JaxPyModel(weights_provider_name="dict") as j:
        m.set_use_fp16_arithmetic(False)
        j.set_use_fp16_arithmetic(False)
        got, want = _drive(m), _drive(j)
    assert got[0] == want[0] == ["float32:w.bin", "float32:b.bin"]
    for n in ("z", "y"):
        np.testing.assert_array_equal(got[1][n][0], want[1][n][0])
        assert got[1][n][1] == want[1][n][1] == [2, 3]
    np.testing.assert_array_equal(got[1]["z"][0], 2 * W + B)
    assert sorted(got[2]) == sorted(want[2]) == ["x", "y", "z"]


def test_pymodel_list_io_and_errors():
    with PyModel() as m:
        m.add_weights_file("float32", "w.bin", W)
        m.add_weights_file("float32", "b.bin", B)
        m.read_string(MODEL)
        m.add_tensor_as_list("x", [[1, 1, 1], [1, 1, 1]], "float32")
        m.run()
        vals, dims = m.get_tensor_as_list("z")
        assert dims == [2, 3] and vals == (W + B).reshape(-1).tolist()
        with pytest.raises(ValueError, match="unknown option 'bogus_option'"):
            m._set_option("bogus_option", True)
        with pytest.raises(OnnxStreamError) as e:
            m.read_file("/nonexistent/model.txt")
    with JaxPyModel() as j:
        with pytest.raises(Exception) as je:
            j.read_file("/nonexistent/model.txt")
    assert str(e.value) == str(je.value)


def _both(fn, *args):
    """fn's result or error string from the port's capi and from JAX's."""
    out = []
    for mod in (capi, jax_capi):
        try:
            out.append(getattr(mod, fn)(*args))
        except Exception as e:  # the error itself is compared
            out.append(f"{type(e).__name__}: {e}")
    return out


def test_capi_errors_match_jax():
    # an unknown provider, an unknown handle, a weight pushed to a disk provider
    a, b = _both("model_new_2", 0, "bogus")
    assert a == b == "ValueError: unknown weights provider 'bogus'"
    a, b = _both("model_run_2", 987654)
    assert a == b == "ValueError: invalid model handle 987654"
    hs = [mod.model_new_2(0, "nocache") for mod in (capi, jax_capi)]
    errs = []
    for mod, h in zip((capi, jax_capi), hs):
        with pytest.raises(RuntimeError) as e:
            mod.model_add_weights_file(h, "float32", "w.bin", W.tobytes())
        errs.append(str(e.value))
        mod.model_read_string(h, MODEL)
        errs.append(mod.model_run_2(h))  # no input pushed: the error string
        mod.model_delete(h)
    assert errs[0] == errs[2] == "current weights provider does not accept client weights"
    assert errs[1] == errs[3] and errs[1].startswith("KeyError: ")
    # an integer output does not cross the float32-only surface
    hs = [mod.model_new_2(0, "dict") for mod in (capi, jax_capi)]
    errs = []
    for mod, h in zip((capi, jax_capi), hs):
        mod.model_read_string(h, "s:Shape*input:x(2,3)*output:y(2)\n")
        mod.model_add_tensor(h, "float32", "x", [2, 3], np.ones(6, np.float32))
        mod.model_run(h)
        with pytest.raises(TypeError) as e:
            mod.model_get_tensor(h, "y")
        errs.append(str(e.value))
        mod.model_delete(h)
    assert errs[0] == errs[1] == "tensor 'y' is int64, not float (fp32-only ABI surface)"


@pytest.mark.parametrize("wp", sorted(capi._DICT_PROVIDERS) + sorted(capi._LAZY_PROVIDERS))
def test_every_provider_name_reads_a_model(tmp_path, wp):
    """Each model_new_2 name: a client-weights provider takes the bytes over
    the API, a disk provider reads them relative to model.txt (not the cwd)."""
    assert capi._DICT_PROVIDERS.keys() == jax_capi._DICT_PROVIDERS.keys()
    assert capi._LAZY_PROVIDERS == jax_capi._LAZY_PROVIDERS
    W.tofile(str(tmp_path / "w.bin"))
    B.tofile(str(tmp_path / "b.bin"))
    (tmp_path / "model.txt").write_text(MODEL)
    outs = []
    for mod in (capi, jax_capi):
        h = mod.model_new_2(0, wp)
        if wp in mod._DICT_PROVIDERS:
            mod.model_add_weights_file(h, "float32", "w.bin", W.tobytes())
            mod.model_add_weights_file(h, "float32", "b.bin", B.tobytes())
            mod.model_read_string(h, MODEL)
        else:
            assert mod.model_read_file(h, str(tmp_path / "model.txt")) is None
        assert mod.model_get_weights_names(h) == "float32:w.bin|float32:b.bin"
        mod.model_add_tensor(h, "float32", "x", [2, 3], np.full(6, 3.0, np.float32).tobytes())
        assert mod.model_run_2(h) is None
        dims, data = mod.model_get_tensor(h, "z")
        outs.append((dims, np.asarray(data)))
        assert mod.model_get_all_tensor_names(h) == "z|x"
        mod.model_delete(h)
    assert outs[0][0] == outs[1][0] == [2, 3]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][1].reshape(2, 3), 3 * W + B)


def test_capi_sessions_take_the_module_device():
    import torch

    h = capi.model_new()
    assert capi._ctx(h).session.config.device == torch.device("cpu")
    capi.model_delete(h)
    capi._device[0] = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            capi.model_new()


def test_ctypes_model_two_models_interleaved():
    """Through libonnxstream_tpu_torch.so in a fresh process: two models'
    pending weights and tensors are kept by handle, the second-created
    model runs first."""
    lib = native.exports_library()
    code = f"""
import sys, numpy as np
from onnxstream_tpu_torch.api import capi
capi.set_device("cpu")
from onnxstream_tpu_torch.api.bindings import Model
MODEL = {MODEL!r}
m1 = Model({str(lib)!r}, weights_provider_name="dict")
m2 = Model(weights_provider_name="dict")
w1 = np.arange(6, dtype=np.float32); b1 = np.array([1, 2, 3], np.float32)
w2 = w1[::-1].copy(); b2 = np.array([9, 8, 7], np.float32)
m1.add_weights_file("float32", "w.bin", w1)
m2.add_weights_file("float32", "w.bin", w2)
m2.add_weights_file("float32", "b.bin", b2)
m1.add_weights_file("float32", "b.bin", b1)
m1.read_string(MODEL); m2.read_string(MODEL)
assert m1.get_weights_names() == ["float32:w.bin", "float32:b.bin"]
x1 = np.full((2, 3), 2, np.float32); x2 = np.full((2, 3), 3, np.float32)
m1.add_tensor("x", x1); m2.add_tensor("x", x2)
m2.run(); m1.run()
out1, d1 = m1.get_tensor("z"); out2, _ = m2.get_tensor("z")
assert d1 == [2, 3] and np.array_equal(out1, x1 * w1.reshape(2, 3) + b1), out1
assert np.array_equal(out2, x2 * w2.reshape(2, 3) + b2), out2
try:
    m1.read_file("/nonexistent/model.txt")
    raise SystemExit("no error")
except Exception as e:
    print("ERR", e)
m1.close(); m2.close()
bad = [k for k in ("jax", "onnxstream_tpu") if k in sys.modules]
assert not bad, bad
print("CTYPES_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=300, cwd=REPO)
    assert "CTYPES_OK" in r.stdout, r.stdout + r.stderr
    assert "ERR FileNotFoundError: [Errno 2] No such file or directory: '/nonexistent/model.txt'" in r.stdout


def test_c_client_links_and_runs(tmp_path):
    """tests/data/capi_smoke.c, every exported function from a real C
    compiler and linker, on the CPU (the embedded interpreter reads the
    device from ONNXSTREAM_TPU_TORCH_DEVICE)."""
    lib = native.exports_library()
    exe = str(tmp_path / "capi_smoke")
    cc = subprocess.run(
        ["gcc", "-O1", "-Wall", "-Werror", "-pthread", os.path.join(REPO, "tests", "data", "capi_smoke.c"),
         "-o", exe, f"-L{lib.parent}", "-lonnxstream_tpu_torch", f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True, timeout=120)
    assert cc.returncode == 0, cc.stderr
    env = dict(os.environ, ONNXSTREAM_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join([REPO, sysconfig.get_paths()["purelib"]]))
    env.pop("PYTHONHOME", None)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "CAPI_C_SMOKE_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    assert "Traceback" not in r.stderr, r.stderr[-3000:]


def test_compare_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    from onnxstream_tpu.cli import compare_main as jax_compare
    from onnxstream_tpu_torch.cli import compare_main

    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    a.tofile(str(tmp_path / "a.bin"))
    (a + rng.standard_normal(1000).astype(np.float32) * 1e-3).tofile(str(tmp_path / "b.bin"))
    a[:999].tofile(str(tmp_path / "short.bin"))
    outs = []
    for mod in (compare_main, jax_compare):
        rcs = [mod.main([str(tmp_path / "a.bin"), str(tmp_path / f)]) for f in ("b.bin", "short.bin")]
        outs.append((rcs, capsys.readouterr()))
    assert outs[0] == outs[1] and outs[0][0] == [0, 1]
    assert outs[0][1].out.startswith("max dist: ") and "size mismatch: 1000 vs 999" in outs[0][1].err
