"""Structural gate for the port's C# bindings (onnxstream_tpu_torch/api/bindings.cs).

No C# compiler exists here, so, as tests/test_bindings_cs.py does for the
JAX package's copy: a tokenizer-level lint (comments and strings stripped,
every bracket kind balanced, externs terminated), every [DllImport] extern
held to an OSTPU_EXPORT function of the port's api/csrc/exports.cpp at the
same arity (all 16 covered), the Model wrapper calling every extern, the
library name ``Lib`` equal to the one runtime/native.py builds, and every
extern a defined dynamic symbol of that library, built with g++.
"""

import inspect
import os
import re
import shutil
import subprocess

import pytest

from test_bindings_cs import _dllimport_externs, _strip_cs

from onnxstream_tpu_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS_PATH = os.path.join(ROOT, "onnxstream_tpu_torch", "api", "bindings.cs")


def _code() -> str:
    with open(CS_PATH) as f:
        return _strip_cs(f.read())


def _cpp_exports() -> dict:
    """{name: arity} of every OSTPU_EXPORT function of the port's exports.cpp."""
    src = native.EXPORTS_SOURCE.read_text()
    exports = {}
    for m in re.finditer(r"OSTPU_EXPORT\s+[\w:*]+[*\s]+(\w+)\s*\(([^)]*)\)\s*\{", src, re.S):
        params = m.group(2).strip()
        exports[m.group(1)] = 0 if params in ("", "void") else params.count(",") + 1
    return exports


def test_brackets_balanced_and_statements_terminated():
    pairs = {")": "(", "]": "[", "}": "{"}
    stack, line = [], 1
    code = _code()
    for ch in code:
        if ch == "\n":
            line += 1
        elif ch in "([{":
            stack.append((ch, line))
        elif ch in ")]}":
            assert stack, f"unmatched '{ch}' at line {line}"
            op, op_line = stack.pop()
            assert op == pairs[ch], f"'{op}' (line {op_line}) closed by '{ch}' (line {line})"
    assert not stack, f"unclosed brackets: {stack}"
    for m in re.finditer(r"static extern[^;{]*", code):
        assert m.group(0).strip().endswith(")"), f"extern not ');'-terminated: {m.group(0)[:80]}"


def test_dllimport_surface_matches_port_c_abi():
    externs, exports = _dllimport_externs(_code()), _cpp_exports()
    assert len(exports) == 16, f"expected the 15 ABI functions + model_new, got {sorted(exports)}"
    assert set(externs) == set(exports), (sorted(set(exports) - set(externs)), sorted(set(externs) - set(exports)))
    for name, arity in externs.items():
        assert arity == exports[name], f"{name}: bindings.cs {arity} params, exports.cpp {exports[name]}"


def test_model_class_wraps_every_entry_point():
    code = _code()
    externs = set(_dllimport_externs(code))
    used = set(re.findall(r"Native\.(\w+)\(", code)) - {"TensorReturn"}
    assert used <= externs, f"Model calls undeclared natives: {sorted(used - externs)}"
    assert externs - used == {"model_new"}, f"declared but unused externs: {sorted(externs - used - {'model_new'})}"


def test_lib_names_the_library_native_builds():
    with open(CS_PATH) as f:
        lib = re.search(r'private const string Lib = "(\w+)";', f.read()).group(1)
    built = re.search(r'build_library\(EXPORTS_SOURCE, "(\w+)"', inspect.getsource(native.exports_library)).group(1)
    assert lib == built == "onnxstream_tpu_torch"


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("nm") is None, reason="needs g++ and nm")
def test_every_dllimport_is_a_defined_symbol_of_the_built_library():
    lib = native.exports_library()
    assert lib.name == "libonnxstream_tpu_torch.so"
    nm = subprocess.run(["nm", "-D", "--defined-only", str(lib)], capture_output=True, text=True, check=True)
    defined = {line.split()[-1] for line in nm.stdout.splitlines() if line.strip()}
    externs = set(_dllimport_externs(_code()))
    assert len(externs) == 16 and externs <= defined, sorted(externs - defined)
