"""The port's minijs (onnxstream_tpu_torch/minijs) against the JAX package's.

* every case of tests/data/es_conformance.json (spec-mandated results,
  test262 style) through the port's engine, each held to the spec's value
  and to the JAX package's engine on the same case;
* the language cases of tests/test_minijs.py that interp.js and client.js
  rely on, on the port's engine;
* a parse of every .js under onnxstream_tpu_torch/api/ and of each example
  page's inline script;
* ``import onnxstream_tpu_torch.minijs`` in a fresh interpreter loads
  neither jax nor ml_dtypes.
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from onnxstream_tpu.minijs import Engine as JaxEngine
from onnxstream_tpu.minijs import JSThrow as JaxJSThrow
from onnxstream_tpu.minijs import MiniJsError as JaxMiniJsError
from onnxstream_tpu_torch.minijs import Engine, JSThrow, MiniJsError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "data", "es_conformance.json")


def _load():
    with open(CORPUS) as f:
        data = json.load(f)
    return [(section, e) for section, entries in data.items() if not section.startswith("_") for e in entries]


CASES = _load()


def _outcome(engine, errors, js: str):
    """('value', String(js)) or ('raises', the kind of error)."""
    try:
        return "value", engine().eval(f"String({js})")
    except errors as e:
        return "raises", type(e).__name__


def test_corpus_is_substantial():
    assert len(CASES) >= 250, len(CASES)
    assert len([e for _, e in CASES if e.get("gate")]) >= 5
    assert len([e for _, e in CASES if e.get("throws")]) >= 3


@pytest.mark.parametrize("section,entry", CASES, ids=[f"{s}:{e['js'][:48]}" for s, e in CASES])
def test_conformance_case_matches_spec_and_jax_engine(section, entry):
    js = entry["js"]
    got = _outcome(Engine, (MiniJsError, JSThrow), js)
    assert got == _outcome(JaxEngine, (JaxMiniJsError, JaxJSThrow), js), f"[{section}] {js}"
    if entry.get("gate"):  # out of the subset: rejected, never run
        assert got[0] == "raises", f"[{section}] {js} ran: {got[1]!r}"
    elif entry.get("throws"):
        with pytest.raises(JSThrow):
            Engine().eval(js)
    else:
        assert got == ("value", entry["want"]), f"[{section}] {js}\n  spec: {entry['want']!r}\n  minijs: {got!r}"


# ------------------------------------------------- the language interp.js uses
def run(src: str):
    e = Engine()
    e.run(src)
    return e


def ev(src: str):
    return Engine().eval(src)


def logs(src: str):
    return [m for _, m in run(src).console_lines]


def test_number_semantics():
    assert ev("1 + 2") == 3.0
    assert ev("3 / 2") == 1.5
    assert ev("7 % 3") == 1.0
    assert ev("-7 % 3") == -1.0  # JS fmod, not Python floor-mod
    assert ev("2 ** 10") == 1024.0
    assert np.isnan(ev("0 / 0"))
    assert ev("1 / 0") == float("inf")
    assert ev("(5 | 0)") == 5.0
    assert ev("(-1 >>> 0)") == 4294967295.0
    assert ev("(5.9 | 0)") == 5.0
    assert ev("1e21 + ''") == "1e+21"
    assert ev("5 + ''") == "5"
    assert ev("0.5 + ''") == "0.5"


def test_string_and_template():
    assert ev("`a${1 + 1}b${'c'}`") == "a2bc"
    assert ev("'1,2,3'.split(',').map(Number)[1]") == 2.0
    assert ev("'  x '.trim()") == "x"
    assert ev("'hello'.slice(1, -1)") == "ell"
    assert ev("'ab'.startsWith('a') && 'ab'.endsWith('b')")
    assert ev("String([1, 2])") == "1,2"


def test_bigint_separation():
    assert ev("typeof 5n") == "bigint"
    assert ev("5n + 3n") == 8
    assert ev("Number(4503599627370495n)") == 4503599627370495.0
    assert ev("BigInt(7)") == 7
    assert ev("1n < 2")
    with pytest.raises(JSThrow):
        ev("1n + 2")  # mixed arithmetic throws TypeError


def test_equality():
    assert ev("null == undefined")
    assert not ev("null === undefined")
    assert ev("'5' == 5")
    assert not ev("'5' === 5")
    assert not ev("NaN === NaN")
    assert ev("[1] !== [1]")


def test_closures_and_arrows():
    assert logs("""
    function counter() { let n = 0; return () => ++n; }
    const c = counter(); c(); c();
    console.log(c());
    """) == ["3"]
    assert logs("""
    class A { constructor() { this.v = 7; } get() { return (() => this.v)(); } }
    console.log(new A().get());
    """) == ["7"]


def test_destructuring_spread_default():
    assert logs("""
    const [a, b = 10, ...rest] = [1, undefined, 3, 4];
    const { x, y: z = 5 } = { x: 2 };
    const arr = [...[1, 2], ...[3]];
    function f(p, { q } = { q: 9 }) { return p + q; }
    console.log(a, b, rest.length, x, z, arr.join(''), f(1, { q: 2 }));
    """) == ["1 10 2 2 5 123 3"]


def test_switch_fallthrough_and_loops():
    assert logs("""
    let s = '';
    for (const v of [1, 2, 3]) {
        switch (v) {
            case 1: s += 'a';
            case 2: s += 'b'; break;
            default: s += 'z';
        }
    }
    let i = 0, out = 0;
    while (true) { i++; if (i === 3) break; if (i === 1) continue; out += i; }
    console.log(s, out);
    """) == ["abbz 2"]


def test_try_finally_and_throw():
    assert logs("""
    let trace = '';
    try {
        try { throw new TypeError('boom'); }
        finally { trace += 'f'; }
    } catch (e) { trace += e.name + ':' + e.message; }
    console.log(trace);
    """) == ["fTypeError:boom"]


def test_async_await_sync_promises():
    assert logs("""
    async function g() { return 5; }
    async function h() { const v = await g(); return v + 1; }
    h().then(v => console.log(v));
    """) == ["6"]


def test_typed_arrays_match_numpy():
    e = run("""
    const f = new Float32Array(3);
    f[0] = 0.1;
    const v = f[0];
    const sub = f.subarray(0, 2);
    sub[1] = 2;
    const big = new BigInt64Array([1n, 9007199254740993n]);
    console.log(v === 0.1, f[1], big[1] === 9007199254740993n);
    """)
    assert e.console_lines == [("log", "false 2 true")]  # f32 store-rounding is real


def test_typed_array_views_over_an_array_buffer():
    """client.js's get_tensor: a u32 header, its dims and the f32 payload read
    as views at byte offsets of one ArrayBuffer."""
    assert logs("""
    const buf = new Float32Array([0, 0, 0, 1.5, -2]).buffer;
    const head = new Uint32Array(buf, 0, 1);
    head[0] = 2;
    const dims = new Uint32Array(buf, 4, head[0]);
    dims[0] = 1; dims[1] = 2;
    const data = new Float32Array(buf, 4 + 4 * head[0]);
    console.log(Array.from(new Uint32Array(buf, 4, 2)).join('x'), data.length, data[0], data[1]);
    """) == ["1x2 2 1.5 -2"]


def test_map_set_iteration_order():
    assert logs("""
    const m = new Map(); m.set('b', 1); m.set('a', 2); m.set('b', 3);
    const s = new Set([3, 1, 3]);
    console.log([...m.keys()].join(''), m.get('b'), s.size, s.has(3));
    const m2 = new Map(m);
    m2.set('c', 4);
    console.log(m.size, m2.size);
    """) == ["ba 3 2 true", "2 3"]


def test_array_methods():
    assert logs("""
    const a = Array.from({ length: 4 }, (_, i) => i * 2);
    const b = a.filter(v => v > 0).reduce((x, y) => x + y, 0);
    const c = new Array(3).fill(1).concat([9]).slice(1);
    console.log(a.join(','), b, c.join(','), Array.isArray(a));
    """) == ["0,2,4,6 12 1,1,9 true"]


def test_getter_free_object_protocol():
    assert logs("""
    const o = { n: 1 };
    o['m'] = o.n + 1;
    const key = 'n';
    delete o.n;
    console.log(o.m, o[key] === undefined, 'm' in o, typeof o.zz);
    """) == ["2 true true undefined"]


def test_engine_rejects_unsupported():
    with pytest.raises(MiniJsError):
        run("class A extends B {}")
    with pytest.raises(MiniJsError):
        run("function* gen() { yield 1; }")


def test_number_edge_semantics_match_js():
    assert np.isnan(ev("(-2) ** 0.5"))
    assert ev("1e300 ** 2") == float("inf")
    assert np.isnan(ev("Math.pow(-2, 0.5)"))
    assert ev("Math.pow(1e300, 2)") == float("inf")
    assert ev("Math.exp(1000)") == float("inf")
    assert ev("Math.exp(-1000)") == 0.0
    assert ev("Math.floor(Infinity)") == float("inf")
    assert np.isnan(ev("Math.sqrt(-1)"))
    assert ev("Math.log(0)") == float("-inf")
    assert ev("1 / (1 + Math.exp(-(-800)))") == 0.0  # the Sigmoid kernel's huge negative logit
    assert not ev("1n == Infinity")
    assert not ev("1n == NaN")


def test_for_let_per_iteration_bindings():
    assert logs("""
    const fns = [];
    for (let i = 0; i < 3; i++) fns.push(() => i);
    console.log(fns.map(f => f()).join(','));
    """) == ["0,1,2"]


def test_computed_delete_and_fractional_index():
    assert logs("""
    const o = { big: 1 };
    const k = 'big';
    delete o[k];
    const a = [10, 20, 30];
    a[1.5] = 99;
    console.log('big' in o, a[1.5] === undefined || a[1.5] === 99, a[1], a[3 / 2]);
    """) == ["false true 20 undefined"]


def test_template_escapes_match_string_escapes():
    assert ev("`\\u0041\\x42\\n`") == "AB\n"
    assert ev("'\\u0041\\x42\\n'") == "AB\n"


def test_host_marshalling_shares_typed_memory():
    e = Engine()
    buf = np.zeros(4, np.float32)
    e.scope.declare("buf", e.to_js(buf))
    e.run("buf[2] = 7;")
    assert buf[2] == 7.0  # no copy: JS writes land in the numpy array


# ------------------------------------------------------------ the port's JS
def test_engine_parses_every_port_js_file_and_example_page():
    from onnxstream_tpu_torch.minijs.parser import parse

    js = sorted(glob.glob(os.path.join(ROOT, "onnxstream_tpu_torch", "api", "*.js")))
    assert [os.path.basename(p) for p in js] == ["client.js", "interp.js"]
    for p in js:
        with open(p, encoding="utf-8") as f:
            parse(f.read())
    pages = 0
    for p in glob.glob(os.path.join(ROOT, "examples", "**", "*.html"), recursive=True):
        with open(p, encoding="utf-8") as f:
            m = re.search(r"<script>(.*)</script>", f.read(), re.S)
        if m:
            parse(m.group(1))
            pages += 1
    assert pages >= 3


def test_import_loads_neither_jax_nor_ml_dtypes():
    code = ("import sys, onnxstream_tpu_torch.minijs as m; "
            "e = m.Engine(); assert e.eval('1 + 1') == 2.0; "
            "print(sorted(k for k in ('jax', 'ml_dtypes', 'onnxstream_tpu') if k in sys.modules))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
