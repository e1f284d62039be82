"""minijs — an embedded JavaScript (ES2020 subset) engine, from scratch.

The PyTorch/CUDA port's own copy of the engine: it imports numpy and the
standard library only, so the port's JavaScript runs where the port runs
(the machine with the card has no JS host either). Why this exists: the port
ships a dependency-free in-browser interpreter of the text IR
(`api/interp.js`), the counterpart of the reference's WASM in-tab runtime
(reference src/wasm.js + src/BUILD.bazel:1-134,
examples/YOLOv8n_wasm/index.html), and an HTTP client of its server
(`api/client.js`). minijs is a small tree-walking JS engine that parses and
executes the REAL JavaScript sources, so `interp.js` is held to the port's
Session and `client.js` drives the port's server end to end
(tests/test_torch_interp_js.py, tests/test_torch_client_js.py).

Scope: exactly the language surface interp.js uses (strict-mode ES2020
subset): const/let, functions + closures + arrows, classes with
static/async methods, async/await (synchronous promise semantics — the tab
API is async for symmetry, it never suspends), template literals,
destructuring, spread, for/for-of/while/switch/try, Map/Set, BigInt, and
typed arrays backed by numpy so array semantics (f32 rounding on store,
float64 reads) match the browser exactly.

Non-goals: prototypes chains, getters/setters, generators, regex, eval,
`with`, sloppy mode, the DOM. Anything outside the subset raises
MiniJsError at parse or run time rather than mis-executing.

Entry points:
    from onnxstream_tpu_torch.minijs import Engine
    eng = Engine(); eng.run_file("api/interp.js")
    InterpModel = eng.global_get("InterpModel")
    model = eng.await_(eng.call(eng.get(InterpModel, "create")))
"""

from .errors import MiniJsError, JSThrow
from .engine import Engine

__all__ = ["Engine", "MiniJsError", "JSThrow"]
