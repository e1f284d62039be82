"""minijs evaluator — tree-walking interpreter over parser.py's tuple AST."""

import math
from typing import Any, List, Optional

from .errors import MiniJsError, JSThrow
from .values import (
    NULL, UNDEF, JSArray, JSBoundMethod, JSClass, JSFunction, JSMap, JSObject,
    JSPromise, JSSet, JSTypedArray, NativeFunction, js_to_number, js_to_string,
    js_truthy, js_typeof, num_to_str, to_int32, to_uint32, _type_error,
)
from . import runtime


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise JSThrow(JSObject({"name": "ReferenceError",
                                "message": f"{name} is not defined"}))

    def set_existing(self, name: str, value) -> None:
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        raise JSThrow(JSObject({"name": "ReferenceError",
                                "message": f"{name} is not defined"}))

    def declare(self, name: str, value) -> None:
        self.vars[name] = value


class _OptShortCircuit(Exception):
    """Internal: a nullish base at an optional-chain link; caught by the
    enclosing optchain node, never escapes to JS."""


class BreakEx(Exception):
    def __init__(self, label=None):
        self.label = label


class ContinueEx(Exception):
    def __init__(self, label=None):
        self.label = label


class ReturnEx(Exception):
    def __init__(self, value):
        self.value = value


class Interp:
    def __init__(self, global_scope: Scope):
        self.global_scope = global_scope

    # ---------------------------------------------------------- statements
    def exec_block(self, stmts: List[tuple], scope: Scope, this) -> None:
        # hoist function declarations (interp.js defines helpers bottom-up)
        for st in stmts:
            if st[0] == "funcdecl":
                _, name, params, body, is_async = st
                scope.declare(name, JSFunction(name, params, body, scope,
                                               is_async=is_async))
        for st in stmts:
            self.exec_stmt(st, scope, this)

    def exec_stmt(self, st: tuple, scope: Scope, this, label=()) -> None:
        # `label` is the tuple of LabelledStatement names directly wrapping
        # this statement (`a: b: for...` gives the loop both names); loops
        # use it to match labeled break/continue
        kind = st[0]
        if kind == "expr":
            self.eval(st[1], scope, this)
        elif kind == "var":
            for pat, init in st[2]:
                v = self.eval(init, scope, this) if init is not None else UNDEF
                self.bind_pattern(pat, v, scope, this, declare=True)
        elif kind == "block":
            self.exec_block(st[1], Scope(scope), this)
        elif kind == "if":
            if js_truthy(self.eval(st[1], scope, this)):
                self.exec_stmt(st[2], scope, this)
            elif st[3] is not None:
                self.exec_stmt(st[3], scope, this)
        elif kind == "for":
            init, test, update, body = st[1], st[2], st[3], st[4]
            s2 = Scope(scope)
            if init is not None:
                self.exec_stmt(init, s2, this)
            # per-iteration let/const environments (spec
            # CreatePerIterationEnvironment): each iteration's test/body/
            # update see a FRESH copy of the loop bindings, so closures made
            # in the body capture that iteration's values, not the final ones
            per_iter = init is not None and init[0] == "var" and init[1] != "var"

            def _copy(e):
                nxt = Scope(scope)
                nxt.vars.update(e.vars)
                return nxt

            # spec ForBodyEvaluation: copy before the FIRST test, then after
            # each body and BEFORE the update — so body N's closures capture
            # iteration N's bindings and the update increments iteration
            # N+1's copy
            env = _copy(s2) if per_iter else s2
            while True:
                if test is not None and not js_truthy(self.eval(test, env, this)):
                    break
                try:
                    self.exec_stmt(body, Scope(env), this)
                except BreakEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                    break
                except ContinueEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                if per_iter:
                    env = _copy(env)
                if update is not None:
                    self.eval(update, env, this)
        elif kind == "forof":
            _, _kw, pat, iter_e, body = st
            for v in runtime.js_iter(self.eval(iter_e, scope, this)):
                s2 = Scope(scope)
                # kw None = non-declaration LHS (`for (k of xs)` with outer
                # k): assign the existing binding, so it survives the loop
                self.bind_pattern(pat, v, s2, this, declare=_kw is not None)
                try:
                    self.exec_stmt(body, s2, this)
                except BreakEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                    break
                except ContinueEx as e:
                    if e.label is not None and e.label not in label:
                        raise
        elif kind == "forin":
            _, _kw, pat, obj_e, body = st
            obj = self.eval(obj_e, scope, this)
            keys = (list(obj.props) if isinstance(obj, JSObject)
                    else [num_to_str(float(i)) for i in range(len(obj.items))]
                    if isinstance(obj, JSArray) else [])
            for k in keys:
                s2 = Scope(scope)
                self.bind_pattern(pat, k, s2, this, declare=_kw is not None)
                try:
                    self.exec_stmt(body, s2, this)
                except BreakEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                    break
                except ContinueEx as e:
                    if e.label is not None and e.label not in label:
                        raise
        elif kind == "while":
            while js_truthy(self.eval(st[1], scope, this)):
                try:
                    self.exec_stmt(st[2], Scope(scope), this)
                except BreakEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                    break
                except ContinueEx as e:
                    if e.label is not None and e.label not in label:
                        raise
        elif kind == "dowhile":
            while True:
                try:
                    self.exec_stmt(st[1], Scope(scope), this)
                except BreakEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                    break
                except ContinueEx as e:
                    if e.label is not None and e.label not in label:
                        raise
                if not js_truthy(self.eval(st[2], scope, this)):
                    break
        elif kind == "return":
            raise ReturnEx(self.eval(st[1], scope, this) if st[1] is not None else UNDEF)
        elif kind == "break":
            raise BreakEx(st[1] if len(st) > 1 else None)
        elif kind == "continue":
            raise ContinueEx(st[1] if len(st) > 1 else None)
        elif kind == "label":
            # break <name> targeting a labeled NON-loop (or the loop itself)
            # unwinds to here; continue <name> is consumed by the loop
            try:
                self.exec_stmt(st[2], scope, this, label=(st[1],) + tuple(label))
            except BreakEx as e:
                if e.label != st[1]:
                    raise
        elif kind == "throw":
            raise JSThrow(self.eval(st[1], scope, this))
        elif kind == "try":
            _, block, param, catch, fin = st
            try:
                self.exec_stmt(block, scope, this)
            except JSThrow as e:
                if catch is not None:
                    s2 = Scope(scope)
                    if param is not None:
                        self.bind_pattern(param, e.value, s2, this, declare=True)
                    self.exec_stmt(catch, s2, this)
                else:
                    raise
            finally:
                if fin is not None:
                    self.exec_stmt(fin, scope, this)
        elif kind == "switch":
            disc = self.eval(st[1], scope, this)
            s2 = Scope(scope)
            cases = st[2]
            matched = False
            try:
                for test, stmts in cases:
                    if not matched and test is not None:
                        if strict_equals(self.eval(test, s2, this), disc):
                            matched = True
                    if matched:
                        for s in stmts:
                            self.exec_stmt(s, s2, this)
                if not matched:  # default clause (and fall-through after it)
                    hit_default = False
                    for test, stmts in cases:
                        if test is None:
                            hit_default = True
                        if hit_default:
                            for s in stmts:
                                self.exec_stmt(s, s2, this)
            except BreakEx as e:
                # plain `break` exits the switch; `break label` targets an
                # enclosing labeled statement and must propagate
                if e.label is not None:
                    raise
        elif kind == "funcdecl":
            pass  # hoisted in exec_block
        elif kind == "classdecl":
            scope.declare(st[1], self.make_class(st, scope, this))
        elif kind == "empty":
            pass
        else:
            raise MiniJsError(f"unsupported statement {kind}")

    # ---------------------------------------------------------- functions
    def make_class(self, node: tuple, scope: Scope, this) -> JSClass:
        _, name, members = node
        kls = JSClass(name, scope)
        for m in members:
            if m[0] == "method":
                _, mname, params, body, is_static, is_async = m
                fn = JSFunction(mname, params, body, scope, is_async=is_async)
                (kls.statics if is_static else kls.methods)[mname] = fn
            else:  # field
                _, fname, init, is_static = m
                if is_static:
                    kls.static_props[fname] = self.eval(init, scope, this)
                else:
                    kls.fields.append((fname, init))
        return kls

    def bind_pattern(self, pat: tuple, value, scope: Scope, this,
                     declare: bool) -> None:
        kind = pat[0]
        if kind == "pid":
            if declare:
                scope.declare(pat[1], value)
            else:
                scope.set_existing(pat[1], value)
        elif kind == "pdefault":
            if value is UNDEF:
                value = self.eval(pat[2], scope, this)
            self.bind_pattern(pat[1], value, scope, this, declare)
        elif kind == "parr":
            items = list(runtime.js_iter(value))
            i = 0
            for p in pat[1]:
                if p is None:
                    i += 1
                    continue
                if p[0] == "prest":
                    self.bind_pattern(p[1], JSArray(items[i:]), scope, this, declare)
                    return
                v = items[i] if i < len(items) else UNDEF
                self.bind_pattern(p, v, scope, this, declare)
                i += 1
        elif kind == "pobj":
            for key, p in pat[1]:
                v = runtime.get_prop(self, value, key)
                self.bind_pattern(p, v, scope, this, declare)
        elif kind == "prest":
            self.bind_pattern(pat[1], value, scope, this, declare)
        else:
            raise MiniJsError(f"unsupported pattern {kind}")

    def call(self, fn, this, args: List[Any]):
        """Invoke any callable JS value."""
        while isinstance(fn, JSBoundMethod):
            this = fn.this_val
            fn = fn.fn
        if isinstance(fn, NativeFunction):
            return fn.fn(this, args)
        if isinstance(fn, JSClass):
            raise JSThrow(_type_error(
                f"class {fn.name} cannot be invoked without 'new'"))
        if not isinstance(fn, JSFunction):
            raise JSThrow(_type_error(f"{js_to_string(fn)} is not a function"))
        scope = Scope(fn.env)
        use_this = fn.this_val if fn.is_arrow else this
        i = 0
        for p in fn.params:
            if p[0] == "prest":
                self.bind_pattern(p[1], JSArray(list(args[i:])), scope, use_this,
                                  declare=True)
                i = len(args)
                break
            v = args[i] if i < len(args) else UNDEF
            self.bind_pattern(p, v, scope, use_this, declare=True)
            i += 1

        def run():
            if fn.is_arrow and fn.is_expr_body:
                return self.eval(fn.body, scope, use_this)
            try:
                self.exec_stmt(fn.body, scope, use_this)
            except ReturnEx as r:
                return r.value
            return UNDEF

        if fn.is_async:
            try:
                return JSPromise(value=run())
            except JSThrow as e:
                return JSPromise(error=e)
        return run()

    def construct(self, ctor, args: List[Any]):
        if isinstance(ctor, NativeFunction):
            return ctor.fn(("new",), args)  # natives see a 'new' marker this
        if not isinstance(ctor, JSClass):
            raise JSThrow(_type_error(f"{js_to_string(ctor)} is not a constructor"))
        obj = JSObject(klass=ctor)
        for fname, init in ctor.fields:
            obj.props[fname] = (self.eval(init, Scope(ctor.scope), obj)
                                if init is not None else UNDEF)
        init_fn = ctor.methods.get("constructor")
        if init_fn is not None:
            self.call(init_fn, obj, args)
        return obj

    # ---------------------------------------------------------- expressions
    def eval_args(self, arg_nodes: List[tuple], scope: Scope, this) -> List[Any]:
        args: List[Any] = []
        for a in arg_nodes:
            if a[0] == "spread":
                args.extend(runtime.js_iter(self.eval(a[1], scope, this)))
            else:
                args.append(self.eval(a, scope, this))
        return args

    def eval(self, e: tuple, scope: Scope, this):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "str":
            return e[1]
        if kind == "bigint":
            return e[1]
        if kind == "bool":
            return e[1]
        if kind == "null":
            return NULL
        if kind == "undef":
            return UNDEF
        if kind == "ident":
            return scope.lookup(e[1])
        if kind == "this":
            return this
        if kind == "tmpl":
            out = []
            for p in e[1]:
                if p[0] == "str":
                    out.append(p[1])
                else:
                    out.append(js_to_string(self.eval(p[1], scope, this)))
            return "".join(out)
        if kind == "arr":
            items: List[Any] = []
            for el in e[1]:
                if el[0] == "spread":
                    items.extend(runtime.js_iter(self.eval(el[1], scope, this)))
                else:
                    items.append(self.eval(el, scope, this))
            return JSArray(items)
        if kind == "obj":
            from .values import JSAccessor

            obj = JSObject()
            for p in e[1]:
                if p[0] == "prop":
                    obj.props[p[1]] = self.eval(p[2], scope, this)
                elif p[0] == "computed":
                    k = js_to_string(self.eval(p[1], scope, this))
                    obj.props[k] = self.eval(p[2], scope, this)
                elif p[0] in ("getter", "setter"):
                    fn = self.eval(p[2], scope, this)
                    cur = obj.props.get(p[1])
                    if not isinstance(cur, JSAccessor):
                        cur = JSAccessor()
                    if p[0] == "getter":
                        cur.get_fn = fn
                    else:
                        cur.set_fn = fn
                    obj.props[p[1]] = cur
                else:  # spread: copies VALUES (spec CopyDataProperties
                    # invokes getters; the copy is a plain data property)
                    src = self.eval(p[1], scope, this)
                    if isinstance(src, JSObject):
                        for k in list(src.props):
                            obj.props[k] = runtime.resolve_prop_value(
                                self, src, k, src.props[k])
            return obj
        if kind == "func":
            _, name, params, body, is_async = e
            return JSFunction(name, params, body, scope, is_async=is_async)
        if kind == "arrow":
            _, params, body, is_expr, is_async = e
            return JSFunction("", params, body, scope, is_arrow=True,
                              is_async=is_async, this_val=this,
                              is_expr_body=is_expr)
        if kind == "classexpr":
            return self.make_class(e, scope, this)
        if kind == "member":
            obj = self.eval(e[1], scope, this)
            return runtime.get_prop(self, obj, e[2])
        if kind == "index":
            obj = self.eval(e[1], scope, this)
            idx = self.eval(e[2], scope, this)
            return runtime.get_index(self, obj, idx)
        if kind == "optchain":
            # a?.b.c — one nullish optional link short-circuits the WHOLE
            # remaining chain to undefined (spec OptionalExpression)
            try:
                return self.eval(e[1], scope, this)
            except _OptShortCircuit:
                return UNDEF
        if kind in ("optmember", "optindex"):
            obj = self.eval(e[1], scope, this)
            if obj is UNDEF or obj is NULL:
                raise _OptShortCircuit()
            if kind == "optmember":
                return runtime.get_prop(self, obj, e[2])
            return runtime.get_index(self, obj, self.eval(e[2], scope, this))
        if kind == "optcall":
            # f?.(...) — the nullish check applies to the FUNCTION value;
            # when the callee is a property access, its base object is the
            # `this` binding, same as the non-optional call path below
            callee = e[1]
            this_obj = UNDEF
            if callee[0] in ("member", "optmember", "index", "optindex"):
                this_obj = self.eval(callee[1], scope, this)
                if callee[0] in ("optmember", "optindex") and (
                        this_obj is UNDEF or this_obj is NULL):
                    raise _OptShortCircuit()
                if callee[0] in ("member", "optmember"):
                    fn = runtime.get_prop(self, this_obj, callee[2])
                else:
                    fn = runtime.get_index(
                        self, this_obj, self.eval(callee[2], scope, this))
            else:
                fn = self.eval(callee, scope, this)
            if fn is UNDEF or fn is NULL:
                raise _OptShortCircuit()
            return self.call(fn, this_obj, self.eval_args(e[2], scope, this))
        if kind == "call":
            callee = e[1]
            if callee[0] in ("optmember", "optindex"):
                obj = self.eval(callee[1], scope, this)
                if obj is UNDEF or obj is NULL:
                    raise _OptShortCircuit()
                if callee[0] == "optmember":
                    fn = runtime.get_prop(self, obj, callee[2])
                else:
                    fn = runtime.get_index(
                        self, obj, self.eval(callee[2], scope, this))
                return self.call(fn, obj, self.eval_args(e[2], scope, this))
            if callee[0] == "member":
                obj = self.eval(callee[1], scope, this)
                fn = runtime.get_prop(self, obj, callee[2])
                args = self.eval_args(e[2], scope, this)
                return self.call(fn, obj, args)
            if callee[0] == "index":
                obj = self.eval(callee[1], scope, this)
                idx = self.eval(callee[2], scope, this)
                fn = runtime.get_index(self, obj, idx)
                args = self.eval_args(e[2], scope, this)
                return self.call(fn, obj, args)
            fn = self.eval(callee, scope, this)
            args = self.eval_args(e[2], scope, this)
            return self.call(fn, UNDEF, args)
        if kind == "new":
            ctor = self.eval(e[1], scope, this)
            args = self.eval_args(e[2], scope, this)
            return self.construct(ctor, args)
        if kind == "unary":
            op = e[1]
            if op == "typeof":
                # typeof of an unresolvable name is 'undefined', not a throw
                if e[2][0] == "ident":
                    try:
                        return js_typeof(scope.lookup(e[2][1]))
                    except JSThrow:
                        return "undefined"
                return js_typeof(self.eval(e[2], scope, this))
            v = self.eval(e[2], scope, this)
            if op == "!":
                return not js_truthy(v)
            if op == "-":
                if isinstance(v, int) and not isinstance(v, bool):
                    return -v
                return -js_to_number(v)
            if op == "+":
                return js_to_number(v)
            if op == "~":
                if isinstance(v, int) and not isinstance(v, bool):
                    return ~v
                return float(~to_int32(js_to_number(v)))
            if op == "void":
                return UNDEF
            if op == "delete":
                if e[2][0] == "member" and isinstance(
                        o := self.eval(e[2][1], scope, this), JSObject):
                    o.props.pop(e[2][2], None)
                elif e[2][0] == "index":
                    o = self.eval(e[2][1], scope, this)
                    key = js_to_string(self.eval(e[2][2], scope, this))
                    if isinstance(o, JSObject):
                        o.props.pop(key, None)
                return True
            raise MiniJsError(f"unsupported unary {op}")
        if kind == "await":
            v = self.eval(e[1], scope, this)
            if isinstance(v, JSPromise):
                if v.error is not None:
                    raise v.error
                return v.value
            return v
        if kind == "update":
            _, op, target, prefix = e
            get, put = self._resolve_ref(target, scope, this)
            old = get()
            if isinstance(old, int) and not isinstance(old, bool):
                new = old + 1 if op == "++" else old - 1
            else:
                n = js_to_number(old)
                new = n + 1.0 if op == "++" else n - 1.0
                old = n
            put(new)
            return new if prefix else old
        if kind == "binary":
            return self.binop(e[1], self.eval(e[2], scope, this),
                              self.eval(e[3], scope, this))
        if kind == "logical":
            op = e[1]
            l = self.eval(e[2], scope, this)
            if op == "&&":
                return self.eval(e[3], scope, this) if js_truthy(l) else l
            if op == "||":
                return l if js_truthy(l) else self.eval(e[3], scope, this)
            # ??
            return self.eval(e[3], scope, this) if (l is UNDEF or l is NULL) else l
        if kind == "cond":
            return (self.eval(e[2], scope, this)
                    if js_truthy(self.eval(e[1], scope, this))
                    else self.eval(e[3], scope, this))
        if kind == "assign":
            op, target, rhs = e[1], e[2], e[3]
            if target[0] in ("member", "index"):
                # spec order: the member reference (object, then computed
                # key) evaluates BEFORE the rhs, and exactly once — compound
                # ops must not re-evaluate a side-effecting index
                get, put = self._resolve_ref(target, scope, this)
                if op == "=":
                    v = self.eval(rhs, scope, this)
                else:
                    v = self.binop(op[:-1], get(), self.eval(rhs, scope, this))
                put(v)
                return v
            if op == "=":
                v = self.eval(rhs, scope, this)
            else:
                cur = self.eval(target, scope, this)
                v = self.binop(op[:-1], cur, self.eval(rhs, scope, this))
            self.assign_to(target, v, scope, this)
            return v
        if kind == "seq":
            v = UNDEF
            for sub in e[1]:
                v = self.eval(sub, scope, this)
            return v
        if kind == "spread":
            raise MiniJsError("spread outside call/array")
        raise MiniJsError(f"unsupported expression {kind}")

    def _resolve_ref(self, target: tuple, scope: Scope, this):
        """Evaluate an assignment target to a (get, put) pair with the base
        object and any computed key evaluated exactly ONCE (spec Reference
        semantics: `a[i()] += 1` calls i() once; `o[k()] = v()` runs k before
        v — both caught by the conformance corpus)."""
        kind = target[0]
        if kind == "ident":
            name = target[1]
            return (lambda: self.eval(target, scope, this),
                    lambda v: scope.set_existing(name, v))
        if kind == "member":
            obj = self.eval(target[1], scope, this)
            prop = target[2]
            return (lambda: runtime.get_prop(self, obj, prop),
                    lambda v: runtime.set_prop(self, obj, prop, v))
        if kind == "index":
            obj = self.eval(target[1], scope, this)
            idx = self.eval(target[2], scope, this)
            return (lambda: runtime.get_index(self, obj, idx),
                    lambda v: runtime.set_index(self, obj, idx, v))
        raise MiniJsError(f"unsupported reference target {kind}")

    def assign_to(self, target: tuple, value, scope: Scope, this) -> None:
        kind = target[0]
        if kind == "ident":
            scope.set_existing(target[1], value)
        elif kind == "member":
            obj = self.eval(target[1], scope, this)
            runtime.set_prop(self, obj, target[2], value)
        elif kind == "index":
            obj = self.eval(target[1], scope, this)
            idx = self.eval(target[2], scope, this)
            runtime.set_index(self, obj, idx, value)
        elif kind == "arr":  # destructuring assignment [a, b] = e
            items = list(runtime.js_iter(value))
            for i, el in enumerate(target[1]):
                if el[0] == "undef":
                    continue
                self.assign_to(el, items[i] if i < len(items) else UNDEF,
                               scope, this)
        else:
            raise MiniJsError(f"unsupported assignment target {kind}")

    # ---------------------------------------------------------- operators
    def binop(self, op: str, l, r):
        lbig = isinstance(l, int) and not isinstance(l, bool)
        rbig = isinstance(r, int) and not isinstance(r, bool)
        if op == "+":
            if isinstance(l, str) or isinstance(r, str):
                return js_to_string(l) + js_to_string(r)
            if isinstance(l, (JSArray, JSObject)) or isinstance(r, (JSArray, JSObject)):
                return js_to_string(l) + js_to_string(r)
            if lbig and rbig:
                return l + r
            if lbig or rbig:
                raise JSThrow(_type_error("cannot mix BigInt and other types"))
            return js_to_number(l) + js_to_number(r)
        if op in ("-", "*", "/", "%", "**"):
            if lbig and rbig:
                if op == "-":
                    return l - r
                if op == "*":
                    return l * r
                if op == "/":
                    if r == 0:
                        raise JSThrow(JSObject({"name": "RangeError",
                                                "message": "division by zero"}))
                    q = abs(l) // abs(r)
                    return q if (l < 0) == (r < 0) else -q
                if op == "%":
                    if r == 0:
                        raise JSThrow(JSObject({"name": "RangeError",
                                                "message": "division by zero"}))
                    m = abs(l) % abs(r)
                    return m if l >= 0 else -m
                if op == "**" and r < 0:
                    raise JSThrow(JSObject({
                        "name": "RangeError",
                        "message": "Exponent must be non-negative"}))
                return l ** r
            if lbig or rbig:
                raise JSThrow(_type_error("cannot mix BigInt and other types"))
            a, b = js_to_number(l), js_to_number(r)
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                if b == 0.0:
                    if a != a or a == 0.0:
                        return float("nan")
                    sign = math.copysign(1.0, a) * math.copysign(1.0, b)
                    return float("inf") * sign
                return a / b
            if op == "%":
                if b == 0.0 or a != a or b != b or a in (float("inf"), float("-inf")):
                    return float("nan")
                if a == 0.0:
                    return a
                return math.fmod(a, b)
            from .values import js_pow

            return js_pow(a, b)
        if op in ("==", "!="):
            eq = loose_equals(l, r)
            return eq if op == "==" else not eq
        if op in ("===", "!=="):
            eq = strict_equals(l, r)
            return eq if op == "===" else not eq
        if op in ("<", ">", "<=", ">="):
            if isinstance(l, str) and isinstance(r, str):
                pass  # string compare
            else:
                l = l if lbig else js_to_number(l)
                r = r if rbig else js_to_number(r)
                if (isinstance(l, float) and l != l) or (isinstance(r, float) and r != r):
                    return False
            if op == "<":
                return l < r
            if op == ">":
                return l > r
            if op == "<=":
                return l <= r
            return l >= r
        if op in ("&", "|", "^", "<<", ">>", ">>>"):
            if lbig and rbig:
                if op == "&":
                    return l & r
                if op == "|":
                    return l | r
                if op == "^":
                    return l ^ r
                if op == "<<":
                    return l << r if r >= 0 else l >> -r
                if op == ">>":
                    return l >> r if r >= 0 else l << -r
                raise JSThrow(_type_error("BigInts have no unsigned shift"))
            a = to_int32(js_to_number(l))
            if op == ">>>":
                ua = to_uint32(js_to_number(l))
                sh = to_uint32(js_to_number(r)) & 31
                return float(ua >> sh)
            b = to_int32(js_to_number(r))
            if op == "&":
                return float(a & b)
            if op == "|":
                return float(a | b)
            if op == "^":
                return float(a ^ b)
            sh = to_uint32(js_to_number(r)) & 31
            if op == "<<":
                return float(to_int32(float((a << sh) & 0xFFFFFFFF)))
            return float(a >> sh)
        if op == "instanceof":
            if isinstance(r, JSClass):
                return isinstance(l, JSObject) and l.klass is r
            if isinstance(r, NativeFunction):
                return runtime.native_instanceof(l, r)
            return False
        if op == "in":
            if isinstance(r, JSObject):
                return js_to_string(l) in r.props
            if isinstance(r, JSArray):
                key = js_to_string(l)
                if key == "length":
                    return True
                n = js_to_number(l)
                # finiteness first: int(inf) raises in Python
                if n != n or n in (float("inf"), float("-inf")):
                    return False
                return n == int(n) and 0 <= n < len(r.items)
            return False
        raise MiniJsError(f"unsupported operator {op}")


def strict_equals(l, r) -> bool:
    if isinstance(l, bool) or isinstance(r, bool):
        return type(l) is type(r) and l == r
    if isinstance(l, float) and isinstance(r, float):
        return l == r  # NaN != NaN naturally
    if isinstance(l, int) and isinstance(r, int):
        return l == r
    if isinstance(l, str) and isinstance(r, str):
        return l == r
    if l is UNDEF or l is NULL or r is UNDEF or r is NULL:
        return l is r
    if isinstance(l, (float, int, str)) or isinstance(r, (float, int, str)):
        return False
    return l is r  # objects: reference identity


def loose_equals(l, r) -> bool:
    if (l is UNDEF or l is NULL) and (r is UNDEF or r is NULL):
        return True
    if l is UNDEF or l is NULL or r is UNDEF or r is NULL:
        return False
    lb, rb = isinstance(l, bool), isinstance(r, bool)
    if lb:
        return loose_equals(1.0 if l else 0.0, r)
    if rb:
        return loose_equals(l, 1.0 if r else 0.0)
    if isinstance(l, float) and isinstance(r, str):
        return l == js_to_number(r)
    if isinstance(l, str) and isinstance(r, float):
        return js_to_number(l) == r
    if isinstance(l, int) and isinstance(r, float):
        # non-finite floats never equal a BigInt (int(inf) would raise)
        if r != r or r in (float("inf"), float("-inf")):
            return False
        return r == int(r) and l == int(r)
    if isinstance(l, float) and isinstance(r, int):
        return loose_equals(r, l)
    if isinstance(l, int) and isinstance(r, str):
        try:
            return l == int(r.strip() or "x")
        except ValueError:
            return False
    if isinstance(l, str) and isinstance(r, int):
        return loose_equals(r, l)
    # object == primitive: ToPrimitive(object) then retry ([] == false is
    # true via "" -> 0 == 0; spec step 11/12 of IsLooselyEqual). Plain
    # objects/arrays have no valueOf here, so ToPrimitive is ToString.
    l_obj = isinstance(l, (JSArray, JSObject, JSTypedArray))
    r_obj = isinstance(r, (JSArray, JSObject, JSTypedArray))
    if l_obj and isinstance(r, (float, int, str)):
        return loose_equals(js_to_string(l), r)
    if r_obj and isinstance(l, (float, int, str)):
        return loose_equals(l, js_to_string(r))
    return strict_equals(l, r)
