"""minijs parser — recursive descent with precedence climbing.

AST nodes are plain tuples (first element = node kind); the evaluator
dispatches on that. Covers the strict-mode ES2020 subset described in
__init__.py; anything outside raises MiniJsError with a line number.
"""

from typing import List, Optional

from .errors import MiniJsError
from .lexer import Lexer, Token

KEYWORDS = {
    "var", "let", "const", "function", "class", "return", "if", "else",
    "for", "while", "do", "break", "continue", "throw", "try", "catch",
    "finally", "switch", "case", "default", "new", "typeof", "instanceof",
    "in", "of", "this", "null", "undefined", "true", "false", "void",
    "delete", "await", "async", "static", "extends", "super", "yield",
}

# binary operator precedence (higher binds tighter)
BINOPS = {
    "??": 1, "||": 2, "&&": 3, "|": 4, "^": 5, "&": 6,
    "==": 7, "!=": 7, "===": 7, "!==": 7,
    "<": 8, ">": 8, "<=": 8, ">=": 8, "instanceof": 8, "in": 8,
    "<<": 9, ">>": 9, ">>>": 9,
    "+": 10, "-": 10,
    "*": 11, "/": 11, "%": 11,
    "**": 12,
}
LOGICAL = {"&&", "||", "??"}
ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<=", ">>=", ">>>=", "**="}


class Parser:
    def __init__(self, src: str, line: int = 1):
        self.toks: List[Token] = Lexer(src, line).tokens()
        self.pos = 0

    # ------------------------------------------------------------- plumbing
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value=None) -> Optional[Token]:
        if self.at(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if not self.at(kind, value):
            raise MiniJsError(f"expected {value or kind}, got {t.kind} {t.value!r}", t.line)
        return self.next()

    def error(self, msg: str) -> MiniJsError:
        return MiniJsError(msg, self.peek().line)

    def _semi(self) -> None:
        """Consume `;` — or apply ASI (newline / `}` / EOF)."""
        if self.eat("punct", ";"):
            return
        t = self.peek()
        if t.kind == "eof" or (t.kind == "punct" and t.value == "}") or t.nl_before:
            return
        raise self.error(f"missing semicolon before {t.value!r}")

    # ------------------------------------------------------------- programs
    def parse_program(self) -> tuple:
        stmts = []
        while not self.at("eof"):
            stmts.append(self.parse_statement())
        return ("block", stmts)

    # ------------------------------------------------------- statements
    def parse_statement(self) -> tuple:
        t = self.peek()
        if t.kind == "punct":
            if t.value == "{":
                return self.parse_block()
            if t.value == ";":
                self.next()
                return ("empty",)
        if t.kind == "ident":
            v = t.value
            if v in ("let", "const", "var"):
                node = self.parse_var_decl()
                self._semi()
                return node
            if v == "function":
                return self.parse_function_decl(is_async=False)
            if v == "async" and self.at("ident", "function", 1):
                self.next()
                return self.parse_function_decl(is_async=True)
            if v == "class":
                return self.parse_class(decl=True)
            if v == "if":
                return self.parse_if()
            if v == "for":
                return self.parse_for()
            if v == "while":
                self.next()
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                return ("while", cond, self.parse_statement())
            if v == "do":
                self.next()
                body = self.parse_statement()
                self.expect("ident", "while")
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                self._semi()
                return ("dowhile", body, cond)
            if v == "return":
                self.next()
                nt = self.peek()
                if nt.nl_before or (nt.kind == "punct" and nt.value in (";", "}")) or nt.kind == "eof":
                    self._semi()
                    return ("return", None)
                e = self.parse_expression()
                self._semi()
                return ("return", e)
            if v == "break":
                self.next()
                nt = self.peek()
                if (nt.kind == "ident" and not nt.nl_before
                        and nt.value not in KEYWORDS):
                    self.next()
                    self._semi()
                    return ("break", nt.value)
                self._semi()
                return ("break",)
            if v == "continue":
                self.next()
                nt = self.peek()
                if (nt.kind == "ident" and not nt.nl_before
                        and nt.value not in KEYWORDS):
                    self.next()
                    self._semi()
                    return ("continue", nt.value)
                self._semi()
                return ("continue",)
            if v == "throw":
                self.next()
                e = self.parse_expression()
                self._semi()
                return ("throw", e)
            if v == "try":
                return self.parse_try()
            if v == "switch":
                return self.parse_switch()
            # labeled statement: `name: stmt` (spec LabelledStatement)
            if (v not in KEYWORDS and self.at("punct", ":", 1)):
                self.next()
                self.next()
                return ("label", v, self.parse_statement())
        e = self.parse_expression()
        self._semi()
        return ("expr", e)

    def parse_block(self) -> tuple:
        self.expect("punct", "{")
        stmts = []
        while not self.at("punct", "}"):
            if self.at("eof"):
                raise self.error("unterminated block")
            stmts.append(self.parse_statement())
        self.next()
        return ("block", stmts)

    def parse_var_decl(self) -> tuple:
        kind = self.next().value
        decls = []
        while True:
            pat = self.parse_pattern()
            init = None
            if self.eat("punct", "="):
                init = self.parse_assignment()
            decls.append((pat, init))
            if not self.eat("punct", ","):
                break
        return ("var", kind, decls)

    def parse_function_decl(self, is_async: bool) -> tuple:
        self.expect("ident", "function")
        name = self.expect("ident").value
        params = self.parse_params()
        body = self.parse_block()
        return ("funcdecl", name, params, body, is_async)

    def parse_params(self) -> list:
        self.expect("punct", "(")
        params = []
        while not self.at("punct", ")"):
            if self.eat("punct", "..."):
                params.append(("prest", self.parse_pattern()))
            else:
                pat = self.parse_pattern()
                if self.eat("punct", "="):
                    pat = ("pdefault", pat, self.parse_assignment())
                params.append(pat)
            if not self.eat("punct", ","):
                break
        self.expect("punct", ")")
        return params

    def parse_pattern(self) -> tuple:
        t = self.peek()
        if t.kind == "ident" and (t.value not in KEYWORDS or t.value in ("of", "async", "static")):
            self.next()
            return ("pid", t.value)
        if self.at("punct", "["):
            self.next()
            elems = []
            while not self.at("punct", "]"):
                if self.at("punct", ","):
                    elems.append(None)  # hole
                elif self.eat("punct", "..."):
                    elems.append(("prest", self.parse_pattern()))
                else:
                    pat = self.parse_pattern()
                    if self.eat("punct", "="):
                        pat = ("pdefault", pat, self.parse_assignment())
                    elems.append(pat)
                if not self.eat("punct", ","):
                    break
            self.expect("punct", "]")
            return ("parr", elems)
        if self.at("punct", "{"):
            self.next()
            props = []
            while not self.at("punct", "}"):
                key = self.expect("ident").value
                pat = ("pid", key)
                if self.eat("punct", ":"):
                    pat = self.parse_pattern()
                if self.eat("punct", "="):
                    pat = ("pdefault", pat, self.parse_assignment())
                props.append((key, pat))
                if not self.eat("punct", ","):
                    break
            self.expect("punct", "}")
            return ("pobj", props)
        raise self.error(f"invalid binding pattern at {t.value!r}")

    def parse_if(self) -> tuple:
        self.expect("ident", "if")
        self.expect("punct", "(")
        cond = self.parse_expression()
        self.expect("punct", ")")
        then = self.parse_statement()
        other = None
        if self.eat("ident", "else"):
            other = self.parse_statement()
        return ("if", cond, then, other)

    def parse_for(self) -> tuple:
        self.expect("ident", "for")
        self.expect("punct", "(")
        init = None
        if not self.at("punct", ";"):
            if self.at("ident", "let") or self.at("ident", "const") or self.at("ident", "var"):
                decl = self.parse_var_decl()
                if self.at("ident", "of") or self.at("ident", "in"):
                    word = self.next().value
                    if len(decl[2]) != 1 or decl[2][0][1] is not None:
                        raise self.error(f"bad for-{word} binding")
                    it = self.parse_expression()
                    self.expect("punct", ")")
                    return ("for" + word, decl[1], decl[2][0][0], it, self.parse_statement())
                init = decl
            else:
                e = self.parse_expression()
                # `for (k in obj)` with an already-declared k: the expression
                # parser consumed `k in obj` as the binary 'in' operator —
                # recover the for-in form from the AST shape
                if (isinstance(e, tuple) and e[0] == "binary" and e[1] == "in"
                        and self.at("punct", ")")):
                    self.next()
                    pat = self._expr_to_pattern(e[2])
                    return ("forin", None, pat, e[3], self.parse_statement())
                if self.at("ident", "of") or self.at("ident", "in"):
                    word = self.next().value
                    it = self.parse_expression()
                    self.expect("punct", ")")
                    pat = self._expr_to_pattern(e)
                    return ("for" + word, None, pat, it, self.parse_statement())
                init = ("expr", e)
        self.expect("punct", ";")
        test = None if self.at("punct", ";") else self.parse_expression()
        self.expect("punct", ";")
        update = None if self.at("punct", ")") else self.parse_expression()
        self.expect("punct", ")")
        return ("for", init, test, update, self.parse_statement())

    def _expr_to_pattern(self, e: tuple) -> tuple:
        if e[0] == "ident":
            return ("pid", e[1])
        raise self.error("unsupported for-of/in target")

    def parse_try(self) -> tuple:
        self.expect("ident", "try")
        block = self.parse_block()
        param = None
        catch = None
        fin = None
        if self.eat("ident", "catch"):
            if self.eat("punct", "("):
                param = self.parse_pattern()
                self.expect("punct", ")")
            catch = self.parse_block()
        if self.eat("ident", "finally"):
            fin = self.parse_block()
        if catch is None and fin is None:
            raise self.error("try without catch/finally")
        return ("try", block, param, catch, fin)

    def parse_switch(self) -> tuple:
        self.expect("ident", "switch")
        self.expect("punct", "(")
        disc = self.parse_expression()
        self.expect("punct", ")")
        self.expect("punct", "{")
        cases = []
        while not self.at("punct", "}"):
            if self.eat("ident", "case"):
                test = self.parse_expression()
            else:
                self.expect("ident", "default")
                test = None
            self.expect("punct", ":")
            stmts = []
            while not (self.at("punct", "}") or self.at("ident", "case") or self.at("ident", "default")):
                stmts.append(self.parse_statement())
            cases.append((test, stmts))
        self.next()
        return ("switch", disc, cases)

    # ------------------------------------------------------- expressions
    def parse_expression(self) -> tuple:
        e = self.parse_assignment()
        if self.at("punct", ","):
            exprs = [e]
            while self.eat("punct", ","):
                exprs.append(self.parse_assignment())
            return ("seq", exprs)
        return e

    def _arrow_ahead(self) -> bool:
        """At '(': does the matching ')' lead to '=>'? (arrow lookahead)."""
        depth = 0
        k = 0
        while True:
            t = self.peek(k)
            if t.kind == "eof":
                return False
            if t.kind == "punct":
                if t.value in ("(", "[", "{"):
                    depth += 1
                elif t.value in (")", "]", "}"):
                    depth -= 1
                    if depth == 0:
                        nxt = self.peek(k + 1)
                        return nxt.kind == "punct" and nxt.value == "=>"
            k += 1

    def parse_assignment(self) -> tuple:
        t = self.peek()
        # arrow functions: ident => ..., (params) => ..., async (params) => ...
        if t.kind == "ident" and t.value == "async" and not self.peek(1).nl_before:
            if self.at("punct", "(", 1):
                save = self.pos
                self.next()
                if self._arrow_ahead():
                    params = self.parse_params()
                    self.expect("punct", "=>")
                    return self._arrow_body(params, is_async=True)
                self.pos = save
            elif self.at("ident", 1) and self.at("punct", "=>", 2):
                self.next()
                name = self.next().value
                self.expect("punct", "=>")
                return self._arrow_body([("pid", name)], is_async=True)
        if (t.kind == "ident" and t.value not in KEYWORDS
                and self.at("punct", "=>", 1)):
            self.next()
            self.next()
            return self._arrow_body([("pid", t.value)], is_async=False)
        if t.kind == "punct" and t.value == "(" and self._arrow_ahead():
            params = self.parse_params()
            self.expect("punct", "=>")
            return self._arrow_body(params, is_async=False)

        left = self.parse_conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in ASSIGN_OPS:
            self.next()
            right = self.parse_assignment()
            if left[0] not in ("ident", "member", "index", "arr", "obj"):
                raise self.error("invalid assignment target")
            return ("assign", t.value, left, right)
        return left

    def _arrow_body(self, params: list, is_async: bool) -> tuple:
        if self.at("punct", "{"):
            body = self.parse_block()
            return ("arrow", params, body, False, is_async)
        body = self.parse_assignment()
        return ("arrow", params, body, True, is_async)

    def parse_conditional(self) -> tuple:
        cond = self.parse_binary(0)
        if self.eat("punct", "?"):
            then = self.parse_assignment()
            self.expect("punct", ":")
            other = self.parse_assignment()
            return ("cond", cond, then, other)
        return cond

    def parse_binary(self, min_prec: int) -> tuple:
        left = self.parse_unary()
        while True:
            t = self.peek()
            op = None
            if t.kind == "punct" and t.value in BINOPS:
                op = t.value
            elif t.kind == "ident" and t.value in ("instanceof", "in") and t.value in BINOPS:
                op = t.value
            if op is None:
                return left
            prec = BINOPS[op]
            if prec < min_prec:
                return left
            self.next()
            # ** is right-associative; everything else left
            right = self.parse_binary(prec if op == "**" else prec + 1)
            kind = "logical" if op in LOGICAL else "binary"
            left = (kind, op, left, right)

    def parse_unary(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "-", "+", "~"):
            self.next()
            return ("unary", t.value, self.parse_unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("update", t.value, self.parse_unary(), True)
        if t.kind == "ident" and t.value in ("typeof", "void", "delete", "await"):
            self.next()
            if t.value == "await":
                return ("await", self.parse_unary())
            return ("unary", t.value, self.parse_unary())
        e = self.parse_postfix()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") and not t.nl_before:
            self.next()
            return ("update", t.value, e, False)
        return e

    def parse_postfix(self) -> tuple:
        if self.at("ident", "new"):
            self.next()
            callee = self.parse_member_chain(self.parse_primary(), no_call=True)
            args = self.parse_args() if self.at("punct", "(") else []
            e = ("new", callee, args)
            return self.parse_member_chain(e)
        return self.parse_member_chain(self.parse_primary())

    def parse_member_chain(self, e: tuple, no_call: bool = False) -> tuple:
        has_opt = False
        while True:
            if self.eat("punct", "."):
                name = self.expect("ident").value
                e = ("member", e, name)
            elif self.eat("punct", "?."):
                has_opt = True
                if self.at("punct", "["):
                    self.next()
                    idx = self.parse_expression()
                    self.expect("punct", "]")
                    e = ("optindex", e, idx)
                elif self.at("punct", "(") and not no_call:
                    e = ("optcall", e, self.parse_args())
                else:
                    e = ("optmember", e, self.expect("ident").value)
            elif self.at("punct", "["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                e = ("index", e, idx)
            elif self.at("punct", "(") and not no_call:
                e = ("call", e, self.parse_args())
            else:
                # one optional link short-circuits the whole chain: wrap it
                # so the interpreter has a catch boundary (spec
                # OptionalExpression coverage)
                return ("optchain", e) if has_opt else e

    def parse_args(self) -> list:
        self.expect("punct", "(")
        args = []
        while not self.at("punct", ")"):
            if self.eat("punct", "..."):
                args.append(("spread", self.parse_assignment()))
            else:
                args.append(self.parse_assignment())
            if not self.eat("punct", ","):
                break
        self.expect("punct", ")")
        return args

    def parse_primary(self) -> tuple:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ("num", t.value)
        if t.kind == "bigint":
            self.next()
            return ("bigint", t.value)
        if t.kind == "str":
            self.next()
            return ("str", t.value)
        if t.kind == "template":
            self.next()
            parts = []
            for p in t.value:
                if p[0] == "str":
                    parts.append(("str", p[1]))
                else:
                    sub = Parser(p[1], p[2])
                    parts.append(("expr", sub.parse_expression()))
                    if not sub.at("eof"):
                        raise MiniJsError("trailing tokens in template expression", p[2])
            return ("tmpl", parts)
        if t.kind == "punct":
            if t.value == "(":
                self.next()
                e = self.parse_expression()
                self.expect("punct", ")")
                return e
            if t.value == "[":
                self.next()
                elems = []
                while not self.at("punct", "]"):
                    if self.at("punct", ","):
                        elems.append(("undef",))  # hole
                    elif self.eat("punct", "..."):
                        elems.append(("spread", self.parse_assignment()))
                    else:
                        elems.append(self.parse_assignment())
                    if not self.eat("punct", ","):
                        break
                self.expect("punct", "]")
                return ("arr", elems)
            if t.value == "{":
                return self.parse_object_literal()
        if t.kind == "ident":
            v = t.value
            if v == "function":
                self.next()
                name = self.eat("ident")
                params = self.parse_params()
                body = self.parse_block()
                return ("func", name.value if name else None, params, body, False)
            if v == "async" and self.at("ident", "function", 1):
                self.next()
                self.next()
                name = self.eat("ident")
                params = self.parse_params()
                body = self.parse_block()
                return ("func", name.value if name else None, params, body, True)
            if v == "class":
                return self.parse_class(decl=False)
            if v == "this":
                self.next()
                return ("this",)
            if v == "null":
                self.next()
                return ("null",)
            if v == "undefined":
                self.next()
                return ("undef",)
            if v == "true":
                self.next()
                return ("bool", True)
            if v == "false":
                self.next()
                return ("bool", False)
            if v not in KEYWORDS or v in ("of", "async", "static", "await"):
                self.next()
                return ("ident", v)
        raise self.error(f"unexpected token {t.value!r}")

    def parse_object_literal(self) -> tuple:
        self.expect("punct", "{")
        props = []
        while not self.at("punct", "}"):
            if self.eat("punct", "..."):
                props.append(("spread", self.parse_assignment()))
                if not self.eat("punct", ","):
                    break
                continue
            t = self.peek()
            if t.kind in ("str", "num"):
                self.next()
                key = t.value if t.kind == "str" else _numkey(t.value)
            elif t.kind == "ident":
                self.next()
                key = t.value
                # accessor: `get name() {...}` / `set name(v) {...}`
                if key in ("get", "set") and (
                        self.at("ident") or self.at("str") or self.at("num")):
                    kt = self.next()
                    aname = kt.value if kt.kind != "num" else _numkey(kt.value)
                    params = self.parse_params()
                    body = self.parse_block()
                    props.append((key + "ter", aname,
                                  ("func", aname, params, body, False)))
                    if not self.eat("punct", ","):
                        break
                    continue
            elif self.at("punct", "["):
                self.next()
                keyexpr = self.parse_assignment()
                self.expect("punct", "]")
                self.expect("punct", ":")
                props.append(("computed", keyexpr, self.parse_assignment()))
                if not self.eat("punct", ","):
                    break
                continue
            else:
                raise self.error(f"bad object key {t.value!r}")
            if self.eat("punct", ":"):
                props.append(("prop", key, self.parse_assignment()))
            elif self.at("punct", "("):
                params = self.parse_params()
                body = self.parse_block()
                props.append(("prop", key, ("func", key, params, body, False)))
            else:
                props.append(("prop", key, ("ident", key)))  # shorthand
            if not self.eat("punct", ","):
                break
        self.expect("punct", "}")
        return ("obj", props)

    def parse_class(self, decl: bool) -> tuple:
        self.expect("ident", "class")
        name = None
        if self.at("ident") and self.peek().value not in KEYWORDS:
            name = self.next().value
        if self.at("ident", "extends"):
            raise self.error("class inheritance unsupported")
        self.expect("punct", "{")
        members = []
        while not self.at("punct", "}"):
            if self.eat("punct", ";"):
                continue
            is_static = False
            is_async = False
            if self.at("ident", "static") and not self.at("punct", "(", 1):
                self.next()
                is_static = True
            if self.at("ident", "async") and not self.at("punct", "(", 1):
                self.next()
                is_async = True
            mname = self.next()
            if mname.kind != "ident" and mname.kind != "str":
                raise self.error(f"bad class member {mname.value!r}")
            if self.at("punct", "("):
                params = self.parse_params()
                body = self.parse_block()
                members.append(("method", mname.value, params, body, is_static, is_async))
            elif self.eat("punct", "="):
                init = self.parse_assignment()
                self._semi()
                members.append(("field", mname.value, init, is_static))
            else:
                raise self.error("bad class member")
        self.next()
        return ("classdecl" if decl else "classexpr", name, members)


def _numkey(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


def parse(src: str) -> tuple:
    return Parser(src).parse_program()
