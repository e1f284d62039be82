"""minijs lexer.

Produces Token tuples; template literals come out as a single 'template'
token whose parts hold raw ${...} sub-sources (the parser lexes those
recursively). No regex literals — interp.js has none, and rejecting them
keeps `/` unambiguous (always the divide operator here).
"""

from typing import List, NamedTuple, Union

from .errors import MiniJsError


class Token(NamedTuple):
    kind: str  # 'num' | 'bigint' | 'str' | 'template' | 'ident' | 'punct' | 'eof'
    value: Union[str, float, int, list]
    line: int
    nl_before: bool  # a newline appeared between previous token and this one


# longest-match-first punctuators (subset interp.js uses, plus the cheap rest)
PUNCTS = [
    ">>>=", "...", "===", "!==", "**=", "<<=", ">>=", ">>>",
    "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "**", "++", "--",
    "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "<<", ">>",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/",
    "%", "&", "|", "^", "!", "~", "?", ":", "=", ".", "`",
]

_ID_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_$")
_ID_CONT = _ID_START | set("0123456789")

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v",
            "0": "\0", "'": "'", '"': '"', "`": "`", "\\": "\\", "\n": ""}


class Lexer:
    def __init__(self, src: str, line: int = 1):
        self.src = src
        self.i = 0
        self.line = line
        self.n = len(src)

    def error(self, msg: str) -> MiniJsError:
        return MiniJsError(msg, self.line)

    # ------------------------------------------------------------- scanning
    def _skip_ws(self) -> bool:
        """Skip whitespace/comments; return True if a newline was crossed."""
        nl = False
        s, n = self.src, self.n
        while self.i < n:
            c = s[self.i]
            if c == "\n":
                nl = True
                self.line += 1
                self.i += 1
            elif c in " \t\r\f\v":
                self.i += 1
            elif c == "/" and self.i + 1 < n and s[self.i + 1] == "/":
                j = s.find("\n", self.i)
                self.i = n if j < 0 else j
            elif c == "/" and self.i + 1 < n and s[self.i + 1] == "*":
                j = s.find("*/", self.i + 2)
                if j < 0:
                    raise self.error("unterminated block comment")
                nl = nl or ("\n" in s[self.i:j])
                self.line += s.count("\n", self.i, j)
                self.i = j + 2
            else:
                break
        return nl

    def _string(self, quote: str) -> str:
        s = self.src
        out: List[str] = []
        self.i += 1
        while self.i < self.n:
            c = s[self.i]
            if c == quote:
                self.i += 1
                return "".join(out)
            if c == "\n":
                raise self.error("unterminated string")
            if c == "\\":
                out.append(self._escape())
            else:
                out.append(c)
                self.i += 1
        raise self.error("unterminated string")

    def _escape(self) -> str:
        """Decode the escape sequence at self.i (pointing at the backslash);
        shared by quoted strings and template literals."""
        s = self.src
        self.i += 1
        e = s[self.i]
        if e == "u":
            if s[self.i + 1] == "{":
                j = s.find("}", self.i)
                out = chr(int(s[self.i + 2:j], 16))
                self.i = j + 1
                return out
            out = chr(int(s[self.i + 1:self.i + 5], 16))
            self.i += 5
            return out
        if e == "x":
            out = chr(int(s[self.i + 1:self.i + 3], 16))
            self.i += 3
            return out
        self.i += 1
        if e == "\n":
            self.line += 1
        return _ESCAPES.get(e, e)

    def _template(self) -> list:
        """Scan `...` into parts: ('str', cooked) | ('expr', raw, line)."""
        s = self.src
        parts: list = []
        buf: List[str] = []
        self.i += 1  # consume backtick
        while self.i < self.n:
            c = s[self.i]
            if c == "`":
                self.i += 1
                if buf:
                    parts.append(("str", "".join(buf)))
                return parts
            if c == "\\":
                buf.append(self._escape())
                continue
            if c == "$" and self.i + 1 < self.n and s[self.i + 1] == "{":
                if buf:
                    parts.append(("str", "".join(buf)))
                    buf = []
                depth = 1
                j = self.i + 2
                start = j
                exp_line = self.line
                while j < self.n and depth:
                    cj = s[j]
                    if cj == "{":
                        depth += 1
                    elif cj == "}":
                        depth -= 1
                        if depth == 0:
                            break
                    elif cj in "'\"":
                        q = cj
                        j += 1
                        while j < self.n and s[j] != q:
                            j += 2 if s[j] == "\\" else 1
                    elif cj == "`":
                        # nested template: skip it whole, including its own
                        # ${...} holes (recursive raw scan); the expression
                        # substring re-tokenizes through the normal path, so
                        # arbitrary nesting parses
                        j = self._skip_template_raw(j) - 1
                    elif cj == "\n":
                        self.line += 1
                    j += 1
                if depth:
                    raise self.error("unterminated ${...} in template")
                parts.append(("expr", s[start:j], exp_line))
                self.i = j + 1
                continue
            if c == "\n":
                self.line += 1
            buf.append(c)
            self.i += 1
        raise self.error("unterminated template literal")

    def _skip_template_raw(self, j: int) -> int:
        """Raw scan: `j` at a backtick; return the index just past the
        template's closing backtick, skipping escapes, quoted strings inside
        holes, and recursively nested templates."""
        s = self.src
        j += 1
        while j < self.n:
            c = s[j]
            if c == "\\":
                j += 2
                continue
            if c == "\n":
                self.line += 1
            if c == "`":
                return j + 1
            if c == "$" and j + 1 < self.n and s[j + 1] == "{":
                depth = 1
                j += 2
                while j < self.n and depth:
                    cj = s[j]
                    if cj == "\\":
                        j += 2
                        continue
                    if cj == "\n":
                        self.line += 1
                    if cj == "{":
                        depth += 1
                    elif cj == "}":
                        depth -= 1
                    elif cj in "'\"":
                        q = cj
                        j += 1
                        while j < self.n and s[j] != q:
                            j += 2 if s[j] == "\\" else 1
                    elif cj == "`":
                        j = self._skip_template_raw(j) - 1
                    j += 1
                continue
            j += 1
        raise self.error("unterminated template literal")

    def _number(self) -> Token:
        s = self.src
        start = self.i
        radix = {"x": (16, "0123456789abcdefABCDEF"), "b": (2, "01"),
                 "o": (8, "01234567")}
        if (s[self.i] == "0" and self.i + 1 < self.n
                and s[self.i + 1].lower() in radix):
            base, alphabet = radix[s[self.i + 1].lower()]
            self.i += 2
            while self.i < self.n and s[self.i] in alphabet:
                self.i += 1
            if self.i < self.n and s[self.i] == "n":
                self.i += 1
                return Token("bigint", int(s[start:self.i - 1], base), self.line, False)
            return Token("num", float(int(s[start:self.i], base)), self.line, False)
        while self.i < self.n and s[self.i].isdigit():
            self.i += 1
        is_float = False
        if self.i < self.n and s[self.i] == "." and self.i + 1 < self.n and s[self.i + 1].isdigit():
            is_float = True
            self.i += 1
            while self.i < self.n and s[self.i].isdigit():
                self.i += 1
        if self.i < self.n and s[self.i] in "eE":
            is_float = True
            self.i += 1
            if self.i < self.n and s[self.i] in "+-":
                self.i += 1
            while self.i < self.n and s[self.i].isdigit():
                self.i += 1
        if not is_float and self.i < self.n and s[self.i] == "n":
            self.i += 1
            return Token("bigint", int(s[start:self.i - 1]), self.line, False)
        return Token("num", float(s[start:self.i]), self.line, False)

    def tokens(self) -> List[Token]:
        out: List[Token] = []
        while True:
            nl = self._skip_ws()
            if self.i >= self.n:
                out.append(Token("eof", "", self.line, nl))
                return out
            c = self.src[self.i]
            line = self.line
            if c in "'\"":
                out.append(Token("str", self._string(c), line, nl))
            elif c == "`":
                out.append(Token("template", self._template(), line, nl))
            elif c.isdigit() or (c == "." and self.i + 1 < self.n and self.src[self.i + 1].isdigit()):
                t = self._number()
                out.append(Token(t.kind, t.value, line, nl))
            elif c in _ID_START:
                j = self.i + 1
                while j < self.n and self.src[j] in _ID_CONT:
                    j += 1
                out.append(Token("ident", self.src[self.i:j], line, nl))
                self.i = j
            else:
                for p in PUNCTS:
                    if self.src.startswith(p, self.i):
                        # spec: `?.` followed by a digit is `?` then `.5`
                        # (ternary with a fractional literal), not optional
                        # chaining
                        if (p == "?." and self.i + 2 < self.n
                                and self.src[self.i + 2].isdigit()):
                            p = "?"
                        out.append(Token("punct", p, line, nl))
                        self.i += len(p)
                        break
                else:
                    raise self.error(f"unexpected character {c!r}")
