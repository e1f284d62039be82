"""minijs error types.

MiniJsError: the engine itself cannot proceed (syntax error, unsupported
construct, host misuse). These are Python-level bugs/limits, never JS flow.

JSThrow: a JavaScript `throw` in flight — carries the thrown JS value and
unwinds through the evaluator until a `try`/`catch` catches it (or it
escapes to the host, where str() renders the Error message).
"""


class MiniJsError(Exception):
    """Engine-level failure: syntax error or unsupported construct."""

    def __init__(self, msg: str, line: int = 0):
        super().__init__(f"{msg} (line {line})" if line else msg)
        self.line = line


class JSThrow(Exception):
    """A JS exception value propagating (JS `throw`)."""

    def __init__(self, value):
        self.value = value
        super().__init__(self._render())

    def _render(self) -> str:
        v = self.value
        # late import to avoid a cycle at module load
        from .values import JSObject

        if isinstance(v, JSObject) and "message" in v.props:
            name = v.props.get("name", "Error")
            return f"{name}: {v.props['message']}"
        return repr(v)
