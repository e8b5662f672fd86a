"""Schema-free protobuf text-format (prototxt) parser and serializer.

The reference parses prototxt through protoc-generated classes on the C++
side and re-serializes for the JVM (ref: libccaffe/ccaffe.cpp:275-296,
src/main/scala/libs/ProtoLoader.scala:8-29).  We need no generated code:
prototxt is a simple recursive token format, and the compiler interprets
fields by name.  This keeps the framework free of a protoc build step and of
any vendored schema; the subset of ``caffe.proto`` semantics we honor is
encoded in the layer/solver interpreters, not here.

Grammar handled:
  message  := field*
  field    := NAME ':' value | NAME body | NAME ':' body
  body     := '{' message '}'
  value    := number | string ('"..."' or "'...'", adjacent strings concat)
            | bool (true/false) | enum identifier | '[' value (',' value)* ']'
Comments run '#' to end of line.  Repeated fields accumulate in order.
"""

from __future__ import annotations

from typing import Any, Iterator


class Message:
    """An ordered multi-map of field name -> list of values.

    Values are Python scalars (int/float/bool/str) or nested ``Message``.
    Enum identifiers are stored as their bare string (e.g. ``"TRAIN"``).
    """

    __slots__ = ("fields",)

    def __init__(self, fields: dict[str, list[Any]] | None = None):
        self.fields: dict[str, list[Any]] = fields if fields is not None else {}

    # -- write ------------------------------------------------------------
    def add(self, name: str, value: Any) -> "Message":
        self.fields.setdefault(name, []).append(value)
        return self

    def set(self, name: str, value: Any) -> "Message":
        self.fields[name] = [value]
        return self

    # -- read -------------------------------------------------------------
    def get(self, name: str, default: Any = None) -> Any:
        """Last value wins for optional scalar fields (proto semantics)."""
        vals = self.fields.get(name)
        return vals[-1] if vals else default

    def get_all(self, name: str) -> list[Any]:
        return list(self.fields.get(name, []))

    def get_msg(self, name: str) -> "Message":
        """Nested message field, or an empty Message if absent."""
        v = self.get(name)
        return v if isinstance(v, Message) else Message()

    def get_int(self, name: str, default: int = 0) -> int:
        v = self.get(name)
        return default if v is None else int(v)

    def get_float(self, name: str, default: float = 0.0) -> float:
        v = self.get(name)
        return default if v is None else float(v)

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self.get(name)
        if v is None:
            return default
        if isinstance(v, str):
            return v.lower() == "true" or v == "1"
        return bool(v)

    def get_str(self, name: str, default: str = "") -> str:
        v = self.get(name)
        return default if v is None else str(v)

    def has(self, name: str) -> bool:
        return bool(self.fields.get(name))

    def __contains__(self, name: str) -> bool:
        return self.has(name)

    def __repr__(self) -> str:
        return f"Message({serialize(self, indent=0)!r})"

    def copy(self) -> "Message":
        out = Message()
        for k, vals in self.fields.items():
            out.fields[k] = [v.copy() if isinstance(v, Message) else v for v in vals]
        return out


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT = "{}[]:,<>"


def _tokens(text: str) -> Iterator[tuple[str, Any]]:
    """Yields (kind, value): kind in {'punct','ident','number','string'}."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in _PUNCT:
            yield ("punct", c)
            i += 1
        elif c in "\"'":
            quote = c
            i += 1
            buf = []
            while i < n and text[i] != quote:
                if text[i] == "\\" and i + 1 < n:
                    esc = text[i + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(esc, esc))
                    i += 2
                else:
                    buf.append(text[i])
                    i += 1
            i += 1  # closing quote
            yield ("string", "".join(buf))
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_."):
                j += 1
            yield ("ident", text[i:j])
            i = j
        elif c.isdigit() or c in "+-.":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] in "+-."):
                # allow 1e-5, 0x1F, 3.14, -7
                j += 1
            yield ("number", text[i:j])
            i = j
        else:
            raise ValueError(f"prototxt lex error at char {i}: {text[i:i+20]!r}")


def _coerce_number(tok: str) -> int | float:
    try:
        if tok.lower().startswith(("0x", "-0x", "+0x")):
            return int(tok, 16)
        return int(tok)
    except ValueError:
        return float(tok)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokens(text))
        self.pos = 0

    def peek(self) -> tuple[str, Any] | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> tuple[str, Any]:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def expect_punct(self, ch: str) -> None:
        kind, val = self.next()
        if kind != "punct" or val != ch:
            raise ValueError(f"expected {ch!r}, got {val!r} (token {self.pos})")

    def parse_message(self, closing: str | None = None) -> Message:
        msg = Message()
        while True:
            tok = self.peek()
            if tok is None:
                if closing is not None:
                    raise ValueError(f"unexpected EOF, expected {closing!r}")
                return msg
            if tok == ("punct", closing):
                self.next()
                return msg
            kind, name = self.next()
            if kind != "ident":
                raise ValueError(f"expected field name, got {name!r}")
            tok = self.peek()
            if tok == ("punct", ":"):
                self.next()
                tok = self.peek()
                if tok in (("punct", "{"), ("punct", "<")):
                    msg.add(name, self._parse_body())
                elif tok == ("punct", "["):
                    self.next()
                    for v in self._parse_list():
                        msg.add(name, v)
                else:
                    msg.add(name, self._parse_scalar())
            elif tok in (("punct", "{"), ("punct", "<")):
                msg.add(name, self._parse_body())
            else:
                raise ValueError(f"expected ':' or '{{' after {name!r}")

    def _parse_body(self) -> Message:
        kind, val = self.next()
        closing = "}" if val == "{" else ">"
        return self.parse_message(closing=closing)

    def _parse_list(self) -> list[Any]:
        vals: list[Any] = []
        while True:
            tok = self.peek()
            if tok == ("punct", "]"):
                self.next()
                return vals
            if tok == ("punct", ","):
                self.next()
                continue
            if tok in (("punct", "{"), ("punct", "<")):
                vals.append(self._parse_body())
            else:
                vals.append(self._parse_scalar())

    def _parse_scalar(self) -> Any:
        kind, val = self.next()
        if kind == "number":
            return _coerce_number(val)
        if kind == "string":
            # adjacent string literals concatenate (proto text rule)
            while self.peek() is not None and self.peek()[0] == "string":
                val += self.next()[1]
            return val
        if kind == "ident":
            if val == "true":
                return True
            if val == "false":
                return False
            return val  # enum identifier, stored as string
        raise ValueError(f"unexpected token {val!r} as value")


def parse(text: str) -> Message:
    return _Parser(text).parse_message()


def parse_file(path: str) -> Message:
    with open(path, "r") as f:
        return parse(f.read())


# ---------------------------------------------------------------------------
# Serializer
# ---------------------------------------------------------------------------


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s and s.isidentifier() and s.upper() == s:
        # heuristic: ALL_CAPS identifiers were enums — emit bare
        return s
    if s in ("true", "false"):
        return s
    escaped = s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return f'"{escaped}"'


def serialize(msg: Message, indent: int = 0) -> str:
    pad = "  " * indent
    lines: list[str] = []
    for name, vals in msg.fields.items():
        for v in vals:
            if isinstance(v, Message):
                lines.append(f"{pad}{name} {{")
                lines.append(serialize(v, indent + 1))
                lines.append(f"{pad}}}")
            else:
                lines.append(f"{pad}{name}: {_fmt_scalar(v)}")
    return "\n".join(line for line in lines if line != "")
