"""S-expression wire codec.

The control plane speaks S-expressions, the same wire format the reference
framework uses for every management message (reference:
src/aiko_services/main/utilities/parser.py:84-215).  This is a fresh
implementation with the same capability set:

- lists:            ``(add topic name)``       -> ``["add", "topic", "name"]``
- nested lists:     ``(a (b c) d)``            -> ``["a", ["b", "c"], "d"]``
- dictionaries:     ``(k1: v1 k2: v2)``        -> ``{"k1": "v1", "k2": "v2"}``
- quoted strings:   ``(say "hi there")``       -> ``["say", "hi there"]``
- binary symbols:   ``5:ab cd`` length-prefixed raw token (may contain any
                    byte except nothing -- the length disambiguates)

``parse`` returns strings (the wire is untyped); ``generate`` accepts
arbitrary Python scalars/lists/dicts and renders them canonically.
"""

from __future__ import annotations

from typing import Any

__all__ = ["generate", "parse", "parse_bool", "parse_number", "parse_to_dict"]


def generate(command: str, parameters: Any = None) -> str:
    """Render ``(command p0 p1 ...)``.  ``parameters`` is an iterable of
    values; each value may be a scalar, list, or dict."""
    if parameters is None:
        parameters = []
    inner = " ".join(_render(p) for p in parameters)
    return f"({command} {inner})" if inner else f"({command})"


def generate_value(value: Any) -> str:
    """Render a single Python value as an S-expression token/term."""
    return _render(value)


def _render(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "nil"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "(" + " ".join(_render(v) for v in value) + ")"
    if isinstance(value, dict):
        inner = " ".join(f"{_render_key(k)}: {_render(v)}"
                         for k, v in value.items())
        return "(" + inner + ")"
    if isinstance(value, bytes):
        value = value.decode("utf-8", errors="surrogateescape")
        return f"{len(value)}:{value}"
    return _render_symbol(str(value))


def _render_key(key: Any) -> str:
    return _render_symbol(str(key))


_PLAIN_SAFE = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789_-./*#+=<>!?@%&^~$|,[]{}'"
)


def _render_symbol(text: str) -> str:
    if text == "":
        return '""'
    if all(ch in _PLAIN_SAFE for ch in text) and not text.endswith(":"):
        return text
    if any(ch in text for ch in '"\\\n'):
        # Length-prefixed canonical token: survives any payload bytes.
        return f"{len(text)}:{text}"
    return f'"{text}"'


# --------------------------------------------------------------------------
# Parsing


class SExprError(ValueError):
    pass


class _Quoted(str):
    """Marks a string that came from quotes or a length-prefixed token, so
    list parsing never mistakes it for a ``key:`` dictionary marker."""
    __slots__ = ()


def parse(text: str):
    """Parse one S-expression.  Returns ``(command, parameters)`` when the
    top level is a list whose head is a symbol, mirroring the common
    ``(command arg...)`` control-message shape; bare atoms come back as-is.
    """
    value, index = _parse_term(text, _skip_ws(text, 0))
    index = _skip_ws(text, index)
    if index != len(text):
        raise SExprError(f"trailing data at {index}: {text[index:index + 20]!r}")
    if isinstance(value, list) and value and isinstance(value[0], str):
        return value[0], value[1:]
    return value, []


def parse_value(text: str):
    """Parse one S-expression term into its Python value (no command
    destructuring)."""
    value, index = _parse_term(text, _skip_ws(text, 0))
    index = _skip_ws(text, index)
    if index != len(text):
        raise SExprError(f"trailing data at {index}: {text[index:index + 20]!r}")
    return value


def _skip_ws(text: str, i: int) -> int:
    n = len(text)
    while i < n and text[i] in " \t\r\n":
        i += 1
    return i


def _parse_term(text: str, i: int):
    if i >= len(text):
        raise SExprError("unexpected end of input")
    ch = text[i]
    if ch == "(":
        return _parse_list(text, i + 1)
    if ch == ")":
        raise SExprError(f"unexpected ')' at {i}")
    if ch == '"':
        return _parse_quoted(text, i + 1)
    return _parse_atom(text, i)


def _parse_list(text: str, i: int):
    items: list = []
    keys: list = []          # parallel record of "key:" markers
    is_dict = None
    while True:
        i = _skip_ws(text, i)
        if i >= len(text):
            raise SExprError("unterminated list")
        if text[i] == ")":
            i += 1
            break
        value, i = _parse_term(text, i)
        if (isinstance(value, str) and not isinstance(value, _Quoted)
                and value.endswith(":") and len(value) > 1):
            # dictionary key marker
            if is_dict is False:
                raise SExprError(f"mixed list/dict near {i}")
            is_dict = True
            i = _skip_ws(text, i)
            if i >= len(text) or text[i] == ")":
                raise SExprError(f"dangling key {value!r}")
            dict_value, i = _parse_term(text, i)
            keys.append((value[:-1], dict_value))
        else:
            if is_dict is True:
                raise SExprError(f"mixed dict/list near {i}")
            is_dict = False
            items.append(value)
    if is_dict:
        return dict(keys), i
    return items, i


def _parse_quoted(text: str, i: int):
    out = []
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == "\\" and i + 1 < n:
            out.append(text[i + 1])
            i += 2
            continue
        if ch == '"':
            return _Quoted("".join(out)), i + 1
        out.append(ch)
        i += 1
    raise SExprError("unterminated string")


def _parse_atom(text: str, i: int):
    n = len(text)
    j = i
    while j < n and text[j] not in ' \t\r\n()"':
        j += 1
    token = text[i:j]
    # length-prefixed canonical token  "<len>:<raw...>"
    colon = token.find(":")
    if colon > 0 and token[:colon].isdigit():
        length = int(token[:colon])
        start = i + colon + 1
        end = start + length
        if end <= n:
            raw = text[start:end]
            if len(raw) == length:
                return _Quoted(raw), end
    return token, j


# --------------------------------------------------------------------------
# Helpers

def parse_bool(value, default: bool = False) -> bool:
    """Truthy-string parameter normalization, shared by every
    boolean-ish element parameter (``synchronous``, ``streaming``,
    ``quantize``...): accepts real bools and the usual spellings."""
    if isinstance(value, bool):
        return value
    if value is None:
        return default
    return str(value).strip().lower() in ("true", "1", "yes", "on")


def parse_number(token, default=None):
    """Best-effort conversion of a wire token to int/float/bool."""
    if isinstance(token, (int, float, bool)):
        return token
    if not isinstance(token, str):
        return default
    low = token.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("nil", "none", "null"):
        return None
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        return default if default is not None else token


def parse_to_dict(parameters) -> dict:
    """Interpret a parsed parameter list as a flat dictionary:
    accepts either a single parsed dict or alternating key/value items."""
    if len(parameters) == 1 and isinstance(parameters[0], dict):
        return dict(parameters[0])
    result = {}
    for item in parameters:
        if isinstance(item, dict):
            result.update(item)
        elif isinstance(item, list) and len(item) == 2:
            result[item[0]] = item[1]
    return result
