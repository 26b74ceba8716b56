"""OpenFOAM dictionary parsing — ctypes binding to the native parser.

The reference is configured by OpenFOAM dictionaries (SURVEY.md §2.5); this
module parses them so reference case directories work against this
framework.  The hot path is the C++ tokenizer/parser in native/foamdict.cpp
(built on demand with g++); a pure-Python fallback implements the same
grammar for environments without a toolchain.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB = None
_TRIED = False


def _stale(so: str, src: str) -> bool:
    """True when the library must be (re)built from `src`."""
    if not os.path.exists(src):
        return False
    return (not os.path.exists(so)
            or os.path.getmtime(src) > os.path.getmtime(so))


def _load_native():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libfoamdict.so"))
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "foamdict.cpp"))
    if _stale(so, src):
        # the library always comes from the committed source: (re)build it
        # when missing or older than foamdict.cpp; build to a per-process
        # name and rename, so concurrent processes never load a partial file
        tmp = "%s.%d.tmp" % (so, os.getpid())
        try:
            subprocess.run(
                ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                 "-o", tmp, src],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    if os.path.exists(so):
        try:
            lib = ctypes.CDLL(so)
            lib.foamdict_parse_json.restype = ctypes.c_void_p
            lib.foamdict_parse_json.argtypes = [ctypes.c_char_p]
            lib.foamdict_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def parse(text: str) -> dict:
    """Parse OpenFOAM dictionary text into a plain dict (native if
    available, Python fallback otherwise)."""
    lib = _load_native()
    if lib is not None:
        ptr = lib.foamdict_parse_json(text.encode())
        try:
            raw = ctypes.string_at(ptr).decode()
        finally:
            lib.foamdict_free(ptr)
        return json.loads(raw)
    return _parse_py(text)


def parse_file(path: str) -> dict:
    with open(path) as f:
        return parse(f.read())


def native_available() -> bool:
    return _load_native() is not None


# ---------------------------------------------------------------------------
# pure-Python fallback (same grammar)
# ---------------------------------------------------------------------------

# OpenFOAM words may embed balanced, whitespace-free parentheses:
# grad(p) / div(phi,U) / div((rho*U)) are single keyword tokens.
_TOKEN_RE = re.compile(
    r'"(?:\\.|[^"])*"'
    r'|[^\s{}()\[\];"]+(?:\((?:[^()\s{}\[\];"]|\([^()\s{}\[\];"]*\))*\))+'
    r'[^\s{}()\[\];"]*'
    r'|[{}()\[\];]'
    r'|[^\s{}()\[\];"]+'
)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    text = re.sub(r"#[^\n]*", " ", text)  # directives
    return text


def _parse_py(text: str) -> dict:
    toks = _TOKEN_RE.findall(_strip_comments(text))
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def atom(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            f = float(tok)
            return int(f) if f.is_integer() and "e" not in tok.lower() \
                and "." not in tok else f
        except ValueError:
            pass
        if tok in ("true", "yes", "on"):
            return True
        if tok in ("false", "no", "off"):
            return False
        return tok

    def single():
        tok = take()
        if tok == "(":
            out = []
            while peek() not in (")", None):
                if peek() == "{":
                    take()
                    out.append(dict_body())
                else:
                    out.append(single())
            take()
            return out
        if tok == "[":
            dims = []
            while peek() not in ("]", None):
                dims.append(atom(take()))
            take()
            return {"__dims__": dims}
        if tok == "{":
            return dict_body()
        return atom(tok)

    def value_tokens():
        parts = []
        while peek() not in (";", "}", None):
            parts.append(single())
        if peek() == ";":
            take()
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else parts

    def dict_body():
        d = {}
        while peek() not in ("}", None):
            if peek() in (";",):
                take()
                continue
            key = atom(take())
            if not isinstance(key, str):
                continue
            if peek() == "{":
                take()
                d[key] = dict_body()
                if peek() == "}":
                    take()
            else:
                d[key] = value_tokens()
        return d

    return dict_body()
