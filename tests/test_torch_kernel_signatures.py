"""The ctypes signatures of ops/kernels.py (_SIGNATURES) against the C
entries of each csrc/*.cu source: the same functions, and each one's
arguments and result of the same kinds, so that a wrapper cannot pass
a C entry a wrong argument list (which no CPU test would run)."""

import ctypes
import os
import re

import pytest

from compairr_tpu_torch.ops import kernels as K

CSRC = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc")


def _kind(decl: str):
    """The ctypes type of a C parameter's declaration."""
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()
    if words[:2] == ["long", "long"]:
        return ctypes.c_longlong
    if words[:1] == ["int"]:
        return ctypes.c_int
    raise ValueError(f"no ctypes kind for {decl!r}")


def _entries(source: str) -> dict:
    """{name: ([parameter kinds], result kind)} of the source's extern
    "C" block."""
    with open(os.path.join(CSRC, source + ".cu")) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    block = re.sub(r"//[^\n]*", "", block)
    out = {}
    for m in re.finditer(r"(const char\s*\*|int|long long)\s+(\w+)\s*"
                         r"\(([^)]*)\)\s*\{", block):
        ret, name, params = m.groups()
        args = [p for p in (x.strip() for x in params.split(",")) if p]
        out[name] = ([_kind(p) for p in args],
                     ctypes.c_char_p if "*" in ret else _kind(ret))
    return out


@pytest.mark.parametrize("source", sorted(K._SIGNATURES))
def test_signatures_match_the_c_entries(source):
    got = _entries(source)
    want = K._SIGNATURES[source]
    assert sorted(got) == sorted(want)
    for name, (args, ret) in want.items():
        assert (list(args), ret) == got[name], name
