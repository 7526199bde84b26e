"""PyTorch port: the C interface of the hand-written CUDA kernels, read as
text, against the ctypes declarations that call it.

``repro_torch.kernels.build.ENTRIES`` gives every C entry point its library
and its argument types.  ctypes passes a Python int as a 32-bit int unless
it is told otherwise, so a pointer declared ``c_int`` is cut and an argument
added on one side only shifts every later one.  No compiler runs here: the
test parses each ``csrc/<library>.cu``'s ``extern "C"`` block and holds the
parameters of each function (a pointer is ``c_void_p``, an ``int``
``c_int``, a ``float`` ``c_float``) against ``ENTRIES``, both ways; and it
checks that every shared header enters the hash that names a library's
build, so a change to a ``.cuh`` is never served from a stale build.
"""
import ctypes
import re
import shutil

import pytest

from repro_torch.kernels import build

KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
        ctypes.c_float: "float"}


def _param_kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    base = param.replace("const", "").split()[0]
    if base not in ("int", "float"):
        raise ValueError(f"C parameter of unknown kind: {param!r}")
    return base


def _c_entries(library: str) -> dict:
    """name -> parameter kinds of every C function of ``csrc/<library>.cu``:
    those defined at the top level of an ``extern "C" { ... }`` block and
    those declared ``extern "C" int name(...)`` one by one."""
    text = re.sub(r"//[^\n]*", "", (build.CSRC / f"{library}.cu").read_text())
    spans = []
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        spans.append((m.end(), i - 1))

    def top_level(pos):
        for lo, hi in spans:
            if lo <= pos < hi:
                return text[lo:pos].count("{") == text[lo:pos].count("}")
        return False

    entries = {}
    for m in re.finditer(r'(extern "C"\s+)?\bint\s+(\w+)\s*\(([^)]*)\)\s*\{',
                         text):
        if m.group(1) or top_level(m.start()):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            entries[m.group(2)] = [_param_kind(p) for p in params]
    return entries


C_ENTRIES = {lib: _c_entries(lib) for lib in build.LIBRARIES}


@pytest.mark.parametrize("name", sorted(build.ENTRIES))
def test_entry_matches_its_c_function(name):
    library, argtypes = build.ENTRIES[name]
    assert name in C_ENTRIES[library], \
        f"{library}.cu has no extern \"C\" function {name}"
    want = C_ENTRIES[library][name]
    got = [KIND[t] for t in argtypes]
    assert got == want, f"{name}: ctypes {got} != C {want}"


@pytest.mark.parametrize("library", build.LIBRARIES)
def test_every_c_function_is_declared(library):
    assert (build.CSRC / f"{library}.cu").is_file()
    declared = {n for n, (lib, _) in build.ENTRIES.items() if lib == library}
    assert set(C_ENTRIES[library]) == declared


def test_every_header_enters_the_build_hash(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert {h.name for h in headers} >= {"gqa_tile.cuh", "mma_tile.cuh",
                                         "indexer_tile.cuh", "vec.cuh",
                                         "tf32_tile.cuh", "indexer_mma.cuh"}
    for header in headers:
        before = {lib: build.library_path(lib) for lib in build.LIBRARIES}
        header.write_text(header.read_text() + "\n// edited\n")
        after = {lib: build.library_path(lib) for lib in build.LIBRARIES}
        assert all(before[lib] != after[lib] for lib in build.LIBRARIES), \
            header.name
