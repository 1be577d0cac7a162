"""The port's kernel sources as a package ships them (no nvcc needed).

An installed package carries only what setup.py's package_data names, and
ops/_build.py compiles from there at first use: every source and every
header a source includes must be shipped, and an edited header must give a
new library.
"""

import ast
import fnmatch
import re
import shutil
from pathlib import Path

from dpgo_tpu_torch.ops import _build

_REPO = Path(__file__).resolve().parent.parent


def _package_data() -> list:
    """The dpgo_tpu_torch globs of setup.py's package_data."""
    tree = ast.parse((_REPO / "setup.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            return ast.literal_eval(node.value)["dpgo_tpu_torch"]
    raise AssertionError("setup.py names no package_data")


def _shipped(path: Path, globs) -> bool:
    rel = path.relative_to(_build.SRC_DIR.parent).as_posix()
    return any(fnmatch.fnmatch(rel, g) for g in globs)


def test_every_source_and_included_header_is_shipped():
    globs = _package_data()
    sources = sorted(_build.SRC_DIR.glob("*.cu*"))
    assert {s.suffix for s in sources} == {".cu", ".cuh"}
    for src in sources:
        assert _shipped(src, globs), f"{src.name} is not in package_data"
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            header = src.parent / name
            assert header.is_file(), f"{src.name} includes missing {name}"
            assert _shipped(header, globs), f"{name} is not in package_data"


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = _build.library_path()
    assert _build.library_path() == before
    header = next(src.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
