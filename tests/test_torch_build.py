"""ops/_build.py on the CPU, with a stand-in for ``nvcc``.

The machine with the card compiles the real sources; here a small script
takes nvcc's place, so the build's own logic is checked: every
``csrc/*.cu`` gets a library of its own, built at once with the others,
named by a hash that covers its source, the shared headers and the
flags; a built library is not built again; a failing source raises with
the compiler's output and leaves no library behind.
"""

from __future__ import annotations

import stat
import sys

import pytest

from kubeflow_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
src = args[-1]
if "broken" in open(src).read():
    print(src + ": error: expected a ';'")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as out:
    out.write("built from " + src)
print("ptxas info    : Used 128 registers")
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// shared\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    return csrc


def test_every_source_builds_once_into_its_own_library(tree):
    took = _build.build()
    assert set(took) == {"a", "b"}
    assert all(isinstance(t, float) and t >= 0 for t in took.values())
    for name in ("a", "b"):
        lib = _build.library_path(name)
        assert lib.read_text() == f"built from {tree / (name + '.cu')}"
        assert "ptxas" in _build.log_path(name).read_text()
    assert _build.library_path("a") != _build.library_path("b")
    assert _build.build() == {"a": None, "b": None}


def test_the_hash_covers_source_headers_and_flags(tree, monkeypatch):
    before = _build.library_path("a")
    (tree / "b.cu").write_text("// b, edited\n")
    assert _build.library_path("a") == before
    (tree / "common.cuh").write_text("// shared, edited\n")
    after_header = _build.library_path("a")
    assert after_header != before
    (tree / "a.cu").write_text("// a, edited\n")
    assert _build.library_path("a") != after_header
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("a") != after_header


def test_a_failing_source_raises_with_the_compiler_output(tree):
    (tree / "b.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="kernel build of b failed") as info:
        _build.build()
    assert "expected a ';'" in str(info.value)
    assert not _build.library_path("b").exists()
    assert _build.library_path("a").exists()  # the other build completed
    assert not list(_build.BUILD_DIR.glob("*.tmp*"))
