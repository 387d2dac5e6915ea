"""The port's kernel build (ompi_tpu_torch._build), with a stand-in for nvcc:
one compile per source, a rebuild only for a changed source, and a failed
compile that raises with the compiler's output and leaves no library."""

import pytest

from ompi_tpu_torch import _build

FAKE_NVCC = """#!/bin/sh
for a; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
case "$a" in *bad.cu) echo "$a(1): error: expected a declaration" >&2; exit 2;; esac
echo "$a" >> "$(dirname "$0")/calls"
echo "ptxas info    : Used 8 registers ($a)" >&2
touch "$out"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    calls = tmp_path / "calls"
    return csrc, lambda: (calls.read_text().split() if calls.exists()
                          else [])


def test_builds_each_source_once_and_rebuilds_on_change(tree):
    csrc, calls = tree
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    assert sorted(_build.build()) == ["a", "b"]
    assert len(calls()) == 2
    assert _build.build() == {}
    (csrc / "b.cu").write_text("// b, edited")
    assert list(_build.build()) == ["b"]
    assert len(calls()) == 3
    assert sorted(p.name.split("-")[0] for p in
                  _build.BUILD_DIR.glob("*.so")) == ["a", "b", "b"]


def test_failed_build_raises_with_compiler_output(tree):
    csrc, _ = tree
    (csrc / "bad.cu").write_text("not cuda")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.library("bad")
    assert not list(_build.BUILD_DIR.glob("*"))


def test_unknown_kernel_raises(tree):
    with pytest.raises(FileNotFoundError):
        _build.library("absent")


def test_report_is_kept_beside_the_library(tree):
    """The compiler's report of a source stays readable after the build
    that made it, so a later run can still read registers and spills."""
    csrc, calls = tree
    (csrc / "a.cu").write_text("// a")
    built = _build.build()
    assert "Used 8 registers" in built["a"]
    assert _build.build() == {}
    assert _build.report("a") == built["a"]
    assert len(calls()) == 1
