"""The port's kernel builder (kmlserver_tpu_torch/ops/cuda_build.py) with a
stand-in for nvcc: the build runs here without a CUDA toolkit, and nothing
is loaded."""

import stat
import sys

import pytest

from kmlserver_tpu_torch.ops import cuda_build

REPORT = "ptxas info    : Used 168 registers, used 1 barriers"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` that writes an empty library to its ``-o`` path and the
    ptxas line to stderr, counting its calls in ``calls.txt``."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "argv = sys.argv[1:]\n"
        "open(argv[argv.index('-o') + 1], 'wb').close()\n"
        f"open({str(tmp_path / 'calls.txt')!r}, 'a').write('x')\n"
        f"print({REPORT!r}, file=sys.stderr)\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    return tmp_path / "calls.txt"


def test_a_reused_library_keeps_its_ptxas_report(fake_nvcc, monkeypatch):
    out = cuda_build.build("popcount")
    assert out.exists() and fake_nvcc.read_text() == "x"
    assert REPORT in cuda_build.BUILD_LOG["popcount"]["ptxas"]
    # a second process finds the library built: no nvcc, the same report
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    assert cuda_build.build("popcount") == out
    assert fake_nvcc.read_text() == "x"
    assert cuda_build.BUILD_LOG["popcount"]["seconds"] == 0.0
    assert REPORT in cuda_build.BUILD_LOG["popcount"]["ptxas"]


def test_the_library_name_follows_the_source(fake_nvcc, monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    first = cuda_build.build("k")
    (src / "k.cu").write_text("// two\n")
    second = cuda_build.build("k")
    assert first != second and first.exists() and second.exists()
    assert fake_nvcc.read_text() == "xx"
