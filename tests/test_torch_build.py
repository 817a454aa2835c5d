"""The port's kernel build (``repro_torch.kernels.build``) without a
compiler: where each library goes, and that its name follows every input
of the build (the source, the shared ``csrc/*.cuh`` headers, the flags),
so an edited header never reuses a stale library."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "common.cuh").write_text("#pragma once\nint shared;\n")
    return tmp_path


def test_library_path_is_stable_and_named_by_source(csrc):
    first = build.library_path(csrc / "a.cu")
    assert first == build.library_path(csrc / "a.cu")
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith("a-") and first.suffix == ".so"
    assert first != build.library_path(csrc / "b.cu")


def test_library_path_follows_a_header(csrc):
    before = build.library_path(csrc / "a.cu")
    (csrc / "common.cuh").write_text("#pragma once\nint shared, more;\n")
    assert build.library_path(csrc / "a.cu") != before


def test_library_path_follows_a_new_header(csrc):
    before = build.library_path(csrc / "a.cu")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(csrc / "a.cu") != before


def test_library_path_follows_the_source_and_flags(csrc, monkeypatch):
    before = build.library_path(csrc / "a.cu")
    (csrc / "a.cu").write_text('#include "common.cuh"\nint a2;\n')
    edited = build.library_path(csrc / "a.cu")
    assert edited != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path(csrc / "a.cu") != edited


def test_library_path_ignores_other_files(csrc):
    before = build.library_path(csrc / "a.cu")
    (csrc / "notes.txt").write_text("not an input of the build\n")
    assert build.library_path(csrc / "a.cu") == before


def test_the_port_ships_its_shared_header():
    """The tensor-core kernels include csrc/hopper.cuh, so its bytes are
    in their libraries' names."""
    assert (build.CSRC / "hopper.cuh").exists()
    for name in ("flash_attention", "gmm", "decode_attention"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in source
