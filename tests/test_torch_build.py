"""The port's kernel build cache: a library's key covers its sources, every
header in ``csrc/`` and the flags, and nvcc is given the sources only. On a
``tmp_path`` copy of ``csrc/``; nothing is compiled."""
import shutil
import subprocess

import pytest

from endoscopydepthestimation_pytorch_tpu_torch.ops import _build, block_engine, dense_conv


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return copy


@pytest.mark.parametrize("edit", ["shared header", "new header", "source"])
@pytest.mark.parametrize("module,name", [(dense_conv, "dense_conv"),
                                         (block_engine, "block_engine")])
def test_library_key_follows_sources_and_headers(csrc, edit, module, name):
    """Editing the header that K1 and K4 share, adding a header, or
    editing the library's own source gives a new key; undoing the edit
    gives the old one back."""
    before = _build.library_path(name, module._SOURCES)
    path = {"shared header": csrc / "conv3x3_mma.cuh", "new header": csrc / "extra.cuh",
            "source": csrc / module._SOURCES[0]}[edit]
    old = path.read_text() if path.exists() else None
    path.write_text((old or "") + "\n// edited\n")
    assert _build.library_path(name, module._SOURCES) != before
    if old is None:
        path.unlink()
    else:
        path.write_text(old)
    assert _build.library_path(name, module._SOURCES) == before


def test_nvcc_gets_the_sources_only(csrc, monkeypatch):
    """The shared header is hashed into the key but never listed for nvcc
    (which would compile it as a second translation unit)."""
    seen = []

    def fake_nvcc(cmd, **kwargs):
        seen.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    out = _build.build("dense_conv", dense_conv._SOURCES)
    assert out.exists() and out.parent == _build.BUILD_DIR
    (cmd,) = seen
    inputs = [a for a in cmd if a.startswith(str(csrc))]
    assert inputs == [str(csrc / "dense_conv.cu")]
    assert "--use_fast_math" not in cmd and "-ftz=true" not in cmd
    assert _build.build("dense_conv", dense_conv._SOURCES) == out and len(seen) == 1
