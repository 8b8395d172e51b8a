"""The port's kernel build key (horovod_tpu_torch.ops._build): it hashes every
file under csrc/, headers included, so an edited header builds anew instead
of loading a library built from the old one. No nvcc is needed: the key is
computed from the files alone."""
import shutil

from horovod_tpu_torch.ops import _build


def test_hashed_files_are_every_source_and_header_in_csrc():
    on_disk = {p for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert set(_build.hashed_files()) == on_disk
    assert {p.suffix for p in _build.hashed_files()} == {".cu", ".cuh"}
    assert set(_build.sources()) == {p for p in on_disk if p.suffix == ".cu"}


def test_editing_a_header_changes_the_key(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._key()
    assert _build._key() == before                      # stable for an unchanged tree
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._key() != before


def test_adding_a_header_changes_the_key(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._key()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._key() != before
    assert csrc / "extra.cuh" in _build.hashed_files()
    assert csrc / "extra.cuh" not in _build.sources()
