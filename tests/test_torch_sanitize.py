"""The port's sanitizer legs (``reporter_tpu_torch/tools/sanitize.py``)
against the JAX repo's ``tools/sanitize_tests.sh`` and its Makefile.

The flags are the Makefile's ``SAN_FLAGS`` plus each leg's
``-fsanitize=``; a library is named by a hash of the source and flags, as
the regular build is; a compiler that cannot link a sanitizer skips its
leg with a notice and exit 0; ``native.load(library=)`` holds a library
built elsewhere to the ABI handshake. End to end, the TSan leg builds the
host runtime with ``-fsanitize=thread`` and runs the drive clean under a
preloaded libtsan (about 20 s here, most of it the build).
"""
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from reporter_tpu_torch import native
from reporter_tpu_torch.tools import sanitize, tsan_drive

REPO = Path(__file__).resolve().parents[1]


def _makefile_san_flags():
    text = (REPO / "reporter_tpu" / "native" / "Makefile").read_text()
    m = re.search(r"^SAN_FLAGS := (.*?)(?<!\\)\n", text,
                  re.M | re.S)
    words = m.group(1).replace("\\\n", " ").split()
    return tuple(w for w in words if not w.startswith("$("))


def test_flags_are_the_makefiles_san_flags_and_the_legs():
    assert sanitize.SAN_FLAGS == _makefile_san_flags()
    for leg, sflags in (("asan", ("-fsanitize=address",)),
                        ("ubsan", ("-fsanitize=undefined",
                                   "-fno-sanitize-recover=undefined")),
                        ("tsan", ("-fsanitize=thread",))):
        got = sanitize.flags(leg)
        assert got[:len(sanitize.SAN_FLAGS)] == sanitize.SAN_FLAGS
        assert got[-len(sflags) - 1:] == sflags + ("-shared",)
        extra = got[len(sanitize.SAN_FLAGS):-len(sflags) - 1]
        assert set(extra) <= {"-mavx", "-mf16c"}


def test_the_library_is_named_by_a_hash_of_source_and_flags():
    names = {}
    for leg in ("asan", "ubsan", "tsan"):
        path = sanitize.library_path(leg)
        assert path.parent == native.BUILD_DIR
        m = re.fullmatch(rf"libreporter_host_{leg}-([0-9a-f]{{16}})\.so",
                         path.name)
        assert m, path.name
        want = hashlib.sha256(native.SOURCE.read_bytes() + " ".join(
            sanitize.flags(leg)).encode()).hexdigest()[:16]
        assert m.group(1) == want
        names[leg] = path.name
    regular = native.library_name(native.cxx_flags())
    assert len(set(names.values()) | {regular}) == 4


def test_the_options_are_the_scripts():
    script = (REPO / "tools" / "sanitize_tests.sh").read_text()
    for leg in ("asan", "ubsan", "tsan"):
        name, value = sanitize.LEGS[leg][2]
        assert f'{name}="{value}"' in script
    assert sanitize.PREP_THREADS == 2 and sanitize.TSAN_PREP_THREADS == 4


def test_the_child_preloads_the_runtime_and_libstdcxx_for_asan(tmp_path):
    lib = tmp_path / "lib.so"
    asan = sanitize.child_command("asan", lib)
    assert asan[0] == "env" and asan[1].startswith("LD_PRELOAD=")
    preload = asan[1][len("LD_PRELOAD="):].split()
    assert [Path(p).name for p in preload] == ["libasan.so", "libstdc++.so"]
    assert asan[2] == "ASAN_OPTIONS=detect_leaks=0:abort_on_error=1"
    assert asan[-2:] == ["--pytest-child", str(lib)]
    tsan = sanitize.child_command("tsan", lib)
    assert [Path(p).name for p in
            tsan[1][len("LD_PRELOAD="):].split()] == ["libtsan.so"]
    assert tsan[3:] == [sys.executable, "-m",
                        "reporter_tpu_torch.tools.tsan_drive", "--library",
                        str(lib), "--prep-threads", "4"]


@pytest.mark.parametrize("mode", ["default", "asan", "ubsan", "tsan"])
def test_a_compiler_that_cannot_link_skips_with_exit_0(mode, capsys):
    assert not sanitize.probe("tsan", cxx="false")
    argv = ([] if mode == "default" else [mode]) + ["--cxx", "false"]
    assert sanitize.main(argv) == 0
    out = capsys.readouterr().out
    assert "cannot link -fsanitize" in out
    assert "no sanitizer support in this toolchain" in out


def test_tsan_skips_when_the_runtime_cannot_be_preloaded(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(sanitize, "probe", lambda leg, cxx=None: True)
    monkeypatch.setattr(sanitize, "preload_survives",
                        lambda leg, cxx=None: False)
    monkeypatch.setattr(sanitize, "build", lambda *a: pytest.fail(
        "a skipped leg builds nothing"))
    assert sanitize.main(["tsan"]) == 0
    assert "cannot be preloaded" in capsys.readouterr().out


def test_a_failed_child_fails_the_run(monkeypatch, tmp_path):
    monkeypatch.setattr(sanitize, "probe", lambda leg, cxx=None: True)
    monkeypatch.setattr(sanitize, "build", lambda *a: tmp_path / "x.so")
    monkeypatch.setattr(sanitize, "child_command",
                        lambda leg, lib, cxx=None: ["false"])
    assert sanitize.run_leg("asan") == "failed"
    assert sanitize.main(["ubsan"]) == 1


def _stub_library(tmp_path, body):
    src = tmp_path / "stub.cpp"
    src.write_text('#include <cstdint>\nextern "C" {' + body + '}\n')
    lib = tmp_path / "libstub.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, timeout=120)
    return lib


@pytest.mark.parametrize("body", [
    "int32_t rt_abi_version(void) { return 14; }",
    "int32_t rt_abi_version(void) { return 999; }",
    "int32_t rt_something_else(void) { return 15; }"])
def test_load_library_refuses_a_wrong_abi(tmp_path, monkeypatch, body):
    lib = _stub_library(tmp_path, body)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    with pytest.raises(RuntimeError, match="ABI mismatch"):
        native.load(library=lib)
    assert native._lib is None and native._lib_path is None


def test_load_library_binds_a_library_built_elsewhere(tmp_path,
                                                      monkeypatch):
    lib = native.build()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    bound = native.load(library=lib)
    assert native.load() is bound
    assert native.load(library=lib) is bound
    assert int(bound.rt_abi_version()) == native.ABI_VERSION
    with pytest.raises(RuntimeError, match="already loaded"):
        native.load(library=tmp_path / "other.so")


def test_route_memo_bound_evicts_and_keeps_values():
    """``SegmentMatcher(route_memo=)``, the JAX package's
    ``REPORTER_TPU_ROUTE_MEMO``: the drive's eviction leg on the regular
    build."""
    assert tsan_drive.main(["--prep-threads", "2", "--route-memo",
                            "64"]) == 0


def test_tsan_leg_builds_and_runs_the_drive_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "reporter_tpu_torch.tools.sanitize", "tsan"],
        cwd=REPO, capture_output=True, text=True, timeout=420)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    if "skipping tsan" in out:
        pytest.fail("this host has libtsan; the leg must run:\n" + out)
    assert "tsan-drive: clean: every leg held" in out
    assert "ThreadSanitizer" not in out
    assert sanitize.library_path("tsan").exists()
    assert "tsan=ok" in out
    assert os.path.getsize(sanitize.library_path("tsan")) > 0
