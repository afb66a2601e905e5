"""The port's kernel build key (``repro_torch.kernels._build.build_key``):
a change to a kernel source, or to a local header it includes, must give a
new key, so that a library built from other bytes is never loaded; a
library built before gives back its compiler's log.  Pure Python: runs
without nvcc or a card."""

import ctypes
import re
import subprocess
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro_torch.kernels import _build

CSRC = Path(_build.__file__).resolve().parent / "csrc"


@pytest.fixture
def tree(tmp_path):
    (tmp_path / "kernel.cu").write_text(
        '#include <cuda_runtime.h>\n#include "tile.cuh"\nint k;\n')
    (tmp_path / "tile.cuh").write_text('  #  include "inner.cuh"\nint t;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "unrelated.cuh").write_text("int u;\n")
    return tmp_path


def test_build_key_is_stable(tree):
    assert _build.build_key(tree / "kernel.cu") == _build.build_key(
        tree / "kernel.cu")


@pytest.mark.parametrize("edited", ["kernel.cu", "tile.cuh", "inner.cuh"])
def test_build_key_follows_the_source_and_its_local_headers(tree, edited):
    before = _build.build_key(tree / "kernel.cu")
    path = tree / edited
    path.write_text(path.read_text() + "int more;\n")
    assert _build.build_key(tree / "kernel.cu") != before


def test_build_key_ignores_headers_it_does_not_include(tree):
    before = _build.build_key(tree / "kernel.cu")
    (tree / "unrelated.cuh").write_text("int changed;\n")
    assert _build.build_key(tree / "kernel.cu") == before


def test_build_key_survives_an_include_cycle_and_a_missing_header(tree):
    (tree / "inner.cuh").write_text('#include "tile.cuh"\n'
                                    '#include "missing.cuh"\n')
    assert len(_build.build_key(tree / "kernel.cu")) == 64


def test_every_kernel_source_has_its_own_key():
    sources = sorted(CSRC.glob("*.cu"))
    assert len(sources) >= 5
    assert len({_build.build_key(s) for s in sources}) == len(sources)


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "flash_attention_bwd.cu"])
def test_attention_sources_follow_their_shared_header(tmp_path, source):
    """Both attention kernels include ``hopper.cuh``: an edit there must
    rebuild each."""
    for path in CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    before = _build.build_key(tmp_path / source)
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_key(tmp_path / source) != before


# -- the compiler's log of a library built before -----------------------------


def _ptxas_log(spill: int = 0, drop: int = 0) -> str:
    """ptxas' lines for the backward's twelve tensor-core kernels (rows and
    dQ at HD 32 to 256, dK/dV at HD 32 to 128, HD 256's split dK/dV, which
    is no template) and its partial sum, which the check leaves out:
    ``spill`` bytes of spill stores for the first, the last ``drop`` of the
    twelve left out."""
    entries = [f"{len(kernel)}{kernel}ILi{hd}EEEv"
               for hd in (256, 128, 64, 32)
               for kernel in ("flash_bwd_dq_wgmma_kernel",
                              "flash_bwd_dkdv_wgmma_kernel",
                              "flash_bwd_rows_kernel")
               if not (hd == 256 and "dkdv" in kernel)]
    entries.append("33flash_bwd_dkdv_split_wgmma_kernelE14CUtensorMap_stS0_")
    entries = entries[:len(entries) - drop]
    entries.append("25flash_bwd_dkdv_sum_kernelEPKfP13__nv_bfloat16S3_lif")
    lines = []
    for n, entry in enumerate(entries):
        lines += [
            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
            f"{entry}' for 'sm_90a'",
            f"    0 bytes stack frame, {spill if n == 0 else 0} bytes "
            "spill stores, 0 bytes spill loads",
            "ptxas info    : Used 168 registers, used 16 barriers"]
    return "\n".join(lines) + "\n"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``_build`` with an ``nvcc`` that writes a stand-in library and
    prints ``_ptxas_log()``, and a loader that opens nothing; returns the
    list of compiler calls."""
    calls = []

    def run(cmd, capture_output, text):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"library")
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=_ptxas_log(),
                                           stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda source: "nvcc")
    monkeypatch.setattr(_build, "subprocess", SimpleNamespace(run=run))
    monkeypatch.setattr(_build, "ctypes",
                        SimpleNamespace(CDLL=lambda path: SimpleNamespace()))
    return calls


def test_library_built_before_reports_its_compiler_log(tree, fake_nvcc):
    """A second process finds the library built and reads back the log
    that ptxas wrote when it was built, so ``chip_smoke.py``'s phase 2
    checks the same spills as on a first build."""
    import chip_smoke

    first = _build.KernelLibrary(tree / "kernel.cu", lambda lib: None)
    first.load()
    again = _build.KernelLibrary(tree / "kernel.cu", lambda lib: None)
    again.load()
    assert len(fake_nvcc) == 1
    assert first.info["seconds"] is not None and again.info["seconds"] is None
    assert again.info["log"] == first.info["log"] == _ptxas_log()
    assert again.info["path"] == first.info["path"]
    chip_smoke.check_tensor_core_bwd_spills(again.info["log"])


def test_library_without_its_log_is_built_again(tree, fake_nvcc):
    _build.KernelLibrary(tree / "kernel.cu", lambda lib: None).load()
    for log in (_build.BUILD_DIR).glob("*.log"):
        log.unlink()
    again = _build.KernelLibrary(tree / "kernel.cu", lambda lib: None)
    again.load()
    assert len(fake_nvcc) == 2
    assert again.info["log"] == _ptxas_log()
    assert len(list(_build.BUILD_DIR.glob("*.log"))) == 1


@pytest.mark.parametrize("log,error", [
    (_ptxas_log(spill=4), "spills"),
    (_ptxas_log(drop=1), "not 12"),
    ("", "reported 0"),
], ids=["spill", "one-missing", "empty"])
def test_tensor_core_bwd_spill_check_fails(log, error):
    import chip_smoke

    with pytest.raises(AssertionError, match=error):
        chip_smoke.check_tensor_core_bwd_spills(log)


def _rwkv6_bwd_log(spill: int = 0, drop: int = 0) -> str:
    """ptxas' lines for ``rwkv6_scan_bwd.cu``'s entry functions (pass A at
    four (hd, rows) pairs, passes B and C at two hds, each for its types),
    ``spill`` bytes of spill stores for the first, the last ``drop`` left
    out."""
    types = ["ff", "f13__nv_bfloat16", "13__nv_bfloat16f",
             "13__nv_bfloat16S1_"]
    entries = [f"22rwkv6_bwd_state_kernelILi{hd}ELi{rows}E{ty}EEvPKT1_"
               for hd, rows in ((64, 32), (64, 16), (32, 32), (32, 16))
               for ty in types]
    entries += [f"22rwkv6_bwd_chunk_kernelILi{hd}E{ty}EEvPKT0_"
                for hd in (64, 32) for ty in types]
    entries += [f"19rwkv6_bwd_du_kernelILi{hd}E{ty}EEvPKfPT0_lii"
                for hd in (64, 32) for ty in ("f", "13__nv_bfloat16")]
    lines = []
    for n, entry in enumerate(entries[:len(entries) - drop]):
        lines += [
            "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__"
            f"b426c5de_17_rwkv6_scan_bwd_cu_58d132f8{entry}' for 'sm_90a'",
            f"    0 bytes stack frame, {spill if n == 0 else 0} bytes "
            "spill stores, 0 bytes spill loads",
            "ptxas info    : Used 128 registers, used 16 barriers"]
    return "\n".join(lines) + "\n"


def test_rwkv6_bwd_spill_check_passes_a_clean_log(capsys):
    import chip_smoke

    chip_smoke.check_rwkv6_bwd_spills(_rwkv6_bwd_log())
    out = capsys.readouterr().out
    assert out.count("rwkv6_scan_bwd.cu") == chip_smoke.RW_BWD_ENTRIES == 28
    assert "rwkv6_bwd_chunk_kernel<64,bf16,bf16>" in out


@pytest.mark.parametrize("log,error", [
    (_rwkv6_bwd_log(spill=80), "spills"),
    (_rwkv6_bwd_log(drop=1), "not 28"),
    ("", "reported 0"),
], ids=["spill", "one-missing", "empty"])
def test_rwkv6_bwd_spill_check_fails(log, error):
    import chip_smoke

    with pytest.raises(AssertionError, match=error):
        chip_smoke.check_rwkv6_bwd_spills(log)


def _rglru_bwd_log(spill: int = 0, drop: int = 0) -> str:
    """ptxas' lines for ``rglru_scan_bwd.cu``'s entry functions (the read
    form at two copy widths, the gated form the same for two types of u,
    the sum over B for two types), ``spill`` bytes of spill stores for the
    first, the last ``drop`` left out."""
    entries = [f"21rglru_bwd_read_kernelILi32ELi{vec}EEEvPKfS2_S2_S2_PfS3_"
               for vec in (4, 1)]
    entries += [f"22rglru_bwd_gated_kernelILi8ELi{vec}E{ty}EEvPKT1_PKv"
                for vec in (4, 1) for ty in ("f", "t")]
    entries += [f"20rglru_bwd_sum_kernelI{ty}EEvPKfPT_S3_S3_S3_Pfll"
                for ty in ("f", "t")]
    lines = []
    for n, entry in enumerate(entries[:len(entries) - drop]):
        lines += [
            "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__"
            f"0c4e8a1b_17_rglru_scan_bwd_cu_3f1a2b6c{entry}' for 'sm_90a'",
            f"    0 bytes stack frame, {spill if n == 0 else 0} bytes "
            "spill stores, 0 bytes spill loads",
            "ptxas info    : Used 96 registers, used 2 barriers, 368 bytes "
            "cmem[0]"]
    return "\n".join(lines) + "\n"


def test_rglru_bwd_spill_check_passes_a_clean_log(capsys):
    import chip_smoke

    chip_smoke.check_rglru_bwd_spills(_rglru_bwd_log())
    out = capsys.readouterr().out
    assert out.count("rglru_scan_bwd.cu") == chip_smoke.RG_BWD_ENTRIES == 8
    assert "rglru_bwd_gated_kernel<8,4,bf16>" in out
    assert "rglru_bwd_sum_kernel<f32>" in out


@pytest.mark.parametrize("log,error", [
    (_rglru_bwd_log(spill=8), "spills"),
    (_rglru_bwd_log(drop=1), "not 8"),
    ("", "reported 0"),
], ids=["spill", "one-missing", "empty"])
def test_rglru_bwd_spill_check_fails(log, error):
    import chip_smoke

    with pytest.raises(AssertionError, match=error):
        chip_smoke.check_rglru_bwd_spills(log)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN50_GLOBAL__N__0c4e8a1b_17_rglru_scan_bwd_cu_3f1a2b6c22rglru_bwd_gated_kernelILi8ELi4EtEEvPKT1_PKv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R2, R3 ;
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R4], R5 ;
        /*0030*/               @!P0 BRA 0x20 ;
        /*0040*/                   ISETP.GT.U32.AND P1, PT, R2, R6, PT ;
        /*0050*/                @P1 BRA P3, 0x80 ;
        /*0060*/                   CALL.REL.NOINC 0x140 ;
        /*0070*/                   BRA 0x90 ;
        /*0080*/                   MUFU.RCP R7, R2 ;
        /*0090*/                   FADD R8, R7, R2 ;
        /*00a0*/                   STG.E.U16 desc[UR4][R10.64], R8 ;
        /*00b0*/                   STG.E.U16 desc[UR4][R12.64], R8 ;
        /*00c0*/                @P2 BRA 0x10 ;
.L_x_1:
        /*00d0*/                   LDS R1, [R2] ;
        /*00e0*/                   FMUL R3, R4, R5 ;
        /*00f0*/                   FADD R5, R3, R1 ;
        /*0100*/                   FMUL R3, R4, R5 ;
        /*0110*/                   FADD R5, R3, R1 ;
        /*0120*/                @P3 BRA `(.L_x_1) ;
        /*0130*/                   EXIT ;
        /*0140*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_count_takes_the_hot_path_of_the_math_loop():
    """On a made-up listing: the math loop (0x10-0xc0, two MUFU) without
    its nested wait loop and its slow-path CALL is 8 instructions over two
    stores; the walk loop is 6 instructions over two FADD steps; 8 lanes."""
    import chip_smoke

    got = chip_smoke.sass_per_element(_SASS, lambda e: "rglru_bwd" in e)
    assert list(got) == ["rglru_bwd_gated_kernel<8,4,bf16>"]
    one = got["rglru_bwd_gated_kernel<8,4,bf16>"]
    assert one["static"] == 21 and one["math_loop"] == 12
    assert one["hot_path"] == 8 and one["math_stores"] == 2
    assert one["math"] == 4.0 and one["walk_per_step"] == 3.0
    assert one["walk_lanes"] == 8
    assert one["per_element"] == 4.0 + 32 * 3.0 / 8
    assert chip_smoke._instr_floor_ms(32 * 528, 1.0) == 1e3 / 1.98e9


# -- each wrapper's ctypes declarations against its source's C interface -----

_C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "int32_t": ctypes.c_int32,
            "uint32_t": ctypes.c_uint32, "float": ctypes.c_float,
            "double": ctypes.c_double}


def _c_signatures(source: Path) -> dict:
    """``{name: [ctypes type of each parameter]}`` of every ``extern "C"``
    function defined in ``source``."""
    sigs = {}
    text = source.read_text()
    for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         text):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        sigs[m.group(1)] = [
            ctypes.c_void_p if "*" in p
            else _C_TYPES[p.replace("const", "").split()[0]] for p in params]
    return sigs


def _libraries():
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     rglru_scan, rglru_scan_bwd, rwkv6_scan,
                                     rwkv6_scan_bwd, subsample_gather,
                                     subsample_grid)
    mods = (flash_attention, flash_attention_bwd, rglru_scan, rglru_scan_bwd,
            rwkv6_scan, rwkv6_scan_bwd, subsample_gather, subsample_grid)
    return [lib for mod in mods for lib in vars(mod).values()
            if isinstance(lib, _build.KernelLibrary)]


@pytest.mark.parametrize("lib", _libraries(), ids=lambda lib: lib.source.name)
def test_wrapper_declares_its_sources_c_interface(lib):
    """Every function a wrapper declares exists in its source with the
    parameters its ``argtypes`` name, in order: a pointer passed as a
    32-bit int, or a missing argument, would reach the card unseen."""
    declared = {}

    class Recorder:
        def __getattr__(self, name):
            fn = declared.setdefault(name, SimpleNamespace())
            return fn

    lib._declare(Recorder())
    sigs = _c_signatures(lib.source)
    assert declared, lib.source
    for name, fn in declared.items():
        assert name in sigs, f"{name} is not defined in {lib.source.name}"
        assert list(fn.argtypes) == sigs[name], name
