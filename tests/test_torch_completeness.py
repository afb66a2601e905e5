"""The port does all that the JAX package does: every public top-level
name of every module of ``src/repro`` has a counterpart at the same path
in ``src/repro_torch``.

Names are read by ``ast`` on both sides, with nothing imported: the
functions, classes and assigned names of each module, and for a
package's ``__init__.py`` also the names it imports (its public
interface; a submodule of the port's package of that name counts).
Each exception below carries its reason, which ROADMAP's "Contract
differences" repeats."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

ALLOWED = {
    "kernels/_compat.py": "the Pallas CompilerParams alias: the port has "
                          "no Pallas",
    "kernels/flash_attention.py::NEG_INF": "a constant of the Pallas "
                                           "kernel's masking",
    "kernels/ops.py::ON_TPU": "a constant: whether jax runs on a TPU",
    "kernels/ops.py::subsample_stats_shard": "the shard_map body: the port "
                                             "launches once for each mesh "
                                             "entry",
    "models/rwkv6.py::chunk_body": "the port's forward runs the kernel and "
                                   "kernels/ref.py::chunk_body",
    "launch/train.py::reduced_variant": "lives in "
                                        "repro_torch/launch/serve.py",
    "platform/driver.py::measure_per_sample_cost": "called by nothing in "
                                                   "the port",
    "platform/__init__.py::measure_per_sample_cost": "called by nothing in "
                                                     "the port",
    "launch/dryrun.py::lower_cell": "XLA lowering: the port runs the "
                                    "step on meta tensors "
                                    "(launch/dryrun.py::count_step)",
    "roofline/analysis.py::cost_from_compiled": "XLA's compiled artifact "
                                                "has no counterpart: the "
                                                "dry run counts on meta "
                                                "tensors",
    "roofline/__init__.py::cost_from_compiled": "XLA's compiled artifact "
                                                "has no counterpart",
    "roofline/hw.py::ICI_LINK_BW": "a TPU interconnect figure: the H100's "
                                   "is NVLINK_LINK_BW",
    "roofline/hw.py::VMEM_BYTES": "a TPU core's VMEM: the H100's shared "
                                  "memory is SMEM_BYTES",
}


def _names(path: pathlib.Path, with_imports: bool) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
        elif with_imports and isinstance(node, (ast.Import,
                                                ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in ALLOWED:
        return
    port = PORT / module
    assert port.exists(), f"{module} has no counterpart in the port"
    init = port.name == "__init__.py"
    want = _names(REF / module, with_imports=init)
    have = _names(port, with_imports=True)
    if init:
        have |= {p.stem for p in port.parent.glob("*.py")}
        have |= {p.name for p in port.parent.iterdir() if p.is_dir()}
    missing = sorted(n for n in want - have
                     if f"{module}::{n}" not in ALLOWED)
    assert not missing, f"{module}: {missing}"


def test_every_exception_names_a_reference_name():
    """No stale entry: each allowed name still exists in the reference
    and still lacks a counterpart."""
    for key in ALLOWED:
        module, _, name = key.partition("::")
        assert (REF / module).exists(), key
        if name:
            assert name in _names(REF / module, with_imports=True), key
            port = PORT / module
            assert not port.exists() or name not in _names(
                port, with_imports=True), f"{key} now has a counterpart"
        else:
            assert not (PORT / module).exists(), key
