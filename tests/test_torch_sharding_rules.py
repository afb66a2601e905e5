"""The port's logical-axis sharding rules, meshes, sharding hints and the
optimizer state's layout (``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``, ``repro_torch.optim.adamw.init_structs`` /
``state_shardings``) against the reference's on the CPU.

The rule tests are the reference's ``tests/test_sharding_rules.py`` with
its ``FakeMesh`` (axis names and sizes only), a spec a tuple where the
reference's is a ``PartitionSpec``.  Then every registry config's
parameter and cache trees, under both rule sets on both production
meshes, must give the reference's specs leaf by leaf (each ``P`` turned
into a tuple) and its parameter count, and the optimizer state's shapes,
dtypes and specs must be the reference's for every ``moment_dtype``.
Everything is compared exactly: specs and shapes are integers and
names."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config import ARCH_IDS as REF_ARCH_IDS
from repro.config import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_sh
from repro_torch.config import ARCH_IDS, TrainConfig, get_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import moe as port_moe
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES,
                                           logical_to_spec, serve_rules)
from repro_torch.tree import tree_leaves_with_path


class FakeMesh:
    """Stand-in with just axis_names/shape for rule resolution tests."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}
# the configurations both registries hold (the port's deepseek-v2-lite
# has no reference to compare with)
LM_ARCHS = [a for a in ARCH_IDS
            if a != "paper-subsample" and a in REF_ARCH_IDS]


# -- the reference's rule tests ------------------------------------------------


def test_batch_spec_spans_pods():
    spec = logical_to_spec(("batch", "seq"), MULTI, TRAIN_RULES,
                           (256, 4096))
    assert spec == (("pod", "data"),)


def test_divisibility_fallback_batch_one():
    spec = logical_to_spec(("batch", "seq"), MULTI, TRAIN_RULES, (1, 1))
    assert spec == ()


def test_embed_fsdp_spans_pods_when_divisible():
    spec = logical_to_spec(("vocab", "embed"), MULTI, TRAIN_RULES,
                           (152064, 8192))
    assert spec == ("model", ("data", "pod"))


def test_embed_fallback_when_not_divisible_by_pods():
    # 8 % (16·2) != 0 → trims pod, then 8 % 16 != 0 → replicate
    spec = logical_to_spec(("embed",), MULTI, TRAIN_RULES, (8,))
    assert spec == ()


def test_serve_rules_replicate_embed_except_arctic():
    assert SERVE_RULES["embed"] is None
    arctic = serve_rules(get_config("arctic-480b"))
    assert arctic["embed"] == "data"
    dense = serve_rules(get_config("qwen2-72b"))
    assert dense["embed"] is None


def test_kv_seq_sharded_only_for_serving():
    assert TRAIN_RULES["kv_seq"] is None
    assert SERVE_RULES["kv_seq"] == "model"


def test_all_arch_param_dims_shard_on_production_mesh():
    """Every param leaf of every arch must shard (or cleanly fall back)
    on the 16×16 mesh — guards against new configs breaking divisibility."""
    for arch in ("qwen2-72b", "arctic-480b", "rwkv6-7b",
                 "recurrentgemma-2b", "musicgen-medium", "deepseek-v2-lite"):
        defs = build_model(get_config(arch), device="cpu").param_defs()
        for _, leaf in tree_leaves_with_path(defs):
            spec = logical_to_spec(leaf.logical, SINGLE, TRAIN_RULES,
                                   leaf.shape)
            for dim, part in zip(leaf.shape, spec):
                if part is None:
                    continue
                axes = (part,) if isinstance(part, str) else part
                size = int(np.prod([SINGLE.shape[a] for a in axes]))
                assert dim % size == 0, (arch, leaf.shape, spec)


def test_rules_are_the_references():
    assert dict(TRAIN_RULES) == dict(ref_sh.TRAIN_RULES)
    assert dict(SERVE_RULES) == dict(ref_sh.SERVE_RULES)
    for arch in LM_ARCHS:
        assert dict(serve_rules(get_config(arch))) == dict(
            ref_sh.serve_rules(ref_get_config(arch)))


# -- every registry config against the reference -------------------------------


def _ref_specs_by_path(defs, mesh, rules):
    """The reference's ``tree_specs``, each ``P`` as a tuple, by path."""
    specs = ref_sh.tree_specs(defs, mesh, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(tuple(_key(k) for k in path), tuple(spec))
            for path, spec in flat]


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _port_specs_by_path(defs, mesh, rules):
    """The port's ``tree_specs`` read at every ParamDef's path (a spec is
    a tuple, which a tree walk would enter)."""
    specs = sh.tree_specs(defs, mesh, rules)
    out = []
    for path, _ in tree_leaves_with_path(defs):
        node = specs
        for k in path:
            node = node[k]
        out.append((path, node))
    return out


def _trees(cfg, ref_cfg):
    """(name, port defs, reference defs): parameters, and the decode and
    prefill caches of a small batch."""
    port = build_model(cfg, device="cpu")
    ref = ref_build_model(ref_cfg)
    yield "params", port.param_defs(), ref.param_defs()
    for mode in ("decode", "prefill"):
        yield (f"{mode} cache", port.cache_defs(32, 4096, mode=mode),
               ref.cache_defs(32, 4096, mode=mode))


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("rules", ("train", "serve"))
@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_tree_specs_equal_the_references(arch, rules, mesh):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    port_rules = TRAIN_RULES if rules == "train" else serve_rules(cfg)
    ref_rules = (ref_sh.TRAIN_RULES if rules == "train"
                 else ref_sh.serve_rules(ref_cfg))
    for name, port_defs, ref_defs in _trees(cfg, ref_cfg):
        got = _port_specs_by_path(port_defs, MESHES[mesh], port_rules)
        want = _ref_specs_by_path(ref_defs, MESHES[mesh], ref_rules)
        assert got == want, (arch, name)
        assert sh.param_count(port_defs) == ref_sh.param_count(ref_defs)


def test_named_sharding_and_shard_shape():
    s = sh.named_sharding(("vocab", "embed"), MULTI, TRAIN_RULES,
                          (152064, 8192))
    assert s.spec == ("model", ("data", "pod"))
    assert s.shard_shape((152064, 8192)) == (152064 // 16, 8192 // 32)
    repl = sh.named_sharding(("embed",), MULTI, TRAIN_RULES, (8,))
    assert repl.shard_shape((8,)) == (8,)


def test_tree_shape_structs_are_meta_tensors():
    defs = build_model(get_config("deepseek-7b"), device="cpu").param_defs()
    structs = sh.tree_shape_structs(defs, torch.bfloat16)
    for (path, d), (_, t) in zip(tree_leaves_with_path(defs),
                                 tree_leaves_with_path(structs)):
        assert t.is_meta and tuple(t.shape) == d.shape, path
        assert t.dtype == (d.dtype or torch.bfloat16)


# -- sharding hints ------------------------------------------------------------


def test_hint_is_the_identity_outside_hint_mesh():
    x = torch.ones(4, 8)
    assert port_moe.hint(x, "model", None) is x


def test_hint_mesh_records_the_references_spec():
    """Inside ``hint_mesh`` a hint resolves the spec the reference would
    pin (its own divisibility fallback) and returns the tensor itself."""
    x = torch.empty(64, 12, 256, device="meta")
    with sh.hint_mesh(MULTI) as ctx:
        assert sh.hint(x, ("pod", "data"), "model", None) is x
        sh.hint(x, "model", None, ("data", "pod"))
    assert ctx.pins == [((64, 12, 256), (("pod", "data"), None, None)),
                        ((64, 12, 256), ("model", None, ("data", "pod")))]
    assert sh.hint(x, "model") is x and len(ctx.pins) == 2


def test_moe_hints_fire_at_the_references_sites():
    """The MoE layer pins its dispatch intermediates inside
    ``hint_mesh`` (einsum mode: five of the reference's six sites, since
    the port forms no [T, E, C] dispatch tensor; scatter mode: the
    expert MLP's three) and computes the same outputs either way."""
    from repro_torch.launch.serve import reduced_variant
    cfg = reduced_variant(get_config("deepseek-moe-16b"))
    gen = torch.Generator().manual_seed(0)
    layer = sh.init_params(port_moe.moe_defs(cfg), torch.float32,
                           torch.device("cpu"), gen)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    for mode, sites in (("einsum", 5), ("scatter", 3)):
        plain, aux = port_moe.moe_apply(cfg, layer, x, dispatch=mode)
        with sh.hint_mesh(SINGLE) as ctx:
            hinted, aux2 = port_moe.moe_apply(cfg, layer, x, dispatch=mode)
        assert torch.equal(plain, hinted) and torch.equal(aux, aux2)
        assert len(ctx.pins) == sites, mode


# -- meshes ----------------------------------------------------------------


def test_production_and_test_meshes():
    single = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape) == (
        ("data", "model"), {"data": 16, "model": 16})
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    assert single.devices is None and multi.devices is None
    from repro_torch.config import MULTI_POD_MESH
    assert port_mesh.make_mesh(MULTI_POD_MESH) == multi
    test = port_mesh.make_test_mesh((2, 2), device="cpu")
    assert test.shape == {"data": 2, "model": 2}
    assert test.devices == (torch.device("cpu"),) * 4
    assert port_mesh.make_test_mesh(device="cpu").shape == {"data": 1,
                                                            "model": 1}
    # the rules take the port's meshes as they take the FakeMesh
    assert logical_to_spec(("vocab", "embed"), multi, TRAIN_RULES,
                           (152064, 8192)) == ("model", ("data", "pod"))


# -- the optimizer state's layout --------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("moment_dtype", ("float32", "bfloat16", "int8"))
@pytest.mark.parametrize("arch", ("deepseek-7b", "arctic-480b",
                                  "recurrentgemma-2b"))
def test_optimizer_state_layout_equals_the_references(arch, moment_dtype):
    """``init_structs`` and ``state_shardings`` give the reference's
    shapes, dtypes and specs leaf by leaf on the single-pod mesh (the
    reference's on an ``AbstractMesh``, the port's on the FakeMesh; specs
    as tuples)."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    tcfg = TrainConfig(moment_dtype=moment_dtype)
    from repro.config.base import TrainConfig as RefTrainConfig
    ref_tcfg = RefTrainConfig(moment_dtype=moment_dtype)
    ref_mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    port_m = SINGLE

    ref_defs = ref_build_model(ref_cfg).param_defs()
    ref_structs = ref_sh.tree_shape_structs(ref_defs, jax.numpy.bfloat16)
    ref_state = ref_adamw.init_structs(ref_structs, ref_tcfg)
    ref_shard = ref_adamw.state_shardings(
        ref_sh.tree_shardings(ref_defs, ref_mesh, ref_sh.TRAIN_RULES),
        ref_structs, ref_tcfg, ref_mesh, ("data", "model"))

    defs = build_model(cfg, device="cpu").param_defs()
    structs = sh.tree_shape_structs(defs, torch.bfloat16)
    state = adamw.init_structs(structs, tcfg)
    shard = adamw.state_shardings(sh.tree_shardings(defs, port_m,
                                                    TRAIN_RULES),
                                  structs, tcfg, port_m, ("data", "model"))

    want = [(tuple(t.shape), str(t.dtype), tuple(s.spec)) for t, s in zip(
        jax.tree.leaves(ref_state), jax.tree.leaves(
            ref_shard, is_leaf=lambda x: isinstance(
                x, jax.sharding.NamedSharding)))]
    got = [(tuple(t.shape), _dtype_name(t.dtype), s.spec)
           for (_, t), (_, s) in zip(tree_leaves_with_path(state),
                                     tree_leaves_with_path(shard))]
    assert len(got) == len(want) and got == want
    assert all(t.is_meta for _, t in tree_leaves_with_path(state))
