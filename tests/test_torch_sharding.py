"""The port's sharding rules against the reference's: the PartitionSpec of
every leaf of every architecture's parameters, AdamW state (with and
without ZeRO-1), decode cache (with and without the sequence-sharded
cache) and batch, on the single (16, 16) and multi (2, 16, 16) production
meshes, under the three rule tables. The reference reads only the mesh's
shape and axis names, so it runs on a ``jax.sharding.AbstractMesh``; the
port on a ``DeviceMesh`` over a fake world of 256 or 512 ranks in this
process."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import registry as ref_registry
from repro.models import spec as ref_spec
from repro.serve import abstract_cache as ref_abstract_cache
from repro.serve import cache_pspecs as ref_cache_pspecs
from repro.train import AdamW as RefAdamW
from repro.train import batch_pspecs as ref_batch_pspecs
from repro.train import state_pspecs as ref_state_pspecs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import registry, spec
from repro_torch.serve import abstract_cache, cache_pspecs
from repro_torch.train import AdamW
from repro_torch.train.step import batch_pspecs, state_pspecs
from tests._torch_dist import destroy_default_group


@pytest.fixture(scope="module", autouse=True)
def _no_group_outlives_this_file():
    """The fake worlds this file's tests make are destroyed when the file
    ends, so the next file on this pytest worker starts with no group."""
    yield
    destroy_default_group()


RULES = {"default": (ref_spec.DEFAULT_RULES, spec.DEFAULT_RULES),
         "seq_shard": (ref_spec.seq_shard_rules(), spec.seq_shard_rules()),
         "seq_parallel": (ref_spec.seq_parallel_rules(), spec.seq_parallel_rules())}
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(p) for path, p in leaves}


def _port_flat(tree, prefix=()) -> dict:
    if isinstance(tree, spec.PartitionSpec):
        return {"/".join(prefix): tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_port_flat(v, prefix + (str(k),)))
    return out


def _same(ref: dict, port: dict, what: str) -> int:
    assert set(ref) == set(port), f"{what}: leaves differ: {sorted(set(ref) ^ set(port))}"
    for name in ref:
        assert port[name] == ref[name], f"{what} {name}: port {port[name]}, ref {ref[name]}"
    return len(ref)


def _mesh(name):
    shape, _ = MESHES[name]
    fake_world(256 if len(shape) == 2 else 512)
    return make_production_mesh(multi_pod=name == "multi")


def test_registries_agree():
    assert ARCH_IDS == REF_ARCHS
    assert {k: tuple(v.__dict__.values()) for k, v in SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_the_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh = jax.sharding.AbstractMesh(shape, axes)
    mesh = _mesh(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    decode = SHAPES["decode_32k"]
    checked = 0
    for rules_name, (ref_rules, rules) in RULES.items():
        what = f"{arch}/{mesh_name}/{rules_name}"
        checked += _same(
            _ref_flat(ref_spec.partition_specs(ref_registry.abstract_params(ref_cfg), ref_mesh,
                                               ref_rules)),
            _port_flat(spec.partition_specs(registry.abstract_params(cfg), mesh, rules)),
            f"{what} params")
        for zero1 in (False, True):
            ref_st = ref_state_pspecs(ref_cfg, ref_mesh, RefAdamW(), zero1=zero1, rules=ref_rules)
            st = state_pspecs(cfg, mesh, AdamW(), zero1=zero1, rules=rules)
            checked += _same(_ref_flat(ref_st), _port_flat(st), f"{what} state zero1={zero1}")
        for seq_shard in (False, True):
            ref_cache = ref_abstract_cache(ref_cfg, decode.global_batch, decode.seq_len)
            cache = abstract_cache(cfg, decode.global_batch, decode.seq_len)
            checked += _same(
                _ref_flat(ref_cache_pspecs(ref_cfg, ref_cache, ref_mesh, ref_rules,
                                           seq_shard=seq_shard)),
                _port_flat(cache_pspecs(cfg, cache, mesh, rules, seq_shard=seq_shard)),
                f"{what} cache seq_shard={seq_shard}")
        for batch in (1, 32, 256):
            checked += _same(_ref_flat(ref_batch_pspecs(ref_cfg, ref_mesh, batch, ref_rules)),
                             _port_flat(batch_pspecs(cfg, mesh, batch, rules)),
                             f"{what} batch {batch}")
    assert checked > 100


def test_logical_to_pspec_drops_non_divisible_axes_from_the_right():
    ref_mesh = jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    mesh = _mesh("multi")
    for axes, shape in [(("batch", "seq"), (32, 8)), (("batch", "seq"), (6, 8)),
                        (("batch", "seq"), (1, 8)), (("heads", "kv_heads"), (16, 8)),
                        (("kv_heads", "heads"), (8, 32)), (("vocab", "embed"), (151936, 1024)),
                        (("batch", "experts", None, "embed"), (64, 64, 10, 128))]:
        want = tuple(ref_spec.logical_to_pspec(axes, ref_mesh, shape=shape))
        assert tuple(spec.logical_to_pspec(axes, mesh, shape=shape)) == want, (axes, shape)


def test_to_placements_multi_axis_and_replicated_dims():
    mesh = _mesh("multi")
    P = spec.PartitionSpec
    assert spec.to_placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert spec.to_placements(P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert spec.to_placements(P(), mesh) == (Replicate(),) * 3
    # a batch of 6 splits over pod alone: data is dropped, and so replicated
    ps = spec.logical_to_pspec(("batch", "heads"), mesh, shape=(6, 16))
    assert ps == P("pod", "model")
    assert spec.to_placements(ps, mesh) == (Shard(0), Replicate(), Shard(1))
    # each rank's box of a tensor laid out that way: rank 0 holds the first
    # pod's half of the batch and the first model shard of the heads
    box = spec.local_box((6, 16), mesh, spec.to_placements(ps, mesh))
    assert box == (slice(0, 3), slice(0, 1))
    meta = spec.distribute(torch.empty((6, 16), device="meta"), mesh,
                           spec.to_placements(ps, mesh))
    assert tuple(meta.shape) == (6, 16) and tuple(meta.to_local().shape) == (3, 1)
    # a spec tree's meta stand-ins, laid out by its named shardings
    tree = registry.abstract_params(get_config("qwen3-0.6b"))
    meta = spec.abstract(tree, spec.named_shardings(tree, mesh), mesh)
    wq = meta["layers"]["attn"]["wq"]  # (L, d, heads, hd), heads over model
    assert wq.device.type == "meta" and tuple(wq.shape) == tree["layers"]["attn"]["wq"].shape
    assert wq.to_local().shape[2] == wq.shape[2] // 16
    assert spec.abstract(tree)["embed"]["tok"].device.type == "meta"


def test_trivial_mesh_is_the_identity():
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    assert spec.is_trivial(mesh)
    t = torch.arange(6.0).reshape(2, 3)
    assert spec.distribute(t, mesh, (Shard(0), Shard(1))) is t
    with spec.activation_sharding(mesh):
        assert spec.current_mesh() is None
        assert spec.shard_activation(t, ("batch", "embed")) is t
        assert spec.shard_input(t, ("batch", "seq")) is t
