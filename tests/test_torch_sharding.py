"""PyTorch port, sharding, meshes and elastic restore against the
reference: the woven rules, every parameter's spec and shard shape, and
every cell's input and cache specs on the production meshes (the
reference's on `jax.sharding.AbstractMesh`, shard shapes from
`NamedSharding.shard_shape`), `validate_mesh_rules` and `plan_rescale`; a
mesh of one card (on the CPU here) giving the same logits, tokens and
gradients bit for bit as no mesh; an abstract mesh of several devices
refused (it has no ranks to run on; a live mesh runs in
`test_torch_mesh_parallel.py`), and so are the FSDP layouts on a live
mesh; and `reshard_params` restoring a checkpoint bit for bit onto a mesh
of one.  All comparisons are exact."""

import collections
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.core.program import Program as JProgram
from repro.core.strategies.parallelization import AutoShard as JAutoShard
from repro.core.weaver import weave as jweave_aspects
from repro.distributed.elastic import plan_rescale as jplan_rescale
from repro.distributed.sharding import input_shardings as jinput_shardings
from repro.distributed.sharding import param_shardings as jparam_shardings
from repro.distributed.sharding import validate_mesh_rules as jvalidate
from repro.launch.weave import default_weave as jdefault_weave
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_config as jget
from repro.models.registry import input_specs as jinput_specs
from repro.nn.module import abstract_params as jabstract
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.core.strategies.parallelization import AutoShard
from repro_torch.core.weaver import weave
from repro_torch.distributed.elastic import plan_rescale, reshard_params
from repro_torch.distributed.sharding import (check_layout, input_shardings,
                                              logical_to_pspec, param_shardings,
                                              shard_shape, validate_mesh_rules)
from repro_torch.launch.mesh import (Mesh, make_card_mesh, make_production_mesh,
                                     make_test_mesh, mesh_name)
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import ARCHS, build_model, cells, get_config, input_specs
from repro_torch.nn.module import Ctx, flatten_specs, init_params
from repro_torch.optim import adamw
from repro_torch.optim.tree import leaves, tree_map
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.steps import build_decode_step, build_grad_fn, build_train_step

MESHES = {"pod": False, "multipod": True}


def _meshes(multi_pod):
    ours = make_production_mesh(multi_pod=multi_pod)
    return ours, AbstractMesh(ours.axis_sizes, ours.axis_names)


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _jby_path(tree):
    is_leaf = lambda x: isinstance(x, JNamedSharding) or (  # noqa: E731
        hasattr(x, "shape") and hasattr(x, "dtype"))
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _port_rules(arch, shape, axes):
    program = Program.from_arch(arch, kind=SHAPES[shape].kind, device="meta")
    return default_weave(program, shape, axes).state.rules


def test_mesh_shapes_and_names():
    assert dict(make_production_mesh().shape) == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert mesh_name(make_production_mesh(multi_pod=True)) == "multipod_2x16x16"
    assert mesh_name(make_production_mesh()) == "pod_16x16"
    card = make_card_mesh("cpu")
    assert card.shape == {"data": 1, "model": 1} and card.size == 1
    assert card.devices == (torch.device("cpu"),) and mesh_name(card) == "card_1x1"
    assert make_production_mesh().abstract and not card.abstract
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_card_mesh()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_equal_the_reference_given_the_same_device_memory(mesh):
    """AutoShard's layouts and FSDP choices, for every cell.  The port sizes
    FSDP for an 80 GB card, the reference for a 16 GiB TPU: each package's
    `default_weave` rules equal the other's AutoShard handed its memory."""
    axes = dict(make_production_mesh(multi_pod=MESHES[mesh]).shape)
    for arch in ARCHS:
        for shape in cells(arch):
            train = SHAPES[shape].kind == "train"
            jprog = JProgram.from_arch(arch, kind="train")
            tprog = Program.from_arch(arch, kind="train", device="meta")
            ours = _port_rules(arch, shape, axes)
            theirs = jweave_aspects(jprog, [JAutoShard(axes, hbm_bytes=80 << 30,
                                                       train=train)]).state.rules
            assert ours == theirs, (arch, shape)
            ref = jdefault_weave(jprog, shape, axes).state.rules
            ours16 = weave(tprog, [AutoShard(axes, hbm_bytes=16 << 30,
                                             train=train)]).state.rules
            assert ours16 == ref, (arch, shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_shard_shapes_equal_the_reference(arch):
    """Every leaf's spec entries equal the reference's `PartitionSpec` and
    its shard shape `NamedSharding.shard_shape`, under the rules the port
    weaves for each cell, on both production meshes."""
    model, jmodel = build_model(get_config(arch)), jbuild(jget(arch))
    shapes = {p.split("/", 1)[1]: s.shape for p, s in flatten_specs(model).items()}
    jshapes = {p: s.shape for p, s in _jby_path(jabstract(jmodel)).items()}
    assert shapes == jshapes
    for multi_pod in MESHES.values():
        ours_mesh, jmesh = _meshes(multi_pod)
        seen = []
        for shape in cells(arch):
            rules = _port_rules(arch, shape, dict(ours_mesh.shape))
            if rules in seen:
                continue
            seen.append(rules)
            ours = _by_path(param_shardings(model, ours_mesh, rules))
            theirs = _jby_path(jparam_shardings(jmodel, jmesh, rules))
            assert set(ours) == set(theirs)
            for path, sh in ours.items():
                assert sh.spec == tuple(theirs[path].spec), (path, rules)
                assert sh.shard_shape(shapes[path]) == \
                    tuple(theirs[path].shard_shape(shapes[path])), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_equal_the_reference(arch):
    for multi_pod in MESHES.values():
        ours_mesh, jmesh = _meshes(multi_pod)
        for shape in cells(arch):
            rules = _port_rules(arch, shape, dict(ours_mesh.shape))
            ours_specs, theirs_specs = input_specs(get_config(arch), shape), \
                jinput_specs(jget(arch), shape)
            for part in ("inputs", "cache"):
                if theirs_specs[part] is None:
                    assert ours_specs[part] is None
                    continue
                ours = _by_path(input_shardings(ours_specs[part], ours_mesh, rules))
                theirs = _jby_path(jinput_shardings(theirs_specs[part], jmesh, rules))
                assert set(ours) == set(theirs), (shape, part)
                leaf_shapes = _by_path(ours_specs[part])
                for path, sh in ours.items():
                    assert sh.spec == tuple(theirs[path].spec), (shape, path)
                    global_shape = tuple(leaf_shapes[path][0])
                    assert sh.shard_shape(global_shape) == \
                        tuple(theirs[path].shard_shape(global_shape)), (shape, path)


def test_logical_to_pspec_guards_shapes_like_the_reference():
    from repro.distributed.sharding import logical_to_pspec as jlogical

    ours_mesh, jmesh = _meshes(True)
    rules = {"batch": ("pod", "data"), "embed": ("data", "model"), "heads": "model",
             "mlp": None}
    for axes, shape in [(("batch", "embed"), (512, 4096)), (("batch", "embed"), (8, 4096)),
                        (("batch", "embed"), (2, 8)), (("embed", "heads"), (4096, 8)),
                        (("heads", "heads"), (16, 16)), (("mlp", None), (4, 4))]:
        want = jlogical(axes, rules, jmesh, shape)
        got = logical_to_pspec(axes, rules, ours_mesh, shape)
        assert got == (None if want is None else tuple(want)), (axes, shape)
    assert shard_shape((512, 4096), ("data", None), ours_mesh) == (32, 4096)
    with pytest.raises(ValueError, match="divide"):
        shard_shape((10,), ("data",), ours_mesh)


def _jmesh(shape, axes):
    """A duck-typed reference mesh: `plan_rescale` reads `shape` and
    `devices.size` (the CPU here has one device)."""
    return types.SimpleNamespace(shape=collections.OrderedDict(zip(axes, shape)),
                                 devices=np.empty(shape))


def test_validate_and_plan_rescale_like_the_reference():
    """The reference's `TestElastic` case (a 2 x 2 mesh, DP 2) and a batch
    that does not divide, and rules naming an axis the mesh lacks."""
    rules = {"batch": ("data",), "heads": "model", "mlp": "model",
             "vocab": "model", "embed": None, "kv_heads": "model"}
    ours_mesh, jmesh = make_test_mesh((2, 2)), _jmesh((2, 2), ("data", "model"))
    assert plan_rescale(8, ours_mesh, rules) == jplan_rescale(8, jmesh, rules) == {
        "dp": 2, "per_replica_batch": 4, "devices": 4}
    for fn, mesh in ((plan_rescale, ours_mesh), (jplan_rescale, jmesh)):
        with pytest.raises(ValueError, match="not divisible by new DP degree 2"):
            fn(7, mesh, rules)
    bad = dict(rules, batch=("pod", "data"))
    for fn, mesh in ((validate_mesh_rules, ours_mesh), (jvalidate, jmesh)):
        with pytest.raises(ValueError, match="axis 'pod' not in mesh"):
            fn(mesh, bad)
        fn(mesh, rules)


# ---------------------------------------------------------------------------
# a mesh of one card
# ---------------------------------------------------------------------------


def _reduced_server(mesh):
    program = Program.from_arch("yi-6b", kind="serve", reduced=True, device="cpu")
    woven = default_weave(program, "prefill_32k", {})
    return Server(woven, ServerConfig(max_cache_len=48, decode_tokens=4, seed=0),
                  mesh=mesh)


def test_mesh_of_one_serves_and_trains_bit_for_bit():
    card = make_card_mesh("cpu")
    plain, meshed = _reduced_server(None), _reduced_server(card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int64) for n in (5, 9, 12)]
    for a, b in zip(plain.serve_batch(prompts), meshed.serve_batch(prompts)):
        np.testing.assert_array_equal(a, b)
    toks = torch.as_tensor(rng.integers(0, 512, (2, 7)), dtype=torch.int32)
    la, ca = plain.prefill_vc(None, plain.params, {"tokens": toks})
    lb, cb = meshed.prefill_vc(None, meshed.params, {"tokens": toks})
    assert torch.equal(la, lb)
    step = {"tokens": toks[:, :1], "positions": torch.full((2, 1), 7, dtype=torch.int32)}
    assert torch.equal(build_decode_step(plain.woven)(plain.params, step, ca)[0],
                       build_decode_step(meshed.woven, mesh=card)(meshed.params, step, cb)[0])

    program = Program.from_arch("yi-6b", kind="train", reduced=True, device="cpu")
    woven = default_weave(program, SHAPES["train_4k"], dict(card.shape),
                          overrides={"accum_steps": 2})
    params = init_params(program.model, 0, woven.state.policies, "cpu")
    batch = {k: torch.as_tensor(rng.integers(0, 512, (4, 16)), dtype=torch.int32)
             for k in ("tokens", "labels")}
    (loss_a, _), ga = build_grad_fn(woven)(params, batch)
    (loss_b, _), gb = build_grad_fn(woven, mesh=card)(params, batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(x, y) for x, y in zip(leaves(ga), leaves(gb)))
    outs = []
    for mesh in (None, card):
        p = tree_map(lambda t: t.detach().clone(), params)
        opt = adamw.init_state(p, adamw.AdamWConfig())
        p, _, _ = build_train_step(woven, mesh=mesh)(p, opt, batch, 0)
        outs.append(leaves(p))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_a_mesh_of_more_than_one_device_raises():
    """An abstract mesh of several devices has no ranks to run a step on;
    a live one is built by `make_mesh` / `run_on_mesh` (and runs AutoShard's
    layouts; an FSDP split over ranks that hold the same tokens and
    Megatron's sequence-split rules raise there)."""
    two = make_test_mesh((2, 1))
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        Ctx(mesh=two)
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        _reduced_server(two)
    program = Program.from_arch("yi-6b", kind="serve", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        build_decode_step(default_weave(program, "decode_32k", {}), mesh=two)
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        _reduced_server(make_test_mesh((1, 1)))
    Ctx(mesh=make_test_mesh((1, 1)))  # costing on meta: a mesh of one, no device
    with pytest.raises(ValueError, match="make_mesh"):
        Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)  # no groups
    live = types.SimpleNamespace(groups=(None, None), shape={"data": 2, "model": 2})
    rules = {"batch": ("data",), "heads": "model", "embed": ("data",)}
    check_layout(live, rules)  # Megatron's layout with its FSDP rule
    with pytest.raises(NotImplementedError, match="15a"):
        check_layout(live, dict(rules, embed=("model",)))
    sp = {"batch": ("data",), "res_seq": "model", "seq_act": "model", "vocab": "model"}
    check_layout(live, sp, "fsdp_sp")
    # serving under fsdp_sp runs since ROADMAP item 15a-ii: its caches split
    # over the residual stream's axis; Megatron's sequence rules wait (15a-iii)
    check_layout(live, dict(sp, kv_seq="model"), "fsdp_sp")
    with pytest.raises(NotImplementedError, match="15a-iii"):
        check_layout(live, dict(rules, kv_seq="model"), "megatron_tp")
    check_layout(live, dict(rules, embed=None), "megatron_tp")
    check_layout(two, rules)  # an abstract mesh: the dry run's layouts stand


def test_reshard_params_onto_a_mesh_of_one(tmp_path):
    program = Program.from_arch("yi-6b", kind="train", reduced=True, device="cpu")
    params = init_params(program.model, 3, device="cpu")
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(5, {"params": params, "opt": {"count": torch.zeros(())}})
    rules = {"batch": ("data",), "heads": "model", "mlp": "model", "vocab": "model",
             "embed": None, "kv_heads": "model"}
    template = params
    placed, manifest = reshard_params(program.model, ckpt, make_card_mesh("cpu"), rules,
                                      template, 5)
    assert manifest["step"] == 5
    got, want = leaves(placed), leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype and torch.equal(g, w)
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        reshard_params(program.model, ckpt, make_test_mesh((1, 1)), rules, template, 5)
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        reshard_params(program.model, ckpt, make_test_mesh((2, 2)), rules, template, 5)
