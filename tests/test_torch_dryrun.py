"""PyTorch port, the dry run's model pieces against the reference:
`input_specs` for every (arch, cell) (leaves, shapes, dtypes), the cell
lists, `component_blocks` for every architecture reduced and full (names,
counts, block kinds, per-layer cache specs and kwargs), the attention's
`proj_only` impl on a reduced block (fp32, within 1e-5), and
`launch/dryrun.lower_cell` on the card mesh: the reference's record keys
but those only XLA gives, and `hbm_fits` from the analytic formula; on a
pod, the placements and `"roofline": null` with its reason."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import all_cells as jall_cells
from repro.models.registry import build_model as jbuild
from repro.models.registry import cells as jcells
from repro.models.registry import get_config as jget
from repro.models.registry import input_specs as jinput_specs
from repro.models.registry import reduced_config as jreduced
from repro.models.registry import skipped_cells as jskipped_cells
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.roofline.analysis import Roofline as JRoofline
from repro_torch.convert import load_jax_params
from repro_torch.launch import dryrun
from repro_torch.models.registry import (ARCHS, all_cells, build_model, cells, get_config,
                                         input_specs, reduced_config, skipped_cells)
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx, init_params
from repro_torch.roofline.hw import HBM_BYTES

from _torch_port import perturbed, t, to_np


def _leaf_pairs(ours, theirs, path=""):
    """(path, (shape, dtype) ours, ShapeDtypeStruct theirs) over two trees."""
    if theirs is None:
        assert ours is None, path
        return []
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, set(ours), set(theirs))
        return [x for k in theirs for x in _leaf_pairs(ours[k], theirs[k], f"{path}/{k}")]
    return [(path, ours, theirs)]


def _assert_specs_equal(ours, theirs):
    for path, (shape, dtype), sds in _leaf_pairs(ours, theirs):
        assert tuple(shape) == tuple(sds.shape), path
        assert str(dtype).removeprefix("torch.") == str(sds.dtype), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch):
    for shape in jcells(arch):
        ours, theirs = input_specs(get_config(arch), shape), jinput_specs(jget(arch), shape)
        assert set(ours) == set(theirs) == {"inputs", "cache"}
        _assert_specs_equal(ours["inputs"], theirs["inputs"])
        _assert_specs_equal(ours["cache"], theirs["cache"])


def test_cells_equal_the_reference():
    assert all_cells() == jall_cells()
    assert skipped_cells() == jskipped_cells()
    assert all(cells(a) == jcells(a) for a in ARCHS)
    assert len(all_cells()) == 33


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_component_blocks_equal_the_reference(arch, reduced):
    cfg = reduced_config(arch) if reduced else get_config(arch)
    jcfg = jreduced(arch) if reduced else jget(arch)
    for batch, cache_len in ((4, 64), (2, 32768)):
        ours = build_model(cfg).component_blocks(batch, cache_len)
        theirs = jbuild(jcfg).component_blocks(batch, cache_len)
        assert [(n, c) for n, _, c, _, _ in ours] == [(n, c) for n, _, c, _, _ in theirs]
        for (_, block, _, cache, kw), (_, jblock, _, jcache, jkw) in zip(ours, theirs):
            assert (block.name, block.kind) == (jblock.name, jblock.kind)
            assert type(block).__name__ == type(jblock).__name__
            _assert_specs_equal(cache, jcache)
            _assert_specs_equal(kw, jkw)


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_proj_only_attention_equals_the_reference(arch):
    """The roofline's component mode: q plus the means of k and v over
    heads, no S x T core, through a reduced decoder block in fp32."""
    from repro.models.lm import DecoderBlock as JDecoderBlock
    from repro_torch.models.lm import DecoderBlock

    jcfg, tcfg = jreduced(arch), reduced_config(arch)
    jblock, tblock = JDecoderBlock("block", jcfg), DecoderBlock("block", tcfg)
    jparams = perturbed(jinit(jblock, jax.random.PRNGKey(1), JPolicies.default("double")), 3)
    init_params(tblock, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tblock, jparams)
    impls = [("*", "attention", "proj_only")]
    x = np.random.default_rng(2).standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    for mode in ("dense", "prefill"):
        jctx = JCtx(policies=JPolicies.default("double"), impls=impls)
        tctx = Ctx(policies=TPolicies.default("double"), impls=impls)
        want, _ = jax.jit(lambda p, x_, q: jblock(p, x_, ctx=jctx, mode=mode, positions=q))(
            jax.tree.map(jnp.asarray, jparams), jnp.asarray(x), jnp.asarray(pos))
        got, _ = tblock(tparams, t(x), ctx=tctx, mode=mode,
                        positions=torch.as_tensor(pos))
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    eager = tblock(tparams, t(x), ctx=Ctx(policies=TPolicies.default("double")),
                   positions=torch.as_tensor(pos))[0]
    assert not torch.allclose(eager, got)  # the core is skipped


# the reference's dry-run record keys that only XLA's compiler gives
XLA_ONLY = {"lower_s", "compile_s"}
XLA_ONLY_MEMORY = {"temp", "alias", "code"}


def _reference_record_keys():
    roof = JRoofline(arch="a", shape="s", mesh="m", chips=1, flops_per_device=1.0,
                     bytes_per_device=1.0, collective_bytes_per_device=0.0,
                     collective_counts={}, collective_by_op={}, model_flops=1.0,
                     memory_per_device={})
    # `repro/launch/dryrun.lower_cell`'s record: the roofline's keys, then
    # these (its `hbm_fits_v5e` is the port's `hbm_fits`)
    return set(roof.to_json()) | {
        "lower_s", "compile_s", "hbm_per_device", "analytic_hbm_per_device",
        "hbm_fits", "accum_steps", "remat", "rules", "overrides", "ok", "roofline"}


def test_lower_cell_on_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    rec = dryrun.lower_cell("gemma-2b", "decode_32k", mesh="card", verbose=False)
    assert set(rec) >= _reference_record_keys() - XLA_ONLY
    assert not set(rec) & XLA_ONLY
    assert set(rec["memory_per_device"]) == {"argument", "output"}
    assert not set(rec["memory_per_device"]) & XLA_ONLY_MEMORY
    # the analytic formula: state + 3 GiB of transients at decode
    assert rec["analytic_hbm_per_device"] == rec["memory_per_device"]["argument"] + 3 * 2**30
    assert rec["hbm_fits"] == (rec["analytic_hbm_per_device"] <= HBM_BYTES)
    assert rec["hbm_capacity"] == HBM_BYTES == 80e9
    # gemma-2b's 32k x 128 cache, 18 layers of one KV head of 256, and its
    # bf16 weights: 82 GB, past the card
    cfg = get_config("gemma-2b")
    cache = 2 * 18 * 128 * 32768 * cfg.kv_heads * cfg.resolved_head_dim * 2
    assert rec["memory_per_device"]["argument"] > cache
    assert rec["hbm_fits"] is False
    assert rec["mesh"] == "card_1x1" and rec["chips"] == 1
    assert rec["roofline"]["bottleneck"] == rec["bottleneck"] == "memory"
    assert rec["step_s"] == rec["roofline"]["step_s"]
    with open(tmp_path / "gemma-2b__decode_32k__card.json") as f:
        assert json.load(f)["hbm_fits"] is False

    pod = dryrun.lower_cell("gemma-2b", "train_4k", mesh="pod", verbose=False)
    assert pod["roofline"] is None and "SPMD partitioner" in pod["roofline_reason"]
    assert pod["chips"] == 256 and pod["compute_s"] is None
    # fsdp_sp: the vocab over model, the embedding dim FSDP over data
    assert pod["placements"]["params"]["embed/table"] == ["model", "data"]
    assert pod["hbm_fits"] == (pod["analytic_hbm_per_device"] <= HBM_BYTES)
    assert os.path.exists(tmp_path / "gemma-2b__train_4k__pod.json")


def test_dryrun_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "whisper-small", "--shape",
                                     "decode_32k", "--mesh", "both"])
    assert dryrun.main() == 0
    assert sorted(os.listdir(tmp_path)) == ["whisper-small__decode_32k__multipod.json",
                                            "whisper-small__decode_32k__pod.json"]
    assert "Dry-run green" in capsys.readouterr().out
