"""PyTorch port on a live mesh: four gloo ranks on the CPU (`run_on_mesh`,
one thread each) run the reference's Megatron layout through the port's
entry points, each rank on its shard, held against the reference on the
same numpy inputs and against the port without a mesh.

(a) K1 on (2, 2) against the reference's `flash_attention(..., mesh=)`
under `shard_map` (four host devices, in a subprocess, as
`tests/test_system.py` runs it); (b) fp32 logits of reduced yi-6b and
gemma-2b on (2, 2) and (1, 2) against the reference's `apply`; (c) one
train step on (2, 2) against the reference's and the port's own unmeshed
step; (d) greedy tokens through `serve_batch` / `serve_continuous`;
(e) `reshard_params` onto (2, 2) bit for bit, and a meshed trainer's
whole checkpoint restored by a meshed and a one-device trainer; (f) the
train step's all-reduces over `model`; (g) what a live mesh refuses (the
FSDP layouts and the recurrent families run: `test_torch_mesh_fsdp.py`; the
MoE, encoder-decoder and VLM families: `test_torch_mesh_families.py`;
quantized pools and weights, gradient compression and speculative
decoding: `test_torch_mesh_quantized.py`; the QoS governor, the fleet, the
drain and the tuner's feedback: `test_torch_mesh_control.py`).  The
vocab-split argmax breaks ties to the lowest index and the split loss is
the whole vocab's.  The rank bodies are in `_torch_mesh_ranks.py`."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.launch.mesh import run_on_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 120


def on_mesh(fn, shape):
    return run_on_mesh(fn, shape, backend="gloo", device="cpu", threads=1,
                       timeout_s=TIMEOUT_S)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


# -- (a) K1 -------------------------------------------------------------------

def test_k1_on_a_2x2_mesh_matches_the_reference_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 128, 4, 64
    cases = []
    for K in (2, 1):  # KV heads that divide `model`, and MQA taken per q head
        cases.append(tuple(rng.standard_normal((B, S, n, D)).astype(np.float32)
                           for n in (H, K, K)))
    np.savez(tmp_path / "in.npz", *[x for c in cases for x in c])
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys; sys.path.insert(0, {SRC!r})
        import jax.numpy as jnp, numpy as np
        from repro.kernels.flash_attention.ops import flash_attention
        from repro.launch.mesh import make_test_mesh
        arrs = np.load({str(tmp_path / "in.npz")!r})
        xs = [arrs[f"arr_{{i}}"] for i in range(len(arrs.files))]
        mesh = make_test_mesh((2, 2), ("data", "model"))
        rules = {{"batch": ("data",), "heads": "model", "kv_heads": "model"}}
        outs = [np.asarray(flash_attention(*map(jnp.asarray, xs[i:i + 3]), causal=True,
                                           mesh=mesh, rules=rules, interpret=True))
                for i in range(0, len(xs), 3)]
        np.savez({str(tmp_path / "out.npz")!r}, *outs)
    """)
    ref = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    got = on_mesh(functools.partial(ranks.flash, cases), (2, 2))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[f"arr_{i}"], atol=1e-4, rtol=1e-4)


# -- the reference's weights, logits and train step -----------------------------------

def _reference(arch, kind):
    import jax

    from repro.models.registry import reduced_config as jreduced
    from repro.models.registry import build_model as jbuild
    from repro.nn.dtypes import PolicyResolver as JPolicies
    from repro.nn.module import init_params as jinit

    from _torch_port import np_tree

    cfg = jreduced(arch).replace(head_dim=64)
    model = jbuild(cfg)
    params = jinit(model, jax.random.PRNGKey(0), JPolicies.default("f32"))
    return cfg, model, params, np_tree(params)


@functools.lru_cache(maxsize=None)
def _reference_logits(arch):
    import jax.numpy as jnp

    from repro.nn.dtypes import PolicyResolver as JPolicies
    from repro.nn.module import Ctx as JCtx

    _, model, params, np_params = _reference(arch, "serve")
    tokens = np.random.default_rng(1).integers(0, 512, (4, 12)).astype(np.int32)
    want, _ = model(params, {"tokens": jnp.asarray(tokens)},
                    ctx=JCtx(policies=JPolicies.default("f32")), mode="dense")
    return np_params, tokens, np.asarray(want, np.float32)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_logits_on_a_mesh_match_the_reference(arch, shape):
    np_params, tokens, want = _reference_logits(arch)
    got, layout, rules = on_mesh(functools.partial(ranks.logits, arch, np_params, tokens),
                                 shape)
    assert layout == "megatron_tp" and rules["embed"] is None
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_the_vocab_split_argmax_breaks_ties_low_and_the_loss_is_whole():
    """Ties within a rank's block and across ranks go to the lowest index,
    as `torch.argmax` over the whole vocab breaks them; the split loss is
    the whole vocab's cross-entropy."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 16)).astype(np.float32)
    logits[0, :, [2, 9]] = 9.0   # tie across the two blocks
    logits[1, :, [11, 14]] = 9.0  # tie inside the second block
    logits[2, :, [0, 1, 8]] = 9.0
    labels = rng.integers(0, 16, (3, 5))
    top, nll = on_mesh(functools.partial(ranks.vocab_split, logits, labels), (1, 2))
    x = torch.from_numpy(logits)
    np.testing.assert_array_equal(top, torch.argmax(x, dim=-1).numpy())
    assert top[0, 0] == 2 and top[1, 0] == 11 and top[2, 0] == 0
    want = torch.nn.functional.cross_entropy(x.reshape(-1, 16), torch.from_numpy(labels)
                                             .reshape(-1), reduction="none")
    np.testing.assert_allclose(nll.reshape(-1), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def train_run():
    """One train step of reduced yi-6b: the reference's (jitted, no mesh),
    the port's without a mesh, and the port's on (2, 2)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import SHAPES as JSHAPES
    from repro.core.program import Program as JProgram
    from repro.data.pipeline import PipelineConfig, TokenPipeline
    from repro.launch.weave import default_weave as jweave
    from repro.nn.dtypes import PolicyResolver as JPolicies
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jsched
    from repro.runtime.steps import build_train_step as jbuild_train_step
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step

    from _torch_port import np_tree

    cfg, model, jparams, np_params = _reference("yi-6b", "train")
    jw = jweave(JProgram(model=model, cfg=cfg, kind="train"), JSHAPES["train_4k"], {},
                overrides={"accum_steps": 1, "remat": "full"})
    jw.state.policies = JPolicies.default("f32")
    jstep = jax.jit(jbuild_train_step(jw, lr_fn=functools.partial(jsched.constant, peak=1e-3),
                                      opt_cfg=jadamw.AdamWConfig(eps=ranks.ADAM_EPS)))
    batch = next(TokenPipeline(PipelineConfig(vocab=512, seq_len=16, global_batch=4)))
    jp, _, jm = jstep(jparams, jadamw.init_state(jparams, jadamw.AdamWConfig()),
                      jax.tree.map(jnp.asarray, batch), jnp.asarray(0, jnp.int32))
    reference = {"metrics": {k: float(v) for k, v in jm.items()}, "params": np_tree(jp)}

    tw = ranks.woven("yi-6b", "train", {}, {"accum_steps": 1, "remat": "full"})
    tp = ranks.whole_params(tw, np_params)
    tstep = build_train_step(tw, lr_fn=functools.partial(ranks.schedule.constant, peak=1e-3),
                             opt_cfg=adamw.AdamWConfig(eps=ranks.ADAM_EPS))
    tp, _, tm = tstep(tp, adamw.init_state(tp, adamw.AdamWConfig()),
                      {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    unmeshed = {"metrics": {k: float(v) for k, v in tm.items()}, "params": ranks.to_host(tp)}

    metrics, whole, counts = on_mesh(
        functools.partial(ranks.train, "yi-6b", np_params, [batch]), (2, 2))
    meshed = {"metrics": metrics[0], "params": whole, "counts": counts}
    return reference, unmeshed, meshed


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("against", ["reference", "unmeshed"])
def test_a_train_step_on_a_2x2_mesh_matches(train_run, against):
    reference, unmeshed, meshed = train_run
    want = reference if against == "reference" else unmeshed
    for key in ("loss", "grad_norm"):
        assert rel_rms(meshed["metrics"][key], want["metrics"][key]) < 1e-4, key
    got = dict(_leaves(meshed["params"]))
    for path, w in _leaves(want["params"]):
        assert np.shape(got[path]) == np.shape(w), path
        assert rel_rms(got[path], w) < 1e-4, path


def test_the_meshed_train_step_all_reduces_over_model(train_run):
    counts = train_run[2]["counts"]
    assert counts["all_reduce"]["model"]["calls"] > 0, counts
    assert counts["all_reduce"]["data"]["calls"] > 0, counts  # the gradient mean
    print("collectives of one (2, 2) train step, rank 0:", json.dumps(counts))


# -- (d) serving -----------------------------------------------------------------

def test_greedy_tokens_on_a_2x2_mesh_equal_the_unmeshed_server():
    from repro_torch.runtime.server import Server, ServerConfig

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (7, 12, 7, 16)]
    prompts[2][:] = prompts[0]  # a shared prefix
    srv = Server(ranks.woven("yi-6b", "serve", {}),
                 ServerConfig(max_cache_len=48, decode_tokens=5, page_size=8), device="cpu")
    want_batch = [b.tolist() for b in srv.serve_batch(prompts)]
    want_cont = [list(map(int, c)) for c in srv.serve_continuous(prompts)]
    batch, cont, stats = on_mesh(functools.partial(ranks.serve, "yi-6b", prompts), (2, 2))
    assert batch == want_batch
    assert cont == want_cont
    # a rank's pool holds its KV heads: half the one-device bytes
    assert stats["page_hbm_bytes"] * 2 == srv.last_pool_stats["page_hbm_bytes"]


# -- (e) elastic restore -----------------------------------------------------------

def test_reshard_params_onto_a_2x2_mesh_bit_for_bit(tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.program import Program
    from repro_torch.nn.module import init_params

    program = Program.from_arch("yi-6b", kind="train", reduced=True, device="cpu")
    params = init_params(program.model, 3, device="cpu")
    Checkpointer(str(tmp_path), async_save=False).save(
        5, {"params": params, "opt": {"count": torch.zeros(())}})
    rules = {"batch": ("data",), "heads": "model", "mlp": "model", "vocab": "model",
             "embed": None, "kv_heads": "model"}
    step, plan, every = on_mesh(functools.partial(ranks.reshard, str(tmp_path), rules),
                                (2, 2))
    assert step == 5 and plan["dp"] == 2 and plan["devices"] == 4
    shapes = {path: tuple(x.shape) for path, x in _leaves(params)}
    assert len(every) == 4
    for verdicts in every:
        assert len(verdicts) == len(shapes)
        assert all(ok for _, _, ok in verdicts), [v for v in verdicts if not v[2]]
    # some leaves really are split over model
    assert any(shape != shapes[path] for path, shape, _ in every[0])


def test_a_meshed_trainer_checkpoints_whole_state_any_mesh_restores(tmp_path):
    """Rank 0 writes the gathered state as one process writes it; a fresh
    meshed trainer restores its blocks, and so does a one-device trainer
    the whole."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    every, whole, (index, count) = on_mesh(
        functools.partial(ranks.trainer_checkpoint, str(tmp_path)), (2, 2))
    assert (index, count) == (0, 1)
    assert every == [(True, 2, True)] * 4
    one = Trainer(ranks.woven("yi-6b", "train", {}, {"accum_steps": 1}, head_dim=None),
                  TokenPipeline(PipelineConfig(vocab=512, seq_len=16, global_batch=4)),
                  TrainerConfig(ckpt_dir=str(tmp_path), log_every=0))
    assert one.maybe_restore() and one.step == 2
    got = dict(_leaves(ranks.to_host(one.params)))
    for path, w in _leaves(whole):
        np.testing.assert_array_equal(got[path], w, err_msg=path)


# -- run_on_mesh hands back rank 0's result through a temporary file ----------------


@pytest.mark.parametrize("fn,fails", [(ranks.large_result, False),
                                      (ranks.rank_one_raises, True)],
                         ids=["result", "a_rank_raises"])
def test_run_on_mesh_leaves_no_result_file_behind(tmp_path, monkeypatch, fn, fails):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)  # read TMPDIR anew
    if fails:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            on_mesh(fn, (1, 2))
    else:
        got = on_mesh(fn, (1, 2))
        assert got["rank"] == 0 and got["x"].shape == (16, 1 << 20)
        assert bool((got["x"] == 2.0).all())
    assert not list(tmp_path.glob("run_on_mesh_*")), list(tmp_path.iterdir())


# -- (g) refusals ------------------------------------------------------------------

# what a live mesh refuses, and (ROADMAP item 15a-ii, refused before) what
# it now serves as one device does: `fsdp_sp` serving
REFUSED = {
    "whisper_fsdp_sp": "served like one device", "internvl_fsdp_sp": "served like one device",
    "fsdp_sp_serving": "served like one device",
    "abstract_mesh": "abstract mesh",
}


@pytest.fixture(scope="module")
def refused():
    return on_mesh(ranks.refusals, (2, 2))


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_live_mesh_refuses(refused, case):
    assert REFUSED[case] in refused[case], refused[case]
