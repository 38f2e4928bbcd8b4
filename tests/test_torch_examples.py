"""PyTorch port, the four examples: `examples_torch/` against `examples/`.

The reference examples are loaded by path and run as they are; where a test
needs what their `main()` keeps to itself (the trainer, the server, the
choices mARGOt made), it swaps a recording subclass in for the class the
example's module names (`Trainer`, `Server`, `Margot`), in both packages
alike.  Weights cross over from the reference by `convert.load_jax_params`.
No assertion rests on the host's clock: where an example reads
`time.perf_counter`, both packages read one `FakeClock` schedule instead
(the servers' own latencies, the DSE's times, the docking loop's mean).

- drug_discovery: `measure_overlap` at every chunking on the first four
  ligands (fp32, rtol 1e-5); both `main()`s, the DSE table and the docking
  loop on one clock schedule: the same chunk choices, the same summary line.
- navigation_serve: both `main()`s on one latency schedule, policy
  `double` on both weaves (bf16 logits tie, see `test_torch_serve.py`):
  the same tokens and decode budget per serve, memo hits, `served` and
  final knob.
- quickstart: the woven state (policies by path, impls, remat, accum, taps,
  the weave report) and three trainer steps from the reference's initial
  weights and optimizer state, losses within 2e-2 (the `half` bound of
  `test_torch_model.py`: bf16 keeps 8 bits).
- train_100m: `CFG_100M` and its parameter count, the param tree's paths and
  shapes at full size (`jax.eval_shape` on the reference side), and one step
  of a two-layer cut through both `main()`s, loss and grad norm within 2e-2.
- every twin's `main([..., "--device", "cpu"])` runs to its end at a small
  size (train_100m's at the two-layer cut), and without `--device` raises
  where there is no card, as does a `Program` built without a device.

JAX is imported inside the tests (by the reference examples themselves), so
the `gpu`-marked tests at the end collect where only PyTorch is installed.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import load_jax_opt_state, load_jax_params
from repro_torch.core.program import Program
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import flatten_specs

from _torch_port import np_tree

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "train_100m", "navigation_serve", "drug_discovery")
HALF_RTOL = 2e-2


@functools.lru_cache(maxsize=None)
def _example(folder: str, name: str):
    """`<folder>/<name>.py` as a module of its own, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}",
                                                  ROOT / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ref(name):
    return _example("examples", name)


def twin(name):
    return _example("examples_torch", name)


class FakeClock:
    """Stands in for a module's `time`: each `perf_counter()` returns the sum
    of the increments handed out before it, then takes the next one."""

    def __init__(self, increments):
        self._increments = iter(increments)
        self.now = 0.0

    def perf_counter(self):
        t = self.now
        self.now += float(next(self._increments))
        return t


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# drug_discovery
# ---------------------------------------------------------------------------

def _docking_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (64, 96, 3)).astype(np.float32),
            rng.normal(0, 4, (8192, 3)).astype(np.float32))


@pytest.mark.parametrize("chunks", [1, 2, 4, 8, 16])
def test_measure_overlap_matches_the_reference(chunks):
    import jax.numpy as jnp

    ligands, pocket = _docking_inputs()
    tl, tp = twin("drug_discovery").make_inputs(torch.device("cpu"))
    np.testing.assert_array_equal(tl.numpy(), ligands)
    np.testing.assert_array_equal(tp.numpy(), pocket)
    for ligand in ligands[:4]:
        want = float(ref("drug_discovery").measure_overlap(
            jnp.asarray(ligand), jnp.asarray(pocket), chunks))
        got = twin("drug_discovery").measure_overlap(torch.tensor(ligand), tp, chunks)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def _recording_margot(cls, choices):
    class Recording(cls):
        def update(self, *a, **k):
            op = super().update(*a, **k)
            choices.append(dict(op.knobs))
            return op

    return Recording


def test_docking_dse_and_choices_match_the_reference(monkeypatch, capsys):
    """Both `main()`s on one clock schedule: the DSE's 5 x 3 times, the
    budget and every chunk mARGOt picks while docking are the same."""
    incs = np.random.default_rng(7).uniform(1e-4, 2e-3, 1000)
    lines, choices = [], []
    for module, argv in ((ref("drug_discovery"), ()),
                         (twin("drug_discovery"), (["--device", "cpu"],))):
        chosen = []
        monkeypatch.setattr(module, "time", FakeClock(incs))
        monkeypatch.setattr(module, "Margot", _recording_margot(module.Margot, chosen))
        module.main(*argv)
        lines.append(_last_line(capsys))
        choices.append(chosen)
    assert lines[0] == lines[1]
    assert lines[1].startswith("docked 64 ligands with chunks=")
    assert len(choices[1]) == 64 and choices[0] == choices[1]


# ---------------------------------------------------------------------------
# navigation_serve
# ---------------------------------------------------------------------------

def test_navigation_matches_the_reference(monkeypatch, capsys):
    """Both `main()`s, every serve's latency from one schedule: a slow first
    serve pushes mARGOt to the smallest decode budget, the fast ones after
    bring it back, so the budgets and memo hits follow the schedule."""
    import repro.runtime.server as jserver_mod
    from repro.nn.dtypes import PolicyResolver as JPolicies

    import repro_torch.runtime.server as tserver_mod

    incs = [1.0] + [0.01] * 200
    monkeypatch.setattr(jserver_mod, "time", FakeClock(incs))
    monkeypatch.setattr(tserver_mod, "time", FakeClock(incs))
    servers, serves = [], ([], [])

    def recording(cls, policies, served, after_init=lambda srv: None):
        class Recording(cls):
            def __init__(self, woven, cfg, **kw):
                woven.state.policies = policies.default("double")
                super().__init__(woven, cfg, **kw)
                after_init(self)
                servers.append(self)

            def serve(self, tokens, *, decode_tokens=None):
                out = super().serve(tokens, decode_tokens=decode_tokens)
                served.append((decode_tokens, out))
                return out

        return Recording

    jmod, tmod = ref("navigation_serve"), twin("navigation_serve")
    monkeypatch.setattr(jmod, "Server", recording(jmod.Server, JPolicies, serves[0]))
    jmod.main()
    jline = _last_line(capsys)
    monkeypatch.setattr(tmod, "Server", recording(
        tmod.Server, TPolicies, serves[1],
        lambda srv: load_jax_params(srv.woven.program.model, np_tree(servers[0].params))))
    tmod.main(["--device", "cpu"])
    tline = _last_line(capsys)

    jsrv, tsrv = servers
    assert tline == jline
    assert list(tsrv.latencies) == list(jsrv.latencies)
    assert len(serves[1]) == tmod.SERVES == 12
    for (tn, tout), (jn, jout) in zip(serves[1], serves[0]):
        assert tn == jn
        assert tout.shape == (1, tn)
        np.testing.assert_array_equal(tout, jout)
    assert len({n for n, _ in serves[1]}) > 1
    assert (tsrv.memo.hits, tsrv.memo.misses) == (jsrv.memo.hits, jsrv.memo.misses)
    # a memo hit returns before the serve is recorded: served counts misses
    assert tsrv.served == jsrv.served == tsrv.memo.misses
    assert tsrv.memo.hits > 0


# ---------------------------------------------------------------------------
# quickstart and train_100m: trainers carried over from the reference
# ---------------------------------------------------------------------------

def _recording_trainers(jmod, tmod, steps, seen):
    """Trainer subclasses for the reference and the twin that run `steps`
    steps; the twin's starts from the reference's initial weights and
    optimizer state."""

    class JRecording(jmod.Trainer):
        def __init__(self, woven, pipeline, cfg, **kw):
            super().__init__(woven, pipeline, dataclasses.replace(cfg, steps=steps), **kw)
            seen.append(self)

        def init_state(self):
            super().init_state()
            self.initial = (np_tree(self.params), np_tree(self.opt_state))

    class TRecording(tmod.Trainer):
        def __init__(self, woven, pipeline, cfg, **kw):
            super().__init__(woven, pipeline, dataclasses.replace(cfg, steps=steps), **kw)
            seen.append(self)

        def init_state(self):
            super().init_state()
            params, opt = seen[0].initial
            model = self.woven.program.model
            self.params = load_jax_params(model, params)
            self.opt_state = load_jax_opt_state(model, opt,
                                                state_dtype=self.opt_cfg.state_dtype)

    return JRecording, TRecording


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).name


def _policy(p) -> tuple:
    return (_dtype_name(p.param_dtype), _dtype_name(p.compute_dtype),
            _dtype_name(p.accum_dtype), p.quantized, p.cache_dtype)


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    jmod, tmod = ref("quickstart"), twin("quickstart")
    seen = []
    jrec, trec = _recording_trainers(jmod, tmod, 3, seen)
    monkeypatch.setattr(jmod, "Trainer", jrec)
    monkeypatch.setattr(tmod, "Trainer", trec)
    jmod.main()
    jout = capsys.readouterr().out
    assert tmod.main(["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    jtr, ttr = seen
    js, ts = jtr.woven.state, ttr.woven.state

    # the weave: the same decisions, and the same report table
    paths = [p for p, _ in ttr.woven.program.model.walk()]
    assert paths == [p for p, _ in jtr.woven.program.model.walk()]
    assert [_policy(ts.policies.resolve(p)) for p in paths] == \
        [_policy(js.policies.resolve(p)) for p in paths]
    assert _policy(ts.policies.resolve(paths[0]))[:2] == ("bfloat16", "bfloat16")
    assert ts.impls == list(js.impls) == []  # the host weaves no kernel
    for key in ("remat", "accum_steps"):
        assert ts.extra[key] == js.extra[key]
    assert (ts.extra["remat"], ts.extra["accum_steps"]) == ("none", 1)
    assert ts.taps == list(js.taps)
    assert ttr.woven.report.table() == jtr.woven.report.table()
    assert ttr.woven.report.table() in tout and jtr.woven.report.table() in jout

    # three steps from the reference's initial state
    assert len(ttr.history) == len(jtr.history) == 3
    np.testing.assert_allclose([h["loss"] for h in ttr.history],
                               [h["loss"] for h in jtr.history], rtol=HALF_RTOL)
    assert tout.strip().splitlines()[-1].startswith("loss: ")


def test_cfg_100m_is_the_reference_config():
    want, got = ref("train_100m").CFG_100M, twin("train_100m").CFG_100M
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert round(got.param_count() / 1e6) == 101


def test_100m_param_tree_is_the_reference_tree():
    """Paths and shapes at full size, nothing allocated on either side."""
    import jax

    from repro.models.registry import build_model as jbuild
    from repro.nn.module import init_params as jinit

    cfg = ref("train_100m").CFG_100M
    shapes = jax.eval_shape(lambda: jinit(jbuild(cfg), jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(twin("train_100m").CFG_100M)
    prefix = model.name + "/"
    got = {p[len(prefix):]: tuple(s.shape) for p, s in flatten_specs(model).items()}
    assert got == want


def test_100m_train_step_of_a_two_layer_cut_matches_the_reference(monkeypatch, capsys,
                                                                   tmp_path):
    jmod, tmod = ref("train_100m"), twin("train_100m")
    monkeypatch.setattr(jmod, "CFG_100M", jmod.CFG_100M.replace(num_layers=2))
    monkeypatch.setattr(tmod, "CFG_100M", tmod.CFG_100M.replace(num_layers=2))
    seen = []
    jrec, trec = _recording_trainers(jmod, tmod, 1, seen)
    monkeypatch.setattr(jmod, "Trainer", jrec)
    monkeypatch.setattr(tmod, "Trainer", trec)
    small = ["--steps", "1", "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train_100m.py", *small,
                                      "--ckpt-dir", str(tmp_path / "jax")])
    jmod.main()
    assert tmod.main([*small, "--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    jtr, ttr = seen
    assert ttr.woven.state.extra["remat"] == "none"
    assert ttr.woven.state.extra["accum_steps"] == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(ttr.history[0][key], jtr.history[0][key],
                                   rtol=HALF_RTOL, err_msg=key)
    assert _last_line(capsys).startswith("loss ")


# ---------------------------------------------------------------------------
# every twin on the host, and its default device
# ---------------------------------------------------------------------------

SMALL_ARGV = {"quickstart": [], "navigation_serve": [], "drug_discovery": [],
              "train_100m": ["--steps", "1", "--batch", "2", "--seq", "16"]}
LAST_LINE = {"quickstart": "loss: ", "navigation_serve": "served ",
             "drug_discovery": "docked 64 ligands"}


# train_100m's `main` runs on the host at a two-layer cut above: at full
# width one CPU thread takes ~5 s a step (AdamW over 100 M parameters)
@pytest.mark.parametrize("name", ["quickstart", "navigation_serve", "drug_discovery"])
def test_main_runs_on_the_cpu(name, capsys):
    assert twin(name).main(SMALL_ARGV[name] + ["--device", "cpu"]) == 0
    assert _last_line(capsys).startswith(LAST_LINE[name])


@pytest.mark.parametrize("name", TWINS)
def test_main_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        twin(name).main(SMALL_ARGV[name])


def test_program_without_a_device_needs_a_card(monkeypatch):
    cfg = reduced_config("yi-6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        Program(model=build_model(cfg), cfg=cfg)
    program = Program(model=build_model(cfg), cfg=cfg, device="cpu")
    assert program.device == torch.device("cpu")
    assert Program(model=build_model(cfg), cfg=cfg, device="meta").device.type == "meta"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _zeroed_attention_counters():
    from repro_torch.kernels.flash_attention import ops

    ops.flash_attention.launches = ops.flash_attention.lse_launches = 0
    ops.flash_attention_bwd.launches = ops.flash_decode.launches = 0
    return ops


@pytest.mark.gpu
def test_quickstart_on_the_card():
    _card()
    woven = twin("quickstart").build("cuda")
    assert [i for i in woven.state.impls if i[2] == "cuda"] == [("*", "attention", "cuda")]
    trainer = twin("quickstart").build_trainer(woven)
    ops = _zeroed_attention_counters()
    history = trainer.run()
    n = trainer.cfg.steps * woven.program.cfg.num_layers
    assert ops.flash_attention.lse_launches == ops.flash_attention.launches == n
    assert ops.flash_attention_bwd.launches == n
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.gpu
def test_train_100m_on_the_card(capsys, tmp_path):
    _card()
    ops = _zeroed_attention_counters()
    assert twin("train_100m").main(["--steps", "2", "--batch", "2", "--seq", "64",
                                    "--ckpt-dir", str(tmp_path)]) == 0
    assert _last_line(capsys).startswith("loss ")
    assert ops.flash_attention.lse_launches == ops.flash_attention_bwd.launches == 2 * 12


@pytest.mark.gpu
def test_navigation_serve_on_the_card(capsys):
    _card()
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    ops = _zeroed_attention_counters()
    rmsnorm.launches = 0
    assert twin("navigation_serve").main([]) == 0
    assert _last_line(capsys).startswith("served ")
    assert min(ops.flash_attention.launches, ops.flash_decode.launches, rmsnorm.launches) > 0


@pytest.mark.gpu
def test_drug_discovery_on_the_card():
    _card()
    mod = twin("drug_discovery")
    ligands, pocket = mod.make_inputs(torch.device("cuda"))
    lig, poc = ligands[0].double().cpu().numpy(), pocket.double().cpu().numpy()
    want = np.sqrt(((lig[:, None] - poc[None]) ** 2).sum(-1).min(1)).sum()
    for chunks in mod.CHUNKS:
        got = float(mod.measure_overlap(ligands[0], pocket, chunks))
        np.testing.assert_allclose(got, want, rtol=1e-4)
