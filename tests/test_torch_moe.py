"""PyTorch port, the capacity-routed mixture-of-experts feed-forward
(`nn/moe.py`) against the reference's `MoEMLP` on the same weights (carried
across by `convert.load_jax_params`) and the same numpy inputs.

In fp32 the outputs agree within 1e-5 of the reference output's RMS, and
the routing agrees exactly: the top-k experts, each (token, k)'s rank in
its expert, and the `moe_drop_frac` tap — with one group and several, a
sequence the group size does not divide (the divisor walk), a capacity
factor small enough to drop tokens, forced ties in the gates (the lower
expert index wins, as `jax.lax.top_k` has it), gelu (grok) and silu
(mixtral), and both `ctx.extra` knobs.  In bf16 the outputs agree within
2e-2 of the output scale (the largest |output|, at least 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.nn.moe import MoEMLP as JMoE
from repro_torch.convert import load_jax_params
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx
from repro_torch.nn.module import init_params as tinit
from repro_torch.nn.moe import MoEMLP, capacity, group_size, top_k_lower_index

from _torch_port import np_tree, t, to_np

torch.set_num_threads(1)

DM, DFF, E, K = 32, 48, 4, 2


def _pair(activation, policy, *, router=None, seed=0):
    jm = JMoE("ffn", DM, DFF, num_experts=E, top_k=K, activation=activation)
    tm = MoEMLP("ffn", DM, DFF, num_experts=E, top_k=K, activation=activation)
    jparams = np_tree(jinit(jm, jax.random.PRNGKey(seed), JPolicies.default(policy)))
    if router is not None:
        jparams["router"] = router.astype(np.float32)
    tinit(tm, 0, TPolicies.default(policy), "cpu")
    tparams = load_jax_params(tm, jparams)
    jdt = jnp.float32 if policy == "double" else jnp.bfloat16
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), jparams)
    return jm, tm, jparams, tparams


def _run(jm, tm, jparams, tparams, x, policy, extra):
    jctx = JCtx(policies=JPolicies.default(policy), extra=extra, taps_enabled=["*"])
    tctx = TCtx(policies=TPolicies.default(policy), extra=extra, taps_enabled=["*"])
    dt = jnp.float32 if policy == "double" else jnp.bfloat16
    want = jm(jparams, jnp.asarray(x, dt), ctx=jctx)
    got = tm(tparams, t(x).to(torch.float32 if policy == "double" else torch.bfloat16),
             ctx=tctx)
    return (np.asarray(want, np.float32), to_np(got), float(jctx.taps["ffn/moe_drop_frac"]),
            float(tctx.taps["ffn/moe_drop_frac"]))


def _reference_route(jparams, x, policy, grp):
    """The reference's routing lines (`src/repro/nn/moe.py:73-86`) on the
    grouped tokens: top-k experts and ranks."""
    dt = jnp.float32 if policy == "double" else jnp.bfloat16
    B, S, _ = x.shape
    xc = jnp.asarray(x, dt).reshape(B * (S // grp), grp, DM)
    logits = jnp.einsum("bsd,de->bse", xc, jparams["router"].astype(dt),
                        preferred_element_type=jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    _, tope = jax.lax.top_k(gates, K)
    onehot = jax.nn.one_hot(tope, E, dtype=jnp.float32)
    flat = onehot.reshape(xc.shape[0], grp * K, E)
    ranks = (jnp.cumsum(flat, axis=1) - flat).reshape(xc.shape[0], grp, K, E)
    return np.asarray(tope), np.asarray(jnp.sum(ranks * onehot, axis=-1))


def _tied_router(kind):
    rng = np.random.default_rng(3)
    if kind == "zero":  # every gate 1/E: every token routes to experts 0 and 1
        return np.zeros((DM, E), np.float32)
    r = rng.standard_normal((DM, E)).astype(np.float32) / np.sqrt(DM)
    r[:, 2] = r[:, 1]  # experts 1 and 2 tie for every token
    return r


CASES = [
    # name, activation, S, extra, router
    ("one_group_silu", "silu", 16, {}, None),
    ("one_group_gelu", "gelu", 16, {}, None),
    ("groups_of_8", "silu", 24, {"moe_group_size": 8}, None),
    ("divisor_walk_30_by_6", "gelu", 30, {"moe_group_size": 8}, None),
    ("drops_cf_0.5", "silu", 24, {"moe_capacity_factor": 0.5}, None),
    ("drops_cf_0.25_groups", "gelu", 24, {"moe_capacity_factor": 0.25, "moe_group_size": 12},
     None),
    ("tie_all_gates", "silu", 16, {}, "zero"),
    ("tie_experts_1_2", "gelu", 20, {"moe_capacity_factor": 2.0}, "pair"),
]


@pytest.mark.parametrize("name,activation,S,extra,router", CASES, ids=[c[0] for c in CASES])
def test_moe_matches_reference_fp32(name, activation, S, extra, router):
    jm, tm, jparams, tparams = _pair(
        activation, "double", router=None if router is None else _tied_router(router))
    x = np.random.default_rng(1).standard_normal((2, S, DM)).astype(np.float32)
    want, got, jdrop, tdrop = _run(jm, tm, jparams, tparams, x, "double", extra)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert got.shape == want.shape and rms > 0
    assert np.abs(got - want).max() <= 1e-5 * rms, (np.abs(got - want).max(), rms)
    assert tdrop == jdrop  # exactly
    grp = group_size(S, int(extra.get("moe_group_size", 2048)))
    tope, rank = _reference_route(jparams, x, "double", grp)
    xc = t(x).reshape(-1, grp, DM)
    _, our_e, _, our_rank = tm.route(tparams, xc, TPolicies.default("double").resolve("ffn"))
    np.testing.assert_array_equal(to_np(our_e), tope)
    np.testing.assert_array_equal(to_np(our_rank), rank)
    C = capacity(grp, K, float(extra.get("moe_capacity_factor", 1.25)), E)
    if name.startswith("drops") or router == "zero":
        assert jdrop > 0 and (rank >= C).any()
    if router == "zero":
        assert (tope == np.array([0, 1])).all()  # the lower indices win the tie
    if router == "pair":
        # the tie is decided for experts 1 and 2 at least once, toward 1
        picked = set(map(tuple, tope.reshape(-1, K)))
        assert any(1 in p for p in picked) and not any(2 in p and 1 not in p for p in picked)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_moe_matches_reference_bf16(activation):
    jm, tm, jparams, tparams = _pair(activation, "half", seed=4)
    x = np.random.default_rng(5).standard_normal((2, 24, DM)).astype(np.float32)
    want, got, jdrop, tdrop = _run(jm, tm, jparams, tparams, x, "half", {"moe_group_size": 12})
    # bf16 keeps 8 bits, and the two packages round the activation's parts
    # differently: within 2e-2 of the output scale, as the port's other
    # bf16 parity tests hold logits
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-2 * scale, (np.abs(got - want).max(), scale)
    assert tdrop == jdrop


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.1, 0.3, 0.3]])
    values, indices = top_k_lower_index(x, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 2)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    assert indices.tolist() == [[0, 1], [1, 3], [0, 2]]


def test_group_size_capacity_and_active_params_match_reference():
    for S, grp in ((16, 2048), (30, 8), (7, 4), (6000, 2048), (1, 2048)):
        g = group_size(S, grp)
        assert S % g == 0 and g <= grp
    assert group_size(6000, 2048) == 2000 and group_size(30, 8) == 6
    assert capacity(2000, 2, 1.25, 8) == 625 and capacity(1, 2, 1.25, 8) == 1
    jm = JMoE("ffn", 6144, 16384, num_experts=8, top_k=2)
    tm = MoEMLP("ffn", 6144, 16384, num_experts=8, top_k=2)
    assert tm.active_params_per_token() == jm.active_params_per_token()


def test_dropped_token_contributes_exactly_nothing():
    """With room for one token per expert, every later token of a group is
    dropped: its output row is exactly 0 (a masked row, not a clamped
    slot)."""
    _, tm, _, tparams = _pair("silu", "double", router=_tied_router("zero"))
    x = np.random.default_rng(2).standard_normal((1, 8, DM)).astype(np.float32)
    ctx = TCtx(policies=TPolicies.default("double"), extra={"moe_capacity_factor": 0.25})
    out = tm(tparams, t(x), ctx=ctx)  # C = 1: only token 0 keeps experts 0 and 1
    assert torch.count_nonzero(out[0, 0]) > 0
    assert torch.count_nonzero(out[0, 1:]) == 0
