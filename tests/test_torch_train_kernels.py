"""Training kernels and optimizers of the PyTorch port against agenda_tpu, on the CPU.

On the CPU the port's wrappers take their plain versions. These tests hold
them against the JAX package's Pallas kernels, run as the JAX tests run them
on the CPU (interpret mode): the flash backward (dK/dV and dQ), the fused
int8 AdamW with and without EMA, and the optimizers and schedules built on
them. Inputs are drawn with numpy from a seed and handed to both packages.
The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agenda_tpu.kernels.attention import attention_reference as jax_attention_reference
from agenda_tpu.kernels.flash import flash_attention as jax_flash_attention
from agenda_tpu.kernels.fused_adamw import fused_adamw8bit_leaf as jax_fused_leaf
from agenda_tpu.kernels.groupnorm import group_norm_act as jax_group_norm_act
from agenda_tpu.train import optim as joptim
from agenda_tpu_torch.kernels.attention import attention_reference
from agenda_tpu_torch.kernels.flash import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_fwd,
)
from agenda_tpu_torch.kernels import fused_adamw as tfa
from agenda_tpu_torch.kernels.fused_adamw import fused_adamw8bit_leaf
from agenda_tpu_torch.kernels.groupnorm import group_norm_act
from agenda_tpu_torch.train import optim as toptim

# f32 on both sides; only the summation order differs
F32_TOL = 2e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: extra intra-op threads only contend with the
    other test workers' (8 threads each made a step up to 10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# -- flash backward -------------------------------------------------------------


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("d", [40, 80])
def test_flash_backward_matches_pallas_kernels(s, d):
    """Plain backward and the autograd Function against jax.vjp through the
    Pallas dK/dV and dQ kernels (interpret mode)."""
    rng = np.random.RandomState(10 * s + d)
    q, k, v, do = (_rand(rng, 2, s, 2, d) for _ in range(4))
    _, vjp = jax.vjp(jax_flash_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v))
    plain = flash_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(do))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves).backward(_t(do))
    for got_plain, leaf, want in zip(plain, leaves, ref):
        np.testing.assert_allclose(got_plain.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_flash_backward_matches_autograd_of_plain_attention():
    """Ragged S (the Pallas kernel raises there): against torch autograd
    through attention_reference and jax.vjp of the XLA reference."""
    rng = np.random.RandomState(4)
    q, k, v, do = (_rand(rng, 1, 200, 3, 40) for _ in range(4))
    a = [_t(x).requires_grad_() for x in (q, k, v)]
    attention_reference(*a).backward(_t(do))
    b = [_t(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*b).backward(_t(do))
    _, vjp = jax.vjp(jax_attention_reference, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for x, y, want in zip(a, b, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(y.grad.numpy(), x.grad.numpy(), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(y.grad.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_flash_without_autograd_saves_nothing():
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None
    assert flash_attention(q, q, q).grad_fn is not None


# -- GroupNorm backward ---------------------------------------------------------


@pytest.mark.parametrize("act", [None, "silu"])
def test_groupnorm_gradients_match_jax_vjp(act):
    rng = np.random.RandomState(7)
    b, c, h, w, g, eps = 2, 64, 4, 4, 32, 1e-5
    x = _rand(rng, b, h, w, c) * 2.0 + 0.5  # NHWC, the JAX layout
    scale, bias, dy = _rand(rng, c), _rand(rng, c), _rand(rng, b, h, w, c)
    _, vjp = jax.vjp(lambda x_, s_, b_: jax_group_norm_act(x_, s_, b_, g, eps, act),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
    st, bt = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    group_norm_act(xt, st, bt, g, eps, act).backward(_t(dy.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), dx_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), ds_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), db_j, atol=1e-4, rtol=1e-4)


# -- fused int8 AdamW -----------------------------------------------------------


def _leaf_inputs(rng, n):
    nb = (n + 255) // 256
    p = _rand(rng, n)
    g = _rand(rng, n) * 1e-2
    qm = rng.randint(-127, 128, n).astype(np.int8)
    qv = rng.randint(0, 128, n).astype(np.int8)
    sm = rng.uniform(0, 1e-2, nb).astype(np.float32)
    sv = rng.uniform(0, 1e-4, nb).astype(np.float32)
    e = _rand(rng, n)
    return p, g, qm, sm, qv, sv, e


@pytest.mark.parametrize("n", [4096, 3 * 256 + 77])
@pytest.mark.parametrize("ema", [False, True])
def test_fused_adamw_plain_matches_pallas_kernel(n, ema):
    """Identical flat data through both: the Pallas kernel (interpret mode)
    and the port's plain version (which also updates in place). Clipping is
    active (scale 0.5). Params, shadow and scales to f32 rounding; codes
    within one (exp/log may round differently at a bin edge)."""
    rng = np.random.RandomState(n + ema)
    p, g, qm, sm, qv, sv, e = _leaf_inputs(rng, n)
    scal = np.array([1e-3, 0.5, 0.271, 0.0029701, 0.97][: 5 if ema else 4], np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    want = [np.asarray(x) for x in jax_fused_leaf(
        *(jnp.asarray(x) for x in (p, g, qm, sm, qv, sv)), jnp.asarray(scal[None]),
        ema=jnp.asarray(e) if ema else None, **kw)]
    ours = [torch.from_numpy(x.copy()) for x in (p, g, qm, sm, qv, sv)]
    e_t = torch.from_numpy(e.copy()) if ema else None
    got = fused_adamw8bit_leaf(*ours, torch.from_numpy(scal), ema=e_t, **kw)
    assert got[0] is ours[0] and got[2] is ours[3]  # in place
    got = [t.numpy() for t in got]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)
    for i in (1, 3):
        assert np.abs(got[i].astype(int) - want[i].astype(int)).max() <= 1
    for i in (2, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6)
    if ema:
        np.testing.assert_allclose(got[5], want[5], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("ema", [False, True])
def test_fused_adamw_leaves_plain_matches_pallas_kernel(ema):
    """fused_adamw8bit_leaves over a ragged list (its plain path on the CPU)
    against the Pallas kernel (interpret mode) leaf by leaf, clipping active,
    within the one-leaf test's limits."""
    rng = np.random.RandomState(11 + ema)
    sizes = [4096, 3 * 256 + 77, 5 * 256, 300]
    inputs = [_leaf_inputs(rng, n) for n in sizes]
    scal = np.array([1e-3, 0.5, 0.271, 0.0029701, 0.97][: 5 if ema else 4], np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    leaves = [[torch.from_numpy(x.copy()) for x in leaf[:6]] for leaf in inputs]
    emas = [torch.from_numpy(leaf[6].copy()) for leaf in inputs] if ema else None
    tfa.fused_adamw8bit_leaves(leaves, torch.from_numpy(scal), emas=emas, **kw)
    for i, (p, g, qm, sm, qv, sv, e) in enumerate(inputs):
        want = [np.asarray(x) for x in jax_fused_leaf(
            *(jnp.asarray(x) for x in (p, g, qm, sm, qv, sv)), jnp.asarray(scal[None]),
            ema=jnp.asarray(e) if ema else None, **kw)]
        got = [leaves[i][k].numpy() for k in (0, 2, 3, 4, 5)]
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)
        for k in (1, 3):
            assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1
        for k in (2, 4):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        if ema:
            np.testing.assert_allclose(emas[i].numpy(), want[5], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sizes,capacity,want", [
    ([256, 300, 4096], 440, [(0, [0, 1, 3, 19])]),
    ([512] * 5, 2, [(0, [0, 2, 4]), (2, [0, 2, 4]), (4, [0, 2])]),
    ([1280 * 1280 * 9] * 3 + [5120], 3, [(0, [0, 57600, 115200, 172800]), (3, [0, 20])]),
])
def test_leaf_plan_rows_and_split(sizes, capacity, want):
    """The kernel's launches for a leaf list: runs of at most `capacity`
    leaves, each with its leaves' first rows and its row count."""
    assert tfa.leaf_plan(sizes, capacity) == want


def test_leaf_plan_at_the_step_size_and_its_refusals():
    """The UNet's 293 quantized leaves fit one launch of the kernel's 440;
    an empty leaf, or 2^31 - 17 rows in one launch, is refused."""
    rows = [(n + 255) // 256 for n in [1280 * 1280 * 9] * 293]
    plan = tfa.leaf_plan([1280 * 1280 * 9] * 293, 440)
    assert len(plan) == 1 and plan[0][1][-1] == sum(rows)
    with pytest.raises(ValueError):
        tfa.leaf_plan([256, 0], 440)
    with pytest.raises(ValueError):
        tfa.leaf_plan([256 * (2 ** 31 - 17)], 440)
    assert tfa.leaf_plan([256 * (2 ** 31 - 18)], 440) == [(0, [0, 2 ** 31 - 18])]


def test_fused_leaves_check_gradients_every_step():
    rng = np.random.RandomState(12)
    p, g, qm, sm, qv, sv, _ = (torch.from_numpy(x) for x in _leaf_inputs(rng, 600))
    table = tfa.FusedLeaves([(p, qm, sm, qv, sv)])
    scal = torch.tensor([1e-3, 1.0, 0.1, 0.001])
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    for bad in (g.double(), g[:599], g.reshape(2, 300).t()):
        with pytest.raises(ValueError):
            table([bad], scal, **kw)
    with pytest.raises(ValueError):  # a second gradient for a one-leaf list
        table([g, g], scal, **kw)
    with pytest.raises(ValueError):  # codes of the wrong type
        tfa.FusedLeaves([(p, qm.float(), sm, qv, sv)])
    assert table.matches([(p, qm, sm, qv, sv)])
    assert not table.matches([(p, qm.clone(), sm, qv, sv)])
    assert not table.matches([(p, qm, sm, qv, sv)], emas=[p])


def test_fused_optimizer_packs_its_leaves_once(monkeypatch):
    """The optimizer builds its FusedLeaves on the first step and keeps it
    while the params and moments are the same tensors; a new state (as a
    resume gives) gets a new one."""
    built = []

    class Counting(toptim.FusedLeaves):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(toptim, "FusedLeaves", Counting)
    rng = np.random.RandomState(13)
    params = {k: _t(v) for k, v in _tree(rng).items()}
    tx = toptim.make_optimizer(toptim.lr_schedule("constant", 1e-3, 0, 10), use_8bit_adam=True)
    state = tx.init(params)
    for g in _grads(rng, 1.0):
        tx.apply({k: _t(v) for k, v in g.items()}, state, params)
    assert len(built) == 1
    tx.apply({k: _t(v) for k, v in _grads(rng, 1.0)[0].items()}, tx.init(params), params)
    assert len(built) == 2


def _tree(rng):
    return {"big": _rand(rng, 64, 80), "odd": _rand(rng, 4100), "small": _rand(rng, 7)}


def _grads(rng, scale):
    return [{k: v * scale for k, v in _tree(rng).items()} for _ in range(3)]


@pytest.mark.parametrize("scale", [1e-2, 10.0])  # clip idle / active
def test_fused_optimizer_matches_jax(scale):
    """make_optimizer(use_8bit_adam=True) against the JAX fused one over
    three steps: the quantized leaves go through the kernels, the small leaf
    through plain math. Leaves are flat-identical (no transposes), so the moments' codes
    match; params agree to f32 rounding plus a code's step in a moment."""
    rng = np.random.RandomState(1)
    params = _tree(rng)
    grads = _grads(rng, scale)
    lr_j = joptim.lr_schedule("linear", 1e-2, 1, 10)
    ft = joptim.make_optimizer(lr_j, use_8bit_adam=True, fused=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = ft.init(jp)
    for g in grads:
        jp, js, jn = ft.apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
    tx = toptim.make_optimizer(toptim.lr_schedule("linear", 1e-2, 1, 10), use_8bit_adam=True)
    tp = {k: _t(v) for k, v in params.items()}
    ts = tx.init(tp)
    assert isinstance(ts.mu["big"], toptim._Quantized) and not isinstance(ts.mu["small"],
                                                                         toptim._Quantized)
    for g in grads:
        _, ts, tn = tx.apply({k: _t(v) for k, v in g.items()}, ts, tp)
    assert int(ts.count) == int(js.count) == 3
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=2e-5, rtol=1e-5)
    for k in ("big", "odd"):
        for mine, theirs in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert np.abs(mine.q.numpy().astype(int) - np.asarray(theirs.q).astype(int)).max() <= 1
            np.testing.assert_allclose(mine.scale.numpy(), np.asarray(theirs.scale), rtol=1e-4)


def test_fused_optimizer_ema_matches_jax():
    rng = np.random.RandomState(2)
    params = _tree(rng)
    grads = _grads(rng, 1.0)
    ft = joptim.make_optimizer(joptim.lr_schedule("constant", 1e-3, 0, 10), use_8bit_adam=True,
                               fused=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    je = {k: jnp.asarray(v) for k, v in params.items()}
    js = ft.init(jp)
    tx = toptim.make_optimizer(toptim.lr_schedule("constant", 1e-3, 0, 10), use_8bit_adam=True)
    assert tx.fused
    tp = {k: _t(v) for k, v in params.items()}
    te = {k: _t(v) for k, v in params.items()}
    ts = tx.init(tp)
    for i, g in enumerate(grads):
        decay = np.float32(0.5 + 0.1 * i)
        jp, js, _, je = ft.apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp, ema=je,
                                 ema_decay=jnp.float32(decay))
        tx.apply({k: _t(v) for k, v in g.items()}, ts, tp, ema=te,
                 ema_decay=torch.tensor(decay))
    for k in params:
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [1e-2, 10.0])
def test_f32_adamw_matches_optax_chain(scale):
    """make_optimizer(use_8bit_adam=False): optax clip_by_global_norm + adamw."""
    rng = np.random.RandomState(3)
    params = _tree(rng)
    grads = _grads(rng, scale)
    lr_j = joptim.lr_schedule("cosine", 1e-2, 1, 10)
    chain = joptim.make_optimizer(lr_j)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = chain.init(jp)
    for g in grads:
        u, js = chain.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
    tx = toptim.make_optimizer(toptim.lr_schedule("cosine", 1e-2, 1, 10))
    tp = {k: _t(v) for k, v in params.items()}
    ts = tx.init(tp)
    for g in grads:
        tx.apply({k: _t(v) for k, v in g.items()}, ts, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=2e-6, rtol=1e-5)


def test_int8_codes_match_jax():
    """quantize/dequantize (the optimizer state's log10 code) against
    agenda_tpu.train.optim, over six decades within a block."""
    rng = np.random.RandomState(5)
    x = _rand(rng, 3, 700) * np.logspace(-6, 0, 2100).reshape(3, 700).astype(np.float32)
    zj = joptim._quantize(jnp.asarray(x))
    zt = toptim.quantize(_t(x))
    assert np.abs(zt.q.numpy().astype(int) - np.asarray(zj.q).astype(int)).max() <= 1
    np.testing.assert_allclose(zt.scale.numpy(), np.asarray(zj.scale), rtol=1e-6)
    np.testing.assert_allclose(toptim.dequantize(zt).numpy(),
                               np.asarray(joptim._dequantize(zj)), rtol=1e-5, atol=1e-12)


def test_make_optimizer_dispatch_and_refusals():
    lr = toptim.lr_schedule("constant", 1e-3, 0, 10)
    params = {"big": _t(_rand(np.random.RandomState(0), 64, 80))}
    eight = toptim.make_optimizer(lr, use_8bit_adam=True)
    assert eight.fused and isinstance(eight.init(params).mu["big"], toptim._Quantized)
    plain = toptim.make_optimizer(lr)
    assert not plain.fused and isinstance(plain.init(params), toptim.AdamState)
    # accumulation wraps either optimizer (it raised before the port had it)
    accum = toptim.make_optimizer(lr, gradient_accumulation_steps=2, use_8bit_adam=True)
    state = accum.init(params)
    assert accum.fused and isinstance(state, toptim.MultiStepsState)
    assert isinstance(state.inner.mu["big"], toptim._Quantized)
    with pytest.raises(ValueError):
        toptim.make_optimizer(lr, gradient_accumulation_steps=0)


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedule_golden_values_match_jax(name):
    kw = dict(num_cycles=3, power=2.0) if name in ("cosine_with_restarts", "polynomial") else {}
    fj = joptim.lr_schedule(name, 1e-4, 10, 100, **kw)
    ft = toptim.lr_schedule(name, 1e-4, 10, 100, **kw)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        np.testing.assert_allclose(float(ft(step)), float(fj(step)), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(ft(torch.tensor(step, dtype=torch.int32))),
                                   float(fj(step)), rtol=1e-6, atol=1e-12)
