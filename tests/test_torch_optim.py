"""The port's optimizer (``repro_torch.optim``) against the JAX reference,
on the CPU.

The same numpy trees (made from seeds) go through ``repro.optim`` and its
port. The schedule matches to rtol 1e-6. Clipping, compression and AdamW
updates over 1-3 steps, from a non-zero state, with ``grad_clip`` 0 and
1: every leaf of the params, ``mu`` and ``nu`` within rtol 1e-6 plus 1e-6
of the leaf's largest |value| (the two frameworks round ``b * m + (1 -
b) * g`` apart by an ulp, which cancellation can make large against a
small entry), the grad norm to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedule as rschedule  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402

SHAPES = {"embed": (50, 8), "layers.0.wq": (8, 16), "layers.0.ln1": (8,),
          "layers.0.ff.wi": (3, 4, 5), "final_norm": (8,)}


def tree(rng, scale=1.0, positive=False):
    out = {}
    for n, s in SHAPES.items():
        x = rng.random(s) if positive else rng.standard_normal(s)
        out[n] = (x * scale).astype(np.float32)
    return out


def assert_leaf_close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("warmup,total", [(5, 50), (1, 3), (0, 10)])
def test_cosine_schedule(warmup, total):
    """Warmup from 1 / warmup, the cosine, and the clamp past total."""
    for s in range(0, total + 6):
        want = rschedule.cosine_schedule(jnp.asarray(s, jnp.int32),
                                         warmup=warmup, total=total)
        got = schedule.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                       warmup=warmup, total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(schedule.cosine_schedule(torch.tensor(0), warmup=4,
                                          total=9)) == 0.25
    end = schedule.cosine_schedule(torch.tensor(total + 5), warmup=warmup,
                                   total=total, min_ratio=0.2)
    np.testing.assert_allclose(float(end), 0.2, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm(max_norm):
    g = tree(np.random.default_rng(1))
    want, wgn = radamw.clip_by_global_norm(
        {n: jnp.asarray(v) for n, v in g.items()}, max_norm)
    got, gn = adamw.clip_by_global_norm(
        {n: torch.tensor(v) for n, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(gn), float(wgn), rtol=1e-6)
    for n in g:
        assert_leaf_close(got[n], want[n], n)
    if max_norm > float(gn):
        assert all(torch.equal(got[n], torch.tensor(g[n])) for n in g)


@pytest.mark.parametrize("method", ["none", "bf16"])
def test_compress_grads(method):
    g = tree(np.random.default_rng(2))
    want = radamw.compress_grads({n: jnp.asarray(v) for n, v in g.items()},
                                 method)
    got = adamw.compress_grads({n: torch.tensor(v) for n, v in g.items()},
                               method)
    for n in g:
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_adamw_init():
    params = {n: torch.tensor(v) for n, v in
              tree(np.random.default_rng(3)).items()}
    state = adamw.adamw_init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert list(state.mu) == list(SHAPES) == list(state.nu)
    for n, p in params.items():
        for m in (state.mu[n], state.nu[n]):
            assert m.shape == p.shape and m.dtype == torch.float32
            assert not m.any()


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_reference(grad_clip):
    """Three steps from step 3 with non-zero moments, lr scaled by the
    cosine schedule as the train step scales it."""
    rng = np.random.default_rng(4)
    params, mu, nu = tree(rng), tree(rng, 0.01), tree(rng, 1e-4, True)
    rcfg = radamw.AdamWConfig(lr=1e-2, grad_clip=grad_clip)
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=grad_clip)
    rp = {n: jnp.asarray(v) for n, v in params.items()}
    rstate = radamw.AdamWState(jnp.asarray(3, jnp.int32),
                               {n: jnp.asarray(v) for n, v in mu.items()},
                               {n: jnp.asarray(v) for n, v in nu.items()})
    pp = {n: torch.tensor(v) for n, v in params.items()}
    state = adamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                             {n: torch.tensor(v) for n, v in mu.items()},
                             {n: torch.tensor(v) for n, v in nu.items()})
    update = jax.jit(radamw.adamw_update, static_argnums=3)
    for _ in range(3):
        g = tree(rng, 0.5)
        want_scale = rschedule.cosine_schedule(rstate.step, warmup=2,
                                               total=10)
        scale = schedule.cosine_schedule(state.step, warmup=2, total=10)
        rp, rstate, wgn = update(rp, {n: jnp.asarray(v)
                                      for n, v in g.items()},
                                 rstate, rcfg, want_scale)
        out, state, gn = adamw.adamw_update(
            pp, {n: torch.tensor(v) for n, v in g.items()}, state, cfg,
            scale)
        assert out is pp                      # updated in place
        assert int(state.step) == int(rstate.step)
        if grad_clip:
            np.testing.assert_allclose(float(gn), float(wgn), rtol=1e-6)
            assert float(gn) > grad_clip      # the clip is exercised
        else:
            assert float(gn) == 0.0 == float(wgn)
        for n in SHAPES:
            assert_leaf_close(pp[n], rp[n], f"param {n}")
            assert_leaf_close(state.mu[n], rstate.mu[n], f"mu {n}")
            assert_leaf_close(state.nu[n], rstate.nu[n], f"nu {n}")


def test_adamw_updates_a_module_in_place():
    """On an nn.Module the parameters are updated in place, keyed by
    their names, and stay leaves that autograd can differentiate."""
    lin = torch.nn.Linear(4, 3)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    state = adamw.adamw_init(lin)
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    out, state, _ = adamw.adamw_update(lin, grads, state, cfg)
    assert out is lin and int(state.step) == 1
    for n, p in lin.named_parameters():
        assert p.requires_grad and p.is_leaf
        # step 1: mhat / sqrt(nhat) = 1 for g = 1
        torch.testing.assert_close(p.detach(), before[n] - 0.1,
                                   rtol=1e-6, atol=1e-6)
