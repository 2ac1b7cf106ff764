"""The port's LM serving path (``ServingEngine``, the serve CLI, the MoE
dispatch demo) against the JAX reference, on the CPU.

Both engines serve the same requests on the same parameters (the
reference's, carried with ``repro_torch.models.convert``). Tokens match
exactly — including the first token of every request, which is always 0
in both (the reference's ``engine.py:81`` takes the argmax of a 0-d
value). Logits of every prefill and decode step, and the caches the
engines end with, match to rtol 1e-4 / atol 1e-5 (f32 smoke configs).
The demo's co-routing product matches the reference service's: indptr
and indices exactly, values to rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro import serving as rserving  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch import configs, serving  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.tools import moe_dispatch  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TOL = dict(rtol=1e-4, atol=1e-5)


def spy(engine, name, log):
    """Record the logits each call of an engine's step returns."""
    real = getattr(engine, name)

    def wrapped(*args):
        logits, caches = real(*args)
        log.append((name, np.asarray(logits.detach().cpu()
                                     if isinstance(logits, torch.Tensor)
                                     else logits)))
        return logits, caches

    setattr(engine, name, wrapped)


def serve_both(arch, dtype="float32", n=5, slots=2, max_new=6):
    rcfg = rconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if dtype != rcfg.dtype:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(0), rcfg)
    model = convert.from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(n)]
    scfg = dict(batch_slots=slots, max_len=64, cache_dtype="float32")
    reng = rserving.ServingEngine(rcfg, rparams, rserving.ServeConfig(**scfg))
    peng = serving.ServingEngine(cfg, model, serving.ServeConfig(**scfg))
    rlog, plog = [], []
    for eng, log in ((reng, rlog), (peng, plog)):
        spy(eng, "_prefill_one", log)
        spy(eng, "_decode", log)
    rreqs = reng.run([rserving.Request(uid=i, prompt=p,
                                       max_new_tokens=max_new)
                      for i, p in enumerate(prompts)])
    preqs = peng.run([serving.Request(uid=i, prompt=p,
                                      max_new_tokens=max_new)
                      for i, p in enumerate(prompts)])
    return cfg, (reng, rreqs, rlog), (peng, preqs, plog)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b",
                                  "minicpm3-4b"])
def test_engine_matches_reference_engine(arch):
    """5 requests on 2 slots (as tests/test_substrate.py): the same tokens,
    the same logits at every prefill and decode step, the same caches
    (Jamba's list mixes ``{'k', 'v'}`` and ``{'conv', 'ssm'}``; a Mamba
    slot refilled by prefill has its state overwritten whole)."""
    cfg, (reng, rreqs, rlog), (peng, preqs, plog) = serve_both(arch)
    assert all(p.done and len(p.output) == 6 for p in preqs)
    assert [p.output for p in preqs] == [r.output for r in rreqs]
    assert all(p.output[0] == 0 for p in preqs)   # the reference's fault
    assert [name for name, _ in plog] == [name for name, _ in rlog]
    assert sum(name == "_decode" for name, _ in plog) > 5
    for (name, got), (_, want) in zip(plog, rlog):
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    want = convert.caches_from_reference(cfg, reng.caches, "cpu")
    for got_l, want_l in zip(peng.caches, want):
        assert sorted(got_l) == sorted(want_l)
        for n in want_l:
            np.testing.assert_allclose(got_l[n].numpy(), want_l[n].numpy(),
                                       err_msg=n, **TOL)


def test_engine_caches_take_the_compute_dtype():
    """Under bf16 compute both engines' f32 caches come back in bf16 from
    the first decode (``cache.astype(k.dtype)``); the port's engine holds
    its matmul weights in bf16 and its norms in f32."""
    _, (reng, rreqs, _), (peng, preqs, _) = serve_both(
        "qwen3-1.7b", dtype="bfloat16", n=2, slots=2, max_new=2)
    assert reng.caches["blocks"][0]["k"].dtype == jnp.bfloat16
    assert {c[n].dtype for c in peng.caches for n in c} == {torch.bfloat16}
    assert peng.params.layers[0].mixer.wq.dtype == torch.bfloat16
    assert peng.params.final_norm.dtype == torch.float32
    assert all(len(p.output) == 2 for p in preqs)


def test_engine_alone_equals_batched():
    """A request served alone gets the tokens it got in the batch (idle
    slots decode token 0 at length 0 and write only their own rows)."""
    cfg, _, (peng, preqs, _) = serve_both("olmoe-1b-7b")
    alone = serving.ServingEngine(cfg, peng.params, serving.ServeConfig(
        batch_slots=2, max_len=64))
    r = alone.run([serving.Request(uid=9, prompt=preqs[3].prompt,
                                   max_new_tokens=6)])[0]
    assert r.output == preqs[3].output


def logits_by_request(engine, requests):
    """Serve ``requests`` on ``engine``; each request's logits of every
    prefill and decode step, as numpy, in order."""
    logs = {r.uid: [] for r in requests}
    order = iter(requests)      # slots are filled in submission order
    real_pre, real_dec = engine._prefill_one, engine._decode

    def pre(*args):
        logits, caches = real_pre(*args)
        logs[next(order).uid].append(np.array(logits))
        return logits, caches

    def dec(*args):
        active = [(i, r.uid) for i, r in enumerate(engine.slot_req)
                  if r is not None]
        logits, caches = real_dec(*args)
        for i, uid in active:
            logs[uid].append(np.array(logits[i]))
        return logits, caches

    engine._prefill_one, engine._decode = pre, dec
    try:
        engine.run(requests)
    finally:
        engine._prefill_one, engine._decode = real_pre, real_dec
    return logs


def test_olmoe_batched_against_alone(monkeypatch):
    """OLMoE smoke, 6 requests on 4 slots, each against the same request
    served alone (one engine, one request at a time). The einsum combine
    sums a token's expert outputs over (expert, capacity slot), and the
    slot depends on the batch's other rows, so batched and alone group
    the same terms otherwise: the reference engine's and the port's
    einsum logits lie within 1e-5 of the request's largest logit alone
    (4.9e-07 and 4.3e-07 when this test was written; a reference
    behaviour, not a port fault). The port's scatter dispatch gathers each
    token's own rows, so it is bit-equal to alone."""
    arch = "olmoe-1b-7b"
    rcfg = rconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(0), rcfg)
    model = convert.from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(6)]
    scfg = dict(batch_slots=4, max_len=64, cache_dtype="float32")

    def batched_and_alone(pkg, make):
        reqs = [pkg.Request(uid=i, prompt=p, max_new_tokens=4 + i % 3)
                for i, p in enumerate(prompts)]
        batched = logits_by_request(make(), reqs)
        engine = make()
        alone = {}
        for r in reqs:
            alone.update(logits_by_request(engine, [pkg.Request(
                uid=r.uid, prompt=r.prompt,
                max_new_tokens=r.max_new_tokens)]))
        return batched, alone

    def reference_engine():
        return rserving.ServingEngine(rcfg, rparams,
                                      rserving.ServeConfig(**scfg))

    def port_engine():
        return serving.ServingEngine(cfg, model, serving.ServeConfig(**scfg))

    runs = {"reference": batched_and_alone(rserving, reference_engine),
            "einsum": batched_and_alone(serving, port_engine)}
    monkeypatch.setattr(moe, "DISPATCH_MODE", "scatter")
    runs["scatter"] = batched_and_alone(serving, port_engine)
    for name, (batched, alone) in runs.items():
        for uid, want in alone.items():
            got = np.stack(batched[uid])
            want = np.stack(want)
            assert got.shape == want.shape == (4 + uid % 3, cfg.vocab_size)
            if name == "scatter":
                np.testing.assert_array_equal(got, want, err_msg=str(uid))
            else:
                assert np.abs(got - want).max() <= \
                    1e-5 * np.abs(want).max(), (name, uid)


def run_module(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_cli():
    for arch in ("olmoe-1b-7b", "falcon-mamba-7b"):
        out = run_module("repro_torch.launch.serve", "--arch", arch,
                         "--device", "cpu", "--requests", "3", "--max-new",
                         "4")
        assert out.returncode == 0, out.stderr
        lines = out.stdout.strip().splitlines()
        assert len(lines) == 3 and all(" 4 tokens -> " in ln for ln in lines)
    out = run_module("repro_torch.launch.serve", "--arch", "whisper-base",
                     "--device", "cpu")
    assert out.returncode != 0 and "decoder-only serving CLI" in out.stderr
    if not torch.cuda.is_available():
        out = run_module("repro_torch.launch.serve", "--arch", "qwen3-1.7b")
        assert out.returncode != 0 and "no CUDA device" in out.stderr


# ---------------------------------------------------------------------------
# MoE dispatch demo
# ---------------------------------------------------------------------------

def reference_co_routing(logits, k):
    """The co-routing half of examples/moe_dispatch.py, on the reference."""
    tokens, e = logits.shape
    topk = np.argsort(-logits, axis=-1)[:, :k]
    gates = np.take_along_axis(logits, topk, axis=-1)
    gates = np.exp(gates) / np.exp(gates).sum(-1, keepdims=True)
    tok_ids = np.repeat(np.arange(tokens), k)
    exp_ids = topk.reshape(-1)
    t_order = np.argsort(exp_ids, kind="stable")
    service = rserving.SpGEMMService()
    out = []
    for g in (gates, gates * 0.9 + 0.1 / k):
        v = g.reshape(-1).astype(np.float32)
        d = rformats._to_csr(tok_ids, exp_ids, v, tokens, e)
        dt = rformats._to_csr(exp_ids[t_order], tok_ids[t_order], v[t_order],
                              e, tokens)
        out.append(service.multiply(dt, d))
    return out


def test_co_routing_matches_reference_service():
    logits = moe_dispatch.router_logits(2048, 64)
    c1, rep1, c2, rep2, service, _, _ = moe_dispatch.co_routing(logits, 8,
                                                                "cpu")
    (w1, wrep1), (w2, wrep2) = reference_co_routing(logits, 8)
    for got, want in ((c1, w1), (c2, w2)):
        want = want.to_scipy_like()
        np.testing.assert_array_equal(got.indptr.numpy(), want[0])
        nnz = int(want[0][-1])
        np.testing.assert_array_equal(got.indices[:nnz].numpy(),
                                      want[1][:nnz])
        np.testing.assert_allclose(got.values[:nnz].numpy(), want[2][:nnz],
                                   rtol=1e-5, atol=1e-6)
    assert (rep1.workflow, rep2.plan_cache_hit) == (wrep1.workflow, True)
    assert wrep2.plan_cache_hit and service.stats.plan_hits == 1


def test_dispatch_demo_matches_reference():
    rcfg = rconfigs.get_config("olmoe-1b-7b", smoke=True)
    cfg = configs.get_config("olmoe-1b-7b", smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, rlm.init_model(jax.random.PRNGKey(0), rcfg)[0])
    layer = convert.from_reference(cfg, tree, "cpu").layers[0].ff
    ref = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                 tree["blocks"][0]["ff"])
    logits = moe_dispatch.router_logits(4096, 64)
    plans = moe_dispatch.plan_capacity(logits, 8)
    assert dataclasses.asdict(plans["sampled"]) == dataclasses.asdict(
        rmoe.calibrate_capacity(logits, 8, method="sampled"))
    x = np.random.default_rng(3).standard_normal(
        (8, 128, cfg.d_model)).astype(np.float32)
    cf = plans["sampled"].capacity_factor
    with torch.no_grad():
        res = moe_dispatch.run_dispatch(layer, cfg, torch.tensor(x), cf)
    for label, c in (("static 1.0", 1.0), ("sampled", cf)):
        _, raux = rmoe.apply_moe(ref, jnp.asarray(x), rcfg, capacity_factor=c)
        assert res["drops"][label] == {
            "capacity": int(raux["capacity"]),
            "overflow_frac": float(raux["overflow_frac"])}
    assert res["drops"]["static 1.0"]["overflow_frac"] > 0
    assert res["scatter_vs_einsum"] < 1e-4


def test_moe_dispatch_cli():
    out = run_module("repro_torch.tools.moe_dispatch", "--device", "cpu",
                     "--tokens", "2048")
    assert out.returncode == 0, out.stderr
    assert re.search(r"plan_cache_hit=True .*hit rate 50%", out.stdout)


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------

def test_lm_port_imports_neither_jax_nor_reference():
    """No module of the port names JAX or the reference package, and the
    LM path runs with neither loaded (the training modules imported
    too)."""
    root = os.path.join(SRC, "repro_torch")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(f)
    assert not offenders, offenders
    code = (
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import convert, lm\n"
        "from repro_torch.serving import Request, ServeConfig, "
        "ServingEngine\n"
        "from repro_torch.tools import moe_dispatch\n"
        "from repro_torch import checkpoint, data, optim, train\n"
        "from repro_torch.launch import train as train_cli\n"
        "from repro_torch.core import hll\n"
        "cfg = configs.get_config('llama4-scout-17b-a16e', smoke=True)\n"
        "eng = ServingEngine(cfg, lm.init_model(cfg, device='cpu'),\n"
        "                    ServeConfig(batch_slots=2, max_len=32))\n"
        "r = eng.run([Request(0, [1, 2, 3], 3)])[0]\n"
        "assert r.done and len(r.output) == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
