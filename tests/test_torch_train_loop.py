"""The port's data pipeline, checkpoints, train loop and train CLI
against the JAX reference, on the CPU.

Batches are bit-equal to the reference's for every (seed, step, host).
Checkpoints keep the reference's layout (``step_XXXXXXXX/`` with
``shard_host0.npz`` and ``meta.json``), round-trip bit for bit, and a
restore into a tree with other leaves raises. A loop interrupted at step
4 and resumed to 8 ends within 1e-5 of an uninterrupted one (as
``tests/test_substrate.py``). The port's loop and the reference's, from
the same parameters on the same data, log the same steps with losses
within rtol 1e-4 and end in the same state: ``mu`` and ``nu`` leaf by
leaf within 1e-4 of the leaf's largest value, and each parameter leaf's
displacement from the start within 1e-3 of the reference's displacement
in L2 norm (a loop that skipped the update is off by 1 there, one that
applied it with the wrong sign by 2). Beside these, a ceiling, not a
comparison: every parameter lies within ``sum_t 2 * C_t * lr_t`` of the
reference's plus 1e-5 (``C_t`` bounds one AdamW step's
``|mhat / sqrt(nhat)|`` at step t, from the Cauchy-Schwarz bound on the
moments; ``2 * C_t * lr_t`` is the most two runs' step t can differ by
where a near-zero gradient takes opposite signs).
"""
import json
import os
import re
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro import data as rdata  # noqa: E402
from repro import train as rtrain  # noqa: E402
from repro.checkpoint import save_checkpoint as rsave  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim import adamw_init as radamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline  # noqa
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init  # noqa
from repro_torch.train import TrainLoopConfig, train_loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
QUIET = dict(log_fn=lambda *_: None)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 100, 16, 8),
                                                  (3, 512, 33, 6),
                                                  (11, 151936, 8, 4)])
def test_batches_bit_equal_to_reference(seed, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    got, want = SyntheticLM(DataConfig(**kw)), rdata.SyntheticLM(
        rdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        for host, hosts in ((0, 1), (0, 2), (1, 2)):
            a = got.batch(step, host, hosts)
            b = want.batch(step, host, hosts)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert len(np.unique(got.batch(0))) <= DataConfig(**kw).num_states


def test_prefetch_order_and_close():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=4, seed=2,
                     prefetch=2)
    gen = SyntheticLM(cfg)
    it = make_pipeline(cfg, start_step=3)
    ref = rdata.make_pipeline(rdata.DataConfig(**cfg.__dict__),
                              start_step=3)
    try:
        for step in range(3, 9):
            b = next(it)
            np.testing.assert_array_equal(b, gen.batch(step))
            np.testing.assert_array_equal(b, next(ref))
    finally:
        it.close()
        ref.close()
    assert not it.thread.is_alive()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    state = adamw_init(lin)
    state = AdamWState(torch.tensor(7, dtype=torch.int32),
                       {n: torch.randn(t.shape, generator=g)
                        for n, t in state.mu.items()},
                       {n: torch.rand(t.shape, generator=g)
                        for n, t in state.nu.items()})
    return (lin, state, {"a": torch.arange(10.0),
                         "b": [np.ones((3, 3), np.float32),
                               torch.zeros(2, dtype=torch.int32)]})


def leaves(tree):
    from repro_torch.checkpoint.store import flatten
    return flatten(tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = small_tree(0)
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert sorted(os.listdir(path)) == ["meta.json", "shard_host0.npz"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["names"][:3] == ["0/weight", "0/bias", "1/step"]
    assert meta["names"][3:5] == ["1/mu/weight", "1/mu/bias"]
    assert meta["num_leaves"] == len(meta["names"]) == 10
    other = small_tree(1)
    before = [id(leaf) for _, leaf in leaves(other)]
    restored, step = restore_checkpoint(str(tmp_path), other)
    assert step == 7 and restored is other
    assert [id(leaf) for _, leaf in leaves(other)] == before   # in place
    for (n, x), (_, y) in zip(leaves(tree), leaves(other)):
        x = x.detach().numpy() if isinstance(x, torch.Tensor) else x
        y = y.detach().numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_array_equal(x, y, err_msg=n)
        assert x.dtype == y.dtype


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same directory and file names, and the same arrays under the
    same leaf keys, as the reference's for the same leaves."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    save_checkpoint(str(tmp_path / "port"), 3, {"w": torch.tensor(x)})
    rsave(str(tmp_path / "ref"), 3, {"w": x})
    for d in ("port", "ref"):
        assert os.listdir(tmp_path / d) == ["step_00000003"]
        assert sorted(os.listdir(tmp_path / d / "step_00000003")) == [
            "meta.json", "shard_host0.npz"]
    with np.load(tmp_path / "port/step_00000003/shard_host0.npz") as a, \
            np.load(tmp_path / "ref/step_00000003/shard_host0.npz") as b:
        assert a.files == b.files == ["leaf_0"]
        np.testing.assert_array_equal(a["leaf_0"], b["leaf_0"])


def test_checkpoint_retention_and_atomicity(tmp_path):
    tree = {"w": torch.zeros(4)}
    os.makedirs(tmp_path / "step_00000009.tmp")      # a crashed write
    (tmp_path / "step_00000009.tmp" / "junk").write_text("x")
    assert latest_step(str(tmp_path)) is None
    for s in [1, 2, 3, 4, 5]:
        tree["w"].fill_(s)
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005", "step_00000009.tmp"]
    assert latest_step(str(tmp_path)) == 5
    save_checkpoint(str(tmp_path), 9, tree, keep=2)  # replaces the .tmp
    assert sorted(os.listdir(tmp_path)) == ["step_00000005",
                                            "step_00000009"]
    assert sorted(os.listdir(tmp_path / "step_00000009")) == [
        "meta.json", "shard_host0.npz"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


def test_checkpoint_async_snapshot_and_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(8)}
    mgr.save_async(1, tree)
    tree["w"].fill_(5.0)        # after the snapshot: not in the checkpoint
    mgr.wait()
    assert mgr.latest_step() == 1
    got = {"w": torch.zeros(8)}
    mgr.restore(got)
    assert torch.equal(got["w"], torch.ones(8))
    # a file where the directory should be: the error surfaces on wait()
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    bad = CheckpointManager(str(blocked))
    bad.save_async(2, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                  # raised once, then cleared


@pytest.mark.parametrize("change", ["extra", "missing", "shape", "name"])
def test_restore_with_other_leaves_raises(tmp_path, change):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3),
                                       "b": torch.zeros(2, 2)})
    tree = {"extra": {"a": torch.zeros(3), "b": torch.zeros(2, 2),
                      "c": torch.zeros(1)},
            "missing": {"a": torch.zeros(3)},
            "shape": {"a": torch.zeros(3), "b": torch.zeros(4)},
            "name": {"a": torch.zeros(3), "B": torch.zeros(2, 2)}}[change]
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), tree)
    assert all(not t.any() for t in tree.values())


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------

def smoke(arch="qwen3-1.7b"):
    rcfg = rconfigs.get_config(arch, smoke=True)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(0), rcfg)
    return (rcfg, rparams, configs.get_config(arch, smoke=True),
            jax.tree_util.tree_map(np.asarray, rparams))


def test_loop_restart_equals_uninterrupted(tmp_path):
    _, _, cfg, tree = smoke()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=4, seed=1)
    step = lm.make_train_step(cfg, AdamWConfig(lr=1e-3), remat="none",
                              schedule_kwargs={"warmup": 2, "total": 20})

    def fresh():
        model = convert.from_reference(cfg, tree, "cpu")
        return model, adamw_init(model)

    ref = train_loop(step, *fresh(), data_cfg,
                     TrainLoopConfig(total_steps=8, log_every=100), **QUIET)
    ck = str(tmp_path / "ck")
    train_loop(step, *fresh(), data_cfg,
               TrainLoopConfig(total_steps=4, checkpoint_dir=ck,
                               checkpoint_every=4, log_every=100), **QUIET)
    assert latest_step(ck) == 4
    out = train_loop(step, *fresh(), data_cfg,
                     TrainLoopConfig(total_steps=8, checkpoint_dir=ck,
                                     checkpoint_every=4, log_every=100),
                     **QUIET)
    assert out["resumed_from"] == 4 and latest_step(ck) == 8
    assert int(out["opt_state"].step) == 8
    assert len(out["step_times_s"]) == 4
    for a, b in zip(ref["params"].parameters(), out["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
    for n in ref["opt_state"].mu:
        np.testing.assert_allclose(ref["opt_state"].nu[n].numpy(),
                                   out["opt_state"].nu[n].numpy(),
                                   atol=1e-5, rtol=1e-5)


def adam_step_bound(t, b1=0.9, b2=0.95):
    """Largest ``|mhat / sqrt(nhat)|`` AdamW's step t (1-based) can take:
    Cauchy-Schwarz on the moments' sums."""
    geo = sum((b1 * b1 / b2) ** j for j in range(t))
    return ((1 - b1) / np.sqrt(1 - b2) * np.sqrt(geo)
            * np.sqrt(1 - b2 ** t) / (1 - b1 ** t))


def test_loop_ends_where_the_reference_loop_ends():
    rcfg, rparams, cfg, tree = smoke()
    steps, kw = 6, dict(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4, seed=5)
    sched = {"warmup": 2, "total": 20}
    rstep = rlm.make_train_step(rcfg, RAdamWConfig(lr=1e-3), remat="none",
                                schedule_kwargs=sched)
    ref = rtrain.train_loop(jax.jit(rstep), rparams, radamw_init(rparams),
                            rdata.DataConfig(**kw),
                            rtrain.TrainLoopConfig(total_steps=steps,
                                                   log_every=2), **QUIET)
    model = convert.from_reference(cfg, tree, "cpu")
    step = lm.make_train_step(cfg, AdamWConfig(lr=1e-3), remat="none",
                              schedule_kwargs=sched)
    out = train_loop(step, model, adamw_init(model), DataConfig(**kw),
                     TrainLoopConfig(total_steps=steps, log_every=2),
                     **QUIET)
    assert [h["step"] for h in out["metrics_history"]] == [
        h["step"] for h in ref["metrics_history"]] == [0, 2, 4, 5]
    for got, want in zip(out["metrics_history"], ref["metrics_history"]):
        assert set(got) == set(want)
        for k in ("loss", "aux_loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert out["resumed_from"] == ref["resumed_from"] == 0
    assert int(out["opt_state"].step) == int(ref["opt_state"].step) == steps
    lrs = [1e-3 * float(rlm.cosine_schedule(np.int32(t), **sched))
           for t in range(steps)]
    reach = sum(2 * adam_step_bound(t + 1) * lr
                for t, lr in enumerate(lrs)) + 1e-5
    want = convert.reference_named(cfg, jax.tree_util.tree_map(
        np.asarray, ref["params"]))
    start = convert.reference_named(cfg, tree)
    for n, p in out["params"].named_parameters():
        got = p.detach().numpy()
        assert np.abs(got - want[n]).max() <= reach, n
        moved = np.linalg.norm(want[n] - start[n])
        assert np.linalg.norm(got - want[n]) <= 1e-3 * moved, (n, moved)
    for what in ("mu", "nu"):
        want_m = convert.reference_named(cfg, jax.tree_util.tree_map(
            np.asarray, getattr(ref["opt_state"], what)))
        for n, m in getattr(out["opt_state"], what).items():
            err = float(np.abs(m.numpy() - want_m[n]).max())
            assert err <= 1e-4 * float(np.abs(want_m[n]).max()), (what, n)


def test_loss_falls():
    """As tests/test_substrate.py: below 0.8x its start in 60 steps."""
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    model = lm.init_model(cfg, seed=0, device="cpu")
    step = lm.make_train_step(cfg, AdamWConfig(lr=3e-3), remat="none",
                              schedule_kwargs={"warmup": 5, "total": 60})
    out = train_loop(step, model, adamw_init(model),
                     DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=8, seed=2),
                     TrainLoopConfig(total_steps=60, log_every=10), **QUIET)
    first = out["metrics_history"][0]["loss"]
    last = out["metrics_history"][-1]["loss"]
    assert last < first * 0.8, (first, last)


def test_watchdog_flags_one_injected_slow_step():
    """Steps of 50 ms and one of 1 s at step 8: flagged once, as the
    reference's watchdog would (factor 3 over the trailing median, from
    the sixth step on)."""
    holder = torch.nn.Linear(1, 1)
    seen, lines = [], []

    def step(params, opt_state, batch):
        seen.append(batch["tokens"].shape)
        time.sleep(1.0 if len(seen) == 9 else 0.05)
        return params, opt_state, {"loss": torch.tensor(1.0)}

    out = train_loop(step, holder, None,
                     DataConfig(vocab_size=10, seq_len=4, global_batch=2),
                     TrainLoopConfig(total_steps=12, log_every=100),
                     log_fn=lines.append)
    assert out["straggler_steps"] == 1
    assert [ln for ln in lines if "straggler" in ln][0].startswith(
        "[watchdog] step 8 took")
    assert seen == [(2, 5)] * 12 and len(out["step_times_s"]) == 12


# ---------------------------------------------------------------------------
# The train CLI and import hygiene
# ---------------------------------------------------------------------------

def run_module(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli(tmp_path):
    out = run_module("repro_torch.launch.train", "--arch", "qwen3-1.7b",
                     "--smoke", "--steps", "3", "--device", "cpu",
                     "--checkpoint-dir", str(tmp_path), "--log-every", "1")
    assert out.returncode == 0, out.stderr
    assert len(re.findall(r"^\[train\] step \d loss ", out.stdout,
                          re.M)) == 3
    assert re.search(r"^final loss \d+\.\d+ \(from \d+\.\d+\); "
                     r"stragglers: 0$", out.stdout, re.M)
    assert latest_step(str(tmp_path)) == 3
    out = run_module("repro_torch.launch.train", "--arch", "whisper-base",
                     "--smoke", "--device", "cpu")
    assert out.returncode != 0 and "enc-dec" in out.stderr
    out = run_module("repro_torch.launch.train", "--arch", "minicpm3-4b",
                     "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                     "--device", "cpu", "--log-every", "1")
    assert out.returncode == 0, out.stderr
    assert len(re.findall(r"^\[train\] step \d loss ", out.stdout,
                          re.M)) == 2
    if not torch.cuda.is_available():
        out = run_module("repro_torch.launch.train", "--arch",
                         "qwen3-1.7b", "--smoke", "--steps", "1")
        assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_train_main_returns_the_loop_result():
    from repro_torch.launch import train
    out = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "2",
                      "--batch", "2", "--seq", "8", "--device", "cpu",
                      "--remat", "dots"])
    assert set(out) >= {"params", "opt_state", "metrics_history",
                        "resumed_from", "straggler_steps", "step_times_s"}
    assert int(out["opt_state"].step) == 2
    assert all(np.isfinite(h["loss"]) for h in out["metrics_history"])


def test_training_imports_neither_jax_nor_reference():
    """The train path runs with neither JAX nor the reference loaded, and
    ``chip_smoke.py`` names neither."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert not pattern.search(fh.read())
    code = (
        "import sys, tempfile\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.data import make_pipeline\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.optim import adamw_init\n"
        "from repro_torch.train import train_loop\n"
        "d = tempfile.mkdtemp()\n"
        "out = train.main(['--arch', 'gemma3-1b', '--smoke', '--steps', "
        "'2', '--batch', '2', '--seq', '8', '--device', 'cpu', "
        "'--checkpoint-dir', d])\n"
        "assert int(out['opt_state'].step) == 2\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"
