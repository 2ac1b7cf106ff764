"""The port's launch layer — meshes, the sharding policy, the mesh form of
``devices=`` and the cost mode — against the JAX reference, on the CPU.

Specs are the reference's ``ShardingPolicy`` applied to its own
``lm.abstract_params`` at full width, on shape-only meshes (a class with a
``shape`` dict, as ``tests/test_launch.py`` builds one); where the
reference wraps a spec in a ``NamedSharding`` or a sharding constraint,
those are replaced here by functions that return the spec. The port's
stacked-layer spec is the reference's without its leading ``"layers"``
entry. The cost mode's attention and Mamba scan match the reference's to
rtol 1e-5 / atol 1e-6; ``ocean_spgemm`` on a shard mesh is bit-identical
to the unsharded call and to the reference's sharded C.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import workflow as rworkflow  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import sharding as rsharding  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import mamba as rmamba  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import dispatch, formats, workflow  # noqa: E402
from repro_torch.launch import mesh, sharding  # noqa: E402
from repro_torch.models import attention, convert, lm, mamba  # noqa: E402

COST_TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2})


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def logical(shape):
    return mesh.LogicalMesh(tuple(shape), tuple(shape.values()))


def ref_policy(shape, policy="tp", **kw):
    return rsharding.ShardingPolicy(FakeMesh(shape), policy, **kw)


def port_policy(shape, policy="tp", **kw):
    return sharding.ShardingPolicy(logical(shape), policy, **kw)


@pytest.fixture
def specs_not_shardings(monkeypatch):
    """The reference's ``NamedSharding`` and sharding constraint return
    the spec they are given."""
    monkeypatch.setattr(rsharding, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)


def _name(path) -> str:
    parts = []
    for k in path:
        parts.append(str(getattr(k, "key", getattr(k, "idx", k))))
    return ".".join(parts)


def reference_leaves(cfg, tree, is_leaf=None):
    """{port name: (reference leaf, stacked)} of a reference params or
    cache tree: scanned layer ``i`` is ``blocks[i % period]`` at index
    ``i // period``, the tail follows."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    out = {}
    if cfg.is_encoder_decoder:
        return {_name(p): (leaf, False) for p, leaf in flat}
    plan = rtf.StackPlan.from_config(cfg)
    for path, leaf in flat:
        head = _name(path[:1])
        if head == "blocks":
            j, rest = path[1].idx, _name(path[2:])
            for n in range(plan.n_scan):
                out[f"layers.{n * plan.period + j}.{rest}"] = (leaf, True)
        elif head == "tail":
            i = plan.n_scan * plan.period + path[1].idx
            out[f"layers.{i}.{_name(path[2:])}"] = (leaf, False)
        else:
            out[_name(path)] = (leaf, False)
    return out


# ---------------------------------------------------------------------------
# (1) parameter specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch):
    """Every parameter's logical axes, shape and spec under tp and fsdp
    on the three meshes."""
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    rshapes, rspecs = rlm.abstract_params(rcfg)
    model, specs = lm.abstract_params(cfg)
    assert specs == lm.init_specs(cfg)
    shapes = reference_leaves(rcfg, rshapes)
    axes = reference_leaves(rcfg, rspecs,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    named = dict(model.named_parameters())
    assert set(named) == set(shapes) == set(specs)
    for n, p in named.items():
        (rs, stacked), (ra, _) = shapes[n], axes[n]
        want_axes = tuple(ra)[1:] if stacked else tuple(ra)
        assert p.axes == specs[n] == want_axes, n
        assert tuple(p.shape) == (rs.shape[1:] if stacked else rs.shape), n
    for shape in MESHES:
        for pol in ("tp", "fsdp"):
            rp, pp = ref_policy(shape, pol), port_policy(shape, pol)
            got = pp.param_shardings(model, specs)
            for n, spec in got.items():
                (rs, stacked), (ra, _) = shapes[n], axes[n]
                want = tuple(rp.param_spec(rs.shape, ra))
                assert isinstance(spec, sharding.Spec)
                assert tuple(spec) == (want[1:] if stacked else want), \
                    (n, shape, pol)


@pytest.fixture(scope="module")
def falcon():
    """Falcon-Mamba's smoke config: the reference's parameters and the
    port's model holding them."""
    rcfg = rconfigs.get_config("falcon-mamba-7b", smoke=True)
    cfg = configs.get_config("falcon-mamba-7b", smoke=True)
    rparams = rlm.init_model(jax.random.PRNGKey(3), rcfg)[0]
    model = convert.from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, model


def test_axes_survive_conversion_and_cast(falcon):
    """Models loaded from a reference tree and their compute-dtype copies
    carry the same axes as a fresh model (Mamba's parameters made
    directly included)."""
    _, _, cfg, model = falcon
    want = lm.init_specs(cfg)
    for m in (model, lm.cast_weights(model, torch.bfloat16)):
        assert {n: p.axes for n, p in m.named_parameters()} == want


# ---------------------------------------------------------------------------
# (2) cache specs
# ---------------------------------------------------------------------------

@pytest.fixture
def named_specs(monkeypatch):
    """``cache_sharding`` builds ``NamedSharding(mesh, spec)``: keep the
    spec in an object with a ``spec`` attribute."""
    class Named:
        def __init__(self, m, spec):
            self.spec = spec
    monkeypatch.setattr(rsharding, "NamedSharding", Named)


@pytest.mark.usefixtures("named_specs")
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_match_reference(arch):
    """Layer by layer, at decode_32k's and long_500k's (+cp) global batch
    and length, on the two production meshes."""
    rcfg, cfg = rconfigs.get_config(arch), configs.get_config(arch)
    for shape_name, cp in (("decode_32k", False), ("long_500k", True)):
        shape = SHAPES[shape_name]
        b, s = shape.global_batch, shape.seq_len
        kw = {}
        if cfg.is_encoder_decoder:
            kw = dict(src_len=s)
            s = min(448, max(s // 8, 64))
        rcaches = jax.eval_shape(
            lambda: rlm.init_caches(rcfg, b, s, dtype=jnp.bfloat16, **kw))
        caches = lm.init_caches(cfg, b, s, dtype=torch.bfloat16,
                                device="meta", **kw)
        for shape_ in MESHES[:2]:
            rp = ref_policy(shape_, context_parallel=cp)
            pp = port_policy(shape_, context_parallel=cp)
            want = reference_leaves(
                rcfg, jax.tree_util.tree_map(
                    lambda x: tuple(x.spec), rsharding.ShardingPolicy.
                    cache_sharding(rp, rcaches, b)),
                is_leaf=lambda x: isinstance(x, tuple))
            got = pp.cache_sharding(caches, b)
            if cfg.is_encoder_decoder:
                flat = {f"{k}.{i}.{n}": got[k][i][n] for k in got
                        for i in range(len(got[k])) for n in got[k][i]}
            else:
                flat = {f"layers.{i}.{n}": spec
                        for i, layer in enumerate(got)
                        for n, spec in layer.items()}
            assert set(flat) == set(want)
            for n, spec in flat.items():
                ref, stacked = want[n]
                assert tuple(spec) == (ref[1:] if stacked else ref), \
                    (n, shape_name, shape_)


# ---------------------------------------------------------------------------
# (3) batch, data and activation specs
# ---------------------------------------------------------------------------

BATCHES = (1, 2, 7, 16, 32, 48, 256, 512)
ACTIVATIONS = (
    ("activations", (32, 4096, 2048)), ("residual", (7, 13, 64)),
    ("activations", (16,)), ("logits", (32, 151936)), ("logits", (3, 1, 7)),
    ("attn_q", (32, 4096, 16, 128)), ("attn_q", (8, 4096, 6, 128)),
    ("attn_q", (8, 7, 6, 128)), ("attn_kv", (8, 4096, 6, 128)),
    ("attn_kv", (16, 64, 32, 64)), ("moe_group", (16, 512, 64)),
    ("moe_group", (32, 512, 64)), ("moe_group", (4, 8, 64)),
    ("unembed_weights", (151936, 2048)), ("unembed_weights", (2048, 49155)),
    ("unembed_weights", (64, 96)), ("other", (4, 4)))


def test_param_spec_rules_and_indivisible_dims():
    """``tests/test_launch.py``'s checks, and their reference values."""
    pp = port_policy(MESHES[0], "fsdp")
    assert tuple(pp.param_spec((2048, 6144), ("embed", "mlp"))) == \
        ("data", "model")
    assert tuple(pp.param_spec((7, 13), ("embed", "mlp"))) == (None, None)
    assert pp.batch_spec(256)[0] == "data"
    assert pp.batch_spec(1)[0] is None
    for shape in MESHES:
        for pol in ("tp", "fsdp"):
            rp, pp = ref_policy(shape, pol), port_policy(shape, pol)
            for dims, names in (((2048, 6144), ("embed", "mlp")),
                                ((7, 13), ("embed", "mlp")),
                                ((48, 96), ("embed", "heads")),
                                ((16, 2048, 768), ("experts", "embed",
                                                   "mlp")),
                                ((24, 7), ("embed", "state")),
                                ((4, 8192), ("conv", "mlp"))):
                assert tuple(pp.param_spec(dims, names)) == \
                    tuple(rp.param_spec(dims, PartitionSpec(*names)))


@pytest.mark.usefixtures("specs_not_shardings")
def test_batch_data_and_activation_specs_match_reference():
    for shape in MESHES:
        for cp in (False, True):
            for flags in ((False, False), (True, True)):
                kw = dict(context_parallel=cp, opt_unembed_gather=flags[0],
                          opt_attn_sharding=flags[1])
                rp, pp = ref_policy(shape, **kw), port_policy(shape, **kw)
                assert pp.data_axes == rp.data_axes
                for b in BATCHES:
                    assert tuple(pp.batch_spec(b)) == tuple(rp.batch_spec(b))
                    for nd in (1, 2, 3):
                        assert tuple(pp.data_sharding(b, nd)) == \
                            tuple(rp.data_sharding(b, nd))
                assert tuple(pp.replicated(2)) == tuple(rp.replicated(2))
                for name, dims in ACTIVATIONS:
                    x = jax.ShapeDtypeStruct(dims, jnp.float32)
                    want = rp.shard_fn(name, x)
                    want = None if want is x else tuple(want)
                    got = pp.activation_spec(name, dims)
                    assert (None if got is None else tuple(got)) == want, \
                        (name, dims, shape, kw)
                    assert pp.shard_fn(name, x) is x


def test_mesh_shapes_of_both_kinds():
    pm = mesh.make_production_mesh()
    assert pm.shape == {"data": 16, "model": 16} and pm.devices is None
    assert mesh.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert sharding.mesh_shape(pm) == pm.shape
    with pytest.raises(ValueError):
        mesh.LogicalMesh(("data",), (2, 2))


# ---------------------------------------------------------------------------
# (4) cost mode
# ---------------------------------------------------------------------------

@pytest.fixture
def cost_mode():
    for mod in (rattn, rmamba, attention, mamba):
        mod.set_unchunked_for_cost(True)
    try:
        yield
    finally:
        for mod in (rattn, rmamba, attention, mamba):
            mod.set_unchunked_for_cost(False)


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.usefixtures("cost_mode")
@pytest.mark.parametrize("lq,lkv,window,causal", [
    (1100, 1100, 0, True), (1030, 2100, 700, True), (1500, 1500, 0, False)])
def test_cost_mode_attention_matches_reference(lq, lkv, window, causal):
    """One chunk the size of the sequence on both sides, past the 1024
    chunk; the same values as the reference's."""
    q = normal((1, lq, 4, 16), 1)
    k, v = normal((1, lkv, 2, 16), 2), normal((1, lkv, 2, 16), 3)
    start = lkv - lq
    want = rattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_start=start)
    got = attention.attention_core(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal,
                                   window=window, q_start=start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COST_TOL)


@pytest.mark.usefixtures("cost_mode")
@pytest.mark.parametrize("length", [300, 600])
def test_cost_mode_mamba_matches_reference(falcon, length):
    """One scan chunk the length of the sequence (past the 256 chunk):
    the output, and the prefill cache."""
    rcfg, rparams, cfg, model = falcon
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["blocks"][0]["mixer"])
    x = normal((2, length, cfg.d_model), length)
    rcache = rmamba.init_mamba_cache(rcfg, 2, jnp.float32)
    want, rcache = rmamba.apply_mamba(rp, jnp.asarray(x), rcfg, cache=rcache,
                                      mode="prefill")
    with torch.no_grad():
        got, cache = mamba.apply_mamba(
            model.layers[0].mixer, torch.tensor(x), cfg,
            cache=mamba.init_mamba_cache(cfg, 2, torch.float32, "cpu"),
            mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COST_TOL)
    for n in ("conv", "ssm"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(rcache[n]),
                                   **COST_TOL)


def test_cost_mode_is_one_chunk():
    """In cost mode the chunk loops run once (the trace's op count falls),
    and the flags restore."""
    from repro_torch.launch.meta_trace import MetaTrace
    q = torch.zeros((1, 3000, 2, 8), device="meta")

    def ops():
        with torch.no_grad(), MetaTrace() as t:
            attention.attention_core(q, q, q)
        return t.ops
    chunked = ops()
    attention.set_unchunked_for_cost(True)
    try:
        one = ops()
    finally:
        attention.set_unchunked_for_cost(False)
    assert one * 5 < chunked and ops() == chunked


# ---------------------------------------------------------------------------
# (5) meshes as device sets
# ---------------------------------------------------------------------------

@pytest.fixture
def local_group():
    """Destroys the default process group a test started."""
    dist = torch.distributed
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.usefixtures("local_group")
def test_local_mesh_is_a_one_rank_device_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    m = mesh.make_local_mesh(device_type="cpu")
    assert isinstance(m, DeviceMesh)
    assert m.mesh_dim_names == ("data", "model")
    assert tuple(m.mesh.shape) == (1, 1)
    assert torch.distributed.get_world_size() == 1
    assert sharding.mesh_shape(m) == {"data": 1, "model": 1}
    assert dispatch.resolve_devices(m) == (torch.device("cpu"),)
    assert tuple(sharding.ShardingPolicy(m, "tp").batch_spec(4)) == ("data",)
    with pytest.raises(ValueError, match="ranks"):
        mesh.make_local_mesh(2, 1, device_type="cpu")


def test_local_mesh_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        mesh.make_local_mesh()
    with pytest.raises(ValueError, match="have 0"):
        mesh.make_shard_mesh()


def test_resolve_devices_takes_a_shard_mesh_not_a_shape():
    m = mesh.make_shard_mesh(3, device_type="cpu")
    assert m.shape == {"shard": 3}
    assert mesh.make_shard_mesh(device_type="cpu").size == 1
    devs = dispatch.resolve_devices(m)
    assert devs == (torch.device("cpu"),) * 3
    assert dispatch.topology_key(devs) == \
        dispatch.topology_key(dispatch.resolve_devices(["cpu"] * 3))
    with pytest.raises(ValueError, match="holds no devices"):
        dispatch.resolve_devices(mesh.make_production_mesh())
    with pytest.raises(ValueError):
        mesh.make_shard_mesh(0, device_type="cpu")


def test_ocean_spgemm_on_a_shard_mesh_matches_reference():
    """``tests/test_partition.py``'s inputs: the mesh's C is bit-identical
    to the unsharded call's and to the reference's sharded C, on two
    shards."""
    ra = rformats.banded_csr(50, 150, 150, 25)
    a = formats.banded_csr(50, 150, 150, 25, device="cpu")
    c0, _ = workflow.ocean_spgemm(a, a, cache=False)
    c1, rep = workflow.ocean_spgemm(
        a, a, cache=False, devices=mesh.make_shard_mesh(2, device_type="cpu"))
    assert rep.n_shards == 2
    rc, rrep = rworkflow.ocean_spgemm(ra, ra, cache=False,
                                      devices=rmesh.make_shard_mesh(2))
    assert rrep.n_shards == 2
    for x, y, z in zip(formats.to_numpy(c1), formats.to_numpy(c0),
                       rc.to_scipy_like()):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, np.asarray(z))


def test_launch_imports_neither_jax_nor_reference():
    import subprocess
    import sys
    code = ("import sys\n"
            "from repro_torch.launch import dryrun, mesh, report, sharding\n"
            "from repro_torch.core import dispatch\n"
            "m = mesh.make_shard_mesh(2, device_type='cpu')\n"
            "assert len(dispatch.resolve_devices(m)) == 2\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.')]\n"
            "assert not bad, bad\n")
    import os
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
