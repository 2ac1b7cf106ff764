"""The plan cache's key on the pattern fingerprint
(``kernels.pattern_fingerprint``, ``core.planner.structure_key``).

On the CPU: the plain fingerprint against a numpy uint64 oracle and a
pinned constant (the kernel's fixed target); the key equal for copies of
one pattern and changed by any change of a pattern, a shape, the sizes fed
forward or the config; slots past nnz ignored; a warm ``ocean_spgemm``
hitting with C bit-identical to the cold call's and the ``plan.key`` span's
attrs; the kernel's grid and its wrapper's checks. On a card: the kernel
against the plain version bit for bit on the benchmark's FEM, R-MAT and
R·AP patterns, and one launch a keyed call.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import formats, planner, workflow  # noqa: E402
from repro_torch.core.analysis import OceanConfig  # noqa: E402
from repro_torch.kernels import pattern_fingerprint as pf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)

# A and B, 4 x 4 with 6 entries each: a swap changes no shape or nnz
A_PTR, A_IDX = [0, 2, 3, 5, 6], [0, 2, 1, 0, 3, 2]
B_PTR, B_IDX = [0, 1, 2, 4, 6], [2, 0, 1, 2, 0, 3]
# pattern_fingerprint_plain of (A_PTR, A_IDX, B_PTR, B_IDX) as int32
PINNED = (0x7AC9D35306E403F0, 0x1BFC391EB29D2ADF)


def _oracle(arrays):
    """The fingerprint in numpy's uint64, which wraps by definition."""
    def fmix(z):
        z = (z ^ (z >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        z = (z ^ (z >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
        return z ^ (z >> np.uint64(33))

    sums = [0, 0]
    with np.errstate(over="ignore"):
        for x, salts in zip(arrays, pf.SALTS):
            v = x.numpy().astype(np.int64).view(np.uint64)
            p = np.arange(v.shape[0], dtype=np.uint64)
            for k, salt in enumerate(salts):
                t = fmix(v ^ fmix(p + np.uint64(salt)))
                sums[k] = (sums[k] + int(t.sum(dtype=np.uint64))) & pf.MASK
    return tuple(sums)


def _csr(ptr, idx, shape, capacity=None, dtype=torch.int32):
    c = formats.csr_from_arrays(np.asarray(ptr, np.int32),
                                np.asarray(idx, np.int32),
                                np.ones(len(idx), np.float32), shape,
                                capacity=capacity, device="cpu")
    return dataclasses.replace(c, indptr=c.indptr.to(dtype),
                               indices=c.indices.to(dtype))


def _key(a, b, cfg=OceanConfig(), known_sizes=None):
    return planner.structure_key(a, b, cfg, None, True, True,
                                 known_sizes=known_sizes)


def _lanes(a, b):
    return pf.pattern_fingerprint(planner.pattern_arrays(a, b))


# ---------------------------------------------------------------------------
# The fingerprint
# ---------------------------------------------------------------------------

def test_plain_fingerprint_of_a_fixed_pattern_is_pinned():
    arrays = [torch.tensor(x, dtype=torch.int32)
              for x in (A_PTR, A_IDX, B_PTR, B_IDX)]
    assert pf.pattern_fingerprint_plain(arrays) == PINNED
    assert _oracle(arrays) == PINNED


@pytest.mark.parametrize("dtypes,sizes,chunk", [
    ((torch.int32,) * 4, (11, 1000, 0, 77), 7),
    ((torch.int64,) * 4, (5, 6, 7, 8), 3),
    ((torch.int32, torch.int64, torch.int64, torch.int32),
     (2049, 4096, 1, 0), 1 << 22),
])
def test_plain_fingerprint_equals_the_numpy_oracle(dtypes, sizes, chunk):
    rng = np.random.default_rng(sum(sizes))
    arrays = []
    for dt, n in zip(dtypes, sizes):
        hi = 2**31 if dt == torch.int32 else 2**63
        arrays.append(torch.from_numpy(
            rng.integers(-hi, hi, n, dtype=np.int64)).to(dt))
    assert pf.pattern_fingerprint_plain(arrays, chunk=chunk) == \
        _oracle(arrays)


def test_fingerprint_widens_with_the_sign():
    """An int32 array and its int64 copy give the same lanes (the key
    tells them apart by dtype)."""
    x32 = [torch.tensor(x, dtype=torch.int32)
           for x in ([-1, 0, 2**31 - 1], [-(2**31)], [], [7])]
    x64 = [x.long() for x in x32]
    assert pf.pattern_fingerprint(x32) == pf.pattern_fingerprint(x64)
    a32 = _csr(A_PTR, A_IDX, (4, 4))
    a64 = _csr(A_PTR, A_IDX, (4, 4), dtype=torch.int64)
    assert _key(a32, a32) != _key(a64, a64)


@pytest.mark.parametrize("nbytes,sms,blocks", [
    ((0, 0, 0, 0), 132, 1),
    ((4, 16, 8, 0), 132, 1),
    ((768_004, 59_149_152, 768_004, 59_149_152), 132, 1056),
    ((4096 * 16, 8, 8, 8), 132, 16),
    ((4096 * 16 + 1, 0, 0, 0), 2, 16),
    ((4096 * 16 + 1, 0, 0, 0), 3, 17),
])
def test_launch_blocks(nbytes, sms, blocks):
    assert pf.launch_blocks(nbytes, sms) == blocks


@pytest.mark.parametrize("case", ["three", "float", "2-D", "devices"])
def test_fingerprint_refuses_what_the_kernel_does_not_take(case):
    arrays = [torch.arange(5, dtype=torch.int32) for _ in range(4)]
    err = ValueError
    if case == "three":
        arrays = arrays[:3]
    elif case == "float":
        arrays[1], err = arrays[1].float(), TypeError
    elif case == "2-D":
        arrays[2] = arrays[2].reshape(1, 5)
    else:
        arrays[3] = arrays[3].to("meta")
    with pytest.raises(err):
        pf.pattern_fingerprint(arrays)


def test_kernel_launch_refuses_cpu_tensors():
    arrays = [torch.arange(5, dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        pf.launch(arrays, torch.zeros(2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# The key
# ---------------------------------------------------------------------------

def test_copies_of_one_pattern_give_one_key():
    a, b = _csr(A_PTR, A_IDX, (4, 4)), _csr(B_PTR, B_IDX, (4, 4))
    a2, b2 = _csr(A_PTR, A_IDX, (4, 4)), _csr(B_PTR, B_IDX, (4, 4))
    assert a2.indices.data_ptr() != a.indices.data_ptr()
    assert _key(a, b) == _key(a2, b2)
    assert _key(a, a) == _key(a, a2)


def _changed(case):
    """Two ``(a, b, key kwargs)``: the pair, and the same with one thing
    changed."""
    a, b = _csr(A_PTR, A_IDX, (4, 4)), _csr(B_PTR, B_IDX, (4, 4))
    base = (a, b, {})
    if case == "column":
        idx = list(B_IDX)
        idx[3] = 1
        return base, (a, _csr(B_PTR, idx, (4, 4)), {})
    if case == "moved_entry":   # indptr differs, indices equal
        return base, (_csr([0, 1, 3, 5, 6], A_IDX, (4, 4)), b, {})
    if case == "swap":
        return base, (b, a, {})
    if case == "shape":
        return base, (_csr(A_PTR, A_IDX, (4, 5)), b, {})
    if case == "known_sizes":
        return ((a, b, {"known_sizes": np.array([2, 1, 2, 1])}),
                (a, b, {"known_sizes": np.array([2, 1, 2, 2])}))
    if case == "cfg":
        return base, (a, b, {"cfg": OceanConfig(sample_min=601)})
    raise ValueError(case)


@pytest.mark.parametrize("case", ["column", "moved_entry", "swap", "shape",
                                  "known_sizes", "cfg"])
def test_any_change_changes_the_key(case):
    (a, b, kw), (a2, b2, kw2) = _changed(case)
    assert _key(a2, b2, **kw2) != _key(a, b, **kw)
    if case in ("column", "moved_entry", "swap"):
        # the fingerprint itself, not the host's part of the key, tells
        assert _lanes(a2, b2) != _lanes(a, b)


def test_slots_past_nnz_are_ignored():
    a = _csr(A_PTR, A_IDX, (4, 4), capacity=10)
    b = _csr(B_PTR, B_IDX, (4, 4), capacity=9)
    before = _key(a, b)
    a.indices[6:] = 3
    b.indices[6:] = -5
    assert _key(a, b) == before
    a.indices[5] = 1
    assert _key(a, b) != before


def test_warm_call_hits_and_gives_the_cold_c_bit_for_bit():
    a = formats.powerlaw_csr(5, 300, 300, 6.0, device="cpu")
    cache = planner.PlanCache()
    tr = trace.Tracer()
    with trace.tracing(tr):
        c0, r0 = workflow.ocean_spgemm(a, a, cache=cache)
        c1, r1 = workflow.ocean_spgemm(a, a, cache=cache)
    assert not r0.plan_cache_hit and r1.plan_cache_hit
    for x, y in zip(formats.to_numpy(c0), formats.to_numpy(c1)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    keys = [e for e in tr.events() if e["name"] == "plan.key"]
    want = 2 * (a.indptr.numel() * 4 + a.nnz * 4)
    assert [(e["attrs"]["bytes"], e["attrs"]["path"]) for e in keys] == \
        [(want, "plain")] * 2
    assert planner.key_attrs(a, a) == {"bytes": want, "path": "plain"}


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _benchmark_arrays(config, device):
    """The four arrays of a benchmark configuration's A·B, int32 as the
    benchmark hands them to the port."""
    from perfbench import manifest
    cfg = manifest.config(manifest.load(), config)
    ops = manifest.module("gen", cfg["generator"]).make(cfg, 2_718_281_828,
                                                        1, device)
    return [x.int() for m in (ops.a, ops.rhs) for x in (m.indptr, m.indices)]


@pytest.mark.parametrize("config", ["fem-q1-elasticity", "graph500-rmat-s15",
                                    "fem-q1-gamg-rap"])
def test_cuda_fingerprint_equals_the_plain_version(card, config, launches):
    arrays = _benchmark_arrays(config, card)
    cases = {"int32": arrays,
             # views at each 4-byte phase, so every head and tail is taken
             **{f"offset {o}": [x[o:] for x in arrays] for o in (1, 2, 3)},
             "int64": [x.long() for x in arrays],
             "int64 offset 1": [x.long()[1:] for x in arrays],
             "empty B": arrays[:2] + [arrays[2][:0], arrays[3][:0]]}
    got = {}
    for name, xs in cases.items():
        got[name] = (pf.pattern_fingerprint_cuda(xs),
                     pf.pattern_fingerprint_plain(xs, chunk=1 << 24))
        assert got[name][0] == got[name][1], (config, name)
    # widened with the sign, int64 copies give the int32 arrays' lanes
    assert got["int64"] == got["int32"]
    assert got["int64 offset 1"] == got["offset 1"]
    assert launches() == {"pattern_fingerprint": len(cases)}
    print(json.dumps({"config": config, "lanes": got["int32"][0]}))


def test_keyed_calls_launch_the_kernel_once_on_the_card(card, launches):
    a = formats.powerlaw_csr(3, 1 << 12, 1 << 12, 8.0, device=card)
    cache = planner.PlanCache()
    tr = trace.Tracer()
    outs = []
    for _ in range(2):
        before = launches().get("pattern_fingerprint", 0)
        with trace.tracing(tr):
            outs.append(workflow.ocean_spgemm(a, a, cache=cache))
        torch.cuda.synchronize(card)
        assert launches()["pattern_fingerprint"] - before == 1
    (c0, r0), (c1, r1) = outs
    assert not r0.plan_cache_hit and r1.plan_cache_hit
    for x, y in zip(formats.to_numpy(c0), formats.to_numpy(c1)):
        assert x.tobytes() == y.tobytes()
    paths = {e["attrs"]["path"] for e in tr.events()
             if e["name"] == "plan.key"}
    assert paths == {"cuda"}
    assert cache.peek(planner.structure_key(
        a, a, OceanConfig(), None, True, True)) is not None
    a_cpu = formats.CSR(a.indptr.cpu(), a.indices.cpu(), a.values.cpu(),
                        a.shape, a.nnz)
    assert _lanes(a, a) == _lanes(a_cpu, a_cpu)
