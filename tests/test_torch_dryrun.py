"""The port's dry-run — cells traced on ``meta``, their memory, FLOP and
collective terms, the byte counter, the live-bytes tracker and the report
— on the CPU, against hand counts and against the JAX reference's report.

The cells are the smoke configs at small shapes on a logical
``{data 2, model 2}`` mesh. Argument bytes are held to a sum over the
specs written out here; Qwen3's forward-body FLOPs to the matmul count of
its config; a 2-layer dense config's collectives to the rules counted
weight by weight; skipped cells to the reference's reasons; the rendered
table to the reference's ``report.render`` on the same records.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import report as rreport  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, report, sharding  # noqa: E402
from repro_torch.launch.mesh import LogicalMesh  # noqa: E402
from repro_torch.launch.meta_trace import MetaTrace, tensor_bytes  # noqa: E402,E501
from repro_torch.models import lm  # noqa: E402

MESH = LogicalMesh(("data", "model"), (2, 2))
SMALL = {"train": ShapeSpec("train_s", "train", 64, 8),
         "prefill": ShapeSpec("prefill_s", "prefill", 64, 4),
         "decode": ShapeSpec("decode_s", "decode", 128, 4)}
CELLS = (("qwen3-1.7b", "train"), ("qwen3-1.7b", "prefill"),
         ("qwen3-1.7b", "decode"), ("olmoe-1b-7b", "train"),
         ("olmoe-1b-7b", "decode"), ("falcon-mamba-7b", "train"),
         ("falcon-mamba-7b", "prefill"), ("whisper-base", "train"),
         ("whisper-base", "prefill"), ("whisper-base", "decode"))


def smoke_cell(arch, kind, cfg=None, microbatch=4):
    cfg = cfg or configs.get_config(arch, smoke=True)
    shape = SMALL[kind]
    policy = sharding.ShardingPolicy(MESH, "fsdp" if kind == "train"
                                     else "tp")
    rec = {"arch": arch, "shape": shape.name, "mesh": "2x2", "chips": 4}
    return dryrun.evaluate(rec, cfg, shape, policy, remat="dots",
                           microbatch=microbatch), cfg, shape, policy


@pytest.fixture(scope="module")
def cells():
    return {c: smoke_cell(*c) for c in CELLS}


def shard_bytes(shape, spec, itemsize):
    """One device's bytes of ``shape`` under ``spec`` on MESH, counted
    here: each dimension over the product of its axes' sizes."""
    n = 1
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        k = int(np.prod([MESH.shape[a] for a in names]))
        assert dim % k == 0
        n *= dim // k
    return n * itemsize


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_smoke_cells_trace_and_their_argument_bytes(cells, cell):
    rec, cfg, shape, policy = cells[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["artifacts"]["full"]["mem"]
    assert rec["per_device_bytes"] == sum(mem.values())
    assert rec["fits_80g"] and mem["temp_bytes"] > 0
    model, specs = lm.abstract_params(cfg)
    if shape.kind != "train":
        model = lm.cast_weights(model, cfg.compute_dtype)
    b, l = shape.global_batch, shape.seq_len
    params = sum(shard_bytes(p.shape, policy.param_spec(p.shape, specs[n]),
                             p.element_size())
                 for n, p in model.named_parameters())
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    data = ("data",)
    dec = min(448, max(l // 8, 64))
    if shape.kind == "train":
        batch = (shard_bytes((b, l, cfg.d_model), data, item)
                 + shard_bytes((b, dec + 1), data, 4)
                 if cfg.is_encoder_decoder else
                 shard_bytes((b, l + 1), data, 4))
        want = 3 * params + 4 + batch
    else:
        caches = lm.init_caches(cfg, b, dec if cfg.is_encoder_decoder else l,
                                dtype=cfg.compute_dtype, device="meta",
                                src_len=l if cfg.is_encoder_decoder else 0)
        layers = (caches["self"] + caches["cross"]
                  if cfg.is_encoder_decoder else caches)
        cache = sum(shard_bytes(t.shape, policy.cache_spec(t.shape, b),
                                t.element_size())
                    for layer in layers for t in layer.values())
        if shape.kind == "decode":
            ins = shard_bytes((b, 1), data, 4) + shard_bytes((b,), data, 4)
        elif cfg.is_encoder_decoder:
            ins = shard_bytes((b, l, cfg.d_model), data, item) + \
                shard_bytes((b, dec), data, 4)
        else:
            ins = shard_bytes((b, l), data, 4)
        want = params + cache + ins
    assert mem["argument_bytes"] == want
    rf = rec["roofline"]
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")


def test_qwen3_forward_body_flops_are_its_matmuls(cells):
    """The prefill body (one layer, cost mode, per-device batch 2 of 64
    tokens): the projections and the two attention products."""
    rec, cfg, shape, _ = cells[("qwen3-1.7b", "prefill")]
    b, l = shape.global_batch // 2, shape.seq_len
    t = b * l
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim_, cfg.d_ff)
    proj = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * ff
    attn = 2 * b * hq * l * l * dh
    assert rec["artifacts"]["body_prefill"]["flops"] == 2 * t * proj + \
        2 * attn
    # per device: the body over the layers, divided over 'model'
    outer = rec["artifacts"]["outer"]["flops"]
    assert outer == 2 * b * d * cfg.vocab_size
    assert rec["totals"]["flops"] == (
        3 * rec["artifacts"]["body_prefill"]["flops"] + outer) / 2


def test_dense_collectives_are_the_rules_counted_by_hand():
    """A 2-layer Qwen3-smoke under fsdp on {data 2, model 2}, 8 x 64
    tokens: per device 256 tokens; every leaf's spec written out."""
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b", smoke=True),
                              num_layers=2, name="qwen3-2l")
    rec, cfg, shape, _ = smoke_cell("qwen3-1.7b", "train", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    d, hq, hkv, dh, ff, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim_, cfg.d_ff, cfg.vocab_size)
    tokens, cd = 256, 4            # f32 smoke compute dtype

    # (elements of one data group's share, sharded over data?) a leaf:
    # the embedding (vocab over model, embed over data), each layer's two
    # norms (embed over data), q/k norms (replicated), wq/wk/wv/wo and the
    # MLP (their model axis and embed over data); the final norm
    leaves = [(v * d // 2, True), (d, True)]
    per_layer = [(d, True), (d, True), (dh, False), (dh, False),
                 (d * hq * dh // 2, True), (d * hkv * dh // 2, True),
                 (d * hkv * dh // 2, True), (hq * dh * d // 2, True),
                 (d * ff // 2, True), (d * ff // 2, True),
                 (ff * d // 2, True)]
    leaves += per_layer * 2
    ag = sum(2 * n * cd / 2 for n, sharded in leaves if sharded)
    rs = sum(n * 4 / 2 for n, sharded in leaves if sharded)
    ar_grad = sum(n * 4 * 2 / 2 for n, sharded in leaves if not sharded)
    # contracted over 'model': the embedding's gather and each layer's
    # attention and MLP output projections; forward and backward
    ar_act = 2 * tokens * d * 2 * 2 * (1 / 2) * (1 + 2 * 2)
    sharded = sum(1 for _, s in leaves if s)      # 20 leaves
    want = {"all-gather": {"count": 2 * sharded, "bytes": ag},
            "reduce-scatter": {"count": sharded, "bytes": rs},
            # 4 replicated gradients, 5 output activations twice each
            "all-reduce": {"count": 4 + 2 * 5, "bytes": ar_grad + ar_act}}
    got = rec["totals"]["collectives"]
    assert set(got) == set(want)
    for op in want:
        assert got[op]["count"] == want[op]["count"], op
        assert got[op]["bytes"] == pytest.approx(want[op]["bytes"],
                                                 rel=1e-12), op
    assert rec["roofline"]["collective_s"] == pytest.approx(
        sum(w["bytes"] for w in want.values()) / dryrun.HW["link_bw"])


def test_moe_all_to_all_under_model_sharded_experts(cells):
    """OLMoE-smoke's 8 experts divide over model = 2: two all-to-alls a
    MoE layer in decode (4 slots over data 2: 2 tokens a device)."""
    rec, cfg, _, _ = cells[("olmoe-1b-7b", "decode")]
    a2a = rec["totals"]["collectives"]["all-to-all"]
    assert a2a["count"] == 2 * cfg.num_layers
    assert a2a["bytes"] == 2 * cfg.num_layers * 2 * cfg.moe_top_k * \
        cfg.d_model * 2


def test_microbatches_add_gradient_accumulators():
    """One microbatch's step traced, plus one device's shards of the f32
    gradients."""
    one, cfg, _, policy = smoke_cell("qwen3-1.7b", "train", microbatch=0)
    two, _, _, _ = smoke_cell("qwen3-1.7b", "train", microbatch=4)
    assert one["per_device"] == {"batch": 4, "seq": 64, "microbatch": 0}
    assert two["per_device"]["microbatch"] == 2
    model, specs = lm.abstract_params(cfg)
    params = sum(shard_bytes(p.shape, policy.param_spec(p.shape, specs[n]),
                             4) for n, p in model.named_parameters())
    t1 = one["artifacts"]["full"]["mem"]["temp_bytes"]
    t2 = two["artifacts"]["full"]["mem"]["temp_bytes"]
    assert t2 - two["artifacts"]["full"]["peak_bytes"] == params
    assert two["artifacts"]["full"]["peak_bytes"] < t1
    assert one["totals"]["flops"] == two["totals"]["flops"]


def test_skipped_cells_carry_the_reference_reasons():
    for arch in configs.ARCH_IDS:
        want = rconfigs.shape_skips(arch)
        assert configs.shape_skips(arch) == want
        for shape in SHAPES:
            if shape not in want:
                continue
            for multi in (False, True):
                rec = dryrun.run_cell(arch, shape, multi)
                assert rec["status"] == "skipped"
                assert rec["reason"] == want[shape]
                assert rec["chips"] == (512 if multi else 256)


def test_a_failing_cell_is_recorded_with_its_traceback(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no trace")
    monkeypatch.setattr(dryrun, "build_cell", boom)
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False)
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: no trace"
    assert "boom" in rec["traceback"]


def test_cli_grid_and_report(tmp_path):
    """The CLI over a full-width decode cell and a skipped one on both
    meshes, in two worker processes; the report renders them."""
    out = str(tmp_path / "d.json")
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", out])
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k",
                 "--mesh", "both", "--out", out, "--append", "--jobs", "2"])
    with open(out) as f:
        rs = json.load(f)
    assert [(r["shape"], r["mesh"], r["status"]) for r in rs] == [
        ("decode_32k", "16x16", "ok"), ("decode_32k", "2x16x16", "ok"),
        ("long_500k", "16x16", "skipped"), ("long_500k", "2x16x16",
                                            "skipped")]
    ok = rs[0]
    assert ok["policy"] == "tp" and ok["remat"] is None
    assert ok["per_device"]["batch"] == 8 and rs[1]["per_device"]["batch"] \
        == 4
    assert ok["moe_dispatch"] == "einsum" and ok["moe_groups"] == 1
    text = report.render(out)
    assert "cells: 4 | ok: 2 | skipped (documented): 2 | errors: 0" in text


# ---------------------------------------------------------------------------
# (7) byte counter and live-bytes tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_byte_counter_and_live_bytes_on_a_known_sequence(device):
    x = torch.zeros(256, device=device)         # an argument: not counted
    with MetaTrace() as t:
        a = x * 2                               # +1 KiB live
        assert (t.bytes, t.live, t.peak) == (2048, 1024, 1024)
        b = a + x
        assert (t.bytes, t.live) == (2048 + 3072, 2048)
        del a                                   # its storage dies
        assert t.live == 1024
        c = b.view(16, 16)                      # a view: nothing
        assert (t.bytes, t.live) == (5120, 1024)
        d = c.t().contiguous()                  # a copy
        assert (t.bytes, t.live, t.peak) == (5120 + 2048, 2048, 2048)
        b.add_(x)                               # in place: no storage
        assert (t.bytes, t.live) == (7168 + 3072, 2048)
        e = x.expand(4, 256) * 1                # a broadcast read once
        assert (t.bytes, t.live, t.peak) == (10240 + 1024 + 4096, 6144,
                                             6144)
        del b, c, d, e
        assert t.live == 0 and t.peak == 6144
        s = torch.zeros((), device=device) + 1  # scalars count their bytes
        assert t.live == 4
    assert t.ops >= 8
    del s


def test_repeated_ops_count_alike_and_reuse_layouts():
    """A loop body's bytes and peak are the same each time round (the
    second round's outputs are remade from the first's layouts)."""
    x = torch.zeros((3, 8, 5), device="meta").transpose(1, 2)
    rounds = []
    with MetaTrace() as t:
        for _ in range(3):
            before = t.bytes
            y = torch.softmax(x * 3.0, dim=-1).sum(dim=0)
            z = torch.cat([y, y], dim=0)
            rounds.append((t.bytes - before, tuple(z.shape), z.stride(),
                           y.dtype))
            del y, z
            assert t.live == 0
    assert rounds[0] == rounds[1] == rounds[2]
    assert rounds[0][1] == (10, 8)
    assert tensor_bytes(x) == 3 * 8 * 5 * 4
    assert tensor_bytes(torch.zeros(5, device="meta").expand(7, 5)) == 20


# ---------------------------------------------------------------------------
# (8) the report against the reference's
# ---------------------------------------------------------------------------

def test_report_matches_reference(cells, tmp_path):
    recs = [dict(rec, shape=rec["shape"]) for rec, *_ in cells.values()]
    recs.append(dryrun.run_cell("qwen3-1.7b", "long_500k", False))
    recs.append({"arch": "x", "shape": "y", "status": "error",
                 "error": "ValueError: " + "z" * 100})
    recs.append(dict(recs[0], fits_80g=False,
                     roofline=dict(recs[0]["roofline"], useful_ratio=None)))
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    port.write_text(json.dumps(recs, default=float))
    ref.write_text(json.dumps([
        {("fits_16g" if k == "fits_80g" else k): v for k, v in r.items()}
        for r in recs], default=float))
    want = rreport.render(str(ref)).replace("16G", "80G").replace(
        "<16 GB", "<80 GB")
    assert report.render(str(port)) == want
    assert report.collective_detail(str(port), "qwen3-1.7b", "train_s") \
        == rreport.collective_detail(str(ref), "qwen3-1.7b", "train_s")
