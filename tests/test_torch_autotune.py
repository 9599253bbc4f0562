"""The port's block-shape autotuner (``repro_torch.kernels.autotune``): the
counterpart of each case of ``tests/test_autotune.py``, the picks
``kernels.ops`` makes with and without a winner, and parity with the JAX
package's tuner.

Every test points the user's cache and the shipped file at ``tmp_path``
(``REPRO_TORCH_AUTOTUNE_CACHE`` / ``REPRO_TORCH_PRETUNED_CACHE``), but the
one that reads the shipped ``pretuned.json`` itself.  On the CPU the
tuner times the plain versions; its keys carry ``cpu``, so the shipped
file (card keys only) never resolves here.

Tolerances: a recorded winner makes ``kernels.ops`` bitwise the call at
that winner (the same plain-version walk).  Against JAX, ``tp_matmul``
under ``fp32`` with JAX's recorded (32, 128, 128) block and the port's
two-way K split (two sums of 128 products, added once) agrees within
1e-6 relative: both are f32 sums of the same products in orders that
differ by the blocking only.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_CLUSTER, STRIP_UNIT, cluster_size)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TC_BLOCK_K, kernel_tiles, plan_q_rows)
from repro_torch.kernels.tp_matmul import (  # noqa: E402
    plan_split, plan_tc, tc_plan, tp_matmul_plain)

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """An isolated user cache and shipped file; returns a helper that
    writes the shipped file (header + entries) and reloads the tuner."""
    user = tmp_path / "user.json"
    ship_path = tmp_path / "pretuned.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(user))
    monkeypatch.setenv("REPRO_TORCH_PRETUNED_CACHE", str(ship_path))

    def ship(entries, raw=None):
        ship_path.write_text(raw if raw is not None else json.dumps(
            {"card": "test", "entries": entries}))
        autotune.reset()

    autotune.reset()
    ship.user = user
    yield ship
    autotune.reset()


def _cpu_key(op, shape, dtype=F32, build=None):
    k = autotune._key(op, shape, dtype, CPU)
    if build is not None:
        k = k.rsplit("|", 1)[0] + f"|{build}"
    return k


# ---------------------------------------------------------------------------
# candidates and the static rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op,shape,dtype", [
    ("decode_attn", (32, 65, 64, 2, 256), BF16),
    ("decode_attn", (8, 128, 64, 2, 256), BF16),
    ("decode_attn", (4, 3, 16, 48, 128), F32),
    ("decode_attn", (300, 1, 64, 1, 64), BF16),
    ("attn", (256, 16, 2, 256, 256), BF16),
    ("attn", (256, 2, 48, 128, 128), BF16),
    ("attn", (64, 4, 96, 128, 128), BF16),
    ("attn", (96, 2, 2, 128, 128), F32),
    ("attn", (64, 2, 2, 24, 16), BF16),
    ("matmul", (256, 3584, 14336), BF16),
    ("matmul", (4, 14336, 3584), "float32+fp8"),
    ("matmul", (50, 100, 70), BF16),
    ("matmul", (96, 640, 200), "float32+tf32"),
    ("matmul", (64, 256, 128), F32),
])
def test_candidates_legal_and_include_default(op, shape, dtype):
    """Heuristic first, no repeats; clusters powers of two up to the live
    units and 16; query tiles 64 / 128 on ``flash_tc`` (128 alone past a
    group of 64), one on ``flash_fma``; plans whose splits each hold a K
    step, 128-row plans at power-of-two splits on ``tp_matmul``'s split
    route (f32 without a grid, the tf32 grid), led by ``plan_split``."""
    cands = autotune.candidates(op, shape, dtype)
    assert cands[0] == autotune.default_block(op, shape, dtype)
    assert len(cands) == len(set(cands)) >= 1
    if op == "decode_attn":
        units = shape[1]
        for (c,) in cands:
            assert c & (c - 1) == 0 and 1 <= c <= min(MAX_CLUSTER,
                                                      max(1, units))
        assert len(cands) == min(MAX_CLUSTER, units).bit_length()
    elif op == "attn":
        tc = (shape[3], shape[4]) in ((256, 256), (128, 128), (96, 64)) \
            and dtype != F32
        want = ({64, 128} if shape[2] <= 64 else {128}) if tc else \
            {cands[0][0]}
        assert {c for (c,) in cands} == want
        for (c,) in cands:
            assert shape[2] <= c or not tc
    else:
        m, k, n = shape
        steps = -(-k // 64)
        for wm, splits in cands:
            assert wm in (1, 2) and 1 <= splits <= steps
            p = tc_plan(m, k, n, wm, splits)
            assert (p.wm, p.splits) == (wm, splits)
            assert (splits - 1) * p.steps_per_split < steps \
                <= splits * p.steps_per_split
        if dtype in (F32, "float32+tf32"):     # the split route
            assert cands[0] == (1, plan_split(m, k, n).splits)
            assert set(cands) == {cands[0]} | {
                (1, tc_plan(m, k, n, 1, 2 ** i).splits)
                for i in range(steps.bit_length())}


def test_tiny_shapes_collapse():
    assert autotune.candidates("decode_attn", (4, 1, 64, 2, 64)) == [(1,)]
    assert autotune.candidates("matmul", (8, 64, 8), BF16) == [(1, 1),
                                                               (2, 1)]


# ---------------------------------------------------------------------------
# record / lookup, keys, the user's file
# ---------------------------------------------------------------------------
def test_record_lookup_roundtrip(tuner):
    shape, block = (32, 65, 64, 2, 256), (4,)
    assert autotune.lookup("decode_attn", shape, BF16, CPU) is None
    assert autotune.best_block("decode_attn", shape, BF16, CPU) == \
        autotune.default_block("decode_attn", shape) == (16,)
    autotune.record("decode_attn", shape, BF16, block, device=CPU)
    assert autotune.lookup("decode_attn", shape, BF16, CPU) == block
    assert autotune.best_block("decode_attn", shape, BF16, CPU) == block
    # the bucket: 65 and 100 live units share one winner
    assert autotune.lookup("decode_attn", (20, 100, 64, 2, 256), BF16,
                           CPU) == block
    # persisted: a fresh start (reset drops the in-process mirror) reloads
    autotune.reset()
    assert json.loads(tuner.user.read_text())
    assert autotune.lookup("decode_attn", shape, BF16, CPU) == block


def test_dtype_and_device_keys_never_collide(tuner):
    shape = (256, 3584, 14336)
    autotune.record("matmul", shape, BF16, (1, 4), device=CPU)
    assert autotune.lookup("matmul", shape, F32, CPU) is None
    assert autotune.lookup("matmul", shape, "float32+fp8", CPU) is None
    assert autotune.lookup("matmul", shape, BF16, CPU) == (1, 4)
    k = _cpu_key("matmul", shape, BF16)
    assert k.split("|")[3] == "cpu"
    card = k.split("|")
    card[3] = "NVIDIA H100 80GB HBM3 sm90 x132"
    assert "|".join(card) != k
    # an op's shape is not another op's
    assert autotune.lookup("attn", (256, 3584, 14336, 1, 1), BF16, CPU) is None


def test_entry_of_another_build_never_resolves(tuner):
    shape = (64, 256, 128)
    autotune.record("matmul", shape, F32, (1, 2), device=CPU)
    disk = json.loads(tuner.user.read_text())
    assert all(k.endswith(f"|torch-{torch.__version__}") for k in disk)
    other = _cpu_key("matmul", (128, 256, 128), build="torch-0.0.0")
    disk[other] = [2, 4]
    tuner.user.write_text(json.dumps(disk))
    autotune.reset()
    assert autotune.lookup("matmul", shape, F32, CPU) == (1, 2)
    assert autotune.lookup("matmul", (128, 256, 128), F32, CPU) is None
    # kept in the user's file on the next record, still inert
    autotune.record("matmul", (8, 64, 8), F32, (1, 1), device=CPU)
    assert other in json.loads(tuner.user.read_text())


@pytest.mark.parametrize("op,args,shape", [
    ("decode_attn", (8, 12, 16, 2, 64), (8, 12, 16, 2, 64)),
    ("attn", (64, 2, 2, 64), (64, 2, 2, 64, 64)),
    ("matmul", (16, 256, 32), (16, 256, 32)),
])
def test_sweep_picks_and_persists_winner(tuner, op, args, shape):
    fn = {"decode_attn": autotune.autotune_decode,
          "attn": autotune.autotune_attention,
          "matmul": autotune.autotune_matmul}[op]
    dtype = F32 if op == "matmul" else BF16
    winner, timings = fn(*args, dtype=dtype, device="cpu", repeats=1)
    assert winner in timings and list(timings) == autotune.candidates(
        op, shape, dtype)
    assert all(t["ms"] > 0 and t["spread_ms"] == 0 for t in timings.values())
    assert autotune.lookup(op, shape, dtype, CPU) == winner
    assert tuner.user.exists()


def test_winner_needs_a_clear_gain():
    """A candidate displaces the heuristic only past 3% and both spreads."""
    t = lambda ms, sp=0.0: {"ms": ms, "spread_ms": sp}
    h = (16,)
    assert autotune._winner({h: t(1.0), (8,): t(0.98)}, h) == h
    assert autotune._winner({h: t(1.0), (8,): t(0.9)}, h) == (8,)
    assert autotune._winner({h: t(1.0, 0.2), (8,): t(0.9)}, h) == h
    assert autotune._winner({h: t(1.0), (8,): t(0.9, 0.15)}, h) == h
    assert autotune._winner({h: t(1.0), (8,): t(0.9), (4,): t(0.8)},
                            h) == (4,)


# ---------------------------------------------------------------------------
# the shipped file
# ---------------------------------------------------------------------------
def test_pretuned_warm_hit(tuner):
    shape = (32, 65, 64, 2, 256)
    tuner({_cpu_key("decode_attn", shape, BF16): [8]})
    assert autotune.lookup("decode_attn", shape, BF16, CPU) == (8,)
    assert autotune.best_block("decode_attn", shape, BF16, CPU) == (8,)
    assert autotune.pretuned_status(CPU)["adopted"] == 1


def test_pretuned_cold_miss_falls_back_to_heuristic(tuner):
    shape = (256, 16, 2, 256, 256)
    autotune.reset()                     # no shipped file at all
    assert autotune.lookup("attn", shape, BF16, CPU) is None
    assert autotune.best_block("attn", shape, BF16, CPU) == \
        (plan_q_rows(256, 16, 2),)
    tuner({_cpu_key("attn", (1024, 16, 2, 256, 256), BF16): [64]})
    assert autotune.lookup("attn", shape, BF16, CPU) is None


def test_pretuned_stale_build_not_adopted(tuner):
    shape = (64, 256, 128)
    tuner({_cpu_key("matmul", shape, build="torch-0.0.0"): [2, 2]})
    assert autotune.lookup("matmul", shape, F32, CPU) is None
    assert autotune.best_block("matmul", shape, F32, CPU) == \
        autotune.default_block("matmul", shape)
    assert autotune.pretuned_status(CPU)["adopted"] == 0


def test_pretuned_user_cache_wins(tuner):
    shape = (64, 256, 128)
    tuner.user.write_text(json.dumps({_cpu_key("matmul", shape): [1, 4]}))
    tuner({_cpu_key("matmul", shape): [1, 2]})
    assert autotune.lookup("matmul", shape, F32, CPU) == (1, 4)
    # a record persists the user's own entries, not the adopted shipped ones
    tuner({_cpu_key("matmul", shape): [1, 2],
           _cpu_key("matmul", (8, 64, 8)): [2, 1]})
    autotune.record("matmul", (16, 64, 16), F32, (1, 1), device=CPU)
    assert _cpu_key("matmul", (8, 64, 8)) not in json.loads(
        tuner.user.read_text())


def test_pretuned_malformed_entries_skipped(tuner):
    shape = (64, 256, 128)
    tuner({_cpu_key("matmul", shape): "not-a-block",
           "matmul|truncated": [1, 2],
           _cpu_key("attn", (256, 16, 2, 256, 256), BF16): [64]})
    assert autotune.lookup("matmul", shape, F32, CPU) is None
    assert autotune.lookup("attn", (256, 16, 2, 256, 256), BF16, CPU) == (64,)
    for raw in ("not json", json.dumps([1, 2]), json.dumps({"entries": 3})):
        tuner({}, raw=raw)
        assert autotune.lookup("attn", (256, 16, 2, 256, 256), BF16,
                               CPU) is None


def test_shipped_pretuned_file_is_wellformed():
    """The port's own ``kernels/pretuned.json``: card keys only (no
    ``cpu``), each op's build tagged with torch, CUDA and its library's
    source digest, positive integer blocks of the op's arity."""
    path = os.path.join(os.path.dirname(autotune.__file__), "pretuned.json")
    with open(path) as f:
        ship = json.load(f)
    arity = {"decode_attn": 1, "attn": 1, "matmul": 2}
    for k, v in ship["entries"].items():
        op, shape, dtype, device, build = k.split("|")
        assert op in arity and len(v) == arity[op]
        assert len(shape.split("x")) == autotune._DIMS[op]
        assert device != "cpu" and " sm" in device
        assert build.startswith("torch-") and "+cuda-" in build
        assert build.rsplit("+", 1)[1] == ship["digests"][
            autotune.LIBRARY[op]]
        assert all(isinstance(x, int) and x > 0 for x in v)
        autotune._split_dtype(dtype)


def test_cli_on_the_cpu(tuner, tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
        "REPRO_TORCH_AUTOTUNE_CACHE": str(tmp_path / "cli.json")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.kernels.autotune",
                        "--op", "decode_attn", "--shape", "4x6x16x2x32",
                        "--device", "cpu", "--repeats", "1"],
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr
    assert "winner for decode_attn 4x6x16x2x32" in r.stdout
    disk = json.loads((tmp_path / "cli.json").read_text())
    assert list(disk) == ["decode_attn|4x8x16x2x32|bfloat16|cpu|"
                          f"torch-{torch.__version__}"]
    bad = subprocess.run([sys.executable, "-m",
                          "repro_torch.kernels.autotune", "--op", "matmul",
                          "--shape", "4x6", "--device", "cpu"],
                         capture_output=True, text=True, timeout=240, env=env)
    assert bad.returncode == 2 and "3 'x'-separated dims" in bad.stderr


# ---------------------------------------------------------------------------
# kernels.ops: the picks
# ---------------------------------------------------------------------------
def _serving_shapes():
    """(arch, decode rows, units, unit, G, D, window) and (arch, Sq, BKV,
    G, D, Dv) over each registered arch's attention layers at the slot
    counts and table widths the port serves."""
    from repro_torch.models.registry import ARCHS, get_config
    dec, fl = [], []
    for arch in ARCHS:
        cfg = get_config(arch)
        kinds = {s.mixer for s in cfg.layer_list()}
        if not kinds & {"gqa", "shared_attn", "mla"}:
            continue
        g = cfg.n_heads // max(cfg.n_kv_heads, 1)
        if "mla" in kinds:
            d, dv = cfg.nope_dim + cfg.rope_dim, cfg.v_head_dim
            for b in (1, 4):
                fl += [(arch, sq, b * cfg.n_heads, 1, d, dv)
                       for sq in (64, 256, 1024)]
            continue
        windows = {s.window for s in cfg.layer_list()}
        for slots in (1, 4, 16, 128):
            for units in (1, 5, 17, 65, 128):
                for unit in (cfg.page_size, STRIP_UNIT):
                    for w in windows:
                        dec.append((arch, slots * cfg.n_kv_heads, units,
                                    unit, g, cfg.head_dim, w))
            for sq in (1, 96, 256, 1024, 1500):
                fl.append((arch, sq, slots * cfg.n_kv_heads, g,
                           cfg.head_dim, cfg.head_dim))
    return dec, fl


def test_empty_cache_picks_are_the_static_rules(tuner):
    """No winner anywhere: every pick is today's rule, for every
    registered arch's serving shapes, pool dtype and matmul product."""
    dec, fl = _serving_shapes()
    assert len({a for a, *_ in dec}) >= 7 and len(fl) > 100
    for arch, rows, units, unit, g, d, w in dec:
        for dt in (BF16, torch.float8_e5m2, F32):
            assert kops.decode_pick(rows, units, unit, g, d, dt, CPU, w) == \
                cluster_size(rows, units, unit, w), (arch, rows, units, w)
    for arch, sq, bkv, g, d, dv in fl:
        assert kops.flash_q_rows(sq, bkv, g, d, dv, BF16, CPU) == \
            plan_q_rows(sq, bkv, g), arch
    for m in (1, 4, 50, 128, 129, 256, 4096):
        for k, n in ((3584, 14336), (14336, 3584), (100, 70), (64, 256)):
            for dt, grid in ((BF16, None), (F32, "fp8")):
                assert kops.tp_matmul_plan(m, k, n, dt, CPU, grid) == \
                    plan_tc(m, k, n)
    # the meta device (the dry run) takes the rule, never the cache
    autotune.record("decode_attn", (32, 65, 64, 2, 256), BF16, (2,),
                    device=CPU)
    k = torch.empty((32 * 65 + 1, 8, 64, 256), dtype=BF16, device="meta")
    t = torch.zeros((4, 65), dtype=torch.int32, device="meta")
    assert kops.decode_cluster(4, k, t, 4096, group=2) == 16
    kc = torch.empty((1, 1, 1, 1), dtype=BF16).expand(k.shape)
    assert kops.decode_cluster(4, kc, torch.zeros((4, 65)), 4096,
                               group=2) == 2


def _decode_inputs(seed=0, b=4, hkv=2, g=2, d=32, page=16, nk=9):
    gen = torch.Generator().manual_seed(seed)
    n_pages = b * nk + 1
    k, v = (torch.randn((n_pages, hkv, page, d), generator=gen).to(BF16)
            for _ in range(2))
    table = torch.randperm(n_pages, generator=gen)[:b * nk].reshape(
        b, nk).to(torch.int32)
    q = torch.randn((b, hkv * g, 1, d), generator=gen).to(BF16)
    lens = torch.tensor([nk * page, 3, page + 5, 100])
    return q, k, v, table, lens


def test_recorded_winner_drives_decode(tuner):
    """With a winner recorded for the read's bucket, the default call is
    bitwise the call at that cluster, and not the rule's; the fold keeps
    the step form's size (it passes it), and a winner larger than the live
    units is clamped."""
    q, k, v, table, lens = _decode_inputs()
    b, hkv, g, d, page, nk = 4, 2, 2, 32, 16, 9
    rule = cluster_size(b * hkv, nk, page)
    assert rule == 8
    kw = dict(kv_len=lens, block_table=table, policy="tp_bf16", softcap=50.0)
    base = kops.decode_attention(q, k, v, **kw)
    assert torch.equal(base, kops.decode_attention(q, k, v, cluster=rule,
                                                   **kw))
    autotune.record("decode_attn", (b * hkv, nk, page, g, d), BF16, (2,),
                    device=CPU)
    assert kops.decode_cluster(b, k, table, group=g) == 2
    got = kops.decode_attention(q, k, v, **kw)
    at2 = kops.decode_attention(q, k, v, cluster=2, **kw)
    assert torch.equal(got, at2)
    assert not torch.equal(got, base)
    # a window bounds the live units to 2 (16-key pages, window 20): the
    # bucket (8 rows, 2 units) has its own key, and 16 clamps to 2
    autotune.record("decode_attn", (b * hkv, 2, page, g, d), BF16, (16,),
                    device=CPU)
    assert kops.decode_cluster(b, k, table, window=20, group=g) == 2
    # another group or dtype: the rule
    assert kops.decode_pick(b * hkv, nk, page, 4, d, BF16, CPU) == rule
    assert kops.decode_pick(b * hkv, nk, page, g, d, F32, CPU) == rule


def test_recorded_winner_drives_tp_matmul(tuner):
    """The recorded plan's K ranges drive the CPU call: bitwise
    ``tp_matmul_plain`` at that plan, and not the one-block sum."""
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randn(64, 2048).astype(np.float32))
    b = torch.from_numpy(rs.randn(2048, 96).astype(np.float32))
    whole = kops.tp_matmul(a, b, policy="fp32")
    assert torch.equal(whole, tp_matmul_plain(a, b))
    autotune.record("matmul", (64, 2048, 96), F32, (1, 4), device=CPU)
    plan = kops.tp_matmul_plan(64, 2048, 96, F32, CPU)
    assert (plan.splits, plan.k_ranges(2048)) == (
        4, [(0, 512), (512, 1024), (1024, 1536), (1536, 2048)])
    got = kops.tp_matmul(a, b, policy="fp32")
    assert torch.equal(got, tp_matmul_plain(a, b, plan=plan))
    assert not torch.equal(got, whole)
    # a split past the K steps clamps (one 64-wide step each)
    autotune.record("matmul", (64, 128, 96), F32, (1, 64), device=CPU)
    assert kops.tp_matmul_plan(64, 128, 96, F32, CPU).splits == 2


def test_recorded_winner_drives_flash_tiles(tuner):
    """``kernel_tiles`` follows the recorded query rows, and so does the
    plain version's telemetry walk in ``kernels.ops``; the output does
    not depend on it."""
    bkv, g, sq, d = 2, 2, 96, 64
    assert kernel_tiles(BF16, None, sq, bkv, g, d, q_rows=128) == (
        64, TC_BLOCK_K)
    assert kernel_tiles(BF16, None, sq, bkv, g, d) == (
        plan_q_rows(sq, bkv, g) // g, TC_BLOCK_K) == (32, TC_BLOCK_K)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, bkv * g, sq, d), generator=gen).to(BF16)
    k, v = (torch.randn((1, bkv, sq, d), generator=gen).to(BF16)
            for _ in range(2))
    kw = dict(policy="tp_bf16", block_k=TC_BLOCK_K, return_flags=True)
    o64, f64 = kops.flash_attention(q, k, v, **kw)
    autotune.record("attn", (sq, bkv, g, d, d), BF16, (128,), device=CPU)
    assert kops.flash_q_rows(sq, bkv, g, d, d, BF16, CPU) == 128
    o128, f128 = kops.flash_attention(q, k, v, **kw)
    _, want = kops.flash_attention(q, k, v, block_q=64, **kw)
    assert torch.equal(o64, o128) and torch.equal(f128, want)
    # a group past 64 rows never takes the 64-row tile
    autotune.record("attn", (sq, 1, 96, 128, 128), BF16, (64,), device=CPU)
    assert kops.flash_q_rows(sq, 1, 96, 128, 128, BF16, CPU) == 128


def test_picks_are_memoized_until_record(tuner):
    shape = (32, 65, 64, 2, 256)
    assert kops.decode_pick(*shape, BF16, CPU) == 16
    assert autotune._PICKS
    autotune.record("decode_attn", shape, BF16, (4,), device=CPU)
    assert not autotune._PICKS
    assert kops.decode_pick(*shape, BF16, CPU) == 4
    autotune.reset()
    assert kops.decode_pick(*shape, BF16, CPU) == 4      # from the file
    autotune.reset(clear_env_cache=True)
    assert not tuner.user.exists()
    assert kops.decode_pick(*shape, BF16, CPU) == 16


# ---------------------------------------------------------------------------
# parity with the JAX package's tuner
# ---------------------------------------------------------------------------
def test_pow2_bucket_matches_jax():
    from repro.kernels import autotune as jat
    for n in range(0, 8193):
        assert autotune._pow2_bucket(n) == jat._pow2_bucket(n), n


def test_tuned_tp_matmul_matches_jax(tuner, tmp_path, monkeypatch):
    """JAX's tuner records block (32, 128, 128) for [64, 256] @ [256, 128],
    the port's a two-way split of K 256; the two ``tp_matmul(policy=
    "fp32")`` calls agree within 1e-6 relative."""
    import jax.numpy as jnp
    from repro.kernels import autotune as jat
    from repro.kernels import ops as jops
    rs = np.random.RandomState(0)
    a, b = rs.randn(64, 256).astype(np.float32), rs.randn(
        256, 128).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
        mp.setenv("REPRO_PRETUNED_CACHE", str(tmp_path / "jship.json"))
        jat.reset()
        try:
            jat.record("matmul", (64, 256, 128), jnp.float32, (32, 128, 128))
            assert jat.best_block("matmul", (64, 256, 128),
                                  jnp.float32) == (32, 128, 128)
            want = np.asarray(jops.tp_matmul(jnp.asarray(a), jnp.asarray(b),
                                             policy="fp32"))
        finally:
            jat.reset()
    autotune.record("matmul", (64, 256, 128), F32, (1, 2), device=CPU)
    got = kops.tp_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         policy="fp32").numpy()
    assert kops.tp_matmul_plan(64, 256, 128, F32, CPU).splits == 2
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_module_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.kernels.autotune\n"
            "import repro_torch.kernels.ops\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       env={**os.environ, "PYTHONPATH": src})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
