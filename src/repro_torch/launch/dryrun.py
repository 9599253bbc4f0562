"""Dry run on the meta device: every (architecture x input shape) cell's
step at full width and depth, on rank 0's view of the production mesh,
counted without a card, the JAX package's ``launch/dryrun.py``.

JAX lowers and compiles each step for 256 / 512 placeholder CPU devices
and reads XLA's memory and cost analyses.  The port has no HLO; instead
the step itself runs once, eagerly, on META tensors (shapes and dtypes,
no values):

  * the step is the serving or training step the port runs
    (``train.serve_step.make_prefill`` / ``make_decode_step``, the
    ``train.train_step.jit_train_step`` twin with ``remat=True``), with
    the dense attention backends (JAX's "auto" lowers dense on its CPU
    placeholders), built at the cell's global shapes and cut to rank 0's
    blocks (``serve_step.local_args``);
  * the mesh is rank 0's view of ``make_production_mesh`` (``(16, 16)``,
    or ``(2, 16, 16)`` with ``--multi-pod``) with no process group:
    ``launch.spmd`` answers each collective on meta tensors with the shape
    the real one returns and tables it as ``op@group_size`` with its
    output bytes (``coll``, JAX's ``parse_collectives`` keys);
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
    attention products; XLA's count also takes elementwise ops);
  * ``bytes`` / ``transcendentals``: ``Counter``, a ``TorchDispatchMode``
    that sums every op's input and output bytes (eager torch fuses
    nothing, so that is the traffic) and the elements of every
    transcendental op;
  * ``memory``: the same mode follows every storage the step makes
    (a weakref finaliser each) and gives ``peak_bytes`` (arguments plus
    the most the step held at once), ``argument_bytes``,
    ``output_bytes`` (results in new storage), ``temp_bytes`` (peak less
    arguments and outputs) and ``alias_bytes`` (results written into an
    argument's storage: the caches, which JAX donates).

Eager torch runs every layer, chunk and token, so nothing is counted once
per loop body and JAX's R-differential variants have nothing to correct:
``--costs`` counts the same step on the single-pod mesh and adds the
parameter counts.  Meta tensors take the card's op path
(``core.device.meta_as_card``); ``count(card=False)`` traces the CPU's,
which the tests hold against the same step on real CPU tensors.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --costs
  python -m repro_torch.launch.dryrun --all --out results/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..core.device import meta_as_card
from ..core.policy import get_policy
from ..models.transformer import Model
from . import spmd
from .mesh import _mk_mesh, dp_axes_of, make_production_mesh

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

ARCH_IDS = [
    "internvl2-26b", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
    "whisper-small", "xlstm-1.3b", "granite-20b", "gemma2-9b",
    "minicpm3-4b", "gemma3-12b", "zamba2-1.2b",
]

_aten = torch.ops.aten
#: ops whose every output element is one transcendental evaluation
TRANSCENDENTAL = {
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2,
    _aten.tanh, _aten.sigmoid, _aten.rsqrt, _aten.sqrt, _aten.erf,
    _aten.sin, _aten.cos, _aten.pow, _aten.silu, _aten.gelu,
    _aten.softplus, _aten._softmax, _aten._log_softmax, _aten.logsumexp,
}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    seen = {}
    for t in _tensors(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class Counter(TorchDispatchMode):
    """Counts the ops dispatched inside it: ``bytes`` (each op's tensor
    inputs and outputs; view ops move none), ``transcendentals`` (output
    elements of ``TRANSCENDENTAL`` ops) and the live bytes of storages made
    inside it (``live``, its maximum ``peak``); storages in ``known``
    (the arguments') are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self._held = set(known)
        self._mine = {}

    def _free(self, key: int) -> None:
        self.live -= self._mine.pop(key, 0)
        self._held.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        self._held.add(key)
        self._mine[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            if func.overloadpacket in TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
        for t in _tensors(out):
            self._track(t)
        return out


def count(step, args, *, card: bool = True) -> dict:
    """Runs ``step(*args)`` once under the counters (meta tensors take the
    card's op path unless ``card=False``); returns the record's
    ``memory``, ``flops``, ``bytes``, ``transcendentals`` and ``coll``."""
    known = {_key(t) for t in _tensors(args)}
    arg_bytes = storage_bytes(args)
    spmd.reset_stats()
    with meta_as_card(card):
        with FlopCounterMode(display=False) as fc, Counter(known) as c:
            out = step(*args)
        outs = _tensors(out)
        alias = storage_bytes([t for t in outs if _key(t) in known])
        new = storage_bytes([t for t in outs if _key(t) not in known])
    rec = {
        "memory": {"peak_bytes": arg_bytes + c.peak,
                   "argument_bytes": arg_bytes,
                   "output_bytes": new,
                   "temp_bytes": max(c.peak - new, 0),
                   "alias_bytes": alias},
        "flops": fc.get_total_flops(),
        "bytes": c.bytes,
        "transcendentals": c.transcendentals,
        "coll": {k: dict(v) for k, v in sorted(spmd.STATS["coll"].items())},
    }
    del out, outs
    return rec


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def materialize(tree, device):
    """``tree`` with every meta tensor replaced by zeros on ``device``
    (the real-tensor twin of a dry run's arguments)."""
    if isinstance(tree, torch.Tensor):
        return (torch.zeros(tree.shape, dtype=tree.dtype, device=device)
                if tree.device.type == "meta" else tree)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [materialize(v, device) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return tree


def build_step(cfg, shape_name, mesh, policy, *, loss_chunk=1024,
               compress=None, device=META, seq=None, batch=None):
    """``(step, args)`` of the cell on ``mesh``: ``args`` this rank's
    blocks, meta tensors (``device`` another device: zeros there)."""
    from ..optim.optimizer import OptConfig, init_opt_state
    from ..train.serve_step import (local_args, make_decode_step,
                                    make_prefill)
    from ..train.train_step import (init_error_feedback, jit_train_step,
                                    local_rows, shard_opt_state)
    from ..models import sharding as shd

    sh = dict(SHAPES[shape_name])
    sh.update({k: v for k, v in (("seq", seq), ("batch", batch))
               if v is not None})
    pol = get_policy(policy)
    if cfg.narrow_partials:
        pol = pol.replace(narrow_partials=True)
    cfg = dataclasses.replace(cfg, decode_backend="dense",
                              prefill_backend="dense")
    model = Model(cfg=cfg, policy=pol, device=torch.device(device))
    dp = dp_axes_of(mesh)
    if sh["kind"] == "train":
        step, whole, specs = jit_train_step(
            model, OptConfig(), mesh, batch_size=sh["batch"],
            seq_len=sh["seq"], dp_axes=dp, remat=True,
            loss_chunk=loss_chunk, compress_grads=compress)
        params = shd.shard_params(whole[0], mesh, cfg)
        opt = shard_opt_state(
            init_opt_state(whole[0], OptConfig(), pol), specs["opt"], mesh)
        rows = local_rows(whole[2], mesh, dp)
        args = [params, opt, rows]
        if compress is not None:
            args.append(init_error_feedback(params))
            args = [materialize(a, device) for a in args]
            return step, tuple(args) + (0,)
        return step, tuple(materialize(a, device) for a in args)
    if sh["kind"] == "prefill":
        step, whole, specs = make_prefill(model, mesh, batch=sh["batch"],
                                          seq_len=sh["seq"],
                                          max_len=sh["seq"], dp_axes=dp)
    else:
        step, whole, specs = make_decode_step(model, mesh, batch=sh["batch"],
                                              max_len=sh["seq"], dp_axes=dp)
    return step, materialize(local_args(whole, specs, mesh), device)


def real_rank(rank: int, world: int, cells) -> list:
    """A ``spmd.spawn`` rank running each cell's step on real CPU tensors
    (zeros) over a real ``(data, model)`` mesh of the world's first ranks:
    ``cells`` of ``(arch, shape, mesh_shape, seq, batch)`` on the reduced
    configs.  Returns, per cell, this rank's collective table and counted
    flops (None where the rank is outside the mesh): the dry run's
    reference."""
    from ..models.registry import get_config
    out = []
    for arch, shape, mesh_shape, seq, batch in cells:
        mesh = _mk_mesh(tuple(mesh_shape), ("data", "model"))
        if not mesh.member:
            out.append(None)
            continue
        step, args = build_step(get_config(arch, reduced=True), shape, mesh,
                                "tp_bf16", device="cpu", seq=seq,
                                batch=batch)
        spmd.reset_stats()
        with FlopCounterMode(display=False) as fc:
            step(*args)
        out.append({"coll": {k: dict(v) for k, v in
                             sorted(spmd.STATS["coll"].items())},
                    "flops": fc.get_total_flops()})
    return out


# ---------------------------------------------------------------------------
# required dry-run (one cell x one mesh)
# ---------------------------------------------------------------------------
def _apply_sets(cfg, sets):
    """Apply --set key=value overrides (typed by the dataclass field)."""
    if not sets:
        return cfg
    kw = {}
    for kv in sets:
        k, v = kv.split("=", 1)
        obj, attr = cfg, k
        if "." in k:                      # nested sub-config (mlstm.chunk=...)
            head, attr = k.split(".", 1)
            obj = getattr(cfg, head)
        cur = getattr(obj, attr)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        if obj is cfg:
            kw[attr] = v
        else:
            kw[k.split(".")[0]] = dataclasses.replace(obj, **{attr: v})
    return dataclasses.replace(cfg, **kw)


def dry_mesh(multi_pod: bool = False, shape=None):
    """Rank 0's view of the production mesh, or of a ``(data, model)``
    mesh of ``shape``, with no process group."""
    if shape is None:
        return make_production_mesh(multi_pod=multi_pod, dry=True)
    return _mk_mesh(tuple(shape), ("data", "model"), dry=True)


def run_cell(arch: str, shape_name: str, multi_pod: bool, policy: str,
             compress=None, sets=None, *, reduced: bool = False,
             mesh_shape=None) -> dict:
    from ..models.registry import get_config

    cfg = _apply_sets(get_config(arch, reduced=reduced), sets)
    mesh = dry_mesh(multi_pod, mesh_shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.devices.shape),
           "n_devices": int(mesh.devices.size), "policy": policy,
           "compress": compress, "sets": sets or [],
           "counter": "meta-device eager step: FlopCounterMode (flops), "
                      "dispatch Counter (bytes, transcendentals, storage "
                      "lifetimes), spmd dry collectives (coll)"}
    if SHAPES[shape_name]["kind"] != "train" and compress:
        rec.update(ok=False, skipped="compress only applies to train")
        return rec
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec.update(ok=False,
                   skipped="full-attention arch: long_500k per assignment")
        return rec
    t0 = time.time()
    seq = SHAPES[shape_name]["seq"]
    lengths = s_linear(cfg, shape_name)
    if lengths is None:
        step, args = build_step(cfg, shape_name, mesh, policy,
                                compress=compress)
        t1 = time.time()
        counted = count(step, args)
        rec["method"] = "eager count (every layer, chunk and token)"
    else:
        t1 = time.time()
        s1, s2 = lengths
        r1, r2 = (count(*build_step(cfg, shape_name, mesh, policy,
                                    compress=compress, seq=s))
                  for s in lengths)
        counted = _affine(r1, r2, (seq - s1) / (s2 - s1))
        rec["method"] = (f"S-linear: counted at S={s1} and S={s2}, "
                         f"extrapolated to S={seq} (the sLSTM time loop; "
                         f"the peak an affine estimate)")
    rec.update(ok=True, times={"build_s": round(t1 - t0, 2),
                               "count_s": round(time.time() - t1, 2)},
               **counted)
    return rec


#: the lengths an sLSTM stack's prefill is counted at (``s_linear``)
S_LINEAR = (1024, 2048)


def s_linear(cfg, shape_name):
    """The two lengths a cell is counted at and extrapolated from, or None
    (counted at its own length).  An sLSTM stack's prefill walks its time
    loop token by token: at 32768 tokens that is millions of dispatched
    ops.  Its prefill's summed counts (flops, bytes, transcendentals,
    collectives) are affine in S at multiples of the mLSTM chunk (256), so
    two lengths give them exactly (the JAX package's dry run counts one
    sLSTM layer at S = 32 and scales it linearly); the peak, a maximum, is
    extrapolated the same way as an estimate.  Training is counted whole: its backward
    through the time loop moves bytes quadratic in S (each step's
    ``select`` backward fills a whole [B, S, 4D] gradient)."""
    if (SHAPES[shape_name]["kind"] != "prefill"
            or not any(s.mixer == "slstm" for s in cfg.layer_list())):
        return None
    return S_LINEAR


def _affine(r1, r2, k: float):
    """``r1 + k (r2 - r1)`` over every number of two ``count`` records."""
    if isinstance(r1, dict):
        return {key: _affine(r1.get(key, 0) if isinstance(r2.get(key), int)
                             else r1.get(key, {}), r2[key], k)
                for key in r2}
    return int(round(r1 + k * (r2 - r1)))


def cost_cell(arch: str, shape_name: str, policy: str, sets=None,
              compress=None, *, reduced: bool = False) -> dict:
    """The per-device cost terms on the single-pod mesh: the dry run's
    counts (exact, every layer counted) and the parameter counts."""
    from ..models.registry import get_config
    rec = run_cell(arch, shape_name, False, policy, compress=compress,
                   sets=sets, reduced=reduced)
    if not rec["ok"]:
        return rec
    rec.pop("memory")
    rec["params"] = _apply_sets(get_config(arch, reduced=reduced),
                                sets).param_counts()
    return rec


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def all_cells():
    from ..models.registry import get_config
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.sub_quadratic:
                continue
            yield arch, shape


def _run_all(args) -> None:
    os.makedirs(args.out, exist_ok=True)
    jobs = []
    for arch, shape in all_cells():
        base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--policy", args.policy]
        for mp in (False, True):
            tag = f"dryrun_{arch}_{shape}_{'pod2' if mp else 'pod1'}"
            jobs.append((tag, base + ["--json", os.path.join(
                args.out, tag + ".json")] + (["--multi-pod"] if mp else [])))
        tag = f"costs_{arch}_{shape}"
        jobs.append((tag, base + ["--costs", "--json",
                                  os.path.join(args.out, tag + ".json")]))
    todo = [(t, c) for t, c in jobs
            if not (args.skip_existing
                    and os.path.exists(c[c.index("--json") + 1]))]
    running = []
    while todo or running:
        while todo and len(running) < args.jobs:
            tag, cmd = todo.pop(0)
            log = open(cmd[cmd.index("--json") + 1] + ".log", "w+")
            running.append((tag, cmd, time.time(), log, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=log)))
        done = [r for r in running if r[4].poll() is not None]
        if not done:
            time.sleep(0.2)
            continue
        running.remove(done[0])
        tag, cmd, t0, log, proc = done[0]
        outfile = cmd[cmd.index("--json") + 1]
        ok = proc.returncode == 0 and os.path.exists(outfile)
        print(f"[{'ok' if ok else 'FAIL'}] {tag} ({time.time() - t0:.0f}s)",
              flush=True)
        log.seek(0)
        err = log.read()
        log.close()
        os.remove(log.name)
        if not ok:
            with open(outfile + ".err", "w") as f:
                json.dump({"tag": tag, "returncode": proc.returncode,
                           "stderr": err[-4000:]}, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--policy", default="tp_bf16")
    p.add_argument("--compress", default=None)
    p.add_argument("--costs", action="store_true",
                   help="the cost terms and parameter counts on the "
                        "single-pod mesh")
    p.add_argument("--set", action="append", dest="sets", default=[],
                   help="config override key=value (repeatable)")
    p.add_argument("--json", default=None, help="write record to this file")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="results")
    p.add_argument("--skip-existing", action="store_true", default=True)
    p.add_argument("--jobs", type=int, default=1,
                   help="--all: cells counted at once, one process each")
    p.add_argument("--reduced", action="store_true",
                   help="the arch's reduced config (tests)")
    args = p.parse_args(argv)

    if args.all:
        _run_all(args)
        return None

    if not (args.arch and args.shape):
        p.error("--arch and --shape are required (or --all)")
    try:
        if args.costs:
            rec = cost_cell(args.arch, args.shape, args.policy,
                            sets=args.sets, compress=args.compress,
                            reduced=args.reduced)
        else:
            rec = run_cell(args.arch, args.shape, args.multi_pod,
                           args.policy, compress=args.compress,
                           sets=args.sets, reduced=args.reduced)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "ok": False,
               "error": traceback.format_exc()[-4000:]}
        print(json.dumps(rec, indent=1))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rec, f, indent=1)
        sys.exit(1)
    print(json.dumps(rec, indent=1, default=float))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


if __name__ == "__main__":
    main()
