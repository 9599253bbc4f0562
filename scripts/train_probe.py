#!/usr/bin/env python3
"""Where a training step's time goes, on one GPU: full-width
fpnew-case-study at the smoke's shapes (seq 256, batch 16, AdamW) through
``make_train_step``, one variant at a time.

    python3 scripts/train_probe.py

Variants: ``tp_bf16`` with remat ``full`` (the default), deterministic
algorithms on and off, remat off and ``dots``; ``fp32`` and ``em_fp8``
with remat ``full``.  Each prints one line ``PROBE {...}``: host-clock ms
a step (median of 5 after 2 warm-up steps, each ending in a sync), device
busy ms a step (kernels, memcpy and memset under ``torch.profiler``,
``record_function`` ranges left out), the idle share, tokens/s, and peak
device memory.  Needs no kernel build: training launches none.
"""
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = (("tp_bf16", "full", True, False), ("tp_bf16", "full", False, False),
            ("tp_bf16", "none", False, True), ("tp_bf16", "dots", False, False),
            ("fp32", "full", False, False), ("em_fp8", "full", False, False))


def main() -> None:
    import chip_smoke as c          # puts ``ROOT/src`` first on the path
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.convert import stack_layers
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.utils.deterministic.fill_uninitialized_memory = False
    print(c.card_line(), flush=True)
    data = SyntheticLMData(DataConfig(vocab=32000, seq_len=c.TRAIN_SEQ,
                                      global_batch=c.TRAIN_BATCH))
    batches = [{k: v.cuda() for k, v in data.batch_at(i).items()}
               for i in range(7)]
    for policy, remat_policy, det, no_remat in VARIANTS:
        torch.use_deterministic_algorithms(det)
        torch.cuda.reset_peak_memory_stats()
        model = build_model("fpnew-case-study", policy=policy, device="cuda",
                            prefill_backend="dense", remat_policy=remat_policy)
        params = stack_layers(model.init(0), model.cfg)
        cfg = OptConfig(lr=c.TRAIN_LR, warmup_steps=c.TRAIN_WARMUP,
                        total_steps=c.TRAIN_STEPS)
        state = init_opt_state(params, cfg, model.policy)
        step = make_train_step(model, cfg, remat=not no_remat)
        dts = []
        for b in batches:
            t0 = time.perf_counter()
            float(step(params, state, b)[2]["loss"])
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in batches[:3]:
                step(params, state, b)
            torch.cuda.synchronize()
        busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and not ev.is_user_annotation) / 1e3 / 3
        ms = statistics.median(dts[2:]) * 1e3
        print("PROBE " + json.dumps(dict(
            policy=policy, remat=None if no_remat else remat_policy,
            deterministic=det, ms_per_step=ms, device_busy_ms=busy,
            idle_share=1.0 - busy / ms,
            tokens_s=c.TRAIN_SEQ * c.TRAIN_BATCH / ms * 1e3,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)
        del model, params, state, step
        c.gc_cuda()
    torch.use_deterministic_algorithms(False)


if __name__ == "__main__":
    main()
