"""Architecture registry: ``--arch <id>`` -> (ModelConfig, Model).

Every config of the JAX package's ``repro.configs`` is ported, each at
full width and as ``reduced()``: gemma2-9b (GQA), minicpm3-4b (MLA),
qwen3-moe-30b-a3b (GQA + MoE), deepseek-v2-lite-16b (MLA + MoE),
granite-20b (MQA, group 48, gelu MLP with biases), gemma3-12b (5:1
local:global, qk-norm), internvl2-26b (group 6, a patch frontend stub),
whisper-small (an encoder-decoder with layernorm and learned positions),
zamba2-1.2b (Mamba2 and a shared attention block), xlstm-1.3b (mLSTM and
sLSTM) and fpnew-case-study (the 110M dense LM of the training
launcher).  Any other arch id raises ``NotImplementedError``."""
from __future__ import annotations

import importlib

from ..core.device import DeviceLike, resolve_device
from ..core.policy import get_policy
from .transformer import Model

ARCHS = ("gemma2_9b", "minicpm3_4b", "qwen3_moe_30b_a3b",
         "deepseek_v2_lite_16b", "granite_20b", "gemma3_12b",
         "internvl2_26b", "whisper_small", "zamba2_1_2b", "xlstm_1_3b",
         "fpnew_case_study")

ALIASES = {"gemma2-9b": "gemma2_9b", "minicpm3-4b": "minicpm3_4b",
           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "granite-20b": "granite_20b", "gemma3-12b": "gemma3_12b",
           "internvl2-26b": "internvl2_26b",
           "whisper-small": "whisper_small",
           "zamba2-1.2b": "zamba2_1_2b", "xlstm-1.3b": "xlstm_1_3b",
           "fpnew-case-study": "fpnew_case_study"}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, reduced: bool = False):
    name = canonical(arch)
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not a config of this repo (ported: "
            f"{', '.join(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.reduced() if reduced else mod.CONFIG
    return cfg.validate()


def build_model(arch: str, policy="tp_bf16", reduced: bool = False,
                device: DeviceLike = None, **cfg_overrides) -> Model:
    """The model on ``device`` (default: the GPU; raises without one)."""
    model = Model(cfg=get_config(arch, reduced=reduced),
                  policy=get_policy(policy), device=resolve_device(device))
    return model.with_cfg(**cfg_overrides) if cfg_overrides else model
