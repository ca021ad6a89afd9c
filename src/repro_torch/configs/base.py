"""Model/shape configuration system.

Each assigned architecture gets one ``src/repro_torch/configs/<id>.py`` exposing
``CONFIG`` (full published config) and ``smoke_config()`` (reduced config of
the same family for CPU tests). Shapes are global to the LM family:

    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (single-token decode w/ KV cache)
    long_500k    seq_len=524288  global_batch=1     (long-context decode; sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024           # GShard dispatch group size (tokens)
    moe_impl: str = "capacity"      # capacity | dense
    # --- SSM (Mamba-1) ---
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 256            # chunked-scan chunk length
    # --- hybrid (Hymba-style) ---
    swa_window: int = 0             # 0 -> full attention everywhere
    n_global_layers: int = 3        # first/mid/last layers use full attention
    # --- enc-dec (Whisper-style) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- VLM (InternVL-style): patch-embedding stub ---
    n_patches: int = 0
    # --- numerics / compile shape ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "full"      # none | full | dots
    attn_chunk: int = 0             # 0 -> unchunked; else query-chunked attention
    # residual-stream sharding (memory lever for big train/prefill cells):
    # "seq" = Megatron-style sequence parallelism (attention archs),
    # "dmodel" = hidden-dim sharding (SSM/hybrid archs, whose seq scan
    # cannot be split), "none" = replicated residual.
    residual_shard: str = "none"
    # gather FSDP-sharded weights before the matmul (vs XLA's partial-sum +
    # output all-reduce choice). Right for token-heavy train/prefill; wrong
    # for decode where outputs are tiny. Set by launch.steps.tune_config.
    gather_weights: bool = False
    # cast the stacked layer params to the compute dtype BEFORE the layer
    # scan so FSDP all-gathers move bf16, not fp32.
    cast_params_once: bool = True
    norm_eps: float = 1e-5
    vocab_pad: int = 256

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab, self.vocab_pad
        return ((v + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "internvl2_2b",
    "phi4_mini_3p8b",
    "smollm_135m",
    "deepseek_7b",
    "qwen3_0p6b",
    "hymba_1p5b",
    "grok1_314b",
    "granite_moe_1b",
    "falcon_mamba_7b",
    "whisper_medium",
]

# Sub-quadratic archs run long_500k; pure full-attention archs skip it
# (see DESIGN.md §Arch-applicability).
SUBQUADRATIC = {"hymba_1p5b", "falcon_mamba_7b"}


def shape_cells(arch: str) -> list[str]:
    """The dry-run/roofline shape cells defined for an architecture."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        cells.append("long_500k")
    return cells


def load_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def load_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config()
