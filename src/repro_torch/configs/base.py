"""Model / shape configuration system.

One module per assigned architecture lives next to this file; each exports
``CONFIG`` (the exact assigned configuration) and ``SMOKE`` (a reduced
same-family configuration for CPU smoke tests).  ``--arch <id>`` in the
launchers resolves through :func:`get_config`.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    local_window: int = 0            # >0: sliding-window attention size
    alt_local_global: bool = False   # gemma2: alternate local/global layers
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl M-RoPE
    post_norms: bool = False         # gemma2 sandwich norms
    act: str = "silu"
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel
    moe_capacity_factor: float = 2.0  # <=0: dropless (exact)
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_free: bool = False
    hybrid: bool = False             # parallel attn + ssm heads (hymba)
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500
    # numerics
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # modality frontend stub: prefill consumes precomputed embeddings
    embedding_inputs: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        if self.attn_free:
            return True
        if self.hybrid and self.local_window > 0:
            return True
        return False

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KVH, hd = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = 0
        if H:
            per_layer += D * (H * hd) + 2 * D * (KVH * hd) + (H * hd) * D
        if self.ssm_state:
            inner = self.ssm_heads * self.ssm_head_dim
            per_layer += 2 * D * inner + 2 * D * self.ssm_state + inner * D
        if self.moe_experts:
            per_layer += self.moe_experts * 3 * D * F + D * self.moe_experts
            if self.moe_dense_residual:
                per_layer += 3 * D * F
        elif F:
            per_layer += 3 * D * F
        total = self.n_layers * per_layer + V * D
        if self.enc_layers:
            total += self.enc_layers * (4 * D * D + 3 * D * F)
            total += self.n_layers * (4 * D * D)  # cross attention
        return total

    def active_params_count(self) -> int:
        if not self.moe_experts:
            return self.params_count()
        D, F = self.d_model, self.d_ff
        per_layer_moe = self.moe_experts * 3 * D * F
        active_moe = self.moe_top_k * 3 * D * F
        return (
            self.params_count()
            - self.n_layers * per_layer_moe
            + self.n_layers * active_moe
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "mamba2-370m",
    "stablelm-3b",
    "gemma2-2b",
    "qwen1.5-110b",
    "smollm-135m",
    "olmoe-1b-7b",
    "arctic-480b",
    "whisper-medium",
    "qwen2-vl-2b",
    "hymba-1.5b",
]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}"
    )
    return mod.SMOKE if smoke else mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch × shape) runnable?  Returns (ok, reason-if-skip)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "full-attention arch: 512k-token decode needs sub-quadratic "
            "attention (skip per assignment; see DESIGN.md §6)"
        )
    return True, ""
