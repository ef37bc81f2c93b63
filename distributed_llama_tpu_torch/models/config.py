"""Static model configuration derived from the `.m` header's ModelSpec."""

from __future__ import annotations

import dataclasses

from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct, ModelSpec, RopeType


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    arch: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    head_size: int
    kv_dim: int
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_type: RopeType = RopeType.LLAMA
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    # apply the Llama-3.1 frequency scaling to the rotated values instead of
    # the frequencies, bug-for-bug with the reference C++ runtime
    rope_llama3_reference_quirk: bool = False
    # MoE capacity factor (MoE models are not ported yet; the field keeps
    # the config field-for-field equal to the JAX package's)
    moe_capacity_factor: float = 0.0

    @property
    def kv_mul(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def config_from_spec(spec: ModelSpec, **overrides) -> LlamaConfig:
    return LlamaConfig(
        arch=spec.arch_type,
        dim=spec.dim,
        hidden_dim=spec.hidden_dim,
        n_layers=spec.n_layers,
        n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads,
        vocab_size=spec.vocab_size,
        seq_len=spec.seq_len,
        head_size=spec.head_size,
        kv_dim=spec.kv_dim,
        n_experts=spec.n_experts,
        n_active_experts=spec.n_active_experts,
        hidden_act=spec.hidden_act,
        rope_type=spec.resolved_rope_type(),
        rope_theta=spec.rope_theta,
        rope_scaling_factor=spec.rope_scaling_factor,
        rope_scaling_low_freq_factor=spec.rope_scaling_low_freq_factor,
        rope_scaling_high_freq_factor=spec.rope_scaling_high_freq_factor,
        rope_scaling_orig_max_seq_len=spec.rope_scaling_orig_max_seq_len,
        **overrides,
    )
