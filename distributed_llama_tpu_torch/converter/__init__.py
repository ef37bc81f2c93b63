"""Offline conversion toolchain: HF safetensors / Meta .pth -> `.m`,
tokenizers -> `.t`, and the named-model launcher registry.

The port's copy of the JAX package's ``converter`` package: the same files
from the same checkpoints, with the safetensors format read by numpy alone.
"""

from distributed_llama_tpu_torch.converter.hf import convert_hf, permute_qk

__all__ = ["convert_hf", "permute_qk"]
