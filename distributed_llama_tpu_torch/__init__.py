"""PyTorch + CUDA port of distributed_llama_tpu for one NVIDIA Hopper GPU.

Module paths mirror the JAX package's so each counterpart is easy to find.
The package imports torch and never jax, and nothing of the JAX package:
it keeps its own copies of the file formats, tokenizer and PRNG. Its entry
points run on the card unless the caller passes ``device="cpu"``.
"""
