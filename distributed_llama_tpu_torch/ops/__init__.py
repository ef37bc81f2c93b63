"""Q40 matmul kernels and their wrappers, the KV cache, attention."""
