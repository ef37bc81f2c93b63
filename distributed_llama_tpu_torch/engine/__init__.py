"""Weight loading and the single-device inference engine."""

from distributed_llama_tpu_torch.engine.engine import EngineStream, InferenceEngine, TokenStats

__all__ = ["EngineStream", "InferenceEngine", "TokenStats"]
