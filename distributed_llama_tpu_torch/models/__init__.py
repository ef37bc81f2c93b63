"""Model config, rope, the Llama forward and device sampling."""
