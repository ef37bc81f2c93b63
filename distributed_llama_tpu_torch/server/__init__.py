"""The OpenAI-compatible API server."""
