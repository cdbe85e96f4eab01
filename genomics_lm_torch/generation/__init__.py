"""Generation: KV-cached prefill, decode steps and batched sampling."""
