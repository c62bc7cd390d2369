"""The LM stack: the port of `repro.models` for all ten model
architectures (attention, MoE, RG-LRU, RWKV6 and the Whisper
encoder-decoder)."""
