"""Layers of the port: common primitives, RoPE, FFN, attention."""
