"""Quantization-aware training (BASELINE config 5)."""
