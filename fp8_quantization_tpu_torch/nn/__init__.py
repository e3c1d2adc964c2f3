"""Quantized layers, quantizers, factored interchange and weight baking."""
