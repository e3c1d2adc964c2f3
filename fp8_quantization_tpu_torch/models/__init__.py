"""The quantized model zoo and checkpoint conversion."""
