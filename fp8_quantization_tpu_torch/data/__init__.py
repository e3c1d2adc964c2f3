"""Input pipelines (synthetic and ImageFolder data, NHWC float32)."""
