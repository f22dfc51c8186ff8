"""Model and quantization configs (pure Python copies of `repro.configs`)."""
