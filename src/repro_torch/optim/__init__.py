"""AdamW over dicts of tensors (port of ``repro.optim``)."""
