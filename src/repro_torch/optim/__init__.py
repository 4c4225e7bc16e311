"""AdamW with f32 master weights (``adamw``)."""
