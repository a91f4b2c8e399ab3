"""AdamW and its learning-rate schedule, as plain tensor code."""
