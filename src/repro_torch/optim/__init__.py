"""AdamW and error-feedback gradient compression."""
