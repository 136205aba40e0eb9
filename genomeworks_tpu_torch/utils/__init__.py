"""Small utility functions (counterpart of genomeworks_tpu/utils)."""
