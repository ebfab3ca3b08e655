"""Storage hierarchy: holder → index → frame → view → fragment."""
