"""Small host utilities (copied from the reference package)."""
