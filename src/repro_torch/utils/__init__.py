"""Helpers on dicts of tensors (the port's pytrees)."""
