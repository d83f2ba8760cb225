"""Timing on the card and weight interop."""
