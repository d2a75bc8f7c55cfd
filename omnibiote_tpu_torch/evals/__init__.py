"""Serving-side helpers of the eval harness (the harness itself is not
ported yet: ROADMAP Queue 1, item 8)."""
