"""Slot-level pipelines (one card: UEs and codeblocks are batch axes)."""
