"""Checkpoints (counterpart of ``repro.checkpoint``): ``store`` writes and
reads the same files as the reference's store, so either package loads what
the other saved."""
