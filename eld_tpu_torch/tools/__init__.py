"""Command-line entry points (counterpart of ``eld_tpu.tools``)."""
