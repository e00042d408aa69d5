"""Framework-free host helpers (counterpart of ``eld_tpu.core``)."""
