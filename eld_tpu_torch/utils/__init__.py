"""Host utilities (counterpart of ``eld_tpu.utils``)."""
